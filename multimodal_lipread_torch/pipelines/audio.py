"""Audio-only pipeline: GLips WAVs → log-mel on the device → classifier
(counterpart of the JAX package's ``pipelines/audio.py``).

    python -m multimodal_lipread_torch.pipelines.audio --config configs/audio_config.yaml \\
        [--set key=value ...] [--resume] [--device cuda|cpu]

The same YAML schema and recipe as the JAX pipeline: the clips of every
split are decoded (threaded native decoder) and featurized once by the
log-mel CUDA kernel, then the model trains with Adam and
ReduceLROnPlateau('min', 0.5, 5), evaluating the test split every epoch,
keeping the best-val checkpoint and running the final test on it. Logs go
to ``<output.base_dir>/metrics``, checkpoints (``<model>_best.pt``, which
``serving.py`` serves) to ``<output.base_dir>/models_trained``.

``dataset.streaming: true`` streams the waveforms per epoch instead, and
the model is wrapped in ``WaveToLogMel``: the log-mel kernel runs inside
every train and eval step's forward. The loader is
``dataset.loader_backend``:

- ``grain`` (the default): ``data/grain_loader.AudioClipSource`` through a
  ``DataLoader`` of ``dataset.num_workers`` processes, each clip decoded in
  Python (``.m4a`` and off-rate WAVs through ffmpeg);
- ``native``: the C++ prefetcher (``NativeStreamingDataset``,
  ``dataset.num_workers`` threads), PCM16 WAV only: clips that are not WAV
  are transcoded once into a WAV mirror under ``dataset.wav_cache_dir``
  (default ``<root_dir>/wav_cache``, ``tools/transcode.py``).
  ``dataset.wire_dtype: int16`` ships the waveforms to the card as int16.

``model.pretrained`` grafts converted backbone weights after the
initialization (``pipelines/common.load_pretrained_backbones``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Union

from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.audio_io import TARGET_SAMPLES
from multimodal_lipread_torch.data.glips import AUDIO_EXTS, SPLITS, scan_glips
from multimodal_lipread_torch.data.grain_loader import AudioClipSource
from multimodal_lipread_torch.models.audio import get_audio_model
from multimodal_lipread_torch.models.frontend import WaveToLogMel
from multimodal_lipread_torch.parallel.distributed import maybe_initialize_distributed
from multimodal_lipread_torch.pipelines.common import (
    default_dirs,
    load_audio_datasets,
    load_pretrained_backbones,
    maybe_plot,
    model_dtype,
    native_streaming_datasets,
    parse_cli,
    streaming_datasets,
    trainer_extras,
)
from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig


def main(config: Union[Config, str], resume: bool = False, device: str = "cuda") -> Dict[str, Any]:
    if isinstance(config, str):
        from multimodal_lipread_torch.config import load_config

        config = load_config(config)
    cfg = config
    maybe_initialize_distributed(device)
    root_dir = cfg.get("dataset.root_dir")
    num_classes = cfg.get("dataset.num_classes", 4)
    input_size = cfg.get("dataset.input_size", 117)
    model_name = cfg.get("model.name", "resnet")

    streaming = bool(cfg.get("dataset.streaming", False))
    if streaming:
        index = scan_glips(root_dir, exts=AUDIO_EXTS)
        if cfg.get("dataset.loader_backend", "grain") == "native":
            entries = {split: index.by_split(split) for split in SPLITS}
            if any(not e.path.lower().endswith(".wav") for es in entries.values() for e in es):
                from multimodal_lipread_torch.tools.transcode import ensure_wav_mirror

                cache = cfg.get("dataset.wav_cache_dir", os.path.join(root_dir, "wav_cache"))
                entries = {split: ensure_wav_mirror(es, cache, workers=cfg.get("dataset.num_workers", 0) or 8)
                           for split, es in entries.items()}
            datasets = native_streaming_datasets(cfg, entries, index.class_to_idx, "wav", (TARGET_SAMPLES,),
                                                 wire_dtype=cfg.get("dataset.wire_dtype"))
        else:
            datasets = streaming_datasets(
                cfg, lambda split: AudioClipSource(index.by_split(split), index.class_to_idx), ("waveform",))
    else:
        datasets, index = load_audio_datasets(root_dir, input_size=input_size, device=device)
    if len(index.classes) != num_classes:
        raise ValueError(
            f"config says {num_classes} classes but found "
            f"{len(index.classes)}: {index.classes}"
        )
    model = get_audio_model(
        model_name, num_classes, input_size=input_size, version=cfg.get("model.version", 16),
        use_batchnorm=cfg.get("model.use_batchnorm", True),
        dtype=model_dtype(cfg),
        d_model=cfg.get("model.d_model"),  # the conformer's width
    )
    if streaming:
        model = WaveToLogMel(model, input_size=input_size)
    metrics_dir, ckpt_dir = default_dirs(cfg, "audio")
    trainer = Trainer(
        model,
        TrainerConfig(
            model_name=model_name,
            num_classes=num_classes,
            class_names=tuple(index.classes),
            batch_size=cfg.get("training.batch_size", 32),
            epochs=cfg.get("training.epochs", 10),
            learning_rate=cfg.get("training.learning_rate", 5e-4),
            weight_decay=cfg.get("training.weight_decay", 1e-4),
            scheduler_mode="min",
            scheduler_factor=0.5,
            scheduler_patience=5,
            seed=cfg.get("training.seed", 0),
            metrics_dir=metrics_dir,
            checkpoints_dir=ckpt_dir,
            test_every_epoch=True,
            **trainer_extras(cfg),
        ),
        device=device,
    )
    trainer.ensure_initialized()
    load_pretrained_backbones(trainer, cfg)
    result = trainer.fit(datasets["train"], datasets["val"], datasets["test"], resume=resume)
    maybe_plot(cfg, metrics_dir)
    return result


if __name__ == "__main__":
    cfg = parse_cli()
    main(cfg, resume=bool(cfg.get("_cli.resume", False)), device=cfg.get("_cli.device", "cuda"))
