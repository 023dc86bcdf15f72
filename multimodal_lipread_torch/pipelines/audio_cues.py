"""Audio + textual-cue fusion pipeline (counterpart of the JAX package's
``pipelines/audio_cues.py``).

    python -m multimodal_lipread_torch.pipelines.audio_cues --config configs/ac_config.yaml \\
        [--set key=value ...] [--resume] [--device cuda|cpu]

The JAX pipeline's recipe: each split's audio clips are joined to the cue
records by (word, sequence id, split), decoded on the host (the threaded
native decoder) and featurized once by the log-mel kernel at
``dataset.input_size`` time steps; the descriptions are embedded once
through the ``.npz`` cache (``dataset.embed_model``, mpnet by default). One
of the seven fusion models (``middle_fusion_mobile`` by default) trains
with Adam, ReduceLROnPlateau on the val loss (factor 0.5, patience 3), a
2-epoch LR warmup (``training.warmup_epochs: 0`` turns it off) and a test
every epoch; the final test runs on the best checkpoint. The reference
schema ``train.batch`` / ``train.lr`` / ``train.epochs`` / ``train.seed`` is
read first, the ``training.*`` keys after it. ``model.pretrained`` grafts
weights after the initialization. Every epoch also writes the rolling
checkpoint ``<model>_checkpoint.pt`` that ``--resume`` continues from (the
JAX pipeline writes none); ``<model>_best.pt`` is what ``serving.py``
serves.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.cues import embed_cached, load_cue_records, records_by_key
from multimodal_lipread_torch.data.glips import AUDIO_EXTS, SPLITS, scan_glips
from multimodal_lipread_torch.models.audio_cues import get_audio_cues_model
from multimodal_lipread_torch.parallel.distributed import maybe_initialize_distributed
from multimodal_lipread_torch.pipelines.common import (
    compute_logmel_features,
    decode_waveforms,
    default_dirs,
    load_pretrained_backbones,
    maybe_plot,
    model_dtype,
    parse_cli,
    trainer_extras,
)
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig


def load_audio_cue_datasets(
    root_dir: str,
    cue_root: str,
    input_size: int = 117,
    cue_mode: str = "emotion",
    embed_model: str = "mpnet",
    cache_dir: Optional[str] = None,
    splits: Sequence[str] = SPLITS,
    device: str = "cuda",
) -> Tuple[Dict[str, ArrayDataset], List[str]]:
    """(mel, cue embedding, label) datasets per split, the mels computed on
    ``device``; returns them and the audio index's class list."""
    audio_index = scan_glips(root_dir, exts=AUDIO_EXTS)
    cue_map = records_by_key(load_cue_records(cue_root, cue_mode))
    class_to_idx = audio_index.class_to_idx
    datasets: Dict[str, ArrayDataset] = {}
    for split in splits:
        entries = [e for e in audio_index.by_split(split) if e.key in cue_map]
        if not entries:
            raise RuntimeError(f"No aligned audio+cue samples for split '{split}'")
        waves = decode_waveforms([e.path for e in entries])
        mels = compute_logmel_features(waves, input_size=input_size, device=device)
        cues = embed_cached([cue_map[e.key].description for e in entries], model=embed_model, cache_dir=cache_dir)
        labels = np.asarray([class_to_idx[e.word] for e in entries], np.int32)
        datasets[split] = ArrayDataset(inputs=(mels, cues), labels=labels)
    return datasets, audio_index.classes


def main(config: Union[Config, str], resume: bool = False, device: str = "cuda") -> Dict[str, Any]:
    if isinstance(config, str):
        from multimodal_lipread_torch.config import load_config

        config = load_config(config)
    cfg = config
    maybe_initialize_distributed(device)

    datasets, classes = load_audio_cue_datasets(
        cfg.get("dataset.root_dir"),
        cfg.get("dataset.cue_root") or cfg.get("dataset.root_dir"),
        input_size=cfg.get("dataset.input_size", 117),
        cue_mode=cfg.get("dataset.cue_mode", "emotion"),
        embed_model=cfg.get("dataset.embed_model", "mpnet"),
        cache_dir=cfg.get("dataset.cache_dir"),
        device=device,
    )
    num_classes = cfg.get("dataset.num_classes", len(classes))
    if num_classes != len(classes):
        raise ValueError(f"config says {num_classes} classes but found {len(classes)}: {classes}")
    model_name = cfg.get("model.name", "middle_fusion_mobile")
    metrics_dir, ckpt_dir = default_dirs(cfg, "audio_cues")
    trainer = Trainer(
        get_audio_cues_model(model_name, num_classes, dtype=model_dtype(cfg)),
        TrainerConfig(
            model_name=model_name,
            num_classes=num_classes,
            class_names=tuple(classes),
            batch_size=cfg.get("train.batch", cfg.get("training.batch_size", 32)),
            epochs=cfg.get("train.epochs", cfg.get("training.epochs", 5)),
            learning_rate=cfg.get("train.lr", cfg.get("training.learning_rate", 1e-3)),
            weight_decay=cfg.get("train.weight_decay", cfg.get("training.weight_decay", 0.0)),
            scheduler_mode="min",
            scheduler_factor=0.5,
            scheduler_patience=3,
            seed=cfg.get("train.seed", cfg.get("training.seed", 0)),
            metrics_dir=metrics_dir,
            checkpoints_dir=ckpt_dir,
            test_every_epoch=True,
            rolling_checkpoint=True,
            # the JAX pipeline's 2-epoch warmup: at lr 1e-3 Adam's first steps
            # otherwise kill the MobileNet encoder's ReLU6 units
            **trainer_extras(cfg, default_warmup_epochs=2.0),
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
