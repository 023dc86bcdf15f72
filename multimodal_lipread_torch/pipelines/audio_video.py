"""Audio–video fusion pipeline: GLips WAVs and lip-region tensors, joined
clip by clip → one of the seven fusion models (counterpart of the JAX
package's ``pipelines/audio_video.py``).

    python -m multimodal_lipread_torch.pipelines.audio_video --config configs/av_config.yaml \\
        [--set key=value ...] [--resume] [--device cuda|cpu]

The same YAML schema and recipe as the JAX pipeline: audio clips are joined
to the ``.npy`` lip tensors of the mirror tree ``<root>_lip_regions`` by
(word, sequence id, split); each split's clips are decoded (threaded native
decoder) and featurized once by the log-mel kernel at
``dataset.audio_input_size`` time steps, and its lips kept uint8 (scaled to
[0, 1] on the device). The model trains with Adam at lr 1e-4 without weight
decay and without an LR schedule, evaluates the test split every epoch,
keeps the best-val checkpoint and runs the final test on it. Logs go to
``<output.base_dir>/metrics``, checkpoints (``<model>_best.pt``, which
``serving.py`` serves) to ``<output.base_dir>/models_trained``.
``model.pretrained`` grafts weights after the initialization
(``pipelines/common.load_pretrained_backbones``), e.g. a video run's
``resnet`` into ``video_encoder.cnn``. Every epoch also writes the rolling checkpoint
``<model>_checkpoint.pt`` that ``--resume`` continues from, as the video
pipeline does (the JAX AV pipeline writes none).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np

from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.glips import AUDIO_EXTS, SPLITS, align_modalities, scan_glips, scan_lip_regions
from multimodal_lipread_torch.models.audio_video import get_av_model
from multimodal_lipread_torch.pipelines.common import (
    compute_logmel_features,
    decode_waveforms,
    default_dirs,
    load_lip_sequences,
    load_pretrained_backbones,
    maybe_plot,
    model_dtype,
    parse_cli,
    trainer_extras,
)
from multimodal_lipread_torch.pipelines.video import resolve_lip_root
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig


def load_av_datasets(
    root_dir: str,
    lip_root: str,
    input_size: int = 117,
    splits: Sequence[str] = SPLITS,
    device: str = "cuda",
) -> Tuple[Dict[str, ArrayDataset], List[str]]:
    """Aligned (mel, lips, label) datasets per split, the mels computed on
    ``device``; returns them and the class list (the words both
    modalities have)."""
    audio_index = scan_glips(root_dir, exts=AUDIO_EXTS)
    lip_index = scan_lip_regions(lip_root)
    classes = sorted(set(audio_index.classes) & set(lip_index.classes))
    class_to_idx = {w: i for i, w in enumerate(classes)}
    datasets: Dict[str, ArrayDataset] = {}
    for split in splits:
        pairs = align_modalities(audio_index, lip_index, split=split)
        if not pairs:
            raise RuntimeError(f"No aligned audio+video samples for split '{split}'")
        waves = decode_waveforms([a.path for a, _v in pairs])
        mels = compute_logmel_features(waves, input_size=input_size, device=device)
        lips = load_lip_sequences([v.path for _a, v in pairs])
        labels = np.asarray([class_to_idx[a.word] for a, _v in pairs], np.int32)
        datasets[split] = ArrayDataset(inputs=(mels, lips), labels=labels)
    return datasets, classes


def main(config: Union[Config, str], resume: bool = False, device: str = "cuda") -> Dict[str, Any]:
    if isinstance(config, str):
        from multimodal_lipread_torch.config import load_config

        config = load_config(config)
    cfg = config

    input_size = cfg.get("dataset.audio_input_size", 117)
    datasets, classes = load_av_datasets(cfg.get("dataset.root_dir"), resolve_lip_root(cfg),
                                         input_size=input_size, device=device)
    num_classes = cfg.get("dataset.num_classes", len(classes))
    if num_classes != len(classes):
        raise ValueError(f"config says {num_classes} classes but found {len(classes)}: {classes}")
    model_name = cfg.get("model.name", "middle_fusion_mobilenet")
    model = get_av_model(model_name, num_classes, input_size=input_size, dtype=model_dtype(cfg))
    metrics_dir, ckpt_dir = default_dirs(cfg, "audio_video")
    trainer = Trainer(
        model,
        TrainerConfig(
            model_name=model_name,
            num_classes=num_classes,
            batch_size=cfg.get("training.batch_size", 8),
            epochs=cfg.get("training.epochs", 10),
            learning_rate=cfg.get("training.learning_rate", 1e-4),
            weight_decay=0.0,  # the reference trains Adam on the lr alone
            scheduler_factor=1.0,  # and without an LR schedule
            seed=cfg.get("training.seed", 0),
            metrics_dir=metrics_dir,
            checkpoints_dir=ckpt_dir,
            test_every_epoch=True,
            rolling_checkpoint=True,
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
