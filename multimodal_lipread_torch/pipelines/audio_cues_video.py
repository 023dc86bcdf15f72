"""Audio + cue + video ("triple") fusion pipeline (counterpart of the JAX
package's ``pipelines/audio_cues_video.py``).

    python -m multimodal_lipread_torch.pipelines.audio_cues_video --config configs/acv_config.yaml \\
        [--set key=value ...] [--resume] [--device cuda|cpu]

The JAX pipeline's recipe: the audio clips, the ``.npy`` lip tensors of the
mirror tree ``<root>_lip_regions`` (or ``dataset.lip_regions_root``) and the
cue records are joined strictly by (word, sequence id, split); the classes
are the audio index's. Each split's clips are decoded on the host (the
threaded native decoder) and featurized once by the log-mel kernel at
``dataset.input_size`` time steps, the descriptions embedded once through
the ``.npz`` cache and the lips kept uint8 (scaled to [0, 1] on the
device). One of the seven fusion models (``late_fusion_mobile`` by
default) trains with Adam (weight decay 0 unless set), ReduceLROnPlateau
on the val loss (factor 0.5, patience 3) and a test every epoch; every
epoch writes the rolling checkpoint ``<model>_checkpoint.pt`` that
``--resume`` continues from, and the final test runs on the best
checkpoint ``<model>_best.pt`` (what ``serving.py`` serves). The reference
schema ``train.*`` is read first, the ``model.*``, ``training.*`` and
``output.*`` keys after it.

The early variants and ``middle_fusion_resnet`` freeze the audio ResNet
and the video backbone. ``training.frozen_bn_eval`` keeps their
BatchNorms on the running statistics; ``training.cache_frozen_features``
computes their outputs once (``train/frozen_cache.py``) and trains on them.
``model.pretrained`` grafts weights after the initialization.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.cues import embed_cached, load_cue_records, records_by_key
from multimodal_lipread_torch.data.glips import AUDIO_EXTS, SPLITS, align_modalities, scan_glips, scan_lip_regions
from multimodal_lipread_torch.models.audio_cues_video import FROZEN_PARAM_PREFIXES, get_triple_model
from multimodal_lipread_torch.parallel.distributed import maybe_initialize_distributed
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


def load_triple_datasets(
    root_dir: str,
    cue_root: str,
    lip_root: str,
    input_size: int = 117,
    cue_mode: str = "emotion",
    embed_model: str = "mpnet",
    cache_dir: Optional[str] = None,
    splits: Sequence[str] = SPLITS,
    device: str = "cuda",
) -> Tuple[Dict[str, ArrayDataset], List[str]]:
    """(mel, cue embedding, uint8 lips, label) datasets per split, the mels
    computed on ``device``; returns them and the audio index's classes."""
    audio_index = scan_glips(root_dir, exts=AUDIO_EXTS)
    lip_index = scan_lip_regions(lip_root)
    cue_map = records_by_key(load_cue_records(cue_root, cue_mode))
    class_to_idx = audio_index.class_to_idx
    datasets: Dict[str, ArrayDataset] = {}
    for split in splits:
        pairs = [(a, v) for a, v in align_modalities(audio_index, lip_index, split=split) if a.key in cue_map]
        if not pairs:
            raise RuntimeError(f"No aligned audio+cue+video samples for split '{split}'")
        waves = decode_waveforms([a.path for a, _v in pairs])
        mels = compute_logmel_features(waves, input_size=input_size, device=device)
        cues = embed_cached([cue_map[a.key].description for a, _v in pairs], model=embed_model, cache_dir=cache_dir)
        lips = load_lip_sequences([v.path for _a, v in pairs])
        labels = np.asarray([class_to_idx[a.word] for a, _v in pairs], np.int32)
        datasets[split] = ArrayDataset(inputs=(mels, cues, lips), labels=labels)
    return datasets, audio_index.classes


def main(config: Union[Config, str], resume: bool = False, device: str = "cuda") -> Dict[str, Any]:
    if isinstance(config, str):
        from multimodal_lipread_torch.config import load_config

        config = load_config(config)
    cfg = config
    maybe_initialize_distributed(device)

    datasets, classes = load_triple_datasets(
        cfg.get("dataset.root_dir"),
        cfg.get("dataset.cue_root") or cfg.get("dataset.root_dir"),
        resolve_lip_root(cfg),
        input_size=cfg.get("dataset.input_size", 117),
        cue_mode=cfg.get("dataset.cue_mode", "emotion"),
        embed_model=cfg.get("dataset.embed_model", "mpnet"),
        cache_dir=cfg.get("dataset.cache_dir"),
        device=device,
    )
    num_classes = cfg.get("dataset.num_classes", len(classes))
    if num_classes != len(classes):
        raise ValueError(f"config says {num_classes} classes but found {len(classes)}: {classes}")
    model_name = cfg.get("train.model_name") or cfg.get("model.name") or "late_fusion_mobile"
    metrics_dir, ckpt_dir = default_dirs(cfg, "audio_cues_video")
    metrics_dir = cfg.get("train.metrics_dir", metrics_dir)
    ckpt_dir = cfg.get("train.save_dir", ckpt_dir)
    cache_frozen = bool(
        cfg.get("training.cache_frozen_features", cfg.get("train.cache_frozen_features", False))
    ) and model_name in FROZEN_PARAM_PREFIXES
    frozen_bn_eval = cache_frozen or bool(cfg.get("training.frozen_bn_eval", cfg.get("train.frozen_bn_eval", False)))
    trainer = Trainer(
        get_triple_model(model_name, num_classes, dtype=model_dtype(cfg), frozen_bn_eval=frozen_bn_eval),
        TrainerConfig(
            model_name=model_name,
            num_classes=num_classes,
            class_names=tuple(classes),
            batch_size=cfg.get("train.batch", cfg.get("training.batch_size", 4)),
            epochs=cfg.get("train.epochs", cfg.get("training.epochs", 30)),
            learning_rate=cfg.get("train.lr", cfg.get("training.learning_rate", 1e-4)),
            weight_decay=cfg.get("train.weight_decay", cfg.get("training.weight_decay", 0.0)),
            scheduler_mode="min",
            scheduler_factor=0.5,
            scheduler_patience=3,
            log_txt_header=True,
            seed=cfg.get("train.seed", cfg.get("training.seed", 0)),
            metrics_dir=metrics_dir,
            checkpoints_dir=ckpt_dir,
            test_every_epoch=True,
            frozen_param_prefixes=FROZEN_PARAM_PREFIXES.get(model_name, ()),
            rolling_checkpoint=True,
            **trainer_extras(cfg),
        ),
        device=device,
    )
    trainer.ensure_initialized()
    load_pretrained_backbones(trainer, cfg)
    if cache_frozen:
        from multimodal_lipread_torch.train.frozen_cache import cached_dataset

        # the model returns (audio features, video CNN feature sequence); the cue stays raw
        datasets = {k: cached_dataset(trainer, v, lambda raw, f: (f[0], raw[1], f[1])) for k, v in datasets.items()}
        trainer.set_apply_kwargs(cached_features=True)
    result = trainer.fit(datasets["train"], datasets["val"], datasets["test"], resume=resume)
    maybe_plot(cfg, metrics_dir)
    return result


if __name__ == "__main__":
    cfg = parse_cli()
    main(cfg, resume=bool(cfg.get("_cli.resume", False)), device=cfg.get("_cli.device", "cuda"))
