"""Video + textual-cue fusion pipeline (counterpart of the JAX package's
``pipelines/cues_video.py``).

    python -m multimodal_lipread_torch.pipelines.cues_video --config configs/cv_config.yaml \\
        [--set key=value ...] [--resume] [--device cuda|cpu]

The JAX pipeline's recipe: the cue records are joined to the ``.npy`` lip
tensors of the mirror tree ``<root>_lip_regions`` (or
``dataset.lip_regions_root``) by (word, sequence id, split); the classes are
the words of the aligned train split; each split's lips are loaded once as
uint8 (scaled to [0, 1] on the device) and its descriptions embedded once
through the ``.npz`` cache (``dataset.embed_model``). One of the seven
fusion models (``middle_fusion_mobile`` by default) trains with Adam and
weight decay, ReduceLROnPlateau on the val loss (factor 0.5, patience 3)
and a test every epoch; the final test runs on the best checkpoint. The
reference schema ``train.model_name`` / ``train.batch`` / ``train.lr`` /
``train.epochs`` / ``train.weight_decay`` / ``train.seed`` /
``train.metrics_dir`` / ``train.save_dir`` is read first, the ``model.*``,
``training.*`` and ``output.*`` keys after it.

``model.freeze_backbone`` overrides each variant's frozen video backbone:
``false`` trains it (no frozen parameters, no caching), ``true`` freezes
``video_encoder.cnn`` in every variant. ``training.frozen_bn_eval`` keeps a
frozen backbone's BatchNorms on their running statistics;
``training.cache_frozen_features`` (for the frozen mobile variants)
computes the frozen backbone's features once (``train/frozen_cache.py``)
and trains on them. ``model.pretrained`` grafts weights after the
initialization. Every epoch also writes the rolling checkpoint
``<model>_checkpoint.pt`` that ``--resume`` continues from (the JAX
pipeline writes none); ``<model>_best.pt`` is what ``serving.py`` serves.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.cues import embed_cached, load_cue_records, records_by_key
from multimodal_lipread_torch.data.glips import SPLITS, scan_lip_regions
from multimodal_lipread_torch.models.cues_video import FROZEN_PARAM_PREFIXES, get_cues_video_model
from multimodal_lipread_torch.parallel.distributed import maybe_initialize_distributed
from multimodal_lipread_torch.pipelines.common import (
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


def load_cue_video_datasets(
    cue_root: str,
    lip_root: str,
    cue_mode: str = "emotion",
    embed_model: str = "mpnet",
    cache_dir: Optional[str] = None,
    splits: Sequence[str] = SPLITS,
) -> Tuple[Dict[str, ArrayDataset], List[str]]:
    """(cue embedding, uint8 lips, label) datasets per split; returns them
    and the class list: the words of the train split's aligned clips (a
    val or test word outside it raises ``ValueError``)."""
    lip_index = scan_lip_regions(lip_root)
    cue_map = records_by_key(load_cue_records(cue_root, cue_mode))
    classes = sorted({e.word for e in lip_index.by_split("train") if e.key in cue_map})
    class_to_idx = {w: i for i, w in enumerate(classes)}
    datasets: Dict[str, ArrayDataset] = {}
    for split in splits:
        entries = [e for e in lip_index.by_split(split) if e.key in cue_map]
        if not entries:
            raise RuntimeError(f"No aligned cue+video samples for split '{split}'")
        uncovered = sorted({e.word for e in entries} - set(class_to_idx))
        if uncovered:
            raise ValueError(
                f"split '{split}' has words with no train-split cue coverage "
                f"(absent from the fitted class set): {uncovered}"
            )
        lips = load_lip_sequences([e.path for e in entries])
        cues = embed_cached([cue_map[e.key].description for e in entries], model=embed_model, cache_dir=cache_dir)
        labels = np.asarray([class_to_idx[e.word] for e in entries], np.int32)
        datasets[split] = ArrayDataset(inputs=(cues, lips), labels=labels)
    return datasets, classes


def main(config: Union[Config, str], resume: bool = False, device: str = "cuda") -> Dict[str, Any]:
    if isinstance(config, str):
        from multimodal_lipread_torch.config import load_config

        config = load_config(config)
    cfg = config
    maybe_initialize_distributed(device)

    datasets, classes = load_cue_video_datasets(
        cfg.get("dataset.cue_root") or cfg.get("dataset.root_dir"),
        resolve_lip_root(cfg),
        cue_mode=cfg.get("dataset.cue_mode", "emotion"),
        embed_model=cfg.get("dataset.embed_model", "mpnet"),
        cache_dir=cfg.get("dataset.cache_dir"),
    )
    num_classes = cfg.get("dataset.num_classes", len(classes))
    if num_classes != len(classes):
        raise ValueError(f"config says {num_classes} classes but found {len(classes)}: {classes}")
    model_name = cfg.get("train.model_name") or cfg.get("model.name") or "middle_fusion_mobile"
    metrics_dir, ckpt_dir = default_dirs(cfg, "cues_video")
    metrics_dir = cfg.get("train.metrics_dir", metrics_dir)
    ckpt_dir = cfg.get("train.save_dir", ckpt_dir)
    cache_frozen = bool(
        cfg.get("training.cache_frozen_features", cfg.get("train.cache_frozen_features", False))
    ) and model_name in FROZEN_PARAM_PREFIXES
    frozen_bn_eval = cache_frozen or bool(cfg.get("training.frozen_bn_eval", cfg.get("train.frozen_bn_eval", False)))
    freeze_backbone = cfg.get("model.freeze_backbone")
    if freeze_backbone is False:
        cache_frozen = False
        frozen_prefixes: tuple = ()
    elif freeze_backbone is True:  # every variant's CNN lives at this path
        frozen_prefixes = (("video_encoder", "cnn"),)
    else:
        frozen_prefixes = FROZEN_PARAM_PREFIXES.get(model_name, ())
    trainer = Trainer(
        get_cues_video_model(model_name, num_classes, dtype=model_dtype(cfg), frozen_bn_eval=frozen_bn_eval,
                             freeze_backbone=freeze_backbone),
        TrainerConfig(
            model_name=model_name,
            num_classes=num_classes,
            class_names=tuple(classes),
            batch_size=cfg.get("train.batch", cfg.get("training.batch_size", 4)),
            epochs=cfg.get("train.epochs", cfg.get("training.epochs", 30)),
            learning_rate=cfg.get("train.lr", cfg.get("training.learning_rate", 1e-4)),
            weight_decay=cfg.get("train.weight_decay", cfg.get("training.weight_decay", 1e-4)),
            scheduler_mode="min",
            scheduler_factor=0.5,
            scheduler_patience=3,
            log_txt_header=True,
            seed=cfg.get("train.seed", cfg.get("training.seed", 0)),
            metrics_dir=metrics_dir,
            checkpoints_dir=ckpt_dir,
            test_every_epoch=True,
            rolling_checkpoint=True,
            frozen_param_prefixes=frozen_prefixes,
            **trainer_extras(cfg),
        ),
        device=device,
    )
    trainer.ensure_initialized()
    load_pretrained_backbones(trainer, cfg)
    if cache_frozen:
        from multimodal_lipread_torch.train.frozen_cache import cached_dataset

        # the model returns the video CNN's feature sequence; the cue stays raw
        datasets = {k: cached_dataset(trainer, v, lambda raw, f: (raw[0], f[0])) for k, v in datasets.items()}
        trainer.set_apply_kwargs(cached_features=True)
    result = trainer.fit(datasets["train"], datasets["val"], datasets["test"], resume=resume)
    maybe_plot(cfg, metrics_dir)
    return result


if __name__ == "__main__":
    cfg = parse_cli()
    main(cfg, resume=bool(cfg.get("_cli.resume", False)), device=cfg.get("_cli.device", "cuda"))
