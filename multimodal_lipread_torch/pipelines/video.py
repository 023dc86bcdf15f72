"""Video-only pipeline: lip-region tensors → frame backbone → temporal head
(counterpart of the JAX package's ``pipelines/video.py``).

    python -m multimodal_lipread_torch.pipelines.video --config configs/visual_config.yaml \\
        [--set key=value ...] [--resume] [--device cuda|cpu]

The same YAML schema and recipe as the JAX pipeline: the ``.npy`` lip
tensors of the mirror tree ``<root>_lip_regions`` are loaded once as uint8
(scaled to [0, 1] on the device), then one of the seven video models trains
with Adam and ReduceLROnPlateau('max', 0.5, 5) on the val accuracy,
evaluating the test split every epoch, keeping the best-val checkpoint and
a rolling one (``--resume`` continues from it) and running the final test
on the best, whose numbers also go to ``test_results.txt`` beside the
checkpoints in the reference's format. Logs go to
``<output.base_dir>/metrics`` (the TXT log opens with its banner),
checkpoints (``<model>_best.pt``, which ``serving.py`` serves) to
``<output.base_dir>/models_trained``.

``model.pretrained`` grafts converted backbone weights after the
initialization (``pipelines/common.load_pretrained_backbones``). Not
ported yet: ``dataset.streaming`` (ROADMAP.md Queue 1 #11),
``dataset.device_crop`` (#8.5) and ``dataset.host_crop_streaming`` (#11)
raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Union

from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.glips import lip_regions_root, lipread_files_dir
from multimodal_lipread_torch.models.video import get_video_model
from multimodal_lipread_torch.pipelines.common import (
    default_dirs,
    load_pretrained_backbones,
    load_video_datasets,
    maybe_plot,
    model_dtype,
    parse_cli,
    trainer_extras,
)
from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

_UNPORTED = (
    ("dataset.streaming", "streaming lip records (the grain loader)", "Queue 1 #11"),
    ("dataset.device_crop", "the crop/resize/pad of full frames on the device", "Queue 1 #8.5"),
    ("dataset.host_crop_streaming", "host decode + crop of full frames per epoch", "Queue 1 #11"),
)


def resolve_lip_root(cfg: Config) -> str:
    """``dataset.lip_regions_root`` if set, else the mirror tree of
    ``dataset.root_dir`` as the reference derives it: with a
    ``<root>/lipread_files`` wrapper the ``.npy`` files live under
    ``<root>_lip_regions/lipread_files``, without one under
    ``<root>_lip_regions``."""
    explicit = cfg.get("dataset.lip_regions_root")
    if explicit:
        return explicit
    root = cfg.get("dataset.root_dir")
    mirror = lip_regions_root(root)
    base = lipread_files_dir(root)
    if os.path.normpath(base) == os.path.normpath(root):
        return mirror
    return os.path.join(mirror, os.path.basename(base))


def main(config: Union[Config, str], resume: bool = False, device: str = "cuda") -> Dict[str, Any]:
    if isinstance(config, str):
        from multimodal_lipread_torch.config import load_config

        config = load_config(config)
    cfg = config
    for key, what, item in _UNPORTED:
        if cfg.get(key):
            raise NotImplementedError(f"{key} ({what}) is not ported to PyTorch yet (ROADMAP.md, {item})")

    datasets, index = load_video_datasets(resolve_lip_root(cfg))
    num_classes = cfg.get("dataset.num_classes", len(index.classes))
    if num_classes != len(index.classes):
        raise ValueError(
            f"config says {num_classes} classes but found {len(index.classes)}: {index.classes}"
        )
    model_name = cfg.get("model.name", "resnet_lstm")
    model = get_video_model(
        model_name,
        num_classes,
        dtype=model_dtype(cfg),
        resnet_version=cfg.get("model.resnet_version", 18),
        shufflenet_version=cfg.get("model.shufflenet_version", "0.5x"),
        feature_dim=cfg.get("model.feature_dim"),
        dropout=cfg.get("model.dropout"),
    )
    metrics_dir, ckpt_dir = default_dirs(cfg, "video")
    trainer = Trainer(
        model,
        TrainerConfig(
            model_name=model_name,
            num_classes=num_classes,
            batch_size=cfg.get("training.batch_size", 16),
            epochs=cfg.get("training.epochs", 10),
            learning_rate=cfg.get("training.learning_rate", 5e-5),
            weight_decay=cfg.get("training.weight_decay", 1e-5),
            scheduler_mode="max",
            scheduler_factor=0.5,
            scheduler_patience=5,
            seed=cfg.get("training.seed", 0),
            metrics_dir=metrics_dir,
            checkpoints_dir=ckpt_dir,
            test_every_epoch=True,
            rolling_checkpoint=True,
            log_txt_header=True,
            **trainer_extras(cfg),
        ),
        device=device,
    )
    trainer.ensure_initialized()
    load_pretrained_backbones(trainer, cfg)
    result = trainer.fit(datasets["train"], datasets["val"], datasets["test"], resume=resume)
    maybe_plot(cfg, metrics_dir)
    if "final_test_acc" in result:  # the reference's test_results.txt
        with open(os.path.join(ckpt_dir, "test_results.txt"), "w") as f:
            f.write(
                f"Final Test Loss: {result['final_test_loss']:.4f}\n"
                f"Final Test Acc: {result['final_test_acc']:.2f}%\n"
                f"Best Val Acc: {result['best_val_acc']:.2f}%\n"
            )
    return result


if __name__ == "__main__":
    cfg = parse_cli()
    main(cfg, resume=bool(cfg.get("_cli.resume", False)), device=cfg.get("_cli.device", "cuda"))
