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

``model.pretrained`` grafts converted backbone weights after the
initialization (``pipelines/common.load_pretrained_backbones``). Not
ported yet: ``dataset.streaming: true`` (the grain loader, ROADMAP.md
Queue 1 #11) raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Union

from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.models.audio import get_audio_model
from multimodal_lipread_torch.pipelines.common import (
    default_dirs,
    load_audio_datasets,
    load_pretrained_backbones,
    maybe_plot,
    model_dtype,
    parse_cli,
    trainer_extras,
)
from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig


def main(config: Union[Config, str], resume: bool = False, device: str = "cuda") -> Dict[str, Any]:
    if isinstance(config, str):
        from multimodal_lipread_torch.config import load_config

        config = load_config(config)
    cfg = config
    if bool(cfg.get("dataset.streaming", False)):
        raise NotImplementedError(
            "dataset.streaming: true (the grain loader) is not ported to PyTorch yet "
            "(ROADMAP.md, Queue 1 #11)"
        )

    root_dir = cfg.get("dataset.root_dir")
    num_classes = cfg.get("dataset.num_classes", 4)
    input_size = cfg.get("dataset.input_size", 117)
    model_name = cfg.get("model.name", "resnet")

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
    metrics_dir, ckpt_dir = default_dirs(cfg, "audio")
    trainer = Trainer(
        model,
        TrainerConfig(
            model_name=model_name,
            num_classes=num_classes,
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
