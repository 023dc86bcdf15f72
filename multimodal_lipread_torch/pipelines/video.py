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

Streaming, per epoch, instead of the whole corpus in memory
(``data/grain_loader.py``, ``dataset.num_workers`` loader processes):

- ``dataset.device_crop``: the raw ``.mp4`` clips under
  ``dataset.root_dir`` are decoded on the host and their lips detected
  (``dataset.landmark_backend``); the full uint8 frames and the boxes cross
  to the card, where the crop kernel (``ops/crop_resize_cuda.py``) cuts the
  44 × 44 lips inside the train step, as the trainer's ``device_preproc``.
  With ``training.device_resident`` every split is read once instead
  (:func:`full_frame_dataset`) and held on the card whole, so that only
  indices cross a step, and ``training.steps_per_dispatch`` K > 1 runs K
  steps, crop included, as one CUDA graph replay;
- ``dataset.host_crop_streaming``: the same clips decoded, detected and
  cropped on the host (the reference's layout);
- ``dataset.streaming``: the ``.npy`` lip tensors of the mirror tree, with
  ``dataset.loader_backend: native`` through the C++ prefetcher
  (``NativeStreamingDataset``: raw uint8 records of (29, 44, 44, 3),
  ``dataset.num_workers`` threads).

``model.pretrained`` grafts converted backbone weights after the
initialization (``pipelines/common.load_pretrained_backbones``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Union

import numpy as np

from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.glips import (
    SPLITS,
    lip_regions_root,
    lipread_files_dir,
    scan_glips,
    scan_lip_regions,
)
from multimodal_lipread_torch.data.grain_loader import (
    FullFrameClipSource,
    HostCropClipSource,
    LipClipSource,
    StreamingDataset,
)
from multimodal_lipread_torch.models.video import get_video_model
from multimodal_lipread_torch.parallel.distributed import maybe_initialize_distributed
from multimodal_lipread_torch.pipelines.common import (
    default_dirs,
    load_pretrained_backbones,
    load_video_datasets,
    maybe_plot,
    LIP_SHAPE,
    model_dtype,
    native_streaming_datasets,
    parse_cli,
    streaming_datasets,
    trainer_extras,
)
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

VIDEO_EXTS = (".mp4", ".avi")
READ_BATCH = 32  # records a loader batch while a full-frame split is read whole


def full_frame_dataset(source, num_workers: int = 0) -> ArrayDataset:
    """Every record of a full-frame source (``{frames (T, H, W, C) uint8,
    boxes (T, 4) int32, label}``, e.g. ``FullFrameClipSource``) read once,
    in index order, into one ``ArrayDataset`` of ``(frames, boxes)``: the
    train, val or test split of ``dataset.device_crop`` with
    ``training.device_resident``, which the trainer places on the device
    whole. ``num_workers`` loader processes decode (0: this thread). Every
    clip must have the first one's shape."""
    stream = StreamingDataset(source, ("frames", "boxes"), worker_count=num_workers, shard_index=0, shard_count=1)
    n = len(source)
    frames = boxes = labels = None
    at = 0
    for (f, b), y in stream.epoch_batches(0, False, READ_BATCH):
        if frames is None:
            frames = np.empty((n,) + f.shape[1:], f.dtype)
            boxes = np.empty((n,) + b.shape[1:], b.dtype)
            labels = np.empty((n,), np.int32)
        if f.shape[1:] != frames.shape[1:] or b.shape[1:] != boxes.shape[1:]:
            raise ValueError(f"records {at}..{at + len(y) - 1} have frames {f.shape[1:]} and boxes {b.shape[1:]}, "
                             f"the first {frames.shape[1:]} and {boxes.shape[1:]}: a resident split holds one shape")
        frames[at : at + len(y)], boxes[at : at + len(y)], labels[at : at + len(y)] = f, b, y
        at += len(y)
    if frames is None:
        raise ValueError("a full-frame split with no clips cannot be held resident")
    return ArrayDataset(inputs=(frames, boxes), labels=labels)


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
    maybe_initialize_distributed(device)
    backend = cfg.get("dataset.landmark_backend", "auto")
    extra = {}
    if cfg.get("dataset.device_crop", False):
        index = scan_glips(cfg.get("dataset.root_dir"), exts=VIDEO_EXTS)

        def source(split):
            return FullFrameClipSource(index.by_split(split), index.class_to_idx, backend=backend)

        if cfg.get("training.device_resident", False):
            datasets = {split: full_frame_dataset(source(split), cfg.get("dataset.num_workers", 0))
                        for split in SPLITS}
        else:
            datasets = streaming_datasets(cfg, source, ("frames", "boxes"))
        from multimodal_lipread_torch.ops.crop_resize_cuda import device_crop

        extra["device_preproc"] = device_crop
    elif cfg.get("dataset.host_crop_streaming", False):
        index = scan_glips(cfg.get("dataset.root_dir"), exts=VIDEO_EXTS)
        datasets = streaming_datasets(cfg, lambda split: HostCropClipSource(
            index.by_split(split), index.class_to_idx, backend=backend), ("lip_regions",))
    elif cfg.get("dataset.streaming", False):
        index = scan_lip_regions(resolve_lip_root(cfg))
        if cfg.get("dataset.loader_backend", "grain") == "native":
            datasets = native_streaming_datasets(cfg, {split: index.by_split(split) for split in SPLITS},
                                                 index.class_to_idx, "npy_u8", LIP_SHAPE)
        else:
            datasets = streaming_datasets(
                cfg, lambda split: LipClipSource(index.by_split(split), index.class_to_idx), ("lip_regions",))
    else:
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
            class_names=tuple(index.classes),
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
            **extra,
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
