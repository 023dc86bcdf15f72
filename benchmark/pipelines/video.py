"""The video pipeline (``pipelines/video.py``) with ``dataset.device_crop``
and ``training.device_resident``: the train split's full uint8 frames and
lip boxes read once into the program's resident dataset
(``full_frame_dataset``, as the entry point reads it), held on the card,
and cut to 44 × 44 lips by the crop kernel inside every step.

The corpus is synthetic and GLips-shaped, made from the seed clip by clip
on the run's device, so that the reference makes any clip again by itself:
a clip is ``frames`` uint8 noise frames of ``frame_size`` × ``frame_size`` ×
3 (GLips: 29 of 256 × 256) drawn from a generator seeded with the run's
seed and the clip's number, and one margin-expanded lip box a frame, a
mouth-sized box that moves a few pixels from frame to frame. Clip ``i``
is the word ``i % 4``. The program reads the corpus as it reads a
``FullFrameClipSource``: ``len`` and ``corpus[i]`` → ``{frames, boxes,
label}``."""

from __future__ import annotations

import numpy as np
import torch

WORDS = ("aber", "dann", "heute", "wieder")
MARGIN = 0.4
KEY = 64  # bytes of a clip's frames that name it

PREFIX = ""


def optimizer(cfg: dict) -> tuple:
    """(lr, weight decay) of the pipeline's Adam."""
    return cfg["training"]["learning_rate"], cfg["training"]["weight_decay"]


def _clip_seed(seed: int, clip: int) -> int:
    return (int(seed) * 1_000_003 + int(clip)) % (1 << 62)


def clip_boxes(seed: int, clip: int, frames: int, size: int) -> np.ndarray:
    """(frames, 4) int32 margin-expanded lip boxes of one clip."""
    rng = np.random.default_rng([int(seed) % (1 << 62), int(clip)])
    cx, cy = rng.uniform(0.35, 0.65) * size, rng.uniform(0.6, 0.8) * size
    bw, bh = rng.uniform(0.15, 0.3) * size, rng.uniform(0.08, 0.16) * size
    jitter = rng.integers(-3, 4, (frames, 4))
    raw = np.stack([np.full(frames, cx - bw / 2), np.full(frames, cy - bh / 2),
                    np.full(frames, cx + bw / 2), np.full(frames, cy + bh / 2)], -1).astype(np.int64) + jitter
    raw = np.clip(raw, 0, size)
    mw = ((raw[:, 2] - raw[:, 0]) * MARGIN).astype(np.int64)
    mh = ((raw[:, 3] - raw[:, 1]) * MARGIN).astype(np.int64)
    return np.stack([np.maximum(raw[:, 0] - mw, 0), np.maximum(raw[:, 1] - mh, 0),
                     np.minimum(raw[:, 2] + mw, size), np.minimum(raw[:, 3] + mh, size)], -1).astype(np.int32)


class FrameCorpus:
    """``n`` clips of full frames made from ``seed`` on ``device``."""

    def __init__(self, n: int, seed: int, device: torch.device, frames: int, size: int):
        self.n, self.seed, self.device, self.frames, self.size = int(n), int(seed), torch.device(device), frames, size
        self.labels = np.arange(self.n, dtype=np.int64) % len(WORDS)
        self.boxes = np.stack([clip_boxes(seed, i, frames, size) for i in range(self.n)])
        self.keys: dict = {}

    def __len__(self) -> int:
        return self.n

    def clip_frames(self, clip: int) -> torch.Tensor:
        """(frames, size, size, 3) uint8 on the corpus's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_clip_seed(self.seed, clip))
        return torch.randint(0, 256, (self.frames, self.size, self.size, 3), generator=gen, device=self.device,
                             dtype=torch.uint8)

    def __getitem__(self, clip: int) -> dict:
        frames = self.clip_frames(int(clip)).cpu().numpy()
        self.keys[frames.reshape(-1)[:KEY].tobytes()] = int(clip)
        return {"frames": frames, "boxes": self.boxes[int(clip)], "label": np.int32(self.labels[int(clip)])}


def make_corpus(ctx, n: int) -> FrameCorpus:
    return FrameCorpus(n, ctx.seed, ctx.device, ctx.mix["frames"], ctx.mix["frame_size"])


def build_train(ctx, corpus: FrameCorpus):
    """The trainer and the train split's resident dataset as
    ``pipelines.video.main`` builds them with ``dataset.device_crop`` and
    ``training.device_resident`` (it reads every split; the benchmark
    trains on one)."""
    # first, so that a program without it fails before anything is built
    from multimodal_lipread_torch.pipelines.video import full_frame_dataset

    from multimodal_lipread_torch.models.video import get_video_model
    from multimodal_lipread_torch.ops.crop_resize_cuda import device_crop
    from multimodal_lipread_torch.pipelines.common import model_dtype, trainer_extras
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    cfg = ctx.program_config
    dataset = full_frame_dataset(corpus, cfg.get("dataset.num_workers", 0))
    with torch.device(ctx.device):
        model = get_video_model(cfg.get("model.name"), cfg.get("dataset.num_classes"), dtype=model_dtype(cfg),
                                resnet_version=cfg.get("model.resnet_version", 18),
                                shufflenet_version=cfg.get("model.shufflenet_version", "0.5x"),
                                feature_dim=cfg.get("model.feature_dim"), dropout=cfg.get("model.dropout"))
    trainer = Trainer(model, TrainerConfig(
        model_name=cfg.get("model.name"), num_classes=cfg.get("dataset.num_classes"), class_names=WORDS,
        batch_size=cfg.get("training.batch_size"), epochs=cfg.get("training.epochs"),
        learning_rate=cfg.get("training.learning_rate"), weight_decay=cfg.get("training.weight_decay"),
        scheduler_mode="max", scheduler_factor=0.5, scheduler_patience=5, seed=cfg.get("training.seed"),
        metrics_dir=ctx.path("metrics"), checkpoints_dir=ctx.path("models_trained"), test_every_epoch=True,
        rolling_checkpoint=True, log_txt_header=True, device_preproc=device_crop, **trainer_extras(cfg)),
        device=str(ctx.device))
    return trainer, dataset


def batch_clips(corpus: FrameCorpus, inputs: tuple) -> np.ndarray:
    """The clip of each row of a train batch, by its frames and boxes whole;
    -1 where no clip of the corpus matches."""
    frames, boxes = inputs
    flat = frames.reshape(frames.shape[0], -1)
    ids = np.array([corpus.keys.get(flat[r, :KEY].cpu().numpy().tobytes(), -1) for r in range(len(flat))], np.int64)
    for r, i in enumerate(ids):
        if i >= 0 and not (torch.equal(frames[r].to(corpus.device), corpus.clip_frames(int(i)))
                           and np.array_equal(boxes[r].cpu().numpy(), corpus.boxes[i])):
            ids[r] = -1
    return ids


def reference_inputs(corpus: FrameCorpus, ids, device) -> tuple:
    """The clips' frames and boxes, made again from the seed."""
    frames = torch.stack([corpus.clip_frames(int(i)) for i in ids])
    return frames.to(device), torch.from_numpy(corpus.boxes[np.asarray(ids)]).to(device)
