"""How far float32 training trajectories part, on the card and the CPU,
from a float64 run of the same steps.

    python -m multimodal_lipread_torch.tools.train_drift [--pipeline audio|video|audio_video]
        [--model NAME] [--lrs 5e-4 3e-5 1e-5] [--steps 3] [--seeds 0 ...] [--no-cpu]

For each of ``--seeds`` it writes the port's synthetic corpus from the
seed (4 words) and takes its train split: for ``--pipeline audio`` (the
default) 68 WAV clips per split, featurized by the log-mel kernel, and the
model ``vgg_lstm`` (VGG16-BN, BiLSTM 2 x 128) at batch 32; for
``--pipeline video`` 32 lip tensors per split, kept uint8, and the model
``resnet_trans`` (visual_config.yaml's widths) at batch 16; for
``--pipeline audio_video`` 32 aligned clips per split (log-mel by the
kernel, lips uint8) and the model ``middle_fusion_mobilenet``
(av_config.yaml's, input 117) at batch 8 without weight decay. From one
Flax-style initialization from the seed (dropout 0) it takes the first
``--steps`` training steps of the full-width model on the same batches: in
float64 on the card (the reference), in float32 on the card (TF32 off, as
the trainer runs a float32 model), and in float32 on the CPU (left out
with ``--no-cpu``). It prints each step's loss and the relative distances.
Adam's first steps move nearly every weight by ±lr whatever the size of
its gradient, so rounding differences between two float32 runs grow in
proportion to lr; ``chip_smoke.py`` holds the card to the CPU at an lr
where they stay small, and the card to float64 at the trained lr within
the spread this tool reads over seeds. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import List, Sequence

import numpy as np
import torch

from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

NUM_CLASSES = 4
# per pipeline: the model it trains by default, batch, weight decay (the
# shipped configs'), clips per split of the corpus, and the lrs read
PIPELINES = {
    "audio": dict(model="vgg_lstm", batch=32, weight_decay=1e-4, clips=68, lrs=[5e-4, 3e-5, 1e-5]),
    "video": dict(model="resnet_trans", batch=16, weight_decay=1e-5, clips=32, lrs=[5e-5, 1e-5]),
    "audio_video": dict(model="middle_fusion_mobilenet", batch=8, weight_decay=0.0, clips=32, lrs=[1e-4, 1e-5]),
}


def build(pipeline: str, model: str, version: int = 16) -> torch.nn.Module:
    """The pipeline's full-width model with dropout 0."""
    if pipeline == "audio_video":
        from multimodal_lipread_torch.models.audio_video import get_av_model
        from multimodal_lipread_torch.nn.common import Dropout

        net = get_av_model(model, NUM_CLASSES)
        for m in net.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        return net
    if pipeline == "audio":
        from multimodal_lipread_torch.models.audio import VGGWithLSTMClassifier

        if model != "vgg_lstm":
            raise ValueError(f"train_drift knows the audio model vgg_lstm only, not {model!r}")
        return VGGWithLSTMClassifier(NUM_CLASSES, version=version, dropout_rate=0.0)
    from multimodal_lipread_torch.models.video import get_video_model

    return get_video_model(model, NUM_CLASSES, dropout=0.0)


def first_steps(ds: ArrayDataset, device: str, dtype: torch.dtype, lr: float, steps: int,
                seed: int, workdir: str, batch_size: int = 32, version: int = 16,
                pipeline: str = "audio", model_name: str = "vgg_lstm") -> List[float]:
    """Losses of the first ``steps`` training steps of a full-width model
    from the trainer's initialization for ``seed``, dropout 0, in ``dtype``
    on ``device`` (uint8 lips scaled to [0, 1] in that dtype)."""
    model = build(pipeline, model_name, version)
    wd = PIPELINES[pipeline]["weight_decay"]
    trainer = Trainer(model, TrainerConfig(
        model_name="drift", num_classes=NUM_CLASSES, batch_size=batch_size, learning_rate=lr,
        weight_decay=wd, seed=seed, host_prefetch=0,
        metrics_dir=os.path.join(workdir, "metrics"), checkpoints_dir=os.path.join(workdir, "ckpt"),
    ), device=device)
    trainer.init_state()
    if dtype != torch.float32:  # the same initial weights, widened
        model.to(dtype)
        model.dtype = trainer.compute_dtype = dtype
        trainer.optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                             weight_decay=wd)

    def widen(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype) / 255.0 if x.dtype == torch.uint8 else x.to(dtype)

    losses: List[float] = []
    for inputs, labels, weights in trainer.batches(ds, True, np.random.default_rng(seed)):
        if dtype != torch.float32:
            inputs = tuple(widen(x) for x in inputs)
        loss_sum, _, _, wsum = trainer.train_step(inputs, labels, weights).tolist()
        losses.append(loss_sum / wsum)
        if len(losses) == steps:
            break
    return losses


def drift_table(ds: ArrayDataset, lrs: Sequence[float], steps: int, seed: int, workdir: str,
                cpu: bool = True, pipeline: str = "audio", model_name: str = "vgg_lstm") -> List[dict]:
    batch = PIPELINES[pipeline]["batch"]
    kw = dict(batch_size=batch, pipeline=pipeline, model_name=model_name)
    rows = []
    for lr in lrs:
        ref = np.asarray(first_steps(ds, "cuda", torch.float64, lr, steps, seed, workdir, **kw))
        card = np.asarray(first_steps(ds, "cuda", torch.float32, lr, steps, seed, workdir, **kw))
        row = {"lr": lr, "card_f64": ref, "card_f32": card, "card_vs_f64": np.abs(card / ref - 1)}
        if cpu:
            row["cpu_f32"] = np.asarray(first_steps(ds, "cpu", torch.float32, lr, steps, seed, workdir, **kw))
            row["cpu_vs_f64"] = np.abs(row["cpu_f32"] / ref - 1)
            row["card_vs_cpu"] = np.abs(card / row["cpu_f32"] - 1)
        rows.append(row)
    return rows


def train_split(pipeline: str, root: str, seed: int) -> ArrayDataset:
    """The pipeline's synthetic train split for ``seed`` under ``root``."""
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.pipelines import common

    clips = PIPELINES[pipeline]["clips"]
    if pipeline == "audio":
        make_synthetic_glips(root, clips_per_split=clips, seed=seed)
        return common.load_audio_datasets(root, splits=("train",), device="cuda")[0]["train"]
    from multimodal_lipread_torch.data.glips import lip_regions_root

    if pipeline == "audio_video":
        from multimodal_lipread_torch.pipelines.audio_video import load_av_datasets

        make_synthetic_glips(root, clips_per_split=clips, seed=seed, with_lip_regions=True)
        return load_av_datasets(root, lip_regions_root(root), splits=("train",), device="cuda")[0]["train"]
    make_synthetic_glips(root, clips_per_split=clips, seed=seed, with_audio=False, with_lip_regions=True)
    return common.load_video_datasets(lip_regions_root(root), splits=("train",))[0]["train"]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pipeline", choices=sorted(PIPELINES), default="audio")
    parser.add_argument("--model", default=None, help="the pipeline's model (default: its main one)")
    parser.add_argument("--lrs", type=float, nargs="+", default=None)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--no-cpu", action="store_true", help="card runs only (float32 against float64)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_drift needs a card (its reference runs in float64 on it)")
    spec = PIPELINES[args.pipeline]
    model_name = args.model or spec["model"]
    fmt = lambda a: "[" + ", ".join(f"{v:.3e}" for v in a) + "]"  # noqa: E731
    tmp = tempfile.mkdtemp(prefix="mlt_train_drift_")
    try:
        for k, seed in enumerate(args.seeds):  # a seed given twice reads the card's run-to-run spread
            ds = train_split(args.pipeline, os.path.join(tmp, f"GLips_4_{k}"), seed)
            print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; {args.pipeline} {model_name}; "
                  f"seed {seed}; {len(ds)} clips, batch {spec['batch']}", flush=True)
            rows = drift_table(ds, args.lrs or spec["lrs"], args.steps, seed, tmp, cpu=not args.no_cpu,
                               pipeline=args.pipeline, model_name=model_name)
            for r in rows:
                line = (f"lr {r['lr']:g}: card float64 losses {fmt(r['card_f64'])}; relative to it: card float32 "
                        f"{fmt(r['card_vs_f64'])}")
                if "cpu_f32" in r:
                    line += f", CPU float32 {fmt(r['cpu_vs_f64'])}; card vs CPU {fmt(r['card_vs_cpu'])}"
                print(line, flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
