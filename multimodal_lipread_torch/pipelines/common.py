"""Shared pipeline plumbing: config → arrays → Trainer (counterpart of the
JAX package's ``pipelines/common.py``: the audio, video and audio_video
loaders, ``model.pretrained`` grafting and the common trainer knobs).

Audio features are computed once, up front, on the device: every split's
clips are decoded on the host (the threaded native decoder) and featurized
by the log-mel kernel in chunks of 256 clips. Lip tensors are loaded once
and kept uint8 on the host; the trainer and the predictor scale them to
[0, 1] on the device. The streaming branches (``dataset.streaming`` and
the video pipeline's ``device_crop`` / ``host_crop_streaming``) read one
epoch at a time through ``streaming_datasets`` instead, or, with
``dataset.loader_backend: native``, through ``native_streaming_datasets``.

Every pipeline's ``main`` starts with ``maybe_initialize_distributed(device)``
(``parallel/distributed.py``): launched by ``torch.distributed.run`` it
joins the process group (NCCL on the card, gloo on the CPU) and its
trainer runs data-parallel over the world; a plain launch runs alone.
Each rank featurizes the corpus and prints and logs as the JAX package's
processes do; a streaming dataset reads its own shard of each epoch.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_lipread_torch.config import Config, coerce_yaml_scalar, load_config
from multimodal_lipread_torch.data.audio_io import TARGET_SAMPLES, load_waveform
from multimodal_lipread_torch.data.glips import AUDIO_EXTS, SPLITS, GlipsIndex, scan_glips, scan_lip_regions
from multimodal_lipread_torch.data.grain_loader import NativeStreamingDataset, StreamingDataset
from multimodal_lipread_torch.ops.logmel_cuda import log_mel
from multimodal_lipread_torch.train.trainer import ArrayDataset
from multimodal_lipread_torch.utils import trace

MEL_BINS = 80
LIP_SHAPE = (29, 44, 44, 3)


def compute_logmel_features(
    waves: np.ndarray, input_size: int = 117, chunk: int = 256, device: str = "cuda"
) -> np.ndarray:
    """(N, 20000) waveforms → (N, 80, input_size) normalized log-mel,
    computed on ``device`` in chunks of ``chunk`` clips (the last one
    ragged: the kernel takes any batch, and each clip is normalized on its
    own).

    Normalization runs over the full (80, 126) spectrogram before the time
    slice.
    """
    out: List[np.ndarray] = []
    for start in range(0, waves.shape[0], chunk):
        batch = torch.from_numpy(np.ascontiguousarray(waves[start : start + chunk], np.float32)).to(device)
        mel = log_mel(batch, normalize=True)  # (b, 80, 126)
        out.append(mel[:, :MEL_BINS, :input_size].cpu().numpy())
    return np.concatenate(out, axis=0) if out else np.zeros((0, MEL_BINS, input_size), np.float32)


def decode_waveforms(paths: Sequence[str]) -> np.ndarray:
    """Host decode of audio files to fixed 20,000-sample float32 waveforms.

    WAV files go through the threaded native decoder in one pass
    (``data/native_io.py``, which raises if it cannot be built); a file it
    does not take (not PCM16 at 16 kHz) and any other format go to the
    Python decoder, per file. The span ``serve.decode``
    (``utils/trace.py``).
    """
    with trace.span("serve.decode", clips=len(paths)):
        out = np.zeros((len(paths), TARGET_SAMPLES), np.float32)
        wav = [i for i, p in enumerate(paths) if p.lower().endswith(".wav")]
        python = [i for i, p in enumerate(paths) if not p.lower().endswith(".wav")]
        if wav:
            from multimodal_lipread_torch.data.native_io import load_wav_batch

            waves, failed = load_wav_batch([paths[i] for i in wav])
            out[wav] = waves
            if failed >= 0:
                # The decoder names only the first file it refused and leaves every
                # refused file's row zero. Decode the zero rows in Python: a silent
                # PCM16 file among them decodes to the same zeros there.
                python += [i for i, row in zip(wav, waves) if not row.any()]
        for i in python:
            out[i] = load_waveform(paths[i])
        return out


def load_audio_datasets(
    root_dir: str,
    input_size: int = 117,
    splits: Sequence[str] = SPLITS,
    words: Optional[Sequence[str]] = None,
    device: str = "cuda",
) -> Tuple[Dict[str, ArrayDataset], GlipsIndex]:
    """Scan GLips, decode and featurize every audio clip on ``device``;
    returns the per-split datasets and the index."""
    index = scan_glips(root_dir, exts=AUDIO_EXTS, words=words)
    class_to_idx = index.class_to_idx
    datasets: Dict[str, ArrayDataset] = {}
    for split in splits:
        entries = index.by_split(split)
        if not entries:
            raise RuntimeError(
                f"No audio clips found for split '{split}' under {root_dir} — "
                f"check the GLips tree layout"
            )
        waves = decode_waveforms([e.path for e in entries])
        mels = compute_logmel_features(waves, input_size=input_size, device=device)
        labels = np.asarray([class_to_idx[e.word] for e in entries], np.int32)
        datasets[split] = ArrayDataset(inputs=(mels,), labels=labels)
    return datasets, index


def load_lip_sequences(paths: Sequence[str]) -> np.ndarray:
    """Lip-region ``.npy`` files → (N, 29, 44, 44, 3) uint8, NTHWC: a
    quarter of the float bytes cross to the device, where the trainer or
    the predictor scales them to [0, 1]."""
    if not paths:
        return np.zeros((0,) + LIP_SHAPE, np.uint8)
    return np.stack([np.load(p) for p in paths])


def load_video_datasets(
    lip_root: str, splits: Sequence[str] = SPLITS,
) -> Tuple[Dict[str, ArrayDataset], GlipsIndex]:
    """Scan a lip-region mirror tree and load every split's lip tensors;
    returns the per-split datasets and the index."""
    index = scan_lip_regions(lip_root)
    class_to_idx = index.class_to_idx
    datasets: Dict[str, ArrayDataset] = {}
    for split in splits:
        entries = index.by_split(split)
        if not entries:
            raise RuntimeError(
                f"No lip-region files found for split '{split}' under {lip_root} — "
                f"run the lip-extraction preprocessing first"
            )
        lips = load_lip_sequences([e.path for e in entries])
        labels = np.asarray([class_to_idx[e.word] for e in entries], np.int32)
        datasets[split] = ArrayDataset(inputs=(lips,), labels=labels)
    return datasets, index


def _pretrained_converters() -> Dict[str, Any]:
    from multimodal_lipread_torch.utils import torch_import as ti

    return {
        "resnet18": lambda p: ti.convert_resnet(p, 18),
        "resnet34": lambda p: ti.convert_resnet(p, 34),
        "resnet50": lambda p: ti.convert_resnet(p, 50),
        "vgg11": lambda p: ti.convert_vgg_bn(p, 11),
        "vgg13": lambda p: ti.convert_vgg_bn(p, 13),
        "vgg16": lambda p: ti.convert_vgg_bn(p, 16),
        "vgg19": lambda p: ti.convert_vgg_bn(p, 19),
        "mobilenet_v2": ti.convert_mobilenet_v2,
        "mobilenet_v3_small": ti.convert_mobilenet_v3_small,
        "shufflenet_v2_x0_5": lambda p: ti.convert_shufflenet_v2(p, 0.5),
        "shufflenet_v2_x1_0": lambda p: ti.convert_shufflenet_v2(p, 1.0),
    }


def _dotted(path: Any) -> str:
    """A ``submodule`` path (a list of names, or one dotted string) → a
    dotted ``state_dict`` prefix."""
    return ".".join(path) if isinstance(path, (list, tuple)) else str(path or "")


def load_pretrained_backbones(trainer: Any, cfg: Config) -> int:
    """Graft converted weights into an initialized trainer's model; returns
    the number of backbones grafted.

    ``model.pretrained`` is one mapping or a list of them::

        model:
          pretrained:
            - arch: resnet18          # resnet18|resnet34|resnet50|vgg11|vgg13|
                                      # vgg16|vgg19|mobilenet_v2|mobilenet_v3_small|
                                      # shufflenet_v2_x0_5|shufflenet_v2_x1_0|
                                      # checkpoint (one of the port's .pt checkpoints)
              path: /weights/resnet18.pth   # torch.save(model.state_dict(), ...)
              submodule: [resnet]           # the backbone's place in the model
              adapt_1ch: true               # fold conv1's RGB input for mel images

    ``arch: checkpoint`` grafts from one of the port's own trained
    checkpoints (``train/checkpoint.py``): ``source_submodule: [resnet]``
    picks that subtree of its ``params`` and ``batch_stats`` (the whole
    model when left out), e.g. to warm-start a fusion model's
    ``video_encoder.cnn`` from a video run. An unknown arch, a missing
    file, or names or shapes that do not match the submodule raise
    (``ValueError`` naming the keys). The Adam moments are untouched (a
    fresh trainer has none)."""
    from multimodal_lipread_torch.train.checkpoint import load_checkpoint
    from multimodal_lipread_torch.utils import torch_import as ti

    specs = cfg.get("model.pretrained")
    if not specs:
        return 0
    if isinstance(specs, dict):
        specs = [specs]
    converters = _pretrained_converters()
    model = trainer.model
    state = model.state_dict()
    for spec in specs:
        arch = spec.get("arch")
        if arch != "checkpoint" and arch not in converters:
            raise ValueError(f"Unknown pretrained arch '{arch}'. Supported: {sorted(converters) + ['checkpoint']}")
        if "path" not in spec or "submodule" not in spec:
            raise ValueError(f"model.pretrained entry {spec} needs 'path' and 'submodule'")
        path = spec["path"]
        if not os.path.isfile(path):
            how = ("name a .pt checkpoint the port's trainer wrote" if arch == "checkpoint" else
                   f"fetch torchvision's with `python -m multimodal_lipread_torch.tools.fetch_weights --arch {arch} "
                   f"--out <dir>` on a machine with egress, or save a state dict with "
                   f"torch.save(model.state_dict(), path) where the weights are")
            raise FileNotFoundError(f"pretrained weights for '{arch}' not found at {path}: {how}")
        if arch == "checkpoint":
            tree = load_checkpoint(path)["state"]
            source = _dotted(spec.get("source_submodule", ()))
            prefix = f"{source}." if source else ""
            converted = {k[len(prefix):]: v for coll in ("params", "batch_stats")
                         for k, v in tree[coll].items() if k.startswith(prefix)}
            if not converted:
                raise ValueError(f"checkpoint {path} has no submodule '{source}'")
        else:
            converted = converters[arch](path)
            if spec.get("adapt_1ch"):
                converted = ti.adapt_first_conv_to_1ch(converted)
        state = ti.graft_backbone(state, converted, _dotted(spec["submodule"]))
    model.load_state_dict(state, strict=True)
    return len(specs)


def streaming_datasets(cfg: Config, source, input_keys: tuple) -> dict:
    """One ``StreamingDataset`` per split over ``source(split)``."""
    return {split: StreamingDataset(source(split), input_keys=input_keys, seed=cfg.get("training.seed", 0),
                                    worker_count=cfg.get("dataset.num_workers", 0))
            for split in SPLITS}


def native_streaming_datasets(cfg: Config, entries_by_split: Dict[str, list], class_to_idx: Dict[str, int],
                              kind: str, record_shape: tuple, wire_dtype: Optional[str] = None) -> dict:
    """One ``NativeStreamingDataset`` per split (``dataset.loader_backend:
    native``), ``dataset.num_workers`` prefetch threads (0: the library's
    default)."""
    return {split: NativeStreamingDataset(entries_by_split[split], class_to_idx, kind=kind,
                                          record_shape=record_shape, seed=cfg.get("training.seed", 0),
                                          n_threads=cfg.get("dataset.num_workers", 0) or None,
                                          wire_dtype=wire_dtype)
            for split in SPLITS}


def parse_cli(default_config: Optional[str] = None, argv: Optional[Sequence[str]] = None) -> Config:
    """``--config path.yaml [--set a.b=c ...] [--resume] [--device cuda|cpu]``
    → Config with the overrides applied; ``_cli.resume`` and ``_cli.device``
    carry the last two."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=default_config, required=default_config is None)
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    for kv in args.set:
        key, _, value = kv.partition("=")
        try:
            import yaml

            value = coerce_yaml_scalar(yaml.safe_load(value))
        except Exception:
            pass
        cfg.set(key, value)
    cfg.set("_cli.resume", bool(args.resume))
    cfg.set("_cli.device", args.device)
    return cfg


def default_dirs(cfg: Config, pipeline: str) -> Tuple[str, str]:
    """(metrics_dir, checkpoints_dir) for a pipeline, reference-style layout."""
    base = cfg.get("output.base_dir", pipeline)
    metrics = cfg.get("output.metrics_dir", os.path.join(base, "metrics"))
    ckpts = cfg.get("output.checkpoints_dir", os.path.join(base, "models_trained"))
    return metrics, ckpts


def model_dtype(cfg) -> torch.dtype:
    """``model.dtype``: 'bfloat16' or float32 (the default). The compute
    dtype only: parameters and the loss stay float32."""
    return torch.bfloat16 if str(cfg.get("model.dtype", "float32")) == "bfloat16" else torch.float32


def trainer_extras(cfg: Config, default_warmup_epochs: float = 0.0) -> dict:
    """The ``training.*`` TrainerConfig knobs common to every pipeline, as
    the JAX package reads them (``checkpoint_backend``: ``msgpack``, a
    ``.pt`` file, or ``orbax`` / ``orbax_async``, a ``.orbax`` directory);
    ``dropout_rng_impl`` names a
    JAX PRNG and has no counterpart here (torch draws dropout from Philox).
    ``default_warmup_epochs`` is a pipeline's own LR warmup where the config
    sets none (audio_cues ships 2 epochs; ``training.warmup_epochs: 0``
    restores the reference's schedule)."""
    rng_impl = cfg.get("training.dropout_rng_impl", "rbg")
    if rng_impl != "rbg":
        raise NotImplementedError(
            f"training.dropout_rng_impl={rng_impl!r} selects a JAX PRNG; the PyTorch port draws "
            "dropout from a torch.Generator (ROADMAP.md, Queue 3 #6)"
        )
    return {
        "warmup_epochs": cfg.get("training.warmup_epochs", cfg.get("train.warmup_epochs", default_warmup_epochs)),
        "device_resident": cfg.get("training.device_resident", False),
        "steps_per_dispatch": cfg.get("training.steps_per_dispatch", 1),
        "handle_preemption": cfg.get("training.handle_preemption", False),
        "host_prefetch": cfg.get("training.host_prefetch", 2),
        "remat": cfg.get("training.remat", False),
        "half_precision": cfg.get("training.half_precision", False),
        "checkpoint_backend": cfg.get("training.checkpoint_backend", "msgpack"),
        "profile_dir": cfg.get("training.profile_dir", None),
        "mixup_alpha": cfg.get(
            "training.mixup_alpha", cfg.get("augmentation.mixup_alpha", 0.0)
        ),
    }


def maybe_plot(cfg: Config, metrics_dir: str) -> None:
    """Write loss/accuracy PNGs after training; disable with
    ``output.plots: false``. Plotting never fails a run."""
    if cfg.get("output.plots", True):
        try:
            from multimodal_lipread_torch.utils.visualize import plot_logs

            plot_logs(metrics_dir)
        except Exception as e:
            print(f"plotting skipped: {e}")
