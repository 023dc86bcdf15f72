"""Inference / serving of the audio, video and audio_video pipelines
(counterpart of the JAX package's ``serving.py``).

- ``Predictor``: a trained model from a checkpoint, in eval mode on one
  device; serves any number of inputs in fixed-size batches, padding the
  last one; uint8 inputs cross to the device as they are and are scaled
  to [0, 1] there.
- ``predict_audio_clips``: WAV files → host decode (the threaded native
  decoder) → log-mel on the device (the CUDA kernel of
  ``ops/logmel_cuda.py``) → classifier.
- ``predict_clips``: any ported pipeline, per-clip groups of files →
  featurize (``_featurize_modalities``) → classify; for ``video`` the
  lip-region ``.npy`` files, kept uint8 up to the device; for
  ``audio_video`` a WAV and a ``.npy`` per clip, the WAV through the host
  decode and the log-mel kernel on the predictor's device.
- a CLI: ``python -m multimodal_lipread_torch.serving --pipeline
  audio|video|audio_video --config <yaml> --checkpoint <path> <clips...>``
  → JSON predictions (WAV files for audio, lip-region ``.npy`` files for
  video, ``clip.wav,clip.npy`` groups for audio_video).

The audio_video features are taken at ``dataset.audio_input_size`` time
steps, the key its training pipeline reads (the JAX package's serving
reads ``dataset.input_size`` there; ROADMAP.md Queue 3 notes it).

Not ported yet (ROADMAP.md): data-parallel serving, graph export, the
four cue pipelines, ``device_preproc``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from multimodal_lipread_torch.train.checkpoint import load_checkpoint, load_module_state
from multimodal_lipread_torch.utils.precision import compute_dtype, model_precision


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → device tensor; uint8 inputs (lip tensors) cross at 1/4
    of the float bytes and are scaled to [0, 1] on the device, int16
    waveforms cross at 1/2 and are cast to float32 there."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if t.dtype == torch.uint8:
        return t.to(torch.float32) / 255.0
    if t.dtype == torch.int16:
        return t.to(torch.float32)
    return t


@dataclasses.dataclass
class Predictor:
    """Fixed-batch classifier around a model in eval mode on ``device``,
    run at its compute dtype's precision (``utils/precision.py``: no TF32
    for a float32 model)."""

    model: nn.Module
    batch_size: int = 32
    device: str = "cuda"

    def __post_init__(self):
        self.model = self.model.to(self.device).eval()

    @classmethod
    def from_checkpoint(
        cls, model: nn.Module, ckpt_path: str, batch_size: int = 32, device: str = "cuda"
    ) -> "Predictor":
        """Restore a checkpoint (``{epoch, state, val_acc, ...}``) into ``model``."""
        load_module_state(model, load_checkpoint(ckpt_path)["state"])
        return cls(model=model, batch_size=batch_size, device=device)

    def predict_logits(self, *inputs: np.ndarray) -> np.ndarray:
        """Any-N inputs → (N, num_classes) float32 logits via fixed-size batches."""
        n = inputs[0].shape[0]
        out: List[np.ndarray] = []
        with torch.inference_mode(), model_precision(compute_dtype(self.model)):
            for start in range(0, n, self.batch_size):
                chunk = tuple(a[start : start + self.batch_size] for a in inputs)
                k = chunk[0].shape[0]
                if k < self.batch_size:  # pad to the fixed batch
                    chunk = tuple(
                        np.pad(a, [(0, self.batch_size - k)] + [(0, 0)] * (a.ndim - 1))
                        for a in chunk
                    )
                logits = self.model(*(_to_device(a, self.device) for a in chunk))
                out.append(logits[:k].float().cpu().numpy())
        return np.concatenate(out, axis=0) if out else np.zeros((0, 0), np.float32)

    def predict(self, *inputs: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict_logits(*inputs), axis=-1)


def build_audio_model(config: Any) -> nn.Module:
    """The audio model exactly as its training pipeline builds it, wrapped
    in ``WaveToLogMel`` when ``dataset.streaming`` is set (the model then
    takes raw waveforms and its parameters nest under ``model.``)."""
    from multimodal_lipread_torch.models.audio import get_audio_model
    from multimodal_lipread_torch.pipelines.common import model_dtype

    input_size = config.get("dataset.input_size", 117)
    model = get_audio_model(
        config.get("model.name", "resnet"), config.get("dataset.num_classes", 4),
        input_size=input_size,
        version=config.get("model.version", 16),
        use_batchnorm=config.get("model.use_batchnorm", True),
        dtype=model_dtype(config),
        d_model=config.get("model.d_model"),
    )
    if bool(config.get("dataset.streaming", False)):
        from multimodal_lipread_torch.models.frontend import WaveToLogMel

        model = WaveToLogMel(model, input_size=input_size)
    return model


def predict_audio_clips(
    config: Any, ckpt_path: str, clip_paths: Sequence[str], batch_size: int = 32,
    device: str = "cuda",
) -> List[Dict[str, Any]]:
    """End-to-end audio inference: files → decode → log-mel → classify.

    With ``dataset.streaming`` the log-mel runs inside the model's forward
    (``WaveToLogMel``); otherwise the features are computed first
    (``compute_logmel_features``). Both run the log-mel kernel on a card.
    """
    from multimodal_lipread_torch.data.glips import AUDIO_EXTS, scan_glips
    from multimodal_lipread_torch.pipelines.common import compute_logmel_features, decode_waveforms

    model = build_audio_model(config)
    classes: Optional[List[str]] = None
    root = config.get("dataset.root_dir")
    if root:
        try:
            classes = scan_glips(root, exts=AUDIO_EXTS).classes
        except FileNotFoundError:
            pass

    waves = decode_waveforms(list(clip_paths))
    if bool(config.get("dataset.streaming", False)):
        inputs = waves
    else:
        inputs = compute_logmel_features(
            waves, input_size=config.get("dataset.input_size", 117), device=device
        )
    predictor = Predictor.from_checkpoint(model, ckpt_path, batch_size, device=device)
    logits = predictor.predict_logits(inputs)
    preds = np.argmax(logits, axis=-1)
    return [
        {
            "path": path,
            "prediction": int(p),
            "word": classes[int(p)] if classes else None,
            "logits": [float(x) for x in row],
        }
        for path, p, row in zip(clip_paths, preds, logits)
    ]


PIPELINES = ("audio", "video", "audio_video")
# per-pipeline input modalities, in the model's order: 'a' = audio clip
# path, 'v' = lip-region .npy path, 'c' = cue text file (the JAX package's)
_PIPELINE_INPUTS = {
    "audio": "a",
    "video": "v",
    "audio_video": "av",
    "cues": "c",
    "audio_cues": "ac",
    "cues_video": "cv",
    "audio_cues_video": "acv",
}


def _unported(pipeline: str) -> NotImplementedError:
    return NotImplementedError(
        f"pipeline '{pipeline}' is not ported to PyTorch yet; ported: {', '.join(PIPELINES)} "
        "(see ROADMAP.md, Queue 1 #9-10)"
    )


def build_model(pipeline: str, config: Any) -> nn.Module:
    """The model exactly as the pipeline's training entry builds it (a
    different knob gives other parameter names, and the checkpoint does
    not load)."""
    from multimodal_lipread_torch.pipelines.common import model_dtype

    if pipeline == "audio":
        raise ValueError("audio uses predict_audio_clips (streaming-aware)")
    if pipeline == "video":
        from multimodal_lipread_torch.models.video import get_video_model

        return get_video_model(
            config.get("model.name", "resnet_lstm"), config.get("dataset.num_classes", 4),
            dtype=model_dtype(config),
            resnet_version=config.get("model.resnet_version", 18),
            shufflenet_version=config.get("model.shufflenet_version", "0.5x"),
            feature_dim=config.get("model.feature_dim"),
            dropout=config.get("model.dropout"),
        )
    if pipeline == "audio_video":
        from multimodal_lipread_torch.models.audio_video import get_av_model

        return get_av_model(
            config.get("model.name", "middle_fusion_mobilenet"), config.get("dataset.num_classes", 4),
            input_size=config.get("dataset.audio_input_size", 117), dtype=model_dtype(config),
        )
    if pipeline in _PIPELINE_INPUTS:
        raise _unported(pipeline)
    raise ValueError(f"unknown pipeline '{pipeline}' (one of {tuple(_PIPELINE_INPUTS)})")


def _featurize_modalities(pipeline: str, config: Any, groups: Sequence[Sequence[str]],
                          device: str = "cuda") -> tuple:
    """Per-clip file groups (one path per modality, in the order of
    ``_PIPELINE_INPUTS``) → the model's input arrays, as the training
    pipeline featurizes them. Audio is decoded on the host and featurized
    by the log-mel kernel on ``device`` at ``dataset.audio_input_size``
    steps; lips are loaded as uint8 (a float file in [0, 1] is scaled to
    uint8) and scaled to [0, 1] on the device by the predictor. The audio
    pipeline goes through ``predict_audio_clips``."""
    if pipeline == "audio":
        raise ValueError("audio uses predict_audio_clips (streaming-aware)")
    if pipeline not in PIPELINES:
        raise _unported(pipeline)
    codes = _PIPELINE_INPUTS[pipeline]
    for g in groups:
        if len(g) != len(codes):
            raise ValueError(
                f"pipeline '{pipeline}' needs {len(codes)} files per clip "
                f"({','.join(codes)}: a=audio, v=lips .npy, c=cue text); got {g}"
            )
    inputs: List[np.ndarray] = []
    for i, code in enumerate(codes):
        paths = [g[i] for g in groups]
        if code == "a":
            from multimodal_lipread_torch.pipelines.common import compute_logmel_features, decode_waveforms

            inputs.append(compute_logmel_features(
                decode_waveforms(paths), input_size=config.get("dataset.audio_input_size", 117), device=device))
        else:
            lips = np.stack([np.load(p) for p in paths])
            if lips.dtype != np.uint8:
                lips = np.clip(lips * 255.0 if lips.max() <= 1.0 else lips, 0, 255).astype(np.uint8)
            inputs.append(lips)
    return tuple(inputs)


def _class_names(config: Any) -> Optional[List[str]]:
    """The sorted word list under ``dataset.root_dir``, from its audio
    clips or ``.npy`` files, where there are any."""
    from multimodal_lipread_torch.data.glips import AUDIO_EXTS, scan_glips

    root = config.get("dataset.root_dir")
    if not root:
        return None
    for exts in (AUDIO_EXTS, (".npy",)):
        try:
            classes = scan_glips(root, exts=exts).classes
        except FileNotFoundError:
            continue
        if classes:
            return classes
    return None


def predict_clips(
    config: Any, ckpt_path: str, pipeline: str, groups: Sequence[Sequence[str]],
    batch_size: int = 32, device: str = "cuda",
) -> List[Dict[str, Any]]:
    """End-to-end inference for a ported pipeline: per-clip file groups →
    featurize → classify (see ``_featurize_modalities`` for the groups)."""
    if pipeline == "audio":
        return predict_audio_clips(config, ckpt_path, [g[0] for g in groups], batch_size, device=device)
    model = build_model(pipeline, config)
    inputs = _featurize_modalities(pipeline, config, groups, device=device)
    logits = Predictor.from_checkpoint(model, ckpt_path, batch_size, device=device).predict_logits(*inputs)
    preds = np.argmax(logits, axis=-1)
    classes = _class_names(config)
    return [
        {
            "paths": list(g),
            "prediction": int(p),
            "word": classes[int(p)] if classes and int(p) < len(classes) else None,
            "logits": [float(x) for x in row],
        }
        for g, p, row in zip(groups, preds, logits)
    ]


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import json

    from multimodal_lipread_torch.config import load_config

    parser = argparse.ArgumentParser(
        description="Serve an audio, video or audio_video checkpoint of the PyTorch port: classify clips",
    )
    parser.add_argument("--pipeline", default="audio", choices=PIPELINES)
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    parser.add_argument("clips", nargs="+",
                        help="files to classify: WAV clips (audio), lip-region .npy files (video), "
                             "or comma-separated 'clip.wav,clip.npy' groups (audio_video)")
    args = parser.parse_args(argv)
    config = load_config(args.config)
    results = predict_clips(config, args.checkpoint, args.pipeline, [c.split(",") for c in args.clips],
                            args.batch_size, device=args.device)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
