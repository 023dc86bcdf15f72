"""Inference / serving of the audio pipeline (counterpart of the JAX
package's ``serving.py``).

- ``Predictor``: a trained model from a checkpoint, in eval mode on one
  device; serves any number of inputs in fixed-size batches, padding the
  last one.
- ``predict_audio_clips``: WAV files → host decode (the threaded native
  decoder) → log-mel on the device (the CUDA kernel of
  ``ops/logmel_cuda.py``) → classifier.
- a CLI: ``python -m multimodal_lipread_torch.serving --pipeline audio
  --config <yaml> --checkpoint <path> <clips...>`` → JSON predictions.

Not ported yet (ROADMAP.md): data-parallel serving, graph export, the
other pipelines, ``device_preproc``.
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
        version=config.get("model.version", 16),
        use_batchnorm=config.get("model.use_batchnorm", True),
        dtype=model_dtype(config),
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


PIPELINES = ("audio",)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import json

    from multimodal_lipread_torch.config import load_config

    parser = argparse.ArgumentParser(
        description="Serve an audio checkpoint of the PyTorch port: classify WAV clips",
    )
    parser.add_argument("--pipeline", default="audio", choices=PIPELINES)
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    parser.add_argument("clips", nargs="+", help="WAV files to classify")
    args = parser.parse_args(argv)
    config = load_config(args.config)
    results = predict_audio_clips(
        config, args.checkpoint, args.clips, args.batch_size, device=args.device
    )
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
