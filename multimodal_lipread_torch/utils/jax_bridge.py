"""The JAX package's variables → the port's ``state_dict``.

The inverse of the JAX package's ``utils/torch_import.py``: it takes
``params`` and ``batch_stats`` as nested dicts of numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, variables)``) and returns the
``state_dict`` of the port's module with the same submodule names:

- Conv ``kernel`` (kh, kw, I, O) → ``weight`` (O, I, kh, kw);
- Dense ``kernel`` (I, O) → ``weight`` (O, I);
- BatchNorm ``scale``/``bias`` + ``mean``/``var`` → ``weight``/``bias`` +
  ``running_mean``/``running_var`` (``num_batches_tracked`` 0);
- LSTM ``l{n}_{fwd,bwd}/{w_ih, w_hh, b_ih, b_hh}`` (D, 4H) →
  ``{weight_ih, weight_hh, bias_ih, bias_hh}_l{n}[_reverse]`` (4H, D).

Nothing here imports JAX: the caller converts to numpy first.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_LSTM_KEY = re.compile(r"l(\d+)_(fwd|bwd)")


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32)))


def _walk(p: Mapping[str, Any], s: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if "kernel" in p:  # Conv or Dense
        k = np.asarray(p["kernel"])
        out[prefix + "weight"] = _t(k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T)
        if "bias" in p:
            out[prefix + "bias"] = _t(p["bias"])
        return
    if "scale" in p:  # BatchNorm
        out[prefix + "weight"] = _t(p["scale"])
        out[prefix + "bias"] = _t(p["bias"])
        out[prefix + "running_mean"] = _t(s["mean"])
        out[prefix + "running_var"] = _t(s["var"])
        out[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        return
    lstm = {k: _LSTM_KEY.fullmatch(k) for k in p}
    if lstm and all(lstm.values()):
        for key, m in lstm.items():
            suffix = f"l{m.group(1)}" + ("_reverse" if m.group(2) == "bwd" else "")
            cell = p[key]
            out[f"{prefix}weight_ih_{suffix}"] = _t(np.asarray(cell["w_ih"]).T)
            out[f"{prefix}weight_hh_{suffix}"] = _t(np.asarray(cell["w_hh"]).T)
            out[f"{prefix}bias_ih_{suffix}"] = _t(cell["b_ih"])
            out[f"{prefix}bias_hh_{suffix}"] = _t(cell["b_hh"])
        return
    for key, child in p.items():
        _walk(child, s.get(key, {}), f"{prefix}{key}.", out)


def state_dict_from_jax(
    params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """JAX ``params``/``batch_stats`` (numpy leaves) → the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    _walk(params, batch_stats or {}, "", out)
    return out
