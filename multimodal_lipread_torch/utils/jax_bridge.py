"""The JAX package's variables → the port's ``state_dict``.

The inverse of the JAX package's ``utils/torch_import.py``: it takes
``params`` and ``batch_stats`` as nested dicts of numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, variables)``) and returns the
``state_dict`` of the port's module with the same submodule names:

- Conv ``kernel`` (kh, kw, I/groups, O) → ``weight`` (O, I/groups, kh, kw),
  which covers a depthwise kernel (kh, kw, 1, C) → (C, 1, kh, kw);
- Conv1d ``kernel`` (k, I, O) → ``weight`` (O, I, k);
- Dense ``kernel`` (I, O) → ``weight`` (O, I), which covers the 2-D
  ``query``/``key``/``value`` kernels of ``SingleQueryAttention`` (plain
  Dense layers, not the attention projections below);
- the ``query``/``key``/``value`` projections of Flax's
  ``MultiHeadDotProductAttention`` (``DenseGeneral``), ``kernel``
  (D, heads, head_dim) and ``bias`` (heads, head_dim) → ``nn.Linear``'s
  ``weight`` (heads·head_dim, D) and ``bias`` (heads·head_dim,); its ``out``
  projection, ``kernel`` (heads, head_dim, D) → ``weight`` (D, heads·head_dim);
- BatchNorm ``scale``/``bias`` + ``mean``/``var`` → ``weight``/``bias`` +
  ``running_mean``/``running_var``; a BatchNorm that a JAX module wraps in
  its own module (``bn1/BatchNorm_0/...``, the ResNet's and ShuffleNet's
  ``_BN``) maps to the port's ``bn1`` itself;
- LayerNorm ``scale``/``bias`` (no statistics) → ``weight``/``bias``
  (BERT's ``layer_norm``, ``attention_norm``, ``output_norm`` too);
- Embed ``embedding`` (num_embeddings, features) → ``weight``, the same
  layout;
- LSTM ``l{n}_{fwd,bwd}/{w_ih, w_hh, b_ih, b_hh}`` (D, 4H) →
  ``{weight_ih, weight_hh, bias_ih, bias_hh}_l{n}[_reverse]`` (4H, D); a
  single ``LSTMLayer``'s ``{w_ih, w_hh, b_ih, b_hh}`` at its own scope →
  ``..._l0``;
- a bare parameter leaf (the AV late-fusion models' 0-d ``alpha``, the
  audio_cues late fusion's (2,) ``attn_weights``) → the tensor under its
  own name;
- the ``PipelinedBertClassifier``'s stacked ``encoder`` (every leaf with a
  leading layer axis) → ``encoder.*`` tensors of the same leading axis,
  each layer converted as a ``BertLayer``'s.

Nothing here imports JAX: the caller converts to numpy first.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_LSTM_KEY = re.compile(r"l(\d+)_(fwd|bwd)")
_MHA_PROJECTIONS = ("query", "key", "value", "out")


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))  # keeps a 0-d leaf 0-d


def _kernel(k: np.ndarray, name: str) -> np.ndarray:
    """A Flax kernel under the submodule ``name`` → the torch weight."""
    if k.ndim == 4:  # Conv2d, grouped or not
        return k.transpose(3, 2, 0, 1)
    if k.ndim == 3 and name == "out":  # attention output (heads, head_dim, D)
        return k.reshape(-1, k.shape[-1]).T
    if k.ndim == 3 and name in _MHA_PROJECTIONS:  # attention q/k/v (D, heads, head_dim)
        return k.reshape(k.shape[0], -1).T
    if k.ndim == 3:  # Conv1d (k, I, O)
        return k.transpose(2, 1, 0)
    return k.T  # Dense (I, O)


_LSTM_CELL = {"w_ih", "w_hh", "b_ih", "b_hh"}


def _lstm_cell(cell: Mapping[str, Any], prefix: str, suffix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}weight_ih_{suffix}"] = _t(np.asarray(cell["w_ih"]).T)
    out[f"{prefix}weight_hh_{suffix}"] = _t(np.asarray(cell["w_hh"]).T)
    out[f"{prefix}bias_ih_{suffix}"] = _t(cell["b_ih"])
    out[f"{prefix}bias_hh_{suffix}"] = _t(cell["b_hh"])


def _walk(p: Any, s: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor], name: str = "") -> None:
    if not isinstance(p, Mapping):  # a bare parameter
        out[prefix[:-1]] = _t(p)
        return
    if set(p) == _LSTM_CELL:  # LSTMLayer: one direction of one layer
        _lstm_cell(p, prefix, "l0", out)
        return
    if set(p) == {"BatchNorm_0"}:  # a BatchNorm wrapped in its own module: one level less
        _walk(p["BatchNorm_0"], s.get("BatchNorm_0", {}), prefix, out, name)
        return
    if "embedding" in p:  # Embed
        out[prefix + "weight"] = _t(p["embedding"])
        return
    if "kernel" in p:  # Conv, Dense or an attention projection
        out[prefix + "weight"] = _t(_kernel(np.asarray(p["kernel"]), name))
        if "bias" in p:
            out[prefix + "bias"] = _t(np.asarray(p["bias"]).reshape(-1))
        return
    if "scale" in p:  # BatchNorm, or LayerNorm (no statistics)
        out[prefix + "weight"] = _t(p["scale"])
        out[prefix + "bias"] = _t(p["bias"])
        if "mean" in s:
            out[prefix + "running_mean"] = _t(s["mean"])
            out[prefix + "running_var"] = _t(s["var"])
        return
    lstm = {k: _LSTM_KEY.fullmatch(k) for k in p}
    if lstm and all(lstm.values()):
        for key, m in lstm.items():
            _lstm_cell(p[key], prefix, f"l{m.group(1)}" + ("_reverse" if m.group(2) == "bwd" else ""), out)
        return
    for key, child in p.items():
        _walk(child, s.get(key, {}), f"{prefix}{key}.", out, key)


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _stacked(encoder: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A stacked encoder → ``encoder.*``, converted layer by layer."""
    first = encoder
    while isinstance(first, Mapping):
        first = next(iter(first.values()))
    layers = []
    for i in range(np.asarray(first).shape[0]):
        out: Dict[str, torch.Tensor] = {}
        _walk(_layer(encoder, i), {}, "encoder.", out)
        layers.append(out)
    return {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}


def state_dict_from_jax(
    params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """JAX ``params``/``batch_stats`` (numpy leaves) → the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    rest = dict(params)
    encoder = rest.pop("encoder", None)
    if isinstance(encoder, Mapping) and "attention" in encoder:
        out.update(_stacked(encoder))
    elif encoder is not None:
        rest["encoder"] = encoder
    _walk(rest, batch_stats or {}, "", out)
    return out
