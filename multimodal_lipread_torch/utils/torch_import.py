"""torchvision-style state dicts → the port's ``state_dict`` names
(counterpart of the JAX package's ``utils/torch_import.py``).

The reference starts every backbone from torchvision ImageNet weights;
``model.pretrained`` (``pipelines/common.load_pretrained_backbones``)
grafts such weights, saved with ``torch.save(model.state_dict(), path)``
on a machine that has torchvision, into a model before training. The port's
modules carry the JAX package's names (``layer1_0.conv1``, ``block{i}.expand``,
``conv{k}``), so a converter here is the JAX converter's key map without
its layout transposes: both ends are torch layout. Each returns a flat
``{name: float32 tensor}`` mapping relative to the backbone, which
``graft_backbone`` installs under a dotted submodule prefix.

- ``convert_resnet``: torchvision resnet18/34/50 → ``backbones.ResNet``;
- ``convert_vgg_bn``: torchvision vgg{11,13,16,19}_bn ``features`` →
  ``backbones.VGG``;
- ``convert_mobilenet_v2`` / ``convert_mobilenet_v3_small`` →
  ``backbones.MobileNetV2`` / ``MobileNetV3Small``;
- ``convert_shufflenet_v2``: shufflenet_v2_x0_5 / x1_0 → ``ShuffleNetV2``;
- ``convert_lstm``: ``torch.nn.LSTM`` (batch first) → ``nn.recurrent.LSTM``.

torchvision's ``num_batches_tracked`` counters have no counterpart and are
dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

_VGG_CFG_LAYERS = {11: 8, 13: 10, 16: 13, 19: 16}
_RESNET_STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
# torchvision mobilenet_v3_small: (has_expand, has_se) per features.{1..11}
_MBV3S_BLOCKS = (
    (False, True), (True, False), (True, False), (True, True), (True, True),
    (True, True), (True, True), (True, True), (True, True), (True, True),
    (True, True),
)
_MBV2_EXPAND = (1,) + (6,) * 16  # expand ratio of torchvision's features.{1..17}

StateDict = Dict[str, torch.Tensor]


def load_state_dict(src: Any) -> StateDict:
    """A ``.pth`` path (read with ``weights_only``) or an in-memory mapping
    of tensors or arrays → ``{name: float32 CPU tensor}``."""
    if isinstance(src, (str, bytes)):
        src = torch.load(src, map_location="cpu", weights_only=True)
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32) for k, v in src.items()}


def _copy(sd: Mapping[str, torch.Tensor], out: StateDict, dst: str, src: str, bias: bool = False) -> None:
    out[f"{dst}.weight"] = sd[f"{src}.weight"].clone()
    if bias:
        out[f"{dst}.bias"] = sd[f"{src}.bias"].clone()


def _bn(sd: Mapping[str, torch.Tensor], out: StateDict, dst: str, src: str) -> None:
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{name}"] = sd[f"{src}.{name}"].clone()


def convert_resnet(src: Any, version: int = 18) -> StateDict:
    """torchvision resnet state dict → ``backbones.ResNet`` names."""
    sd = load_state_dict(src)
    out: StateDict = {}
    _copy(sd, out, "conv1", "conv1")
    _bn(sd, out, "bn1", "bn1")
    n_convs = 3 if version >= 50 else 2
    for stage, n_blocks in enumerate(_RESNET_STAGES[version]):
        for b in range(n_blocks):
            t, f = f"layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            for ci in range(1, n_convs + 1):
                _copy(sd, out, f"{f}.conv{ci}", f"{t}.conv{ci}")
                _bn(sd, out, f"{f}.bn{ci}", f"{t}.bn{ci}")
            if f"{t}.downsample.0.weight" in sd:
                _copy(sd, out, f"{f}.downsample_conv", f"{t}.downsample.0")
                _bn(sd, out, f"{f}.downsample_bn", f"{t}.downsample.1")
    return out


def convert_vgg_bn(src: Any, version: int = 11) -> StateDict:
    """torchvision vgg*_bn ``features`` state dict → ``backbones.VGG``: the
    k-th conv/BatchNorm pair of the sequential ``features`` becomes
    ``conv{k}``/``bn{k}``."""
    sd = load_state_dict(src)
    conv_keys = sorted(
        {int(k.split(".")[1]) for k in sd if k.startswith("features.") and k.endswith(".weight")
         and sd[k].ndim == 4}
    )
    expected = _VGG_CFG_LAYERS[version]
    if len(conv_keys) != expected:
        raise ValueError(f"VGG{version} expects {expected} convs, found {len(conv_keys)}")
    out: StateDict = {}
    for i, idx in enumerate(conv_keys):
        _copy(sd, out, f"conv{i}", f"features.{idx}", bias=True)
        _bn(sd, out, f"bn{i}", f"features.{idx + 1}")
    return out


def _convbn(sd: Mapping[str, torch.Tensor], out: StateDict, dst: str, conv: str, bn: str) -> None:
    _copy(sd, out, f"{dst}.conv", conv)
    _bn(sd, out, f"{dst}.bn", bn)


def convert_mobilenet_v2(src: Any) -> StateDict:
    """torchvision mobilenet_v2 state dict → ``backbones.MobileNetV2``:
    ``features.0`` the stem, ``features.{1..17}`` the blocks (``.conv``:
    [expand,] depthwise, project), ``features.18`` the head."""
    sd = load_state_dict(src)
    out: StateDict = {}
    _convbn(sd, out, "stem", "features.0.0", "features.0.1")
    for idx, t in enumerate(_MBV2_EXPAND):
        f, b = f"features.{idx + 1}.conv", f"block{idx}"
        if t == 1:
            pairs = (("depthwise", f"{f}.0.0", f"{f}.0.1"), ("project", f"{f}.1", f"{f}.2"))
        else:
            pairs = (("expand", f"{f}.0.0", f"{f}.0.1"), ("depthwise", f"{f}.1.0", f"{f}.1.1"),
                     ("project", f"{f}.2", f"{f}.3"))
        for name, ck, bk in pairs:
            _convbn(sd, out, f"{b}.{name}", ck, bk)
    _convbn(sd, out, "head", "features.18.0", "features.18.1")
    return out


def convert_mobilenet_v3_small(src: Any) -> StateDict:
    """torchvision mobilenet_v3_small state dict → ``backbones.MobileNetV3Small``:
    each ``features.{i}.block`` holds [expand,] depthwise, [squeeze-excite
    (``fc1``/``fc2``, biased, no BatchNorm),] project."""
    sd = load_state_dict(src)
    out: StateDict = {}
    _convbn(sd, out, "stem", "features.0.0", "features.0.1")
    for idx, (has_expand, has_se) in enumerate(_MBV3S_BLOCKS):
        f, b = f"features.{idx + 1}.block", f"block{idx}"
        pos = 0
        if has_expand:
            _convbn(sd, out, f"{b}.expand", f"{f}.{pos}.0", f"{f}.{pos}.1")
            pos += 1
        _convbn(sd, out, f"{b}.depthwise", f"{f}.{pos}.0", f"{f}.{pos}.1")
        pos += 1
        if has_se:
            for fc in ("fc1", "fc2"):
                _copy(sd, out, f"{b}.se.{fc}", f"{f}.{pos}.{fc}", bias=True)
            pos += 1
        _convbn(sd, out, f"{b}.project", f"{f}.{pos}.0", f"{f}.{pos}.1")
    _convbn(sd, out, "head", "features.12.0", "features.12.1")
    return out


def convert_shufflenet_v2(src: Any, width: float = 1.0) -> StateDict:
    """torchvision shufflenet_v2_x{0_5,1_0} state dict → ``backbones.ShuffleNetV2``:
    ``conv1.{0,1}``; ``stage{2,3,4}.{i}.branch1.{0..3}`` (stride-2 units
    only) and ``.branch2.{0,1,3,4,5,6}``; ``conv5.{0,1}``. (``width`` picks
    nothing here; the shapes come with the weights.)"""
    sd = load_state_dict(src)
    out: StateDict = {}
    _copy(sd, out, "conv1", "conv1.0")
    _bn(sd, out, "conv1_bn", "conv1.1")
    for stage, reps in zip((2, 3, 4), (4, 8, 4)):
        for i in range(reps):
            t, f = f"stage{stage}.{i}", f"stage{stage}_{i}"
            if i == 0:  # the stride-2 unit has branch1
                _copy(sd, out, f"{f}.b1_dw", f"{t}.branch1.0")
                _bn(sd, out, f"{f}.b1_dw_bn", f"{t}.branch1.1")
                _copy(sd, out, f"{f}.b1_pw", f"{t}.branch1.2")
                _bn(sd, out, f"{f}.b1_pw_bn", f"{t}.branch1.3")
            for name, conv, bn in (("b2_pw1", 0, 1), ("b2_dw", 3, 4), ("b2_pw2", 5, 6)):
                _copy(sd, out, f"{f}.{name}", f"{t}.branch2.{conv}")
                _bn(sd, out, f"{f}.{name}_bn", f"{t}.branch2.{bn}")
    _copy(sd, out, "conv5", "conv5.0")
    _bn(sd, out, "conv5_bn", "conv5.1")
    return out


def convert_lstm(src: Any, num_layers: int = 1, bidirectional: bool = True) -> StateDict:
    """``torch.nn.LSTM`` state dict → ``nn.recurrent.LSTM`` (the same names:
    gate packing i, f, g, o on both sides)."""
    sd = load_state_dict(src)
    out: StateDict = {}
    for layer in range(num_layers):
        for suffix in ("", "_reverse") if bidirectional else ("",):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                key = f"{name}_l{layer}{suffix}"
                out[key] = sd[key].clone()
    return out


def graft_backbone(model_state: Mapping[str, torch.Tensor], backbone_state: Mapping[str, torch.Tensor],
                   submodule: str) -> StateDict:
    """``model_state`` (a model's ``state_dict``) with every entry under
    ``submodule`` (a dotted prefix, ``""`` for the whole model) replaced by
    ``backbone_state``'s. The two must name the same tensors at the same
    shapes; otherwise ``ValueError`` names the missing, extra and
    mismatched keys."""
    prefix = f"{submodule}." if submodule else ""
    old = {k[len(prefix):]: v for k, v in model_state.items() if k.startswith(prefix)}
    if not old:
        raise ValueError(f"backbone graft: the model has no submodule '{submodule}'")
    missing = sorted(set(old) - set(backbone_state))
    extra = sorted(set(backbone_state) - set(old))
    mismatched = sorted(k for k in set(old) & set(backbone_state)
                        if tuple(old[k].shape) != tuple(backbone_state[k].shape))
    if missing or extra or mismatched:
        raise ValueError(
            f"backbone graft mismatch at '{submodule}': missing={missing[:5]} extra={extra[:5]} "
            f"mismatched={[(k, tuple(old[k].shape), tuple(backbone_state[k].shape)) for k in mismatched[:5]]}"
        )
    out = dict(model_state)
    for k, v in backbone_state.items():
        out[prefix + k] = v.to(old[k].dtype)
    return out


def adapt_first_conv_to_1ch(state: Mapping[str, torch.Tensor]) -> StateDict:
    """A 3-channel ``conv1`` → 1 channel by summing its input channels (the
    channel-fold that keeps the pretrained kernels, for mel images)."""
    out = dict(state)
    w = state["conv1.weight"]  # (O, I, kh, kw)
    folded = w[:, :1].clone()
    for i in range(1, w.shape[1]):
        folded += w[:, i : i + 1]
    out["conv1.weight"] = folded
    return out
