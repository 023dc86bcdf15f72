"""Plain ``resnet_trans`` from full uint8 frames and their lip boxes.

- Crop (``preprocessing.padding_mode: average``): each frame's
  margin-expanded box (x_min, y_min, x_max, y_max) is cut out and resized
  into a 44 × 44 canvas keeping its aspect, as the reference project's cv2
  path does it: the resized size ``(44, 44·h // w)`` for a wide box and
  ``(44·w // h, 44)`` otherwise, centred; each canvas pixel samples the box
  at cv2 ``INTER_LINEAR``'s ``(dst + 0.5) · scale − 0.5``, clamped into the
  box, its second neighbour clamped at the box's last row and column; the
  bilinear blend in float32, rounded half to even; the canvas outside the
  resized region takes the floor of the region's mean colour; a box of no
  width or height gives a black frame. Then /255.
- ResNet-18 per frame (He et al. 2016, torchvision's topology: a 7 × 7
  stride-2 stem to 64, BatchNorm (eps 1e-5), ReLU, a 3 × 3 stride-2
  max-pool, four stages of two basic blocks of 64, 128, 256 and 512, the
  first block of stages 2–4 at stride 2 with a 1 × 1 projection shortcut,
  convolutions without bias, the global mean).
- Linear 512 → 256, the sinusoidal positions, a 2-layer post-LN Transformer
  encoder (d 256, 4 heads, FF 1024 with ReLU, LayerNorm eps 1e-6, dropout
  0.2 after the attention, inside the FF and after it, and on the attention
  probabilities with one (T, T) mask shared over batch and heads), the mean
  over the frames, ReLU, dropout 0.2 and Linear 256 → classes.

Departures from torchvision's ResNet-18, as the reference project's port
builds it: no final fully connected layer; frames of 44 × 44, so the maps
are 22, 11, 6, 3 and 2 wide; BatchNorm's running variance is the biased one
(training normalizes with the batch's own statistics either way).

Dropout masks are drawn in forward order from the generator the trainer
gives its dropout layers, one Bernoulli draw of each mask's shape."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import layers as L

TARGET = 44
STAGES = (64, 128, 256, 512)
BLOCKS = 2
FEATURES = 512
D_MODEL = 256
HEADS = 4
FF = 1024
LAYERS = 2
DROPOUT = 0.2
BN_EPS = 1e-5
LN_EPS = 1e-6
FRAMES = 29
FRAME_SIZE = 256


def _blocks():
    """(name, in, out, stride) of the eight basic blocks."""
    c = STAGES[0]
    for s, width in enumerate(STAGES):
        for b in range(BLOCKS):
            yield f"resnet.layer{s + 1}_{b}", c, width, 2 if s > 0 and b == 0 else 1
            c = width


def _ln_spec(name: str, d: int) -> dict:
    return {f"{name}.weight": ((d,), "bn_weight", 1), f"{name}.bias": ((d,), "bn_bias", 1)}


def param_spec(cfg: dict) -> dict:
    spec = {}
    spec.update(L.conv_spec("resnet.conv1", 3, STAGES[0], 7, bias=False))
    spec.update(L.bn_spec("resnet.bn1", STAGES[0]))
    for name, cin, cout, stride in _blocks():
        spec.update(L.conv_spec(f"{name}.conv1", cin, cout, 3, bias=False))
        spec.update(L.bn_spec(f"{name}.bn1", cout))
        spec.update(L.conv_spec(f"{name}.conv2", cout, cout, 3, bias=False))
        spec.update(L.bn_spec(f"{name}.bn2", cout))
        if stride != 1 or cin != cout:
            spec.update(L.conv_spec(f"{name}.downsample_conv", cin, cout, 1, bias=False))
            spec.update(L.bn_spec(f"{name}.downsample_bn", cout))
    spec.update(L.linear_spec("proj_in", FEATURES, D_MODEL))
    for i in range(LAYERS):
        name = f"transformer.layer{i}"
        for proj in ("query", "key", "value", "out"):
            spec.update(L.linear_spec(f"{name}.self_attn.{proj}", D_MODEL, D_MODEL))
        spec.update(_ln_spec(f"{name}.norm1", D_MODEL))
        spec.update(L.linear_spec(f"{name}.linear1", D_MODEL, FF))
        spec.update(L.linear_spec(f"{name}.linear2", FF, D_MODEL))
        spec.update(_ln_spec(f"{name}.norm2", D_MODEL))
    spec.update(L.linear_spec("fc", D_MODEL, cfg["dataset"]["num_classes"]))
    return spec


# ----------------------------------------------------------------- the crop


def _axis(lo: torch.Tensor, hi: torch.Tensor, resized: torch.Tensor, offset: torch.Tensor, limit: int):
    """Along one axis of N frames: per canvas index (N, 44) the two source
    indices, the second one's weight, and whether it lies in the resized
    region. ``lo``/``hi`` are the box's int32 edges, ``resized`` its
    resized length and ``offset`` where that starts on the canvas."""
    length = (hi - lo).clamp_min(1)
    dst = torch.arange(TARGET, device=lo.device, dtype=torch.float32)[None, :] - offset.float()[:, None]
    inside = (dst >= 0) & (dst < resized.float()[:, None])
    scale = (length.float() / resized.float())[:, None]
    src = torch.minimum(torch.maximum((dst + 0.5) * scale - 0.5, torch.zeros_like(dst)),
                        (length.float() - 1.0)[:, None]) + lo.float()[:, None]
    src = src.clamp(0.0, limit - 1.0)
    first = torch.floor(src)
    last = torch.clamp_max(lo + length - 1, limit - 1)[:, None]
    second = torch.minimum(first.int() + 1, last)
    weight = src - first
    return first.long().clamp(0, limit - 1), second.long().clamp(0, limit - 1), weight, inside


def sample_points(boxes: torch.Tensor, h: int, w: int) -> tuple:
    """Where the canvases of int32 boxes (N, 4) in (h, w) frames sample
    them: per canvas row (N, 44) the two source rows, the second one's
    weight and whether the row is in the resized region, then the same per
    canvas column."""
    b = boxes.int()
    bw, bh = (b[:, 2] - b[:, 0]).clamp_min(1), (b[:, 3] - b[:, 1]).clamp_min(1)
    wide = bw * TARGET > bh * TARGET
    new_w = torch.where(wide, torch.full_like(bw, TARGET), TARGET * bw // bh).clamp_min(1)
    new_h = torch.where(wide, TARGET * bh // bw, torch.full_like(bh, TARGET)).clamp_min(1)
    return (*_axis(b[:, 1], b[:, 3], new_h, (TARGET - new_h) // 2, h),
            *_axis(b[:, 0], b[:, 2], new_w, (TARGET - new_w) // 2, w))


def crop(frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """uint8 frames (..., H, W, C) and int32 boxes (..., 4) → uint8 lips
    (..., 44, 44, C)."""
    lead, (h, w, c) = frames.shape[:-3], frames.shape[-3:]
    fl = frames.reshape(-1, h, w, c)
    b = boxes.reshape(-1, 4).int()
    n = fl.shape[0]
    y0, y1, wy, in_y, x0, x1, wx, in_x = sample_points(b, h, w)
    f = torch.arange(n, device=fl.device)[:, None, None]
    wy, wx = wy[:, :, None, None], wx[:, None, :, None]

    def at(ys, xs):  # (N, 44, 44, C) float32
        return fl[f, ys[:, :, None], xs[:, None, :]].float()

    blend = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
             + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)
    pixels = torch.round(blend).clamp(0.0, 255.0)
    region = (in_y[:, :, None] & in_x[:, None, :])[..., None]  # (N, 44, 44, 1)
    count = region.float().sum(dim=(1, 2)).clamp_min(1.0)
    mean = torch.floor((pixels * region.float()).sum(dim=(1, 2)) / count)  # (N, C)
    canvas = torch.where(region, pixels, mean[:, None, None, :])
    empty = (b[:, 2] <= b[:, 0]) | (b[:, 3] <= b[:, 1])
    canvas = torch.where(empty[:, None, None, None], torch.zeros_like(canvas), canvas)
    return canvas.to(torch.uint8).reshape(lead + (TARGET, TARGET, c))


# ------------------------------------------------------------ the network


def resnet18(p: L.Params, x: torch.Tensor, train: bool) -> torch.Tensor:
    """(N, 3, H, W) → (N, 512)."""
    x = F.relu(L.batch_norm(p, "resnet.bn1", F.conv2d(x, p["resnet.conv1.weight"], None, 2, 3), train, BN_EPS))
    x = F.max_pool2d(x, 3, 2, 1)
    for name, cin, cout, stride in _blocks():
        y = F.relu(L.batch_norm(p, f"{name}.bn1", F.conv2d(x, p[f"{name}.conv1.weight"], None, stride, 1),
                                train, BN_EPS))
        y = L.batch_norm(p, f"{name}.bn2", F.conv2d(y, p[f"{name}.conv2.weight"], None, 1, 1), train, BN_EPS)
        if stride != 1 or cin != cout:
            x = L.batch_norm(p, f"{name}.downsample_bn", F.conv2d(x, p[f"{name}.downsample_conv.weight"], None,
                                                                   stride), train, BN_EPS)
        x = F.relu(y + x)
    return x.mean(dim=(2, 3))


def positions(t: int) -> torch.Tensor:
    """(t, 256) sinusoids: sin at the even features, cos at the odd ones, of
    position · exp(−ln(10000) · 2i / 256), in float64 rounded to float32."""
    angle = np.arange(t, dtype=np.float64)[:, None] * np.exp(np.arange(0, D_MODEL, 2) * (-math.log(10000.0) / D_MODEL))
    table = np.zeros((t, D_MODEL), np.float64)
    table[:, 0::2], table[:, 1::2] = np.sin(angle), np.cos(angle)
    return torch.from_numpy(table.astype(np.float32))


def _attention(p: L.Params, name: str, x: torch.Tensor, train: bool, generator) -> torch.Tensor:
    b, t, d = x.shape
    hd = d // HEADS

    def heads(proj):
        return L.linear(p, f"{name}.{proj}", x).reshape(b, t, HEADS, hd).transpose(1, 2)

    q, k, v = heads("query") / math.sqrt(hd), heads("key"), heads("value")
    probs = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    if train:  # one (T, T) mask for every example and head
        keep = torch.empty((1, 1, t, t), dtype=probs.dtype, device=probs.device).bernoulli_(
            1.0 - DROPOUT, generator=generator)
        probs = probs * keep / (1.0 - DROPOUT)
    return L.linear(p, f"{name}.out", (probs @ v).transpose(1, 2).reshape(b, t, d))


def _layer_norm(p: L.Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def forward(p: L.Params, cfg: dict, inputs: tuple, train: bool, generator=None) -> torch.Tensor:
    frames, boxes = inputs
    b, t = frames.shape[:2]
    lips = crop(frames, boxes).to(p["proj_in.weight"].dtype) / 255.0  # float32, or the parameters' dtype
    x = resnet18(p, lips.reshape((b * t,) + lips.shape[2:]).permute(0, 3, 1, 2), train).reshape(b, t, FEATURES)
    x = L.linear(p, "proj_in", x) + positions(t).to(x.device)
    for i in range(LAYERS):
        name = f"transformer.layer{i}"
        a = L.dropout(_attention(p, f"{name}.self_attn", x, train, generator), DROPOUT, generator, train)
        x = _layer_norm(p, f"{name}.norm1", x + a)
        y = L.dropout(F.relu(L.linear(p, f"{name}.linear1", x)), DROPOUT, generator, train)
        x = _layer_norm(p, f"{name}.norm2", x + L.dropout(L.linear(p, f"{name}.linear2", y), DROPOUT, generator,
                                                          train))
    pooled = F.relu(x.mean(dim=1))
    return L.linear(p, "fc", L.dropout(pooled, DROPOUT, generator, train))


def example_inputs(batch: int) -> tuple:
    """Zeros of the raw inputs' shapes and dtypes, for counting FLOPs."""
    return (torch.zeros(batch, FRAMES, FRAME_SIZE, FRAME_SIZE, 3, dtype=torch.uint8),
            torch.zeros(batch, FRAMES, 4, dtype=torch.int32))
