"""The crop kernel's staging arithmetic on the CPU: ``ops/crop_resize_cuda
.staging_plan``, the host's reckoning of the rounds in which
``csrc/crop_resize.cu`` stages a band's source rows into shared memory,
against the plain version's source coordinates (``ops/crop_resize
.source_coords``). Every gather of every letterboxed pixel lies inside the
window its round stages, every round fits the block's staging bytes, every
letterboxed pixel is blended in exactly one round of its own band, and the
bands' integer sums add up to the plain version's pad colour. The boxes are
``chip_smoke.crop_boxes``' (random mouths, a failed detection, a negative
width, edges, the whole frame, a square and an exact 44 x 44), on GLips
frames and on frames up to 1920 wide."""

import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_lipread_torch.ops import crop_resize_cuda
from multimodal_lipread_torch.ops.crop_resize import crop_resize_pad_reference, letterbox, source_coords


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(n, H, W, seed):
    return torch.from_numpy(chip_smoke.crop_boxes(np.random.default_rng(seed), n, H, W))


# (H, W, C, target, cluster, stage cap): GLips frames at the default launch
# and at other cluster sizes; small caps that force rounds of fewer rows and
# column groups; other channel counts and canvases; wide frames
CASES = [
    (256, 256, 3, (44, 44), crop_resize_cuda.CLUSTER, crop_resize_cuda.STAGE_CAP),
    (256, 256, 3, (44, 44), 1, crop_resize_cuda.STAGE_CAP),
    (256, 256, 3, (44, 44), 4, 16 * 1024),
    (256, 256, 3, (44, 44), 8, 16 * 1024),
    (256, 256, 3, (44, 44), 2, 2048),
    (256, 256, 3, (44, 44), 4, 64),
    (72, 96, 1, (45, 37), 3, crop_resize_cuda.STAGE_CAP),
    (72, 96, 2, (32, 48), 2, 512),
    (72, 96, 4, (45, 37), 4, crop_resize_cuda.STAGE_CAP),
    (1080, 1920, 3, (44, 44), crop_resize_cuda.CLUSTER, crop_resize_cuda.STAGE_CAP),
    (720, 1280, 4, (44, 44), 4, 8192),
]


def _case_id(case):
    H, W, C, target, cluster, cap = case
    return f"{H}x{W}x{C}-to-{target[0]}x{target[1]}-K{cluster}-cap{cap}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_every_gather_lies_in_its_rounds_window(case):
    H, W, C, target, cluster, cap = case
    n = 24
    boxes = _boxes(n, H, W, seed=H + W + C)
    stage = crop_resize_cuda.stage_bytes(H, W, C, target, cluster, cap)
    assert stage % 16 == 0 and 64 <= stage <= max(cap, 64)
    plan = crop_resize_cuda.staging_plan(boxes, H, W, C, target, cluster, stage)
    y0, y1, _wy, x0, x1, _wx, in_region = source_coords(boxes, H, W, target)
    band = -(-target[0] // cluster)
    for f, rounds in enumerate(plan):
        covered = torch.zeros(target, dtype=torch.int32)
        for rd in rounds:
            (ra, rb), (ca, cb), (xa, xb) = rd["rows"], rd["cols"], rd["span"]
            assert rd["band"] * band <= ra < rb <= min((rd["band"] + 1) * band, target[0])
            assert rd["bytes"] == len(rd["src_rows"]) * rd["stride"] <= stage
            assert rd["stride"] == crop_resize_cuda.span_stride(xb - xa)
            assert rd["src_rows"] == sorted(set(rd["src_rows"]))
            for y in rd["src_rows"]:  # the 16-byte-aligned window of a staged row fits its stride
                row = (f * H + y) * W * C
                assert -(-(row + xb) // 16) * 16 - (row + xa) // 16 * 16 <= rd["stride"]
            for r in range(ra, rb):
                assert int(y0[f, r, 0]) in rd["src_rows"] and int(y1[f, r, 0]) in rd["src_rows"]
            assert int(x0[f, 0, ca:cb].min()) * C >= xa and int(x1[f, 0, ca:cb].max()) * C + C <= xb
            covered[ra:rb, ca:cb] += 1
        # every letterboxed pixel in exactly one round; a degenerate box has none
        valid = bool(boxes[f, 2] > boxes[f, 0]) and bool(boxes[f, 3] > boxes[f, 1])
        assert torch.equal(covered, in_region[f].int() if valid else torch.zeros_like(covered))


@pytest.mark.parametrize("H, W, C, cluster", [(256, 256, 3, 1), (256, 256, 3, 2), (256, 256, 3, 4),
                                              (1080, 1920, 3, 2), (1080, 1920, 4, 4), (480, 640, 1, 8)])
def test_a_whole_frame_box_keeps_to_the_budget(H, W, C, cluster):
    boxes = torch.tensor([[0, 0, W, H], [0, 0, W // 2, H], [W - 7, 0, W, H]], dtype=torch.int32)
    stage = crop_resize_cuda.stage_bytes(H, W, C, (44, 44), cluster)
    plan = crop_resize_cuda.staging_plan(boxes, H, W, C, (44, 44), cluster)
    assert all(rd["bytes"] <= stage for rounds in plan for rd in rounds)
    # the whole frame: every letterboxed row once in the first column group, within a row's bytes
    whole, (new_h, _new_w, _ph, pw) = plan[0], letterbox(boxes[:1], (44, 44))
    assert sum(rd["rows"][1] - rd["rows"][0] for rd in whole if rd["cols"][0] == int(pw)) == int(new_h)
    assert all(0 <= rd["span"][0] < rd["span"][1] <= W * C for rd in whole)
    # a window wider than half the stage is cut into column groups
    if crop_resize_cuda.span_stride(W * C) > stage // 2:
        assert len({rd["cols"] for rd in whole}) > 1


def test_the_glips_default_stages_a_mouth_band_in_one_round():
    boxes = _boxes(464, 256, 256, seed=0)
    plan = crop_resize_cuda.staging_plan(boxes, 256, 256, 3)
    rounds_per_band = {}
    for f, rounds in enumerate(plan):
        for rd in rounds:
            rounds_per_band[f, rd["band"]] = rounds_per_band.get((f, rd["band"]), 0) + 1
    one = sum(1 for v in rounds_per_band.values() if v == 1)
    assert one / len(rounds_per_band) > 0.9, f"{one} of {len(rounds_per_band)} bands in one round"


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("H, W, C, target", [(256, 256, 3, (44, 44)), (72, 96, 4, (45, 37))])
def test_band_sums_add_up_to_the_plain_pad_colour(cluster, H, W, C, target):
    n = 32
    rng = np.random.default_rng(cluster * 7 + C)
    frames = torch.from_numpy(rng.integers(0, 256, (n, H, W, C), dtype=np.uint8))
    boxes = _boxes(n, H, W, seed=cluster)
    out = crop_resize_pad_reference(frames, boxes, target).to(torch.int64)
    in_region = source_coords(boxes, H, W, target)[-1]
    new_h, new_w, _ph, _pw = letterbox(boxes, target)
    band = -(-target[0] // cluster)
    padded = 0
    for f in range(n):
        if not (boxes[f, 2] > boxes[f, 0] and boxes[f, 3] > boxes[f, 1]):
            continue
        # each cluster block's integer sums of its band's rounded letterboxed values
        sums = [(out[f, b * band:(b + 1) * band] * in_region[f, b * band:(b + 1) * band, :, None]).sum((0, 1))
                for b in range(cluster)]
        total = torch.stack(sums).sum(0)
        assert torch.equal(total, (out[f] * in_region[f, :, :, None]).sum((0, 1)))
        pad = np.floor(np.float32(total.numpy()) / np.float32(int(new_h[f]) * int(new_w[f])))
        outside = ~in_region[f]
        if bool(outside.any()):
            padded += 1
            assert np.array_equal(out[f][outside].numpy(), np.broadcast_to(pad, (int(outside.sum()), C)))
    assert padded > 0
