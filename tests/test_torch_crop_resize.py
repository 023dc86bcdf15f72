"""The port's lip crop (``ops/crop_resize.py``, the plain version of the
CUDA kernel, and its entry ``ops/crop_resize_cuda.py``) against the JAX
package's ``ops/crop_resize.py`` on the CPU, on the cases of
tests/test_crop_resize.py: random, square, exact-size and degenerate boxes,
(B, T) leading axes, ``expand_boxes`` and the fused normalize; and the
port's host half (``data/lip_extraction.py``) against the JAX one on the
same synthetic ``.mp4``.

Both packages take the same float32 operations in the same order, but
XLA:CPU contracts a multiply and an add into one FMA (every ``a*b - c`` of
100 000 random triples came out as the fused result), where the port rounds
each product, as its CUDA kernel does to stay bit-equal to it. A blend that
lands within an ULP of a half then rounds the other way, and a pad colour
whose mean sits at an integer floors the other way. So every pixel is held
to the contract's 1 LSB, and the pixels and frames that differ at all are
counted and bounded (at most 1 % of the pixels; on the random boxes at most
a quarter of the frames, 10 of 64 at seed 0), as tests/test_crop_resize.py
counts and bounds the JAX op's frames against cv2. No frame may differ by
more than 1 LSB (that test lets 2 of 64 do so)."""

import numpy as np
import pytest
import torch

from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)

from multimodal_lipread_tpu.data import lip_extraction as jlip
from multimodal_lipread_tpu.ops import crop_resize as jcrop

from multimodal_lipread_torch.data import lip_extraction as plip
from multimodal_lipread_torch.ops import crop_resize as pcrop
from multimodal_lipread_torch.ops import crop_resize_cuda


def _random_frames_boxes(n, H=72, W=96, seed=0):
    r = np.random.default_rng(seed)
    frames = r.integers(0, 256, size=(n, H, W, 3), dtype=np.uint8)
    x0 = r.integers(0, W - 8, size=n)
    y0 = r.integers(0, H - 8, size=n)
    x1 = x0 + r.integers(4, W // 2, size=n)
    y1 = y0 + r.integers(4, H // 2, size=n)
    boxes = np.stack([x0, y0, np.minimum(x1, W), np.minimum(y1, H)], -1)
    return frames, boxes.astype(np.int32)


def _port(frames, boxes, normalize=False):
    fn = crop_resize_cuda.crop_resize_pad_normalize if normalize else crop_resize_cuda.crop_resize_pad
    return fn(torch.from_numpy(frames), torch.from_numpy(boxes)).numpy()


def _differing_frames(got, want):
    """The frames that differ at all, once every pixel is within 1 LSB and
    at most 1 % of them differ."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64)).reshape(len(got), -1)
    assert diff.max() <= 1, f"a pixel differs by {diff.max()} LSB"
    assert (diff > 0).mean() <= 0.01, f"{(diff > 0).mean():.2%} of the pixels differ"
    return int((diff.max(1) > 0).sum())


@pytest.mark.parametrize("seed", [0, 6, 9])
def test_random_boxes_match_jax(seed):
    frames, boxes = _random_frames_boxes(64, seed=seed)
    got = _port(frames, boxes)
    assert got.dtype == np.uint8 and got.shape == (64, 44, 44, 3)
    assert _differing_frames(got, np.asarray(jcrop.crop_resize_pad(frames, boxes))) <= 16


@pytest.mark.parametrize("box", [[10, 5, 54, 49], [7, 3, 51, 47], [0, 0, 96, 72], [80, 60, 96, 72],
                                 [0, 30, 95, 40], [40, 0, 45, 72]])
def test_square_exact_and_edge_boxes_match_jax(box):
    # square, exact 44 x 44, the whole frame, touching the corner, very wide
    # and very tall boxes
    frames, _ = _random_frames_boxes(8, seed=1)
    boxes = np.array([box] * 8, np.int32)
    got = _port(frames, boxes)
    _differing_frames(got, np.asarray(jcrop.crop_resize_pad(frames, boxes)))


def test_exact_size_crop_is_identity():
    frames, _ = _random_frames_boxes(4, seed=2)
    box = np.array([7, 3, 51, 47], np.int32)
    got = _port(frames, np.tile(box, (4, 1)))
    np.testing.assert_array_equal(got, frames[:, 3:47, 7:51])


def test_degenerate_boxes_give_blank_frames():
    frames, boxes = _random_frames_boxes(4)
    boxes[0] = (10, 10, 10, 20)  # zero width
    boxes[1] = (30, 12, 20, 40)  # negative width
    boxes[2] = (0, 0, 0, 0)  # a failed detection
    got = _port(frames, boxes)
    assert (got[:3] == 0).all() and got[3].any()
    np.testing.assert_array_equal(got, np.asarray(jcrop.crop_resize_pad(frames, boxes)))


def test_batch_axes_and_video_shape():
    frames, boxes = _random_frames_boxes(12, seed=3)
    video, vboxes = frames.reshape(3, 4, 72, 96, 3), boxes.reshape(3, 4, 4)
    got = _port(video, vboxes)
    assert got.shape == (3, 4, 44, 44, 3)
    np.testing.assert_array_equal(got.reshape(12, 44, 44, 3), _port(frames, boxes))
    _differing_frames(got.reshape(12, 44, 44, 3), np.asarray(jcrop.crop_resize_pad(video, vboxes)).reshape(12, 44, 44, 3))


def test_fused_normalize_matches_jax():
    frames, boxes = _random_frames_boxes(16, seed=5)
    got = _port(frames, boxes, normalize=True)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _port(frames, boxes).astype(np.float32) / 255.0, rtol=0, atol=0)
    want = np.asarray(jcrop.crop_resize_pad_normalize(frames, boxes))
    np.testing.assert_allclose(got, want, rtol=0, atol=1.0 / 255.0 + 1e-7)


def test_expand_boxes_matches_jax_and_the_host():
    r = np.random.default_rng(4)
    H, W = 72, 96
    x0, y0 = r.integers(0, 60, 50), r.integers(0, 40, 50)
    x1, y1 = np.minimum(x0 + r.integers(2, 30, 50), W), np.minimum(y0 + r.integers(2, 30, 50), H)
    boxes = np.stack([x0, y0, x1, y1], -1).astype(np.int32)
    got = pcrop.expand_boxes(torch.from_numpy(boxes), H, W).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcrop.expand_boxes(boxes, H, W)))
    assert [tuple(b) for b in got] == [plip._expand_box(*b, H, W) for b in boxes.tolist()]


def test_the_entry_refuses_what_it_does_not_take():
    frames, boxes = _random_frames_boxes(2)
    with pytest.raises(TypeError, match="uint8"):
        crop_resize_cuda.crop_resize_pad(torch.from_numpy(frames).float(), torch.from_numpy(boxes))
    with pytest.raises(ValueError, match="do not match"):
        crop_resize_cuda.crop_resize_pad(torch.from_numpy(frames), torch.from_numpy(boxes[:1]))
    before = crop_resize_cuda.launch_count
    crop_resize_cuda.crop_resize_pad(torch.from_numpy(frames), torch.from_numpy(boxes))
    assert crop_resize_cuda.launch_count == before  # the CPU runs the plain version


# --- the host half -----------------------------------------------------------


def _write_video(path, n_frames=12, size=(96, 96)):
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, size)
    r = np.random.default_rng(7)
    for _ in range(n_frames):
        writer.write(r.integers(0, 256, (size[1], size[0], 3), np.uint8))
    writer.release()
    return str(path)


@pytest.mark.parametrize("n_frames", [12, 40])
def test_full_frame_sequence_and_crop_match_jax(tmp_path, n_frames):
    video = _write_video(tmp_path / f"clip_0001-{n_frames:04d}.mp4", n_frames=n_frames)
    ours, theirs = plip.LipRegionExtractor(backend="center"), jlip.LipRegionExtractor(backend="center")
    frames, boxes = ours.extract_full_frame_sequence(video)
    jframes, jboxes = theirs.extract_full_frame_sequence(video)
    assert frames.shape == (29, 96, 96, 3) and boxes.dtype == np.int32
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(boxes, jboxes)
    got = _port(frames, boxes)
    _differing_frames(got, np.asarray(jcrop.crop_resize_pad(jframes, jboxes)))
    # and the all-host cv2 path, within the crop's 1 LSB envelope
    host = ours.extract_lip_sequence(video)
    np.testing.assert_array_equal(host, theirs.extract_lip_sequence(video))
    assert np.abs(got.astype(int) - host.astype(int)).max() <= 1


def test_failed_detections_give_blank_frames(tmp_path):
    class NeverDetect:
        def lip_box(self, frame_rgb):
            return None

    video = _write_video(tmp_path / "clip_0001-0002.mp4", n_frames=5)
    ex = plip.LipRegionExtractor(backend="center")
    ex.backend = NeverDetect()
    frames, boxes = ex.extract_full_frame_sequence(video)
    assert (boxes == 0).all()
    assert (_port(frames, boxes) == 0).all() and (ex.extract_lip_sequence(video) == 0).all()


def test_resize_and_pad_matches_jax():
    frames, boxes = _random_frames_boxes(16, seed=8)
    for f, (x0, y0, x1, y1) in zip(frames, boxes):
        crop = f[y0:y1, x0:x1]
        for mode in ("average", "zeros"):
            np.testing.assert_array_equal(plip.resize_and_pad(crop, padding_mode=mode),
                                          jlip.resize_and_pad(crop, padding_mode=mode))
    assert (plip.resize_and_pad(None) == 0).all()


@pytest.mark.parametrize("backend", ["center", "auto"])
def test_process_dataset_matches_jax(tmp_path, backend):
    for root in ("ours", "theirs"):
        d = tmp_path / root / "lipread_files" / "abend" / "train"
        d.mkdir(parents=True)
        _write_video(d / "abend_0000-0001.mp4", n_frames=8)
    assert plip.process_dataset(str(tmp_path / "ours"), backend=backend) == (1, 0)
    assert jlip.process_dataset(str(tmp_path / "theirs"), backend=backend) == (1, 0)
    rel = "lipread_files/abend/train/abend_0000-0001.npy"
    np.testing.assert_array_equal(np.load(tmp_path / "ours_lip_regions" / rel),
                                  np.load(tmp_path / "theirs_lip_regions" / rel))
