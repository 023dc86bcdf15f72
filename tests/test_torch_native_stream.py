"""The port's native streaming path (``data/native_io.py``'s
``load_npy_u8_batch`` and ``NativePrefetcher``, ``data/grain_loader.
NativeStreamingDataset``, the audio pipeline's ``loader_backend: native``)
against the JAX package's and ``np.load``, on the CPU:

- the loaders give the bytes ``np.load`` gives, as the JAX binding does;
- ``NativeStreamingDataset`` yields the JAX one's order, labels and
  batches over epochs 0–2, shuffled and not, in each of 2 shards;
- ``wire_dtype: int16`` is exact on PCM16, and a stereo clip whose channel
  mean is not integral raises, naming the clip (the JAX dataset truncates
  it); a corrupt ``.npy`` raises, naming the file;
- ``pipelines.audio.main`` with ``loader_backend: native`` and the int16
  wire trains and evaluates to the grain backend's losses. The video
  pipeline's native branch is held to grain in
  ``tests/test_torch_video_pipeline.py::test_main_refuses_what_is_not_ported``."""

import os
import wave

import numpy as np
import pytest

from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)

from multimodal_lipread_tpu.data import native_io as jnative_io
from multimodal_lipread_tpu.data.glips import scan_glips as jscan_glips
from multimodal_lipread_tpu.data.glips import scan_lip_regions as jscan_lip_regions
from multimodal_lipread_tpu.data.grain_loader import NativeStreamingDataset as JNativeStreamingDataset

from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data import native_io
from multimodal_lipread_torch.data.glips import ClipEntry, lip_regions_root, scan_glips, scan_lip_regions
from multimodal_lipread_torch.data.grain_loader import NativeStreamingDataset
from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
from multimodal_lipread_torch.pipelines import audio as paudio_pipeline

LIPS = (29, 44, 44, 3)


def _lip_paths(glips_root, split="train"):
    return [e.path for e in scan_lip_regions(lip_regions_root(glips_root)).by_split(split)]


def test_load_npy_u8_batch_equals_np_load_and_jax(glips_root):
    paths = _lip_paths(glips_root)
    want = np.stack([np.load(p) for p in paths])
    raw, failed = native_io.load_npy_u8_batch(paths, LIPS, scale=1.0)
    assert failed == -1 and raw.dtype == np.float32 and raw.shape == (len(paths),) + LIPS
    np.testing.assert_array_equal(raw.astype(np.uint8), want)
    scaled, failed = native_io.load_npy_u8_batch(paths, LIPS)
    assert failed == -1
    np.testing.assert_array_equal(scaled, jnative_io.load_npy_u8_batch(paths, LIPS))


def test_load_npy_u8_batch_names_the_file_it_refuses(glips_root, tmp_path):
    paths = _lip_paths(glips_root)[:3]
    np.save(tmp_path / "float.npy", np.zeros(LIPS, np.float32))
    np.save(tmp_path / "short.npy", np.zeros((3, 44, 44, 3), np.uint8))
    for bad in ("float.npy", "short.npy"):
        out, failed = native_io.load_npy_u8_batch(paths[:1] + [str(tmp_path / bad)] + paths[1:], LIPS, 1.0)
        assert failed == 1 and not out[1].any()
        np.testing.assert_array_equal(out[2].astype(np.uint8), np.load(paths[1]))


@pytest.mark.parametrize("kind", ["npy_u8", "wav"])
def test_prefetcher_equals_jax_and_np_load(glips_root, kind):
    if kind == "npy_u8":
        paths, shape = _lip_paths(glips_root), LIPS
    else:
        paths, shape = [e.path for e in scan_glips(glips_root).by_split("train")], (20000,)
    order = np.random.default_rng(3).permutation(len(paths))
    got, want = [], []
    for cls, out in ((native_io.NativePrefetcher, got), (jnative_io.NativePrefetcher, want)):
        pf = cls(paths, kind, shape, n_threads=3, capacity=4)
        for _ in range(2):  # a second epoch on the same prefetcher
            pf.start_epoch(order)
            while (batch := pf.next_batch(5)) is not None:
                out.append(batch)
            assert pf.first_error == -1
        pf.close()
    assert [b.shape[0] for b in got] == [b.shape[0] for b in want]
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    if kind == "npy_u8":
        assert got[0].dtype == np.uint8
        np.testing.assert_array_equal(np.concatenate(got)[: len(paths)], np.stack([np.load(paths[i]) for i in order]))
    with pytest.raises(RuntimeError, match="closed"):
        pf_closed = native_io.NativePrefetcher(paths, kind, shape, n_threads=1)
        pf_closed.close()
        pf_closed.next_batch(1)


def test_prefetcher_refuses_an_order_outside_its_files(glips_root):
    paths = _lip_paths(glips_root)
    pf = native_io.NativePrefetcher(paths, "npy_u8", LIPS, n_threads=1)
    with pytest.raises(ValueError, match="must be in"):
        pf.start_epoch(np.array([0, len(paths)]))
    pf.close()


@pytest.mark.parametrize("kind", ["wav", "npy_u8"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
def test_native_streaming_dataset_equals_jax(glips_root, kind, shuffle):
    if kind == "wav":
        ours_index, theirs_index, shape = scan_glips(glips_root), jscan_glips(glips_root), (20000,)
    else:
        ours_index = scan_lip_regions(lip_regions_root(glips_root))
        theirs_index = jscan_lip_regions(lip_regions_root(glips_root))
        shape = LIPS
    for shard in (0, 1):
        ours = NativeStreamingDataset(ours_index.by_split("train"), ours_index.class_to_idx, kind, shape, seed=7,
                                      n_threads=2, shard_index=shard, shard_count=2)
        theirs = JNativeStreamingDataset(theirs_index.by_split("train"), theirs_index.class_to_idx, kind, shape,
                                         seed=7, n_threads=2, shard_index=shard, shard_count=2)
        assert len(ours) == len(theirs) and ours.global_batches(3) == theirs.global_batches(3)
        for a, b in zip(ours.example_inputs(2), theirs.example_inputs(2)):
            assert a.shape == b.shape and a.dtype == b.dtype
        for epoch in range(3):
            got = list(ours.epoch_batches(epoch, shuffle, 3))
            want = list(theirs.epoch_batches(epoch, shuffle, 3))
            assert len(got) == len(want) > 1
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gy, wy)
                np.testing.assert_array_equal(gx[0], wx[0])
        ours.close()
        theirs.close()


def test_int16_wire_is_exact_on_pcm16(glips_root):
    index = scan_glips(glips_root)
    entries = index.by_split("val")
    f32 = NativeStreamingDataset(entries, index.class_to_idx, "wav", (20000,), n_threads=2)
    i16 = NativeStreamingDataset(entries, index.class_to_idx, "wav", (20000,), n_threads=2, wire_dtype="int16")
    assert i16.example_inputs(2)[0].dtype == np.int16
    (a,), la = next(f32.epoch_batches(0, True, 16))
    (b,), lb = next(i16.epoch_batches(0, True, 16))
    assert b.dtype == np.int16 and a.dtype == np.float32 and a.any()
    np.testing.assert_array_equal(b.astype(np.float32), a)
    np.testing.assert_array_equal(la, lb)
    with pytest.raises(ValueError, match="only applies"):
        NativeStreamingDataset(entries, index.class_to_idx, "npy_u8", LIPS, wire_dtype="int16")


def test_int16_wire_names_a_stereo_clip_it_cannot_carry(glips_root, tmp_path):
    index = scan_glips(glips_root)
    entries = index.by_split("val")[:3]
    stereo = str(tmp_path / "abend" / "val" / "stereo_00001.wav")
    os.makedirs(os.path.dirname(stereo))
    frames = np.zeros((20000, 2), "<i2")
    frames[:, 0] = np.arange(20000) % 7  # channel means of x.5
    with wave.open(stereo, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(frames.tobytes())
    entries = entries[:1] + [ClipEntry("abend", "val", "00001", stereo)] + entries[1:]
    f32 = NativeStreamingDataset(entries, index.class_to_idx, "wav", (20000,), n_threads=2)
    (x,), _ = next(f32.epoch_batches(0, False, 4))
    np.testing.assert_array_equal(x[1], (np.arange(20000) % 7) / 2.0)  # the float wire carries it
    i16 = NativeStreamingDataset(entries, index.class_to_idx, "wav", (20000,), n_threads=2, wire_dtype="int16")
    with pytest.raises(ValueError, match="stereo_00001.wav has samples that are not integral"):
        next(i16.epoch_batches(0, False, 4))


def test_a_corrupt_npy_raises_naming_the_file(glips_root, tmp_path):
    index = scan_lip_regions(lip_regions_root(glips_root))
    entries = index.by_split("test")[:3]
    bad = tmp_path / "bad_00009.npy"
    bad.write_bytes(b"\x93NUMPY garbage")
    entries = entries + [ClipEntry(entries[0].word, "test", "00009", str(bad))]
    ds = NativeStreamingDataset(entries, index.class_to_idx, "npy_u8", LIPS, n_threads=2)
    with pytest.raises(RuntimeError, match="could not read .*bad_00009.npy"):
        list(ds.epoch_batches(0, False, 2))


def test_native_backend_refuses_clips_that_are_not_wav(glips_root):
    index = scan_glips(glips_root)
    entries = [ClipEntry(e.word, e.split, e.sequence_id, e.path[:-4] + ".m4a") for e in index.by_split("val")]
    with pytest.raises(ValueError, match="non-WAV clips"):
        NativeStreamingDataset(entries, index.class_to_idx, "wav", (20000,))


def test_audio_pipeline_native_backend_trains_to_the_grain_losses(tmp_path):
    root = make_synthetic_glips(str(tmp_path / "GLips_4"), clips_per_split=2, seed=5)
    history = {}
    for backend, extra in (("grain", {}), ("native", {"wire_dtype": "int16", "num_workers": 2})):
        cfg = Config.from_dict({
            "dataset": {"root_dir": root, "num_classes": 4, "input_size": 117, "streaming": True,
                        "loader_backend": backend, **extra},
            "model": {"name": "vgg_lstm", "version": 11},
            "training": {"batch_size": 4, "epochs": 1, "learning_rate": 1e-3, "seed": 0},
            "output": {"base_dir": str(tmp_path / backend), "plots": False},
        })
        history[backend] = paudio_pipeline.main(cfg, device="cpu")["history"][0]
    for k in ("train_loss", "val_loss", "test_loss", "train_acc", "val_acc"):
        np.testing.assert_allclose(history["native"][k], history["grain"][k], rtol=1e-6, err_msg=k)
