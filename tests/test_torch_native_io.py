"""The port's native WAV decoder (``data/native_io.py`` over the repo's
``native/mlt_io.cpp``) against the JAX package's binding and the Python
decoder, its build into ``build/``, and the per-file dispatch of
``pipelines.common.decode_waveforms``."""

import os
import wave

import numpy as np
import pytest

from multimodal_lipread_tpu.data.native_io import load_wav_batch as jload_wav_batch

from multimodal_lipread_torch.data import audio_io, native_io
from multimodal_lipread_torch.data.glips import scan_glips
from multimodal_lipread_torch.pipelines.common import decode_waveforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")


def _clips(root, split="train"):
    return [e.path for e in scan_glips(root).by_split(split)]


def _write_raw_wav(path, frames: bytes, channels: int, width: int, rate: int = 16000):
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(frames)


def test_native_decode_is_bit_equal_to_jax_and_python(glips_root):
    clips = _clips(glips_root)
    got, failed = native_io.load_wav_batch(clips)
    assert failed == -1 and got.shape == (len(clips), 20000) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jload_wav_batch(clips))
    np.testing.assert_array_equal(got, np.stack([audio_io.load_waveform(p) for p in clips]))


@pytest.mark.parametrize("n", [100, 20000, 25000])
def test_native_decode_pads_and_truncates(tmp_path, n):
    wave_in = np.random.default_rng(n).integers(-30000, 30000, n).astype(np.float32)
    path = str(tmp_path / "a" / "x.wav")
    audio_io.write_wav(path, wave_in)
    got, failed = native_io.load_wav_batch([path])
    assert failed == -1
    np.testing.assert_array_equal(got[0], audio_io.load_waveform(path))


def _native_files():
    # libmlt_io.so is the JAX binding's own build output (git-ignored), which
    # its tests may rebuild in another worker meanwhile
    return {n: os.stat(os.path.join(NATIVE, n)).st_mtime_ns
            for n in os.listdir(NATIVE) if n != "libmlt_io.so"}


def test_native_library_is_built_into_build_and_native_is_untouched(tmp_path, monkeypatch):
    before = _native_files()
    # a fresh build directory, so the compiler really runs
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build" / "native")
    path = native_io.build()
    assert path.is_file() and path.parent == tmp_path / "build" / "native"
    assert path.name.startswith("libmlt_io-") and path.suffix == ".so"
    assert native_io.build() == path  # built once: the same content-keyed file
    assert _native_files() == before
    monkeypatch.undo()
    assert native_io.library_path().parent == native_io.REPO_DIR / "build" / "native"  # the default
    native_io.get_lib()
    assert native_io.library_path().is_file()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_io, "SOURCE", broken)
    monkeypatch.setattr(native_io, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        native_io.get_lib()
    assert not list((tmp_path / "build").glob("*.so"))  # nothing half-written is left
    with pytest.raises(RuntimeError, match="failed"):
        decode_waveforms([str(tmp_path / "x.wav")])  # no quiet switch to Python


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(OSError):
        native_io.build()


def test_decode_waveforms_sends_what_native_refuses_to_python(tmp_path, glips_root):
    rng = np.random.default_rng(3)
    good = _clips(glips_root, "val")[:3]
    eight_bit = str(tmp_path / "u8.wav")  # PCM 8-bit: the native decoder takes PCM16 only
    _write_raw_wav(eight_bit, rng.integers(0, 256, 9000, dtype=np.uint8).tobytes(), 1, 1)
    stereo = str(tmp_path / "stereo.wav")  # PCM16 stereo: native, mono-downmixed
    _write_raw_wav(stereo, rng.integers(-3000, 3000, 2 * 7000).astype("<i2").tobytes(), 2, 2)
    paths = [good[0], eight_bit, good[1], stereo, good[2]]
    _, failed = native_io.load_wav_batch(paths)
    assert failed == 1
    got = decode_waveforms(paths)
    want = np.stack([audio_io.load_waveform(p) for p in paths])
    np.testing.assert_array_equal(got[[0, 1, 2, 4]], want[[0, 1, 2, 4]])
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-3)  # integer vs float downmix
    assert np.abs(got[1]).max() > 0  # decoded by the Python path, not left as zeros


def test_decode_waveforms_stays_linear_with_many_refused_files(tmp_path, glips_root, monkeypatch):
    # One native pass whatever the number of refused files; the Python
    # decoder takes only the rows the native pass left zero.
    from multimodal_lipread_torch.pipelines import common

    rng = np.random.default_rng(4)
    good = _clips(glips_root, "val")[:3]
    refused = []
    for i in range(6):  # PCM 8-bit and 32-bit: the native decoder takes PCM16 only
        refused.append(str(tmp_path / f"r{i}.wav"))
        width = 1 if i % 2 else 4
        _write_raw_wav(refused[-1], rng.integers(0, 256, 6000 * width, dtype=np.uint8).tobytes(), 1, width)
    silent = str(tmp_path / "silent.wav")  # PCM16 all zeros: native takes it
    _write_raw_wav(silent, bytes(2 * 5000), 1, 2)
    paths = [refused[0], good[0], refused[1], refused[2], silent, good[1], refused[3], refused[4], good[2], refused[5]]
    calls = {"native": 0, "python": []}
    native = native_io.load_wav_batch
    python = common.load_waveform

    def count_native(batch, *a, **k):
        calls["native"] += 1
        return native(batch, *a, **k)

    def count_python(path, *a, **k):
        calls["python"].append(path)
        return python(path, *a, **k)

    monkeypatch.setattr(native_io, "load_wav_batch", count_native)
    monkeypatch.setattr(common, "load_waveform", count_python)
    got = decode_waveforms(paths)
    assert calls["native"] == 1
    assert sorted(calls["python"]) == sorted(refused + [silent])
    want = np.stack([audio_io.load_waveform(p) for p in paths])
    np.testing.assert_array_equal(got, want)
    assert all(np.abs(got[paths.index(p)]).max() > 0 for p in refused)
