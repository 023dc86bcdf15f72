"""The port's ffmpeg decode (``data/audio_io.py``) and WAV mirror
(``tools/transcode.py``) against the JAX package's, on the CPU.

This image has no ffmpeg, so a stand-in ``ffmpeg`` executable goes on
``PATH`` for these tests only. It records its argv, and:

- for ``-f s16le ... -`` it writes little-endian int16 samples to stdout,
  drawn from a seed that the input's file name and the ``-ar`` rate fix;
- for a ``.wav`` target it writes the same samples as a mono PCM16 WAV at
  the ``-ar`` rate (what ``tools/transcode.py`` asks for);
- for an input whose name holds ``corrupt`` it fails with exit code 1.

Held: both packages' ``load_waveform`` decode an ``.m4a`` and a 22.05 kHz
WAV bit for bit alike with the same command lines; both raise without
ffmpeg; ``ensure_wav_mirror`` makes the JAX package's tree, skips current
files, and raises on a failed clip in both; the mirror's WAV decodes to
what the ``.m4a`` decodes to."""

import json
import os
import stat
import sys
import time

import numpy as np
import pytest

from multimodal_lipread_tpu.data import audio_io as jaudio_io
from multimodal_lipread_tpu.data.glips import ClipEntry as JClipEntry
from multimodal_lipread_tpu.tools import transcode as jtranscode

from multimodal_lipread_torch.data import audio_io
from multimodal_lipread_torch.data.glips import ClipEntry
from multimodal_lipread_torch.tools import transcode

STUB = '''#!{python}
import json, sys, wave, zlib
import numpy as np
argv = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(argv) + "\\n")
src = argv[argv.index("-i") + 1]
if "corrupt" in src:
    sys.exit(1)
rate = int(argv[argv.index("-ar") + 1])
name = src.rsplit("/", 1)[-1].encode()
rng = np.random.default_rng(zlib.crc32(name) + rate)
pcm = rng.integers(-30000, 30000, rng.integers(15000, 25000)).astype("<i2")
if argv[-1] == "-":
    sys.stdout.buffer.write(pcm.tobytes())
else:
    with wave.open(argv[-1], "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
'''


@pytest.fixture
def ffmpeg_stub(tmp_path, monkeypatch):
    """The stand-in ffmpeg on PATH; yields the file of its argv, one JSON list a call."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "ffmpeg_argv.jsonl"
    exe = bin_dir / "ffmpeg"
    exe.write_text(STUB.format(python=sys.executable, log=str(log)))
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    yield log


def _calls(log) -> list:
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return [json.loads(line) for line in f]


def _clip(tmp_path, kind: str) -> str:
    """An .m4a (its bytes are never read) or a 22.05 kHz PCM16 WAV."""
    path = str(tmp_path / "clips" / f"clip_{kind}.{'m4a' if kind == 'm4a' else 'wav'}")
    if kind == "m4a":
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(b"not audio")
    else:
        wave = np.random.default_rng(5).integers(-20000, 20000, 27000).astype(np.float32)
        audio_io.write_wav(path, wave, sample_rate=22050)
    return path


@pytest.mark.parametrize("kind", ["m4a", "wav22k"])
def test_load_waveform_through_ffmpeg_equals_jax(tmp_path, ffmpeg_stub, kind):
    path = _clip(tmp_path, kind)
    ours = audio_io.load_waveform(path)
    calls = _calls(ffmpeg_stub)
    theirs = jaudio_io.load_waveform(path)
    assert ours.dtype == np.float32 and ours.shape == (20000,)
    np.testing.assert_array_equal(ours, theirs)
    assert len(calls) == 1 and _calls(ffmpeg_stub) == calls * 2
    assert calls[0] == ["-v", "error", "-i", path, "-f", "s16le", "-acodec", "pcm_s16le", "-ac", "1", "-ar",
                        "16000", "-"]
    assert ours.any() and np.array_equal(ours, np.round(ours))


@pytest.mark.parametrize("kind", ["m4a", "wav22k"])
def test_load_waveform_without_ffmpeg_raises_as_jax(tmp_path, monkeypatch, kind):
    path = _clip(tmp_path, kind)
    monkeypatch.setenv("PATH", str(tmp_path / "no_tools"))
    for load in (audio_io.load_waveform, jaudio_io.load_waveform):
        with pytest.raises(RuntimeError, match="ffmpeg"):
            load(path)


def _entries(tmp_path, cls) -> list:
    """Two .m4a clips, one of them also as .flac (the first source wins),
    and one WAV that passes through."""
    root = tmp_path / "GLips"
    out = []
    for word, split, name in (("abend", "train", "a_00001.m4a"), ("abend", "train", "a_00001.flac"),
                              ("dabei", "val", "d_00002.m4a"), ("dabei", "val", "d_00003.wav")):
        path = root / word / split / name
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.exists():
            pass
        elif name.endswith(".wav"):
            audio_io.write_wav(str(path), np.arange(100, dtype=np.float32))
        else:
            path.write_bytes(b"not audio")
        out.append(cls(word=word, split=split, sequence_id=name[2:7], path=str(path)))
    return out


def _tree(root) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), root)] = f.read()
    return out


def test_ensure_wav_mirror_makes_the_jax_tree(tmp_path, ffmpeg_stub):
    ours = transcode.ensure_wav_mirror(_entries(tmp_path, ClipEntry), str(tmp_path / "ours"), workers=2)
    calls = len(_calls(ffmpeg_stub))
    theirs = jtranscode.ensure_wav_mirror(_entries(tmp_path, JClipEntry), str(tmp_path / "theirs"), workers=2)
    assert calls == 2 and len(_calls(ffmpeg_stub)) == 4
    assert [os.path.relpath(e.path, tmp_path / "ours") for e in ours[:3]] == \
        [os.path.relpath(e.path, tmp_path / "theirs") for e in theirs[:3]] == \
        ["abend/train/a_00001.wav"] * 2 + ["dabei/val/d_00002.wav"]
    assert ours[3].path == theirs[3].path and ours[3].path.endswith("d_00003.wav")
    assert _tree(tmp_path / "ours") == _tree(tmp_path / "theirs") and len(_tree(tmp_path / "ours")) == 2
    # the mirror holds what the per-clip ffmpeg decode gives
    np.testing.assert_array_equal(audio_io.load_waveform(ours[2].path),
                                  audio_io.load_waveform(_entries(tmp_path, ClipEntry)[2].path))
    # current files are skipped; a source newer than its WAV is transcoded again
    n = len(_calls(ffmpeg_stub))
    transcode.ensure_wav_mirror(_entries(tmp_path, ClipEntry), str(tmp_path / "ours"), workers=2)
    assert len(_calls(ffmpeg_stub)) == n
    later = time.time() + 10
    os.utime(_entries(tmp_path, ClipEntry)[2].path, (later, later))
    transcode.ensure_wav_mirror(_entries(tmp_path, ClipEntry), str(tmp_path / "ours"), workers=2)
    assert _calls(ffmpeg_stub)[n:] == [["-v", "error", "-y", "-i", _entries(tmp_path, ClipEntry)[2].path, "-acodec",
                                        "pcm_s16le", "-ac", "1", "-ar", "16000", _calls(ffmpeg_stub)[n][-1]]]
    assert ".tmp." in _calls(ffmpeg_stub)[n][-1] and _calls(ffmpeg_stub)[n][-1].endswith(".wav")


def test_ensure_wav_mirror_raises_on_a_failed_clip_as_jax(tmp_path, ffmpeg_stub):
    for cls, mirror, tmod in ((ClipEntry, "ours", transcode), (JClipEntry, "theirs", jtranscode)):
        entries = _entries(tmp_path, cls)
        bad = tmp_path / "GLips" / "dabei" / "val" / "corrupt_00004.m4a"
        bad.write_bytes(b"")
        entries.append(cls(word="dabei", split="val", sequence_id="00004", path=str(bad)))
        with pytest.raises(RuntimeError, match="transcoding failed for 1 clips"):
            tmod.ensure_wav_mirror(entries, str(tmp_path / mirror), workers=2)
        assert not [n for n in _tree(tmp_path / mirror) if ".tmp." in n]


def test_transcode_cli_writes_the_jax_tree(tmp_path, ffmpeg_stub, capsys):
    _entries(tmp_path, ClipEntry)
    src = str(tmp_path / "GLips")
    transcode.main(["--src", src, "--dst", str(tmp_path / "ours"), "--workers", "2"])
    assert capsys.readouterr().out.startswith("transcoded 2, up-to-date 1, failed 0")
    jtranscode.main(["--src", src, "--dst", str(tmp_path / "theirs"), "--workers", "2"])
    assert _tree(tmp_path / "ours") == _tree(tmp_path / "theirs")
