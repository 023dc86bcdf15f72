"""Parallel m4a → WAV transcoding for the native streaming loader
(counterpart of the JAX package's ``tools/transcode.py``).

Real GLips ships ``.m4a`` audio. The native streaming prefetcher
(``native/mlt_io.cpp``, ``dataset.loader_backend: native``) reads PCM16 WAV
only, and decoding AAC with an ffmpeg subprocess per clip every epoch costs
far more than one transcode and a native WAV read. This tool builds the WAV
mirror tree once:

    <dst>/<word>/<split>/<clip>.wav   for every audio clip under <src>

with ``ffmpeg -acodec pcm_s16le -ac 1 -ar 16000``, the decode of
``data/audio_io._load_via_ffmpeg``, so the mirror holds the samples the
per-clip ffmpeg path gives. Up-to-date WAVs are skipped (size above a WAV
header, not older than the source) and each write is atomic (a temporary
file named by process and thread, then a rename), so an interrupted run
resumes.

    python -m multimodal_lipread_torch.tools.transcode --src <GLips root> --dst <mirror>

The audio pipeline calls :func:`ensure_wav_mirror` itself when
``dataset.loader_backend: native`` meets clips that are not WAV.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

from multimodal_lipread_torch.data.audio_io import SAMPLE_RATE, _ffmpeg_available

AUDIO_SRC_EXTS = (".m4a", ".mp4", ".aac", ".ogg", ".flac", ".mp3")


def _transcode_one(src: str, dst: str, sample_rate: int) -> bool:
    """ffmpeg decode → mono s16 PCM WAV at ``sample_rate``; atomic write."""
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    # process and thread in the name: two pool threads writing one dst never
    # share a temporary file; the .wav suffix picks ffmpeg's muxer
    tmp = f"{dst}.tmp.{os.getpid()}.{threading.get_ident()}.wav"
    cmd = [
        "ffmpeg", "-v", "error", "-y", "-i", src,
        "-acodec", "pcm_s16le", "-ac", "1", "-ar", str(sample_rate),
        tmp,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True)
        if proc.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, dst)
        return True
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _is_current(src: str, dst: str) -> bool:
    try:
        return os.path.getsize(dst) > 44 and os.path.getmtime(dst) >= os.path.getmtime(src)
    except OSError:
        return False


def transcode_paths(
    pairs: Sequence[Tuple[str, str]],
    sample_rate: int = SAMPLE_RATE,
    workers: int = 8,
) -> Tuple[int, int, List[str]]:
    """Transcode ``(src, dst)`` pairs in parallel → ``(done, skipped,
    failed sources)``. Each ffmpeg runs in its own process, so a thread
    pool keeps ``workers`` decoders busy."""
    # one transcode per dst (foo.m4a and foo.flac both map to foo.wav): the
    # first source in input order wins, and no two renames race
    seen = set()
    unique = []
    for s, d in pairs:
        if d not in seen:
            seen.add(d)
            unique.append((s, d))
    todo = [(s, d) for s, d in unique if not _is_current(s, d)]
    skipped = len(pairs) - len(todo)
    if todo and not _ffmpeg_available():
        raise RuntimeError(f"{len(todo)} clips need transcoding but ffmpeg is not installed")
    failed: List[str] = []
    if todo:
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            results = ex.map(lambda p: (p[0], _transcode_one(p[0], p[1], sample_rate)), todo)
            failed = [src for src, ok in results if not ok]
    return len(todo) - len(failed), skipped, failed


def ensure_wav_mirror(
    entries: Sequence,
    cache_root: str,
    sample_rate: int = SAMPLE_RATE,
    workers: int = 8,
) -> List:
    """``entries`` (``ClipEntry``-like: ``path``, ``word``, ``split``)
    rewritten onto a WAV mirror tree, transcoding what is missing or stale.

    WAV entries pass through unchanged; the others map to
    ``<cache_root>/<word>/<split>/<stem>.wav``. Raises on any failed clip:
    a zero-filled clip would train on silence."""
    out, pairs = [], []
    for e in entries:
        if e.path.lower().endswith(".wav"):
            out.append(e)
            continue
        stem = os.path.splitext(os.path.basename(e.path))[0]
        dst = os.path.join(cache_root, e.word, e.split, stem + ".wav")
        pairs.append((e.path, dst))
        out.append(dataclasses.replace(e, path=dst))
    _done, _skipped, failed = transcode_paths(pairs, sample_rate, workers)
    if failed:
        raise RuntimeError(f"transcoding failed for {len(failed)} clips (e.g. {failed[0]})")
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="GLips root (or lipread_files dir)")
    ap.add_argument("--dst", required=True, help="output WAV mirror root")
    ap.add_argument("--sample-rate", type=int, default=SAMPLE_RATE)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 8)
    args = ap.parse_args(argv)

    pairs = []
    for dirpath, _dirs, files in os.walk(args.src):
        for fname in sorted(files):
            if os.path.splitext(fname)[1].lower() in AUDIO_SRC_EXTS:
                src = os.path.join(dirpath, fname)
                rel = os.path.relpath(src, args.src)
                pairs.append((src, os.path.join(args.dst, os.path.splitext(rel)[0] + ".wav")))
    done, skipped, failed = transcode_paths(pairs, args.sample_rate, args.workers)
    print(f"transcoded {done}, up-to-date {skipped}, failed {len(failed)}")
    for f in failed[:10]:
        print(f"  FAILED {f}")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
