"""Frame extraction for cue generation: 3 evenly spaced JPEGs per video
(counterpart of the JAX package's ``data/frame_extraction.py``).

Writes ``<out_dir>/<split>/<word>/<stem>_frame{K}.jpg`` for each ``.mp4``
under the GLips tree, K from 1, at frame indices ``int(i * total /
num_frames)``: the reference's selection and names, so trees extracted by
either interleave.

    python -m multimodal_lipread_torch.data.frame_extraction --root <GLips root> --out <dir> [--num-frames 3]
"""

from __future__ import annotations

import os
from typing import Tuple

from multimodal_lipread_torch.data.glips import SPLITS, lipread_files_dir


def extract_frames_from_video(video_path: str, out_dir: str, stem: str, num_frames: int = 3) -> int:
    """Write ``num_frames`` JPEGs of ``video_path`` into ``out_dir``; returns
    how many were written (0 for a video with no frames)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if total <= 0:
        cap.release()
        return 0
    idxs = [int(i * total / num_frames) for i in range(num_frames)]
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for k, idx in enumerate(idxs):
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
        ok, frame = cap.read()
        if not ok:
            continue
        cv2.imwrite(os.path.join(out_dir, f"{stem}_frame{k + 1}.jpg"), frame)
        written += 1
    cap.release()
    return written


def extract_dataset_frames(root_dir: str, out_root: str, num_frames: int = 3) -> Tuple[int, int]:
    """Walk the GLips tree and write JPEG frames grouped by split and word;
    returns ``(videos processed, frames written)``."""
    base = lipread_files_dir(root_dir)
    n_videos = n_frames = 0
    for word in sorted(os.listdir(base)):
        wdir = os.path.join(base, word)
        if not os.path.isdir(wdir):
            continue
        for split in SPLITS:
            sdir = os.path.join(wdir, split)
            if not os.path.isdir(sdir):
                continue
            for name in sorted(os.listdir(sdir)):
                if not name.lower().endswith(".mp4"):
                    continue
                n_frames += extract_frames_from_video(
                    os.path.join(sdir, name), os.path.join(out_root, split, word), os.path.splitext(name)[0],
                    num_frames,
                )
                n_videos += 1
    return n_videos, n_frames


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Extract JPEG frames for cue generation")
    parser.add_argument("--root", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--num-frames", type=int, default=3)
    args = parser.parse_args(argv)
    nv, nf = extract_dataset_frames(args.root, args.out, args.num_frames)
    print(f"Extracted {nf} frames from {nv} videos → {args.out}")


if __name__ == "__main__":
    main()
