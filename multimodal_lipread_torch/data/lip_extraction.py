"""Lip extraction on the host: videos → (29, 44, 44, 3) uint8 lip tensors
(counterpart of the JAX package's ``data/lip_extraction.py``; numpy and
OpenCV, which is imported inside the functions that use it).

The reference's contract (video/data_utils/visual_preprocessing.py:21-279):
29 evenly spaced frames (the last one repeated when the video is shorter),
per frame a lip box with a 40 % margin, an aspect-preserving resize and an
average-colour pad to 44 × 44, a blank frame where detection fails or a
frame cannot be read. Three uses:

- ``process_dataset`` / the CLI write the ``.npy`` mirror tree
  ``<root>_lip_regions`` that the video pipelines load::

      python -m multimodal_lipread_torch.data.lip_extraction --root <GLips root> [--backend center]

- ``extract_lip_sequence`` crops on the host per clip
  (``dataset.host_crop_streaming``);
- ``extract_full_frame_sequence`` decodes and detects only, and leaves the
  crop to the device (``dataset.device_crop``: ``ops/crop_resize_cuda.py``).

Landmark backends, the best available first under ``auto``: ``mediapipe``
(FaceMesh with the reference's 22 lip landmarks), ``haar`` (OpenCV's
frontal-face cascade; the mouth box from the face box's lower third and
central half) and ``center`` (a fixed lower-middle box).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from multimodal_lipread_torch.data.glips import lip_regions_root

# the reference's lip landmarks (visual_preprocessing.py:54-57)
LIP_LANDMARK_INDICES = [
    61, 146, 91, 181, 84, 17, 314, 405, 321, 375, 291,  # outer
    78, 95, 88, 178, 87, 14, 317, 402, 318, 324, 308,   # inner
]

MARGIN = 0.4
TARGET_SIZE = (44, 44)
NUM_FRAMES = 29


def resize_and_pad(image: Optional[np.ndarray], target_size: Tuple[int, int] = TARGET_SIZE,
                   padding_mode: str = "average") -> np.ndarray:
    """Aspect-preserving ``cv2.resize`` and centred padding, with the mean
    colour of the resized image (``average``) or zeros
    (visual_preprocessing.py:111-162); an empty image gives a blank frame."""
    th, tw = target_size
    if image is None or image.size == 0:
        return np.zeros((th, tw, 3), dtype=np.uint8)
    import cv2

    h, w = image.shape[:2]
    aspect = w / h
    if aspect > tw / th:
        new_w, new_h = tw, int(tw / aspect)
    else:
        new_h, new_w = th, int(th * aspect)
    new_w, new_h = max(new_w, 1), max(new_h, 1)
    resized = cv2.resize(image, (new_w, new_h))
    if padding_mode == "average":
        canvas = np.full((th, tw, 3), np.mean(resized, axis=(0, 1)).astype(np.uint8), dtype=np.uint8)
    else:
        canvas = np.zeros((th, tw, 3), dtype=np.uint8)
    ph, pw = (th - new_h) // 2, (tw - new_w) // 2
    canvas[ph : ph + new_h, pw : pw + new_w] = resized
    return canvas


def _expand_box(x_min, y_min, x_max, y_max, frame_h, frame_w, margin=MARGIN):
    """40 % margin around a lip box, clipped to the frame; the margins
    truncate as ``int()`` does (visual_preprocessing.py:92-103)."""
    h, w = y_max - y_min, x_max - x_min
    mh, mw = int(h * margin), int(w * margin)
    return max(0, x_min - mw), max(0, y_min - mh), min(frame_w, x_max + mw), min(frame_h, y_max + mh)


class _MediaPipeBackend:
    def __init__(self):
        import mediapipe as mp

        self.face_mesh = mp.solutions.face_mesh.FaceMesh(
            static_image_mode=False, max_num_faces=1, min_detection_confidence=0.5, min_tracking_confidence=0.5,
        )

    def lip_box(self, frame_rgb: np.ndarray):
        results = self.face_mesh.process(frame_rgb)
        if not results.multi_face_landmarks:
            return None
        h, w = frame_rgb.shape[:2]
        pts = [(int(lm.x * w), int(lm.y * h))
               for i, lm in enumerate(results.multi_face_landmarks[0].landmark) if i in LIP_LANDMARK_INDICES]
        xs, ys = [p[0] for p in pts], [p[1] for p in pts]
        return _expand_box(min(xs), min(ys), max(xs), max(ys), h, w)


class _HaarBackend:
    def __init__(self):
        import cv2

        self.cascade = cv2.CascadeClassifier(os.path.join(cv2.data.haarcascades,
                                                          "haarcascade_frontalface_default.xml"))
        if self.cascade.empty():
            raise RuntimeError("Haar cascade unavailable")

    def lip_box(self, frame_rgb: np.ndarray):
        import cv2

        faces = self.cascade.detectMultiScale(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2GRAY), 1.1, 4)
        if len(faces) == 0:
            return None
        x, y, w, h = max(faces, key=lambda f: f[2] * f[3])
        fh, fw = frame_rgb.shape[:2]
        # the mouth: the central half across, the lower third down
        return _expand_box(x + w // 4, y + 2 * h // 3, x + 3 * w // 4, y + h, fh, fw)


class _CenterBackend:
    def lip_box(self, frame_rgb: np.ndarray):
        h, w = frame_rgb.shape[:2]
        return _expand_box(w // 3, h // 2, 2 * w // 3, 5 * h // 6, h, w)


def _make_backend(name: str):
    if name == "mediapipe":
        return _MediaPipeBackend()
    if name == "haar":
        return _HaarBackend()
    if name == "center":
        return _CenterBackend()
    raise ValueError(f"Unknown landmark backend: {name}")


def _frame_indices(total: int, num_frames: int) -> np.ndarray:
    """29 evenly spaced frame indices, the last repeated for a short video."""
    if total <= num_frames:
        return np.concatenate([np.arange(total), np.full(num_frames - total, total - 1)])
    return np.linspace(0, total - 1, num_frames).astype(int)


class LipRegionExtractor:
    """Video → (num_frames, 44, 44, 3) uint8 lip-region sequence. ``auto``
    takes the first backend that builds: mediapipe, haar, center."""

    def __init__(self, target_size: Tuple[int, int] = TARGET_SIZE, padding_mode: str = "average",
                 backend: str = "auto"):
        self.target_size = target_size
        self.padding_mode = padding_mode
        if backend == "auto":
            for name in ("mediapipe", "haar", "center"):
                try:
                    self.backend = _make_backend(name)
                except (ImportError, RuntimeError, AttributeError):
                    continue
                self.backend_name = name
                break
        else:
            self.backend = _make_backend(backend)
            self.backend_name = backend

    def extract_lip_region(self, frame_rgb: np.ndarray) -> Optional[np.ndarray]:
        box = self.backend.lip_box(frame_rgb)
        if box is None:
            return None
        x_min, y_min, x_max, y_max = box
        return resize_and_pad(frame_rgb[y_min:y_max, x_min:x_max], self.target_size, self.padding_mode)

    def extract_lip_sequence(self, video_path: str, num_frames: int = NUM_FRAMES) -> np.ndarray:
        """Decode, detect and crop on the host (visual_preprocessing.py:164-211);
        blank frames where a frame cannot be read or no lips are found."""
        import cv2

        cap = cv2.VideoCapture(video_path)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        th, tw = self.target_size
        if total <= 0:
            cap.release()
            return np.zeros((num_frames, th, tw, 3), dtype=np.uint8)
        seq: List[np.ndarray] = []
        for idx in _frame_indices(total, num_frames):
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            ok, frame_bgr = cap.read()
            region = self.extract_lip_region(cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)) if ok else None
            seq.append(region if region is not None else np.zeros((th, tw, 3), dtype=np.uint8))
        cap.release()
        return np.asarray(seq, dtype=np.uint8)

    def extract_full_frame_sequence(self, video_path: str,
                                    num_frames: int = NUM_FRAMES) -> Tuple[np.ndarray, np.ndarray]:
        """Decode and detect only, the device crop's host half: uint8 frames
        (num_frames, H, W, 3) and int32 margin-expanded boxes (num_frames,
        4), the frames and boxes of :meth:`extract_lip_sequence` uncropped.
        A frame that cannot be read, or decodes at another size than the
        first decoded frame, and a failed detection carry the box (0, 0, 0,
        0), which the device crop turns into a blank frame."""
        import cv2

        cap = cv2.VideoCapture(video_path)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if total <= 0:
            cap.release()
            return np.zeros((num_frames, 1, 1, 3), np.uint8), np.zeros((num_frames, 4), np.int32)
        frames = boxes = None
        for k, idx in enumerate(_frame_indices(total, num_frames)):
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            ok, frame_bgr = cap.read()
            if not ok:
                continue
            frame_rgb = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
            if frames is None:  # the size of the first decoded frame, not the header's
                frames = np.zeros((num_frames,) + frame_rgb.shape, np.uint8)
                boxes = np.zeros((num_frames, 4), np.int32)
            if frame_rgb.shape != frames.shape[1:]:
                continue
            frames[k] = frame_rgb
            box = self.backend.lip_box(frame_rgb)
            if box is not None:
                boxes[k] = box
        cap.release()
        if frames is None:
            return np.zeros((num_frames, 1, 1, 3), np.uint8), np.zeros((num_frames, 4), np.int32)
        return frames, boxes


def process_dataset(root_dir: str, output_root: Optional[str] = None, backend: str = "auto",
                    padding_mode: str = "average", num_frames: int = NUM_FRAMES,
                    overwrite: bool = False) -> Tuple[int, int]:
    """Every ``.mp4`` under ``root_dir`` → its ``.npy`` in the mirror tree
    (visual_preprocessing.py:220-279); existing files are kept unless
    ``overwrite``. Returns (processed, failed); a failure is printed and
    the walk goes on, as in the reference."""
    if output_root is None:
        output_root = lip_regions_root(root_dir)
    extractor = LipRegionExtractor(padding_mode=padding_mode, backend=backend)
    processed = failed = 0
    for dirpath, _dirs, files in os.walk(root_dir):
        for name in sorted(files):
            if not name.lower().endswith(".mp4"):
                continue
            src = os.path.join(dirpath, name)
            dst = os.path.join(output_root, os.path.splitext(os.path.relpath(src, root_dir))[0] + ".npy")
            if os.path.exists(dst) and not overwrite:
                continue
            try:
                seq = extractor.extract_lip_sequence(src, num_frames=num_frames)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                np.save(dst, seq)
                processed += 1
            except Exception as e:  # noqa: BLE001 — one bad video must not stop the walk
                print(f"Failed on {src}: {e}")
                failed += 1
    return processed, failed


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Extract lip regions to a .npy mirror tree")
    parser.add_argument("--config", required=False)
    parser.add_argument("--root", required=False, help="GLips root (overrides the config's dataset.root_dir)")
    parser.add_argument("--backend", default="auto", choices=["auto", "mediapipe", "haar", "center"])
    parser.add_argument("--overwrite", action="store_true")
    args = parser.parse_args(argv)
    root, padding = args.root, "average"
    if args.config:
        from multimodal_lipread_torch.config import load_config

        cfg = load_config(args.config)
        root = root or cfg.get("dataset.root_dir")
        padding = cfg.get("preprocessing.padding_mode", "average")
    if not root:
        parser.error("--root or --config with dataset.root_dir required")
    n_ok, n_fail = process_dataset(root, backend=args.backend, padding_mode=padding, overwrite=args.overwrite)
    print(f"Processed {n_ok} videos ({n_fail} failures) → {lip_regions_root(root)}")


if __name__ == "__main__":
    main()
