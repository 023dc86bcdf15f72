"""Textual-cue generation through a vision LLM, an external service
(counterpart of the JAX package's ``tools/cue_generation.py``; host-only
Python, the same behaviour).

Equivalent of ``cues/generate_all_cues.py`` (reference:
cues/generate_all_cues.py:25-190): for every (split x word x mode) it groups
the extracted JPEG frames by sequence id, sends up to 3 frames (base64) to a
vision model with a mode-specific prompt, and writes
``lipreading_analysis_results_{mode}_{word}_{split}.json`` records
``{word, sequence_id, description}`` (the cue store that
``data/cues.py`` reads).

Reliability machinery preserved from the reference:
- global rate limiter: one request per ``min_interval`` seconds across all
  worker threads (22 s mutex, generate_all_cues.py:46-59)
- up to 6 retries with 25 s backoff on rate-limit errors (:110-121)
- per-sequence error swallowing returning None (:120-124)
- ThreadPoolExecutor(2) (:145)
- interim JSON checkpoint every 10 results (:157-164)

The LLM client is injected (``client_factory``) so the pipeline is testable
offline; the default factory uses the ``openai`` package when installed.

    python -m multimodal_lipread_torch.tools.cue_generation --config configs/cues_config.yaml --words <word> ...
"""

from __future__ import annotations

import base64
import json
import os
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

# reference accepts any digit run (generate_all_cues.py:29 \d+-\d+); do
# not silently drop non-4-digit-padded sequence ids
SEQ_FRAME_RE = re.compile(r"(.+_\d+-\d+)_frame\d+\.jpg$")


def build_prompt(mode: str, word: str) -> str:
    """VERBATIM reference prompts (cues/generate_all_cues.py:68-71).

    The emotion prompt embeds the spoken word, so generated descriptions can
    leak it — exactly as the reference's do; that is what tools/data_clean.py
    exists to sanitize afterwards. Reproducing the prompt (leak included)
    keeps regenerated cue corpora distribution-compatible with the
    reference's committed cue datasets.
    """
    if mode == "emotion":
        return (
            "Describe the speaker\u2019s emotional cues from their facial "
            f"expressions and eye movement in these video frames of someone "
            f"pronouncing '{word}'."
        )
    return (
        "Describe the environment around the speaker, include information on "
        "light, background scene, place, etc."
    )


class RateLimiter:
    """Global min-interval gate shared by all worker threads
    (reference: generate_all_cues.py:46-59)."""

    def __init__(self, min_interval: float = 22.0):
        self.min_interval = min_interval
        self._lock = threading.Lock()
        self._last = 0.0

    def wait(self, sleep: Callable[[float], None] = time.sleep) -> None:
        with self._lock:
            now = time.monotonic()
            delta = now - self._last
            if delta < self.min_interval:
                sleep(self.min_interval - delta)
            self._last = time.monotonic()


def group_frames_by_sequence(frames_dir: str) -> Dict[str, List[str]]:
    """``<stem>_frameK.jpg`` files grouped by clip stem
    (reference: generate_all_cues.py:25-43)."""
    groups: Dict[str, List[str]] = {}
    if not os.path.isdir(frames_dir):
        return groups
    for name in sorted(os.listdir(frames_dir)):
        m = SEQ_FRAME_RE.match(name)
        if not m:
            continue
        groups.setdefault(m.group(1), []).append(os.path.join(frames_dir, name))
    return groups


def _default_client_factory(api_key: Optional[str]):
    from openai import OpenAI  # optional dependency, gated

    client = OpenAI(api_key=api_key)

    def complete(prompt: str, image_paths: Sequence[str]) -> str:
        content = [{"type": "text", "text": prompt}]
        for p in image_paths[:3]:
            with open(p, "rb") as f:
                b64 = base64.b64encode(f.read()).decode()
            content.append(
                {"type": "image_url", "image_url": {"url": f"data:image/jpeg;base64,{b64}"}}
            )
        resp = client.chat.completions.create(
            model="gpt-4.1",
            messages=[{"role": "user", "content": content}],
            max_tokens=500,
        )
        return resp.choices[0].message.content

    return complete


def generate_cues_for_word(
    frames_dir: str,
    out_path: str,
    word: str,
    mode: str = "emotion",
    api_key: Optional[str] = None,
    client: Optional[Callable[[str, Sequence[str]], str]] = None,
    rate_limiter: Optional[RateLimiter] = None,
    max_retries: int = 6,
    retry_backoff: float = 25.0,
    checkpoint_every: int = 10,
    max_workers: int = 2,
    sleep: Callable[[float], None] = time.sleep,
) -> List[dict]:
    """Generate cue descriptions for every sequence of one (word, split) dir."""
    if client is None:
        client = _default_client_factory(api_key)
    limiter = rate_limiter or RateLimiter()
    prompt = build_prompt(mode, word)
    groups = group_frames_by_sequence(frames_dir)
    results: List[dict] = []
    lock = threading.Lock()

    def process_sequence(stem: str, paths: List[str]) -> Optional[dict]:
        sid_m = re.search(r"\d+-\d+", stem)
        if not sid_m:
            return None
        for attempt in range(max_retries):
            try:
                limiter.wait(sleep)
                desc = client(prompt, paths)
                return {"word": word, "sequence_id": sid_m.group(0), "description": desc}
            except Exception as e:
                if "429" in str(e) or "rate" in str(e).lower():
                    sleep(retry_backoff)
                    continue
                print(f"cue generation failed for {stem}: {e}")
                return None
        return None

    def on_result(rec: Optional[dict]) -> None:
        if rec is None:
            return
        with lock:
            results.append(rec)
            if len(results) % checkpoint_every == 0:
                _write_json(out_path + ".interim", results)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = [pool.submit(process_sequence, stem, paths) for stem, paths in groups.items()]
        for fut in futures:
            on_result(fut.result())

    _write_json(out_path, results)
    if os.path.exists(out_path + ".interim"):
        os.remove(out_path + ".interim")
    return results


def _write_json(path: str, data: list) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def generate_all_cues(
    cue_data_dir: str,
    out_root: str,
    words: Sequence[str],
    splits: Sequence[str] = ("train", "val", "test"),
    modes: Sequence[str] = ("emotion", "environment"),
    **kwargs,
) -> None:
    """All (split x word x mode) combinations (reference: :175-190)."""
    for mode in modes:
        folder = os.path.join(out_root, f"Descriptions_{mode.capitalize()}")
        for word in words:
            for split in splits:
                frames_dir = os.path.join(cue_data_dir, split, word)
                out_path = os.path.join(
                    folder, f"lipreading_analysis_results_{mode}_{word}_{split}.json"
                )
                generate_cues_for_word(frames_dir, out_path, word, mode=mode, **kwargs)


def main():
    import argparse

    from multimodal_lipread_torch.config import load_config

    parser = argparse.ArgumentParser(description="Generate textual cues with a vision LLM")
    parser.add_argument("--config", required=True)
    parser.add_argument("--words", nargs="+", required=True)
    args = parser.parse_args()
    cfg = load_config(args.config)
    generate_all_cues(
        cfg.get("dataset.cue_data_dir"),
        cfg.get("dataset.cue_root"),
        args.words,
        api_key=cfg.get("main.openai_api_key"),
    )


if __name__ == "__main__":
    main()
