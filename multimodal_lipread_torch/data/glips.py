"""GLips directory scanning (counterpart of the JAX package's
``data/glips.py``; only what serving needs for class names).

Layout: ``<root>/lipread_files/<word>/<split>/<word>_NNNN-NNNN.{m4a,wav,flac}``;
the sequence id is the ``NNNN-NNNN`` part of the file name, and the class
list is the sorted set of word directories.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SPLITS = ("train", "val", "test")
SEQ_ID_RE = re.compile(r"\d{4}-\d{4}")

AUDIO_EXTS = (".m4a", ".wav", ".flac")


def extract_sequence_id(filename: str) -> Optional[str]:
    """Extract the ``NNNN-NNNN`` sequence id from a clip filename."""
    m = SEQ_ID_RE.search(os.path.basename(filename))
    return m.group(0) if m else None


@dataclass(frozen=True)
class ClipEntry:
    word: str
    split: str
    sequence_id: str
    path: str


@dataclass
class GlipsIndex:
    """Index of one modality's files: the classes and one entry per clip."""

    root: str
    classes: List[str] = field(default_factory=list)
    entries: List[ClipEntry] = field(default_factory=list)


def lipread_files_dir(root: str) -> str:
    """``<root>/lipread_files`` if present, else ``root`` itself."""
    cand = os.path.join(root, "lipread_files")
    return cand if os.path.isdir(cand) else root


def scan_glips(root: str, exts: Sequence[str] = AUDIO_EXTS) -> GlipsIndex:
    """Scan the GLips tree for clips with the given extensions.

    Deterministic: the class list is the sorted set of word directories and
    entries are sorted by sequence id. A clip present in several formats
    gives one entry, the earliest extension in ``exts`` winning.
    """
    base = lipread_files_dir(root)
    if not os.path.isdir(base):
        raise FileNotFoundError(f"GLips root not found: {root}")
    found = sorted(d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d)))
    index = GlipsIndex(root=root, classes=found)
    exts = tuple(e.lower() for e in exts)
    for word in found:
        for split in SPLITS:
            d = os.path.join(base, word, split)
            if not os.path.isdir(d):
                continue
            best: Dict[str, Tuple[int, str]] = {}
            for name in sorted(os.listdir(d)):
                lower = name.lower()
                rank = next((i for i, e in enumerate(exts) if lower.endswith(e)), None)
                if rank is None:
                    continue
                sid = extract_sequence_id(name)
                if sid is None:
                    continue
                if sid not in best or rank < best[sid][0]:
                    best[sid] = (rank, os.path.join(d, name))
            for sid in sorted(best):
                index.entries.append(
                    ClipEntry(word=word, split=split, sequence_id=sid, path=best[sid][1])
                )
    return index
