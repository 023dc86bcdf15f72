"""GLips directory scanning and the alignment of modalities (counterpart
of the JAX package's ``data/glips.py``).

Layout: ``<root>/lipread_files/<word>/<split>/<word>_NNNN-NNNN.{m4a,wav,flac}``
and the lip-region mirror tree
``<root>_lip_regions/lipread_files/<word>/<split>/<word>_NNNN-NNNN.npy``
((29, 44, 44, 3) uint8); the sequence id is the ``NNNN-NNNN`` part of the
file name, and the class list is the sorted set of word directories.
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

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.word, self.sequence_id, self.split)


@dataclass
class GlipsIndex:
    """Index of one modality's files: the classes and one entry per clip."""

    root: str
    classes: List[str] = field(default_factory=list)
    entries: List[ClipEntry] = field(default_factory=list)

    @property
    def class_to_idx(self) -> Dict[str, int]:
        return {w: i for i, w in enumerate(self.classes)}

    def by_split(self, split: str) -> List[ClipEntry]:
        return [e for e in self.entries if e.split == split]

    def by_key(self) -> Dict[Tuple[str, str, str], ClipEntry]:
        return {e.key: e for e in self.entries}


def lipread_files_dir(root: str) -> str:
    """``<root>/lipread_files`` if present, else ``root`` itself."""
    cand = os.path.join(root, "lipread_files")
    return cand if os.path.isdir(cand) else root


def lip_regions_root(root: str) -> str:
    """The lip-region mirror tree of ``root``: the sibling directory
    ``<root>_lip_regions`` (``root`` normalized first, so a trailing slash
    does not give ``<root>/_lip_regions``)."""
    root = os.path.normpath(root)
    return os.path.join(os.path.dirname(root), os.path.basename(root) + "_lip_regions")


def scan_glips(
    root: str,
    exts: Sequence[str] = AUDIO_EXTS,
    splits: Sequence[str] = SPLITS,
    words: Optional[Sequence[str]] = None,
) -> GlipsIndex:
    """Scan the GLips tree for clips with the given extensions.

    Deterministic: the class list is the sorted set of word directories
    (or of ``words``, when given) and entries are sorted by sequence id
    within each word and split. A clip present in several formats gives
    one entry, the earliest extension in ``exts`` winning.
    """
    base = lipread_files_dir(root)
    if not os.path.isdir(base):
        raise FileNotFoundError(f"GLips root not found: {root}")
    if words is None:
        found = sorted(d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d)))
    else:
        found = sorted(words)
    index = GlipsIndex(root=root, classes=found)
    exts = tuple(e.lower() for e in exts)
    for word in found:
        for split in splits:
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


def scan_lip_regions(lip_root: str, splits: Sequence[str] = SPLITS) -> GlipsIndex:
    """Index every ``.npy`` file under ``lip_root``, at any depth, taking
    (word, split) from the two directories above the file. Entries are
    sorted by (word, sequence id, split), the classes are the sorted words
    found, and two files with one key raise ``RuntimeError``."""
    if not os.path.isdir(lip_root):
        raise FileNotFoundError(
            f"Lip-region directory not found: {lip_root}. Run the lip-extraction "
            f"preprocessing first (python -m multimodal_lipread_tpu.data.lip_extraction; "
            f"not ported to PyTorch yet, ROADMAP.md Queue 1 #11)."
        )
    entries: Dict[Tuple[str, str, str], ClipEntry] = {}
    words = set()
    for dirpath, _dirnames, filenames in os.walk(lip_root):
        for name in sorted(filenames):
            if not name.endswith(".npy"):
                continue
            sid = extract_sequence_id(name)
            if sid is None:
                continue
            parts = os.path.normpath(dirpath).split(os.sep)
            if len(parts) < 2:
                continue
            split, word = parts[-1], parts[-2]
            if split not in splits:
                continue
            key = (word, sid, split)
            if key in entries:
                raise RuntimeError(f"Duplicate lip-region file for key {key}: {os.path.join(dirpath, name)}")
            entries[key] = ClipEntry(word=word, split=split, sequence_id=sid, path=os.path.join(dirpath, name))
            words.add(word)
    index = GlipsIndex(root=lip_root, classes=sorted(words))
    index.entries = [entries[k] for k in sorted(entries)]
    return index


def align_modalities(*indexes: GlipsIndex, split: Optional[str] = None) -> List[Tuple[ClipEntry, ...]]:
    """Strict N-way alignment of modality indexes by (word, sequence id,
    split): one tuple of entries, one per index, for every key present in
    all of them (in ``split`` only, when given), sorted by key."""
    maps = [ix.by_key() for ix in indexes]
    common = set(maps[0])
    for m in maps[1:]:
        common &= set(m)
    if split is not None:
        common = {k for k in common if k[2] == split}
    return [tuple(m[k] for m in maps) for k in sorted(common)]
