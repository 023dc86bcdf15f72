"""Textual cues: the cue store, the sentence and token embedders and the
``.npz`` embedding cache (counterpart of the JAX package's
``data/cues.py``, numpy only).

- cue store: ``<cue_root>/Descriptions_{Emotion,Environment}/
  lipreading_analysis_results_{mode}_{word}_{split}.json``, each a list of
  ``{word, sequence_id, description}`` records;
- embeddings are computed once per description set and cached to ``.npz``
  under a name keyed by the md5 of the descriptions, the model and the
  backend, so the port and the JAX package read and write the same files.

Backends, chosen as the JAX package chooses them:

- ``SentenceTransformerEmbedder``: sentence-transformers MiniLM-L6 (384-d),
  mpnet (768-d) or their concatenation "ensemble" (1152-d), used only when
  the weights are already in the local Hugging Face cache;
- a token-level Hugging Face model (mpnet, distilbert; (N, max_length, 768)
  arrays), likewise only from the local cache;
- ``HashingEmbedder`` otherwise: per-token random projections seeded by
  the token's md5, mean-pooled and L2-normalized, at the same widths. It is
  the backend wherever the weights are absent.

Which backend was taken is printed to stderr: it decides what the
features mean.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

EMBED_DIMS = {"minilm": 384, "mpnet": 768, "ensemble": 1152, "distilbert": 768}
_CUE_FILE_RE = re.compile(r"lipreading_analysis_results_(\w+?)_(.+)_(train|val|test)\.json$")
_TOKEN_RE = re.compile(r"[a-z0-9']+")


@dataclass(frozen=True)
class CueRecord:
    word: str
    split: str
    sequence_id: str
    description: str

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.word, self.sequence_id, self.split)


def cue_dir(cue_root: str, mode: str) -> str:
    """``Descriptions_Emotion`` / ``Descriptions_Environment`` folder."""
    return os.path.join(cue_root, f"Descriptions_{mode.capitalize()}")


def load_cue_records(
    cue_root: str,
    mode: str = "emotion",
    splits: Optional[Sequence[str]] = None,
) -> List[CueRecord]:
    """Every cue record of one mode, files in sorted order, the split taken
    from the file name; records without a description, sequence id or
    word are skipped."""
    folder = cue_dir(cue_root, mode)
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"Cue directory not found: {folder}")
    records: List[CueRecord] = []
    for name in sorted(os.listdir(folder)):
        m = _CUE_FILE_RE.match(name)
        if not m or m.group(1) != mode:
            continue
        split = m.group(3)
        if splits is not None and split not in splits:
            continue
        with open(os.path.join(folder, name)) as f:
            data = json.load(f)
        for rec in data:
            desc, sid, word = rec.get("description"), rec.get("sequence_id"), rec.get("word")
            if not desc or not sid or not word:
                continue
            records.append(CueRecord(word=word, split=split, sequence_id=sid, description=desc))
    return records


# --------------------------------------------------------------------- embedders


def canonical_embed_model(model: str) -> str:
    """A full Hugging Face name (the reference configs use them) → this
    module's short key; an unknown name raises."""
    aliases = {
        "sentence-transformers/all-minilm-l6-v2": "minilm",
        "all-minilm-l6-v2": "minilm",
        "sentence-transformers/all-mpnet-base-v2": "mpnet",
        "all-mpnet-base-v2": "mpnet",
        "distilbert-base-uncased": "distilbert",
    }
    key = aliases.get(model.lower(), model.lower())
    if key not in EMBED_DIMS:
        raise ValueError(
            f"Unknown cue embedding model '{model}'; expected one of "
            f"{sorted(EMBED_DIMS)} or a known sentence-transformers name"
        )
    return key


class HashingEmbedder:
    """Deterministic offline embedder: each token's vector is a standard
    normal draw from a generator seeded by the first 4 bytes of its md5."""

    cache_tag = "hash"

    def __init__(self, dim: int):
        self.dim = dim

    def _token_vec(self, token: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.md5(token.encode()).digest()[:4], "little")
        return np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)

    def encode(self, sentences: Sequence[str]) -> np.ndarray:
        """(N, dim): the mean of the token vectors, L2-normalized (zero for
        a sentence without tokens)."""
        out = np.zeros((len(sentences), self.dim), np.float32)
        for i, sent in enumerate(sentences):
            tokens = _TOKEN_RE.findall(sent.lower())
            if not tokens:
                continue
            v = np.stack([self._token_vec(t) for t in tokens]).mean(axis=0)
            out[i] = v / (np.linalg.norm(v) + 1e-9)
        return out

    def encode_tokens(self, sentences: Sequence[str], max_length: int = 32) -> np.ndarray:
        """(N, max_length, dim): each of the first ``max_length`` tokens'
        vector, L2-normalized; zero rows after the last token."""
        out = np.zeros((len(sentences), max_length, self.dim), np.float32)
        for i, sent in enumerate(sentences):
            for j, t in enumerate(_TOKEN_RE.findall(sent.lower())[:max_length]):
                v = self._token_vec(t)
                out[i, j] = v / (np.linalg.norm(v) + 1e-9)
        return out


_ST_NAMES = {
    "minilm": "sentence-transformers/all-MiniLM-L6-v2",
    "mpnet": "sentence-transformers/all-mpnet-base-v2",
}
_TOKEN_MODEL_NAMES = {
    "mpnet": "sentence-transformers/all-mpnet-base-v2",
    "distilbert": "distilbert-base-uncased",
}


def _local_hf_weights_available(name: str) -> bool:
    """True iff the Hugging Face hub cache already holds ``name`` (a
    filesystem probe: HF_HUB_CACHE > HUGGINGFACE_HUB_CACHE > HF_HOME/hub >
    ~/.cache/huggingface/hub, huggingface_hub's order)."""
    cache = (
        os.environ.get("HF_HUB_CACHE")
        or os.environ.get("HUGGINGFACE_HUB_CACHE")
        or os.path.join(os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface")), "hub")
    )
    return os.path.isdir(os.path.join(cache, "models--" + name.replace("/", "--")))


class SentenceTransformerEmbedder:
    """The sentence-transformers backend; raises unless the weights are in
    the local cache (it never downloads: a hub download would hang where
    there is no network)."""

    cache_tag = "st"

    def __init__(self, model: str = "mpnet"):
        needed = [_ST_NAMES["minilm"], _ST_NAMES["mpnet"]] if model == "ensemble" else [_ST_NAMES[model]]
        missing = [n for n in needed if not _local_hf_weights_available(n)]
        if missing:
            raise RuntimeError(f"no local HF cache for {missing}")
        from sentence_transformers import SentenceTransformer

        self.model_name = model
        self._models = [SentenceTransformer(n, local_files_only=True) for n in needed]
        self.dim = EMBED_DIMS[model]

    def encode(self, sentences: Sequence[str]) -> np.ndarray:
        embs = [m.encode(list(sentences), convert_to_numpy=True, show_progress_bar=False) for m in self._models]
        return np.concatenate(embs, axis=1).astype(np.float32)


def _announce(kind: str, model: str, embedder) -> None:
    """The backend taken, on stderr (the serving CLI's stdout is its JSON)."""
    print(f"cue embeddings ({kind}, {model}): {type(embedder).__name__} backend "
          f"'{getattr(embedder, 'cache_tag', '?')}'", file=sys.stderr, flush=True)


def get_embedder(model: str = "mpnet", allow_fallback: bool = True):
    """The best available sentence embedder for 'minilm', 'mpnet' or
    'ensemble' (or a full sentence-transformers name): the transformer
    where its weights are cached, else ``HashingEmbedder`` at its width."""
    model = canonical_embed_model(model)
    if model not in _ST_NAMES and model != "ensemble":
        raise ValueError(f"'{model}' is not a sentence-embedding model; choose from {sorted(_ST_NAMES) + ['ensemble']}")
    try:
        embedder = SentenceTransformerEmbedder(model)
    except (RuntimeError, ImportError, OSError):
        if not allow_fallback:
            raise
        embedder = HashingEmbedder(EMBED_DIMS[model])
    _announce("sentence", model, embedder)
    return embedder


class _HFTokenEmbedder:
    """A Hugging Face encoder's last hidden states, (N, max_length, hidden)."""

    cache_tag = "hf"

    def __init__(self, name: str, max_length: int):
        import torch
        from transformers import AutoModel, AutoTokenizer

        self._torch = torch
        self.tokenizer = AutoTokenizer.from_pretrained(name, local_files_only=True)
        self.model = AutoModel.from_pretrained(name, local_files_only=True).eval()
        self.dim = self.model.config.hidden_size
        self.max_length = max_length

    def encode_tokens(self, sentences: Sequence[str], max_length: Optional[int] = None) -> np.ndarray:
        length = max_length or self.max_length
        outs = []
        with self._torch.no_grad():
            for sent in sentences:
                enc = self.tokenizer(sent, truncation=True, padding="max_length", max_length=length,
                                     return_tensors="pt")
                outs.append(self.model(**enc).last_hidden_state.squeeze(0).numpy().astype(np.float32))
        return np.stack(outs)


def get_token_embedder(model: str = "mpnet", max_length: int = 32, allow_fallback: bool = True):
    """A token-level embedder returning (N, max_length, D) arrays: the
    Hugging Face model where its weights are cached, else ``HashingEmbedder``."""
    model = canonical_embed_model(model)
    if model not in _TOKEN_MODEL_NAMES:
        raise ValueError(f"'{model}' has no token-level backend; choose from {sorted(_TOKEN_MODEL_NAMES)}")
    name = _TOKEN_MODEL_NAMES[model]
    try:
        if not _local_hf_weights_available(name):
            raise RuntimeError(f"no local HF cache for {name}")
        embedder = _HFTokenEmbedder(name, max_length)
    except (RuntimeError, ImportError, OSError):
        if not allow_fallback:
            raise
        embedder = HashingEmbedder(EMBED_DIMS[model])
    _announce("token", model, embedder)
    return embedder


# --------------------------------------------------------------------- caching


def _cache_key(descriptions: Sequence[str], model: str) -> str:
    """md5 over the length-prefixed model tag and descriptions (without the
    prefixes ['ab', 'c'] and ['a', 'bc'] would collide)."""
    h = hashlib.md5()
    h.update(f"{len(model)}:".encode())
    h.update(model.encode())
    h.update(f"n={len(descriptions)};".encode())
    for d in descriptions:
        b = d.encode()
        h.update(f"{len(b)}:".encode())
        h.update(b)
    return h.hexdigest()


def embed_cached(
    descriptions: Sequence[str],
    model: str = "mpnet",
    cache_dir: Optional[str] = None,
    embedder=None,
    token_level: bool = False,
    max_length: int = 32,
) -> np.ndarray:
    """Embed ``descriptions`` through the ``.npz`` cache in ``cache_dir``
    (none without one). The file name carries the backend's tag, so a
    hashing run and a transformer run never read each other's files."""
    model = canonical_embed_model(model)
    if embedder is None:
        embedder = get_token_embedder(model, max_length) if token_level else get_embedder(model)
    backend = getattr(embedder, "cache_tag", type(embedder).__name__)
    tag = f"{model}{f'_tok{max_length}' if token_level else ''}_{backend}"
    path = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"cue_emb_{tag}_{_cache_key(descriptions, tag)}.npz")
        if os.path.exists(path):
            return np.load(path)["embeddings"]
    if token_level:
        embs = embedder.encode_tokens(descriptions, max_length=max_length)
    else:
        embs = embedder.encode(descriptions)
    if path:
        np.savez_compressed(path, embeddings=embs)
    return embs


def records_by_key(records: Sequence[CueRecord]) -> Dict[Tuple[str, str, str], CueRecord]:
    return {r.key: r for r in records}
