"""The port's cue data against the JAX package's, on the CPU: the cue store
(``load_cue_records``), the hashing embedder and tokenizer (bit-equal),
the ``.npz`` embedding cache (the same file name and contents), the
backend choice without Hugging Face weights, the synthetic corpus's cue
descriptions (byte-equal JSON and WAV files for both cue styles and a
per-modality ``hardness``), and the port's TF-IDF against scikit-learn's
``TfidfVectorizer`` (the same vocabulary, the matrix at 1e-6, with ties in
term frequency at the ``max_features`` cut)."""

import filecmp
import os

import numpy as np
import pytest
from sklearn.feature_extraction.text import TfidfVectorizer as SkTfidfVectorizer

from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)

from multimodal_lipread_tpu.data import cues as jcues
from multimodal_lipread_tpu.data.synthetic import make_synthetic_glips as jmake
from multimodal_lipread_tpu.models.bert import HashingTokenizer as JHashingTokenizer

from multimodal_lipread_torch.data import cues as pcues
from multimodal_lipread_torch.data import tfidf
from multimodal_lipread_torch.data.synthetic import make_synthetic_glips as pmake
from multimodal_lipread_torch.models.bert import HashingTokenizer, tokenize_texts

SENTENCES = [
    "The speaker appears calm while articulating, with subtle lip movement.",
    "A TENSE expression dominates; the mouth shows rapid motion.",
    "",
    "don't stop -- 42 times, o'clock",
    "word " * 40,
]


@pytest.fixture(autouse=True)
def no_hf_cache(tmp_path, monkeypatch):
    """An empty Hugging Face cache: both packages take the hashing backends."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hf_hub"))


def test_load_cue_records_matches_jax(glips_root):
    for mode in ("emotion", "environment"):
        for splits in (None, ("train",), ("val", "test")):
            got = pcues.load_cue_records(glips_root, mode, splits)
            want = jcues.load_cue_records(glips_root, mode, splits)
            assert [(r.word, r.split, r.sequence_id, r.description) for r in got] == \
                   [(r.word, r.split, r.sequence_id, r.description) for r in want]
            assert got and all(r.key == (r.word, r.sequence_id, r.split) for r in got)
    assert pcues.records_by_key(got).keys() == jcues.records_by_key(want).keys()
    with pytest.raises(FileNotFoundError):
        pcues.load_cue_records(glips_root, "nope")


def test_hashing_embedder_is_bit_equal():
    for dim in (384, 768, 1152):
        got, want = pcues.HashingEmbedder(dim), jcues.HashingEmbedder(dim)
        np.testing.assert_array_equal(got.encode(SENTENCES), want.encode(SENTENCES))
        for length in (8, 32):
            out = got.encode_tokens(SENTENCES, max_length=length)
            assert out.shape == (len(SENTENCES), length, dim) and out.dtype == np.float32
            np.testing.assert_array_equal(out, want.encode_tokens(SENTENCES, max_length=length))
    assert not pcues.HashingEmbedder(384).encode([""]).any()


def test_hashing_tokenizer_is_bit_equal():
    for vocab, length in ((8192, 32), (30522, 16), (100, 4)):
        got = HashingTokenizer(vocab, length)(SENTENCES)
        assert got.dtype == np.int32 and got.shape == (len(SENTENCES), length)
        np.testing.assert_array_equal(got, JHashingTokenizer(vocab, length)(SENTENCES))
    ids = HashingTokenizer(8192, 32)(["a b"])
    assert ids[0, :4].tolist() == [1, ids[0, 1], ids[0, 2], 2] and not ids[0, 4:].any()
    # without the bert-base-uncased files the hashing tokenizer is taken
    np.testing.assert_array_equal(tokenize_texts(SENTENCES, hf_model="bert-base-uncased"),
                                  HashingTokenizer()(SENTENCES))


def test_backend_choice_without_hf_weights(capsys):
    assert isinstance(pcues.get_embedder("mpnet"), pcues.HashingEmbedder)
    assert "HashingEmbedder" in capsys.readouterr().err
    for model, dim in (("minilm", 384), ("sentence-transformers/all-mpnet-base-v2", 768), ("ensemble", 1152)):
        e = pcues.get_embedder(model)
        assert isinstance(e, pcues.HashingEmbedder) and e.dim == dim
        assert type(jcues.get_embedder(model)).__name__ == "HashingEmbedder"
    assert pcues.get_token_embedder("distilbert-base-uncased").dim == 768
    with pytest.raises(RuntimeError):
        pcues.get_embedder("mpnet", allow_fallback=False)
    with pytest.raises(ValueError):
        pcues.get_embedder("distilbert")  # token-level only
    with pytest.raises(ValueError):
        pcues.get_token_embedder("minilm")
    with pytest.raises(ValueError):
        pcues.canonical_embed_model("word2vec")
    for name in ("all-MiniLM-L6-v2", "mpnet", "distilbert-base-uncased", "ENSEMBLE"):
        assert pcues.canonical_embed_model(name) == jcues.canonical_embed_model(name)


def test_local_hf_probe_reads_the_cache_layout(tmp_path, monkeypatch):
    name = "sentence-transformers/all-mpnet-base-v2"
    assert not pcues._local_hf_weights_available(name)
    os.makedirs(tmp_path / "hf_hub" / "models--sentence-transformers--all-mpnet-base-v2")
    assert pcues._local_hf_weights_available(name) and jcues._local_hf_weights_available(name)


@pytest.mark.parametrize("token_level", [False, True])
def test_embed_cached_writes_the_jax_packages_file(tmp_path, token_level):
    descs = SENTENCES[:2] + ["ab", "c"]
    assert pcues._cache_key(descs, "mpnet_hash") == jcues._cache_key(descs, "mpnet_hash")
    assert pcues._cache_key(["ab", "c"], "m") != pcues._cache_key(["a", "bc"], "m")
    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    got = pcues.embed_cached(descs, "mpnet", cache_dir=pdir, token_level=token_level, max_length=8)
    want = jcues.embed_cached(descs, "mpnet", cache_dir=jdir, token_level=token_level, max_length=8)
    np.testing.assert_array_equal(got, want)
    (pname,), (jname,) = os.listdir(pdir), os.listdir(jdir)
    assert pname == jname and ("_tok8_hash_" in pname) == token_level
    np.testing.assert_array_equal(np.load(os.path.join(pdir, pname))["embeddings"],
                                  np.load(os.path.join(jdir, jname))["embeddings"])
    # a second call reads the JAX package's file
    np.testing.assert_array_equal(pcues.embed_cached(descs, "mpnet", cache_dir=jdir, token_level=token_level,
                                                     max_length=8), want)
    np.testing.assert_array_equal(pcues.embed_cached(descs, "mpnet", token_level=token_level, max_length=8), want)


def _tree_files(root):
    out = []
    for base, _dirs, files in os.walk(root):
        out += [os.path.relpath(os.path.join(base, f), root) for f in files]
    return sorted(out)


@pytest.mark.parametrize("kwargs", [
    dict(cue_style="slice"),
    dict(cue_style="compositional", hardness={"cues": 0.6, "audio": 0.3}),
    dict(cue_style="slice", hardness=0.4, label_noise=0.5),
    dict(cue_style="compositional", with_audio=False, words=("a", "b", "c", "d", "e", "f")),
], ids=["slice", "compositional-hardness", "slice-hard-noisy", "compositional-no-audio"])
def test_synthetic_cue_tree_is_byte_equal(tmp_path, kwargs):
    jroot = jmake(str(tmp_path / "j" / "G"), clips_per_split=3, seed=5, with_lip_regions=True, with_cues=True,
                  **kwargs)
    proot = pmake(str(tmp_path / "p" / "G"), clips_per_split=3, seed=5, with_lip_regions=True, with_cues=True,
                  **kwargs)
    for a, b in ((jroot, proot), (jroot + "_lip_regions", proot + "_lip_regions")):
        files = _tree_files(a)
        assert files == _tree_files(b)
        assert all(filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False) for f in files)
    assert any(f.endswith(".json") for f in _tree_files(proot))


def test_synthetic_cue_options():
    with pytest.raises(ValueError, match="cue_style"):
        pmake("/nonexistent", cue_style="nope", with_cues=True)
    with pytest.raises(ValueError, match="8 classes"):
        pmake("/nonexistent", words=tuple("abcdefghi"), with_cues=True, cue_style="compositional",
              with_audio=False)


# --- TF-IDF -------------------------------------------------------------------

# 30 documents over a small vocabulary: many 1- and 2-grams share a corpus
# frequency, so a cut at max_features falls inside a run of ties
_WORDS = ("calm tense neutral animated focused relaxed bright plain subtle pronounced rapid slow rhythmic "
          "steady soft sharp the and with of speaker mouth lips").split()


def _corpus(n=30, seed=0):
    rng = np.random.default_rng(seed)
    docs = [" ".join(rng.choice(_WORDS, size=rng.integers(3, 12))) for _ in range(n)]
    return docs + ["The the THE", "and of with", "Ümlaut café naïve 42 x y"]


@pytest.mark.parametrize("max_features", [5000, 60, 13, 1])
def test_tfidf_matches_sklearn(max_features):
    docs = _corpus()
    want_vec = SkTfidfVectorizer(max_features=max_features, ngram_range=(1, 2), stop_words="english")
    want = want_vec.fit_transform(docs).toarray()
    got_vec = tfidf.TfidfVectorizer(max_features=max_features)
    got = got_vec.fit_transform(docs)
    assert got_vec.vocabulary_ == {k: int(v) for k, v in want_vec.vocabulary_.items()}
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_vec.idf_, want_vec.idf_, rtol=1e-12)


def test_tfidf_cut_falls_inside_ties():
    docs = _corpus()
    counts = {}
    for doc in docs:
        for term in tfidf.TfidfVectorizer.analyze(doc):
            counts[term] = counts.get(term, 0) + 1
    ranked = sorted(counts.values(), reverse=True)
    assert ranked[12] == ranked[13] and ranked[59] == ranked[60]  # the cuts above split ties


def test_tfidf_stop_words_and_analyzer_match_sklearn():
    from sklearn.feature_extraction.text import ENGLISH_STOP_WORDS

    assert tfidf.ENGLISH_STOP_WORDS == ENGLISH_STOP_WORDS
    sk = SkTfidfVectorizer(ngram_range=(1, 2), stop_words="english").build_analyzer()
    for doc in _corpus(5) + SENTENCES:
        assert tfidf.TfidfVectorizer.analyze(doc) == sk(doc)
    with pytest.raises(ValueError):
        tfidf.TfidfVectorizer().fit_transform(["the and of", ""])
