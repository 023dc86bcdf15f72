"""The port's BERT against the JAX package's, on the CPU: the tiny config
on padded token ids in eval mode in float32 at 1e-4 on the logits, in train
mode in float64 (dropout off on both sides: ``jax_dropout_off``) at 1e-4,
the gradient in float64 against ``jax.grad`` and in float32 against
float64; the masked attention and LayerNorm at epsilon 1e-12 against
Flax's; an all-padding row (the ``Predictor`` pads short batches with zero
ids) gives finite logits; bert-base's parameter names and shapes against
``jax.eval_shape`` of the JAX model (no bert-base forward runs here); the
Hugging Face converter held to ``tests/goldens/bert.npz`` at
``test_goldens.py``'s tolerance; bf16 (``bert_lite``) keeps float32
parameters."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import golden_utils as G
from torch_parity_utils import jax_dropout_off, load_bridged, no_dropout, one_torch_thread, random_variables  # noqa: F401

from multimodal_lipread_tpu.models import bert as jbert

from multimodal_lipread_torch.models import bert as pbert
from multimodal_lipread_torch.nn.attention import MultiHeadDotProductAttention
from multimodal_lipread_torch.nn.common import Embedding, LayerNorm, flax_init_
from multimodal_lipread_torch.utils import jax_bridge
from multimodal_lipread_torch.utils.torch_import import convert_hf_bert

TOL = 1e-4
TEXTS = ["the speaker appears calm while articulating", "short", "a " * 40, "tense mouth, rapid motion"]


def _ids(length=16):
    ids = pbert.HashingTokenizer(8192, length)(TEXTS)
    assert (ids == 0).any() and (ids != 0).all(axis=1).any()  # padded rows and a full one
    return ids


def _pair(seed=1, length=16):
    ids = _ids(length)
    jm = jbert.BertClassifier(jbert.bert_tiny_config(), 4)
    v = random_variables(jm, ids, seed=seed)
    pm = load_bridged(pbert.BertClassifier(pbert.bert_tiny_config(), 4), v)
    return ids, jm, v, pm


def test_bert_tiny_matches_jax_on_padded_ids():
    ids, jm, v, pm = _pair()
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, ids))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (len(TEXTS), 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # an explicit mask is the same as the ids' own
    with torch.no_grad():
        np.testing.assert_array_equal(pm(torch.from_numpy(ids), torch.from_numpy(ids != 0)).numpy(), got)
        assert not np.allclose(pm(torch.from_numpy(ids), torch.ones(ids.shape, dtype=torch.bool)).numpy(), got)


def _f64(v):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)


def test_bert_tiny_train_mode_float64_and_gradients(jax_dropout_off):
    ids, _jm, v, pm = _pair(seed=2)
    labels = np.array([0, 1, 2, 3])
    jm64 = jbert.BertClassifier(jbert.bert_tiny_config(), 4, dtype=jnp.float64)
    key = jax.random.PRNGKey(0)

    def jloss(params, ids):
        logits = jm64.apply({"params": params}, ids, train=True, rngs={"dropout": key})
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), labels[:, None], axis=1)), logits

    with jax.enable_x64(True):
        (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(_f64(v)["params"], ids)
        want = np.asarray(want)
        jgrads = jax_bridge.state_dict_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jgrads))

    def port_grads(dtype):
        m = no_dropout(pm.to(dtype).train())
        m.dtype = dtype
        m.zero_grad()
        logits = m(torch.from_numpy(ids))
        torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
        return logits.detach().numpy(), {k: p.grad.double().numpy() for k, p in m.named_parameters()}

    got64, g64 = port_grads(torch.float64)
    assert want.dtype == np.float64
    np.testing.assert_allclose(got64, want, rtol=TOL, atol=TOL)
    assert set(g64) == set(jgrads)
    for k, g in g64.items():
        # a key projection's bias shifts every logit of a row alike: its
        # gradient is zero up to rounding (~1e-17) on both sides
        scale = max(float(np.abs(jgrads[k].numpy()).max()), 1e-9)
        np.testing.assert_allclose(g, jgrads[k].numpy(), rtol=0, atol=1e-6 * scale, err_msg=k)
    assert all(np.abs(g).max() < 1e-12 for k, g in g64.items() if k.endswith("attention.key.bias"))
    _got32, g32 = port_grads(torch.float32)
    for k, g in g32.items():
        if k.endswith("attention.key.bias"):  # float32 rounding only
            assert np.abs(g).max() < 1e-6, k
            continue
        scale = float(np.abs(g64[k]).max())
        np.testing.assert_allclose(g, g64[k], rtol=0, atol=1e-3 * scale, err_msg=k)
    # padded positions are masked out as keys in every layer, so nothing of
    # them reaches [CLS]: the pad id's row gets no gradient at all
    assert not g64["embeddings.word_embeddings.weight"][0].any()
    assert np.abs(g64["embeddings.word_embeddings.weight"][1]).max() > 0


def test_masked_attention_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], bool)[:, None, None, :]
    jm = fnn.MultiHeadDotProductAttention(num_heads=4)
    v = random_variables(jm, x, x, seed=3, init_kwargs={"mask": mask})
    pm = MultiHeadDotProductAttention(16, 4)
    pm.load_state_dict(jax_bridge.state_dict_from_jax(v["params"]), strict=True)
    want = np.asarray(jm.apply(v, x, x, mask=mask))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()  # the row without keys: a uniform softmax, as in Flax
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with jax.enable_x64(True):
        want64 = np.asarray(fnn.MultiHeadDotProductAttention(num_heads=4, dtype=jnp.float64).apply(
            _f64(v), x.astype(np.float64), x.astype(np.float64), mask=mask))
    with torch.no_grad():
        got64 = pm.double()(torch.from_numpy(x).double(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got64, want64, rtol=1e-10, atol=1e-10)


def test_layer_norm_at_bert_epsilon_matches_flax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 32)) * 3 + 0.5).astype(np.float32)
    x[0] = 1e-7 * rng.standard_normal(32)  # a row whose variance is far below 1e-6
    jm = fnn.LayerNorm(epsilon=1e-12)
    v = {"params": {"scale": 1 + 0.1 * rng.standard_normal(32), "bias": 0.1 * rng.standard_normal(32)}}
    pm = LayerNorm(32, eps=1e-12)
    pm.load_state_dict(jax_bridge.state_dict_from_jax(v["params"]))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[1:], np.asarray(jm.apply(v, x))[1:], rtol=TOL, atol=TOL)
    with jax.enable_x64(True):
        want64 = np.asarray(fnn.LayerNorm(epsilon=1e-12, dtype=jnp.float64, param_dtype=jnp.float64).apply(
            _f64(v), x.astype(np.float64)))
    np.testing.assert_allclose(got, want64, rtol=TOL, atol=TOL)  # the tiny row too, against float64
    assert LayerNorm(4).eps == 1e-6


def test_all_padding_rows_give_finite_logits():
    ids, jm, v, pm = _pair(seed=5)
    ids = np.concatenate([ids, np.zeros_like(ids[:2])])
    want = np.asarray(jm.apply(v, ids, train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _meta_tensor(x):
    return torch.empty(np.shape(x), device="meta")


def test_bert_base_names_and_shapes_match_jax(monkeypatch):
    jm = jbert.BertClassifier(jbert.bert_base_config(), 4)
    ids = np.ones((1, 32), np.int32)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, ids))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes["params"])
    monkeypatch.setattr(jax_bridge, "_t", _meta_tensor)
    want = {k: tuple(t.shape) for k, t in jax_bridge.state_dict_from_jax(zeros).items()}
    with torch.device("meta"):
        pm = pbert.BertClassifier(pbert.bert_base_config(), 4)
    got = {k: tuple(t.shape) for k, t in pm.state_dict().items()}
    assert got == want
    assert got["embeddings.word_embeddings.weight"] == (30522, 768) and got["layer11.intermediate.weight"] == (3072, 768)
    assert sum(int(np.prod(s)) for s in got.values()) == 109_485_316
    c = pbert.bert_base_config()
    assert (c.num_layers, c.num_heads, c.max_position, c.layer_norm_eps) == (12, 12, 512, 1e-12)
    for p, j in ((pbert.bert_tiny_config(), jbert.bert_tiny_config()),
                 (pbert.bert_small_config(), jbert.bert_small_config()),
                 (pbert.bert_base_config(), jbert.bert_base_config())):
        assert vars(p) == vars(j)


def test_hf_converter_holds_the_golden():
    z = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "bert.npz"))
    c = G.BERT_CFG
    cfg = pbert.BertConfig(vocab_size=c["vocab"], hidden_size=c["hidden"], num_layers=c["layers"], num_heads=4,
                           intermediate_size=c["intermediate"], max_position=c["max_pos"], dropout_rate=0.0)
    sd = G.synth_state(G.hf_bert_cls_spec(**c), G.SEED)
    model = pbert.BertClassifier(cfg, c["num_labels"])
    model.load_state_dict(convert_hf_bert(sd, c["layers"]), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(z["ids"])).numpy()
    np.testing.assert_allclose(got, z["want"], atol=1e-4, rtol=1e-3)
    # without a classification head the model's own head stays
    headless = {k: v for k, v in sd.items() if not k.startswith("classifier.")}
    assert not any(k.startswith("classifier") for k in convert_hf_bert(headless, c["layers"]))


def test_embedding_init_and_dtypes():
    m = flax_init_(Embedding(1000, 64), torch.Generator().manual_seed(0))
    std = float(m.weight.detach().std())
    assert abs(std - 64 ** -0.5) < 0.05 * 64 ** -0.5 and float(m.weight.detach().abs().max()) <= 2 * 64 ** -0.5 / 0.8796 + 1e-6
    ids = torch.tensor([[1, 2]], dtype=torch.int32)
    assert m(ids).dtype == torch.float32 and m(ids, torch.bfloat16).dtype == torch.bfloat16
    lite = pbert.BertClassifier(pbert.bert_tiny_config(), 4, dtype=torch.bfloat16)
    with torch.no_grad():
        out = lite(torch.from_numpy(_ids()))
    assert out.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in lite.parameters())


def test_bert_lite_tracks_float32():
    ids, _jm, v, pm = _pair(seed=6)
    lite = load_bridged(pbert.BertClassifier(pbert.bert_tiny_config(), 4, dtype=torch.bfloat16), v)
    with torch.no_grad():
        f32, bf16 = pm(torch.from_numpy(ids)).numpy(), lite(torch.from_numpy(ids)).float().numpy()
    np.testing.assert_allclose(bf16, f32, rtol=0, atol=5e-2)


def test_int64_ids_give_the_int32_logits():
    ids, _jm, _v, pm = _pair(seed=7)
    with torch.no_grad():
        np.testing.assert_array_equal(pm(torch.from_numpy(ids).long()).numpy(), pm(torch.from_numpy(ids)).numpy())
