"""The port's cue classifiers against the JAX package's at the same weights
(bridged from the JAX variables), on the CPU at B=3: every registry model
on its embedding kind's input (sentence embeddings, (B, 32, 768) token
embeddings, TF-IDF rows, token ids) in eval mode in float32 at 1e-4 on the
logits and, for the non-BERT models, in train mode in float64 with dropout
off on both sides at 1e-4 (their train mode differs only by dropout; BERT's
is held in tests/test_torch_bert.py). Also the registry (names, embedding
kinds, widths, refusals) and the multi-kernel convolution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_utils import jax_dropout_off, load_bridged, one_torch_thread, random_variables, train_mode_f64  # noqa: F401

from multimodal_lipread_tpu.models import cues as jcues

from multimodal_lipread_torch.models import cues as pcues
from multimodal_lipread_torch.models.bert import HashingTokenizer

TOL = 1e-4
B = 3
TFIDF_WIDTH = 57


def _input(name, seed=0):
    rng = np.random.default_rng(seed)
    kind = pcues.cue_embedding_kind(name)
    if kind == "bert_tok":
        return HashingTokenizer(8192, 32)(["calm speaker", "a tense mouth with rapid motion " * 3, "plain"])
    if kind == "tfidf":
        x = rng.random((B, TFIDF_WIDTH)) * (rng.random((B, TFIDF_WIDTH)) < 0.2)
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    if kind.endswith("_tok"):
        x = rng.standard_normal((B, 32, 768)).astype(np.float32)  # the embedders' max_length
        x[0, 20:] = 0.0  # a short description: zero rows after its last token
        return x
    return rng.standard_normal((B, pcues.embedding_width(kind))).astype(np.float32)


def _models(name, dtype=jnp.float32):
    kw = {"bert_size": "small"} if name.startswith("bert") else {}
    return jcues.get_cue_model(name, 4, dtype=dtype, **kw), kw


@pytest.mark.parametrize("name", jcues.CUE_MODEL_NAMES)
def test_cue_model_matches_jax(name, jax_dropout_off):
    x = _input(name, seed=1)
    jm, kw = _models(name)
    v = random_variables(jm, x, seed=2)
    pm = load_bridged(pcues.get_cue_model(name, 4, input_dim=x.shape[-1] if name == "linear" else None, **kw), v)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape == (B, 4)
    if name == "bert_lite":  # bf16 on both sides: held to the JAX bf16 model at the bf16 bound
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=5e-2)
        return
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if name.startswith("bert"):
        return
    got, want, ours, running = train_mode_f64(_models(name, jnp.float64)[0], v, pm, x)
    assert want.dtype == np.float64 and not ours and not running
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_registry_matches_jax():
    assert pcues.CUE_MODEL_NAMES == jcues.CUE_MODEL_NAMES
    assert len(pcues.CUE_MODEL_NAMES) == 11
    for name in pcues.CUE_MODEL_NAMES:
        assert pcues.cue_embedding_kind(name) == jcues.cue_embedding_kind(name)
    assert [pcues.embedding_width(k) for k in ("minilm", "mpnet", "ensemble", "mpnet_tok", "distilbert_tok")] == \
           [384, 768, 1152, 768, 768]
    with pytest.raises(ValueError, match="input_dim"):
        pcues.get_cue_model("linear", 4)
    assert pcues.get_cue_model("linear", 4, input_dim=5000).fc1.in_features == 5000
    with pytest.raises(ValueError):
        pcues.get_cue_model("nope", 4)
    with pytest.warns(UserWarning, match="tiny random-init BERT"):
        tiny = pcues.get_cue_model("bert", 4)
    assert tiny.config.num_layers == 2 and tiny.config.hidden_size == 128
    base = pcues.get_cue_model("bert", 4, bert_size="base")
    assert base.config.num_layers == 12 and base.dtype == torch.float32
    assert pcues.get_cue_model("bert_lite", 4, bert_size="small").dtype == torch.bfloat16


def test_pipeline_stages_raise():
    with pytest.raises(ValueError, match="only supported for the BERT"):
        pcues.get_cue_model("dense_nn", 4, pipeline_stages=2)
    with pytest.raises(ValueError):
        jcues.get_cue_model("dense_nn", 4, pipeline_stages=2)
    # BERT takes stages that divide its layers, as the JAX registry's
    with pytest.raises(ValueError, match="divisible"):
        pcues.get_cue_model("bert", 4, bert_size="small", pipeline_stages=3)
    with pytest.raises(ValueError, match="divisible"):
        jcues.get_cue_model("bert", 4, bert_size="small", pipeline_stages=3)
    from multimodal_lipread_torch.models.bert import PipelinedBertClassifier

    model = pcues.get_cue_model("bert", 4, bert_size="small", pipeline_stages=4)
    assert isinstance(model, PipelinedBertClassifier) and model.num_stages == 4
    with pytest.raises(ValueError, match="requires a"):  # its forward needs the (data, stage) mesh
        model(torch.ones(4, 6, dtype=torch.long))


def test_multi_kernel_conv_takes_the_max_over_time():
    conv = pcues._MultiKernelConv(8)
    assert conv.feature_dim == 192 and [getattr(conv, f"conv{k}").kernel_size for k in (2, 3, 4)] == [(2,), (3,), (4,)]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 10, 8)).astype(np.float32))
    with torch.no_grad():
        out = conv(x)
        y = torch.relu(conv.conv3(x.transpose(1, 2)))  # (B, 64, 8 valid steps)
    assert out.shape == (2, 192) and y.shape[-1] == 8
    torch.testing.assert_close(out[:, 64:128], y.amax(-1))


def test_cue_model_bfloat16_keeps_float32_parameters():
    x = torch.from_numpy(_input("multi_attn"))
    m = pcues.get_cue_model("multi_attn", 4, dtype=torch.bfloat16)
    with torch.no_grad():
        out = m(x)
    assert out.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in m.parameters())
