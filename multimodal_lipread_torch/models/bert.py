"""BERT cue text classifier (counterpart of the JAX package's
``models/bert.py``): word, position and token-type embeddings, post-LN
encoder layers with exact GELU, a tanh pooler over [CLS] and a
classification head.

``bert_base_config()`` is bert-base-uncased (12 layers, hidden 768, 12
heads, FFN 3072, vocabulary 30 522, 512 positions, LayerNorm epsilon
1e-12), so a Hugging Face checkpoint converts one to one
(``utils/torch_import.convert_hf_bert``). Without those weights the
classifier starts from the Flax-style random initialization and reads ids
from ``HashingTokenizer``, as the JAX package does; ``bert_tiny_config()``
and ``bert_small_config()`` are the small offline widths.

Dropout (rate 0.1) is where the JAX module has it: after the embeddings'
LayerNorm, on the attention probabilities (one (L, L) mask shared over
batch and heads), on the attention output and on the FFN output before
each residual LayerNorm, and on the pooled vector. ``dtype`` is the compute
dtype (parameters stay float32). The attention mask is ``ids != 0`` unless
one is given: padded keys are masked out of every softmax.

Submodule names are the JAX module's (``embeddings.word_embeddings``,
``layer{i}.attention.query``, ``attention_norm``, ``intermediate``,
``output``, ``output_norm``, ``pooler``, ``classifier``), so
``utils/jax_bridge.py`` maps the variables by name.

Model parallelism, as the JAX module has it:

- ``BERT_TP_RULES``: Megatron tensor parallelism over a ``(data, model)``
  mesh. Query, key and value are column-parallel over the heads, the
  attention output row-parallel, the FFN's ``intermediate`` column- and
  ``output`` row-parallel; the trainer cuts the weights
  (``parallel/mesh.place_state``) and ``set_tensor_parallel`` turns on the
  collectives (``BertLayer``, ``MultiHeadDotProductAttention``).
- ``PipelinedBertClassifier``: the same model with its encoder layers
  stacked (``encoder.*``, leading axis = layer) for GPipe over a
  ``(data, stage)`` mesh (``parallel/pipeline.py``, ``BERT_PP_RULES``);
  ``stack_bert_layers`` / ``unstack_bert_layers`` convert its
  ``state_dict`` to and from ``BertClassifier``'s.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_lipread_torch.nn.attention import MultiHeadDotProductAttention
from multimodal_lipread_torch.nn.common import Dropout, Embedding, LayerNorm, linear
from multimodal_lipread_torch.parallel.mesh import copy_to_group, reduce_from_group


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-12


def bert_base_config() -> BertConfig:
    return BertConfig()


# Megatron tensor-parallel rules on the port's names and torch layouts
# (``Linear.weight`` is (out, in)): the JAX rules of models/bert.py, a Flax
# kernel's "in" axis being a torch weight's last. query/key/value and
# intermediate shard their outputs (rows of the weight), attention out and
# output their inputs (columns); their biases stay whole and are added
# after the all-reduce. LayerNorms, embeddings, pooler and head replicate.
BERT_TP_RULES = (
    (r"attention\.(query|key|value)\.weight$", ("model", None)),
    (r"attention\.(query|key|value)\.bias$", ("model",)),
    (r"attention\.out\.weight$", (None, "model")),
    (r"intermediate\.weight$", ("model", None)),
    (r"intermediate\.bias$", ("model",)),
    (r"(^|\.)output\.weight$", (None, "model")),
)

# Pipeline-parallel rule: the stacked encoder shards its layer axis over
# 'stage'; the trailing "..." replicates the rest whatever the rank.
BERT_PP_RULES = ((r"(^|\.)encoder\.", ("stage", "...")),)


def bert_tiny_config(vocab_size: int = 8192) -> BertConfig:
    """2 layers of 128: the offline width without pretrained weights."""
    return BertConfig(vocab_size=vocab_size, hidden_size=128, num_layers=2, num_heads=4,
                      intermediate_size=256, max_position=64)


def bert_small_config(vocab_size: int = 8192) -> BertConfig:
    """4 layers of 128."""
    return BertConfig(vocab_size=vocab_size, hidden_size=128, num_layers=4, num_heads=4,
                      intermediate_size=256, max_position=64)


class BertEmbeddings(nn.Module):
    """Word + position + token-type rows, each in ``dtype`` and summed in
    it, → LayerNorm → dropout."""

    def __init__(self, config: BertConfig):
        super().__init__()
        c = config
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = Embedding(c.max_position, c.hidden_size)
        self.token_type_embeddings = Embedding(c.type_vocab_size, c.hidden_size)
        self.layer_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout = Dropout(c.dropout_rate)

    def forward(self, input_ids: torch.Tensor, dtype: torch.dtype = torch.float32,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids, dtype) + self.position_embeddings(positions, dtype)
             + self.token_type_embeddings(token_type_ids, dtype))
        return self.dropout(self.layer_norm(x))


class BertLayer(nn.Module):
    """Post-LN encoder layer: x = LN(x + dropout(attn(x))), then
    LN(x + dropout(output(gelu(intermediate(x)))))."""

    def __init__(self, config: BertConfig):
        super().__init__()
        c = config
        self.attention = MultiHeadDotProductAttention(c.hidden_size, c.num_heads, c.dropout_rate)
        self.attention_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.intermediate = nn.Linear(c.hidden_size, c.intermediate_size)
        self.output = nn.Linear(c.intermediate_size, c.hidden_size)
        self.output_norm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout = Dropout(c.dropout_rate)
        self.tp_group = None

    def set_tensor_parallel(self, group, size: int) -> None:
        """Run as one of ``size`` tensor-parallel ranks over ``group`` (the
        weights are cut by ``BERT_TP_RULES``)."""
        self.attention.set_tensor_parallel(group, size)
        self.tp_group = group

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attention_norm(x + self.dropout(self.attention(x, mask)))
        if self.tp_group is None:
            y = linear(self.output, F.gelu(linear(self.intermediate, x)))
        else:
            h = F.gelu(linear(self.intermediate, copy_to_group(x, self.tp_group)))
            y = reduce_from_group(F.linear(h, self.output.weight.to(h.dtype)), self.tp_group)
            y = y + self.output.bias.to(h.dtype)
        return self.output_norm(x + self.dropout(y))


class BertClassifier(nn.Module):
    """BERT encoder → tanh pooler over [CLS] → dropout → classifier, on
    (B, L) integer ids."""

    def __init__(self, config: BertConfig, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.embeddings = BertEmbeddings(c)
        for i in range(c.num_layers):
            self.add_module(f"layer{i}", BertLayer(c))
        self.pooler = nn.Linear(c.hidden_size, c.hidden_size)
        self.dropout = Dropout(c.dropout_rate)
        self.classifier = nn.Linear(c.hidden_size, num_classes)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = input_ids != 0
        mask = attention_mask[:, None, None, :].bool()  # (B, 1, 1, L): over the keys
        x = self.embeddings(input_ids, self.dtype)
        for i in range(self.config.num_layers):
            x = getattr(self, f"layer{i}")(x, mask)
        pooled = self.dropout(torch.tanh(linear(self.pooler, x[:, 0, :])))
        return linear(self.classifier, pooled)


class StackedBertLayers(BertLayer):
    """``num_layers`` encoder layers as one ``BertLayer`` whose every
    parameter has a leading layer axis (the JAX ``encoder`` collection);
    ``layer(i, x, mask)`` runs layer ``i`` of what this module holds."""

    def __init__(self, config: BertConfig, num_layers: int):
        super().__init__(config)
        self.config = config
        with torch.no_grad():
            for module in self.modules():
                for name, p in list(module.named_parameters(recurse=False)):
                    setattr(module, name, nn.Parameter(p.detach().unsqueeze(0).repeat(
                        (num_layers,) + (1,) * p.ndim)))

    def fresh_layer(self) -> BertLayer:
        """An unstacked layer, for ``nn.common.flax_init_``."""
        return BertLayer(self.config)

    @property
    def num_stacked(self) -> int:
        return self.attention_norm.weight.shape[0]

    def layer(self, i: int, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        from torch.func import functional_call

        params = {name: p[i] for name, p in self.named_parameters()}
        return functional_call(self, params, (x, mask))


class PipelinedBertClassifier(nn.Module):
    """``BertClassifier`` with its encoder layers stacked (``encoder.*``),
    for GPipe pipeline parallelism (counterpart of the JAX module).

    The same math: embeddings, ``num_layers`` post-LN layers, tanh pooler
    over [CLS], head. ``num_stages`` S > 1 needs a ``(data, stage)`` mesh
    (``parallel/pipeline.get_mesh_pp``): stage s runs layers [s·L/S,
    (s+1)·L/S) over ``num_microbatches`` microbatches (S by default), stage
    0 the embeddings and the last stage the pooler and head
    (``parallel/pipeline.py``); the forward returns the logits on every
    stage. The trainer cuts the encoder by ``BERT_PP_RULES``; an uncut
    encoder runs its own stage's slice. With S = 1 the layers run in turn.
    Embeddings, pooler and head are held whole on every stage, as the JAX
    mesh replicates them. ``stack_bert_layers`` / ``unstack_bert_layers``
    convert checkpoints to and from ``BertClassifier``."""

    def __init__(self, config: BertConfig, num_classes: int, num_stages: int = 1, mesh=None,
                 num_microbatches: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        if num_stages < 1 or c.num_layers % num_stages:
            raise ValueError(f"{c.num_layers} layers not divisible by {num_stages} pipeline stages")
        self.config = c
        self.dtype = dtype
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches or num_stages
        self.mesh = mesh
        self.embeddings = BertEmbeddings(c)
        self.encoder = StackedBertLayers(c, c.num_layers)
        self.pooler = nn.Linear(c.hidden_size, c.hidden_size)
        self.dropout = Dropout(c.dropout_rate)
        self.classifier = nn.Linear(c.hidden_size, num_classes)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embeddings(input_ids, self.dtype)

    def run_layers(self, x: torch.Tensor, mask: Optional[torch.Tensor], stage: int = 0) -> torch.Tensor:
        """This stage's layers over ``x``: all the encoder holds where it is
        cut to the stage, else the stage's slice of the whole stack."""
        held = self.encoder.num_stacked
        per_stage = self.config.num_layers // self.num_stages
        first = 0 if held == per_stage else stage * per_stage
        for i in range(first, first + per_stage):
            x = self.encoder.layer(i, x, mask)
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        pooled = self.dropout(torch.tanh(linear(self.pooler, x[:, 0, :])))
        return linear(self.classifier, pooled)

    @staticmethod
    def key_mask(input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = input_ids != 0
        return attention_mask[:, None, None, :].bool()

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        mask = self.key_mask(input_ids, attention_mask)
        if self.num_stages > 1:
            if self.mesh is None:
                raise ValueError("num_stages > 1 requires a (data, stage) mesh")
            from multimodal_lipread_torch.parallel.pipeline import gpipe_forward

            return gpipe_forward(self, input_ids, mask, self.mesh, self.num_microbatches)
        return self.head(self.run_layers(self.embed(input_ids), mask))


def stack_bert_layers(state: Dict[str, torch.Tensor], num_layers: int) -> Dict[str, torch.Tensor]:
    """``BertClassifier`` ``state_dict`` (``layer0.*`` … ``layer{L-1}.*``) →
    ``PipelinedBertClassifier``'s (one ``encoder.*`` tensor per name, the
    layers stacked on a leading axis)."""
    out = {k: v for k, v in state.items() if not re.match(r"layer\d+\.", k)}
    for key in (k[len("layer0."):] for k in state if k.startswith("layer0.")):
        out[f"encoder.{key}"] = torch.stack([state[f"layer{i}.{key}"] for i in range(num_layers)])
    return out


def unstack_bert_layers(state: Dict[str, torch.Tensor], num_layers: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_bert_layers`: a pipelined checkpoint's
    parameters load into a ``BertClassifier``."""
    out = {k: v for k, v in state.items() if not k.startswith("encoder.")}
    for k, v in state.items():
        if k.startswith("encoder."):
            for i in range(num_layers):
                out[f"layer{i}.{k[len('encoder.'):]}"] = v[i].clone()
    return out


class HashingTokenizer:
    """Deterministic offline tokenizer: 0 = pad, 1 = [CLS], 2 = [SEP], each
    word hashed by its md5 into [3, vocab_size); ids (N, max_length) int32."""

    def __init__(self, vocab_size: int = 8192, max_length: int = 32):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.max_length), np.int32)
        for i, text in enumerate(texts):
            ids = [1]
            for tok in re.findall(r"[a-z0-9']+", text.lower()):
                h = int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "little")
                ids.append(3 + h % (self.vocab_size - 3))
                if len(ids) >= self.max_length - 1:
                    break
            ids.append(2)
            out[i, : len(ids)] = ids
        return out


def tokenize_texts(
    texts: Sequence[str], max_length: int = 32, vocab_size: int = 8192,
    hf_model: Optional[str] = "bert-base-uncased",
) -> np.ndarray:
    """The Hugging Face tokenizer ``hf_model`` where it is in the local
    cache, ``HashingTokenizer(vocab_size, max_length)`` otherwise (the
    choice is printed to stderr)."""
    from multimodal_lipread_torch.data.cues import _local_hf_weights_available

    if hf_model and _local_hf_weights_available(hf_model):
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(hf_model, local_files_only=True)
            enc = tok(list(texts), truncation=True, padding="max_length", max_length=max_length,
                      return_tensors="np")
            print(f"cue tokens: Hugging Face tokenizer {hf_model}", file=sys.stderr, flush=True)
            return enc["input_ids"].astype(np.int32)
        except (ImportError, OSError, ValueError):
            pass
    print(f"cue tokens: HashingTokenizer (vocabulary {vocab_size}, length {max_length})", file=sys.stderr,
          flush=True)
    return HashingTokenizer(vocab_size, max_length)(texts)
