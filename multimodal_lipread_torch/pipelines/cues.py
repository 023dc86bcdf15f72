"""Textual-cue classification pipeline (counterpart of the JAX package's
``pipelines/cues.py``).

    python -m multimodal_lipread_torch.pipelines.cues --config configs/cues_config.yaml \\
        [--set key=value ...] [--resume] [--device cuda|cpu]

The JAX pipeline's recipe: every cue record of one mode is pooled, the
labels are the sorted word set, the descriptions are featurized by the
model's embedding kind (``model.embedding`` overrides it): sentence or
token embeddings through the ``.npz`` cache of ``data/cues.py``, TF-IDF
(``data/tfidf.py``) for ``linear``, token ids for BERT (``HashingTokenizer``
unless the bert-base-uncased tokenizer is in the local cache). The records
are split 90/10 into train and val by ``training.split_seed`` (or, with
``dataset.use_file_splits``, by the split in their file names), and the
model trains with Adam and balanced class weights: ``linear_warmup`` for
the token-level and BERT models, otherwise a constant LR. The logs have
train and val columns only and there is no test unless the file splits
give one. Checkpoints go to ``<output.base_dir>/models_trained``, the
best one (``<model>_best.pt``) being what ``serving.py`` serves, and
every epoch also writes the rolling one (``<model>_checkpoint.pt``) that
``--resume`` continues from, as the port's other pipelines do (the JAX
pipeline writes it only with ``training.rolling_checkpoint``; for
bert-base it is about 1.25 GB with Adam's moments).

Under ``torch.distributed.run`` the BERT models take model parallelism,
as in the JAX pipeline (one or the other, never both):

- ``training.tensor_parallel: K``: a ``(data, model=K)`` mesh and
  ``BERT_TP_RULES`` (Megatron column/row-parallel layers, each rank
  running ``num_heads / K`` heads);
- ``training.pipeline_parallel: S``: a ``(data, stage=S)`` mesh, the
  ``PipelinedBertClassifier`` and ``BERT_PP_RULES`` (GPipe over
  ``training.pipeline_microbatches`` microbatches, S by default).

Checkpoints hold the whole model either way (a pipelined one loads into
``BertClassifier`` through ``models/bert.unstack_bert_layers``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.cues import CueRecord, embed_cached, load_cue_records
from multimodal_lipread_torch.models.cues import cue_embedding_kind, get_cue_model
from multimodal_lipread_torch.parallel.distributed import maybe_initialize_distributed
from multimodal_lipread_torch.pipelines.common import default_dirs, maybe_plot, model_dtype, parse_cli, trainer_extras
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig


def balanced_class_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """scikit-learn's ``compute_class_weight('balanced')``: n / (C · count),
    a class without examples counted once."""
    counts = np.maximum(np.bincount(labels, minlength=num_classes).astype(np.float64), 1.0)
    return (len(labels) / (num_classes * counts)).astype(np.float32)


def _featurize(records: List[CueRecord], kind: str, cache_dir: Optional[str], bert_size: str = "tiny") -> np.ndarray:
    descs = [r.description for r in records]
    if kind == "tfidf":
        from multimodal_lipread_torch.data.tfidf import TfidfVectorizer

        return TfidfVectorizer(max_features=5000).fit_transform(descs).astype(np.float32)
    if kind == "bert_tok":
        from multimodal_lipread_torch.models.bert import tokenize_texts

        # the hashed ids stay inside the tiny BERT's 8192-word vocabulary;
        # bert-base takes the Hugging Face tokenizer where it is cached
        return tokenize_texts(descs, hf_model="bert-base-uncased" if bert_size == "base" else None)
    if kind.endswith("_tok"):
        return embed_cached(descs, model=kind[: -len("_tok")], cache_dir=cache_dir, token_level=True)
    return embed_cached(descs, model=kind, cache_dir=cache_dir)


def load_cue_classification_data(
    cue_root: str,
    mode: str,
    kind: str,
    cache_dir: Optional[str] = None,
    val_fraction: float = 0.1,
    seed: int = 42,
    use_file_splits: bool = False,
    bert_size: str = "tiny",
) -> Tuple[Dict[str, ArrayDataset], List[str]]:
    """The featurized records split into datasets (train and val, and test
    with ``use_file_splits`` where the files give one) and the class list."""
    records = load_cue_records(cue_root, mode)
    if not records:
        raise RuntimeError(f"No cue records for mode '{mode}' under {cue_root}")
    classes = sorted({r.word for r in records})
    class_to_idx = {w: i for i, w in enumerate(classes)}
    feats = _featurize(records, kind, cache_dir, bert_size=bert_size)
    labels = np.asarray([class_to_idx[r.word] for r in records], np.int32)

    datasets: Dict[str, ArrayDataset] = {}
    if use_file_splits:
        for split in ("train", "val", "test"):
            m = np.asarray([r.split == split for r in records])
            if m.any():
                datasets[split] = ArrayDataset(inputs=(feats[m],), labels=labels[m])
        for required in ("train", "val"):
            if required not in datasets:
                raise RuntimeError(
                    f"use_file_splits=true but no cue records carry split '{required}' — "
                    f"check the _{required} JSON files under the cue store"
                )
    else:
        order = np.random.default_rng(seed).permutation(len(records))
        n_val = max(1, int(round(val_fraction * len(records))))
        val_idx, train_idx = order[:n_val], order[n_val:]
        datasets["train"] = ArrayDataset(inputs=(feats[train_idx],), labels=labels[train_idx])
        datasets["val"] = ArrayDataset(inputs=(feats[val_idx],), labels=labels[val_idx])
    return datasets, classes


def main(config: Union[Config, str], resume: bool = False, device: str = "cuda") -> Dict[str, Any]:
    if isinstance(config, str):
        from multimodal_lipread_torch.config import load_config

        config = load_config(config)
    cfg = config
    maybe_initialize_distributed(device)

    cue_root = cfg.get("dataset.cue_root") or cfg.get("dataset.root_dir")
    mode = cfg.get("dataset.cue_mode", "emotion")
    model_name = cfg.get("model.name", "dense_nn")
    kind = cfg.get("model.embedding", cue_embedding_kind(model_name))
    bert_size = cfg.get("model.bert_size", "tiny")
    tp = int(cfg.get("training.tensor_parallel", 1))
    pp = int(cfg.get("training.pipeline_parallel", 1))
    if tp > 1 and pp > 1:
        raise ValueError("training.tensor_parallel and training.pipeline_parallel are mutually exclusive — "
                         "pick one 2-D mesh")
    mesh, partition_rules = None, ()
    if tp > 1:
        if model_name not in ("bert", "bert_lite"):
            raise ValueError("training.tensor_parallel > 1 is only supported for the BERT cue models "
                             f"(got model.name={model_name!r})")
        from multimodal_lipread_torch.models.bert import BERT_TP_RULES
        from multimodal_lipread_torch.parallel.mesh import get_mesh_2d

        mesh, partition_rules = get_mesh_2d(tp), BERT_TP_RULES
    elif pp > 1:
        from multimodal_lipread_torch.models.bert import BERT_PP_RULES
        from multimodal_lipread_torch.parallel.pipeline import get_mesh_pp

        mesh, partition_rules = get_mesh_pp(pp), BERT_PP_RULES

    datasets, classes = load_cue_classification_data(
        cue_root, mode, kind, cache_dir=cfg.get("dataset.cache_dir"),
        val_fraction=cfg.get("training.val_fraction", 0.1),
        seed=cfg.get("training.split_seed", 42),
        use_file_splits=cfg.get("dataset.use_file_splits", False),
        bert_size=bert_size,
    )
    num_classes = len(classes)
    model = get_cue_model(model_name, num_classes, dtype=model_dtype(cfg), bert_size=bert_size, pipeline_stages=pp,
                          input_dim=datasets["train"].inputs[0].shape[-1], mesh=mesh if pp > 1 else None,
                          num_microbatches=int(cfg.get("training.pipeline_microbatches", 0)))
    metrics_dir, ckpt_dir = default_dirs(cfg, f"cues_{mode}")
    trainer = Trainer(
        model,
        TrainerConfig(
            param_partition_rules=partition_rules,
            model_name=model_name,
            num_classes=num_classes,
            class_names=tuple(classes),
            batch_size=cfg.get("training.batch_size", 8),
            epochs=cfg.get("training.epochs", 30),
            learning_rate=cfg.get("training.learning_rate", 1e-3),
            weight_decay=cfg.get("training.weight_decay", 0.0),
            scheduler_factor=1.0,  # the sentence-level cue trainers keep their LR
            lr_schedule="linear_warmup" if kind.endswith("_tok") else "plateau",
            warmup_proportion=cfg.get("training.warmup_proportion", 0.1),
            seed=cfg.get("training.seed", 42),
            metrics_dir=metrics_dir,
            checkpoints_dir=ckpt_dir,
            log_columns="train_val",
            test_every_epoch=False,
            class_weights=balanced_class_weights(datasets["train"].labels, num_classes),
            rolling_checkpoint=True,
            **trainer_extras(cfg),
        ),
        device=device,
        mesh=mesh,
    )
    result = trainer.fit(datasets["train"], datasets["val"], datasets.get("test"), resume=resume)
    maybe_plot(cfg, metrics_dir)
    return result


if __name__ == "__main__":
    cfg = parse_cli()
    main(cfg, resume=bool(cfg.get("_cli.resume", False)), device=cfg.get("_cli.device", "cuda"))
