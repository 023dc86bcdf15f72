"""Ranks of the PyTorch port's multi-process tests (tests/test_torch_ddp.py,
test_torch_tensor_parallel.py, test_torch_pipeline_parallel.py,
test_torch_checkpoint_backends.py, test_torch_mixup_ranks.py).

``run_ranks(case, world, workdir, inputs)`` starts ``world`` processes of
this file, each ``python tests/torch_dist_worker.py CASE WORKDIR`` with
``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` in its environment; they meet over a
``FileStore`` in ``workdir`` (no port, so tests under xdist do not
collide), join a gloo group on the CPU through
``parallel.distributed.maybe_initialize_distributed``, run ``case_<CASE>``
on the ``inputs`` the test saved, and write what each rank returns to
``workdir/result_<rank>.pt``. Any rank that fails fails the test.

This module imports torch, numpy and the port only: a spawned rank must
not import JAX (``tests/conftest.py`` does), as ``tests/mp_fit_worker.py``
keeps the JAX package's ranks apart.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 4


def run_ranks(case: str, world: int, workdir: str, inputs: Optional[Dict[str, Any]] = None,
              timeout: float = 240.0, device: str = "cpu", backend: str = "gloo") -> List[Dict[str, Any]]:
    """Run ``case_<case>`` on ``world`` ranks (on ``device`` over
    ``backend``; ranks on a card share card 0); returns each rank's
    result."""
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs or {}, os.path.join(workdir, "inputs.pt"))
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
               "OMP_NUM_THREADS": "1", "MLT_TEST_DEVICE": device, "MLT_TEST_BACKEND": backend,
               "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
        env.pop("MASTER_ADDR", None)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), case, workdir], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} of '{case}' exited with {p.returncode}:\n{out[-6000:]}")
    return [torch.load(os.path.join(workdir, f"result_{r}.pt"), weights_only=False) for r in range(world)]


# ------------------------------------------------------------------ models


class BnMlp(nn.Module):
    """The port's counterpart of tests/test_mesh_invariance.py's ``_BnMlp``
    (Dense 32 → BatchNorm at Flax's default momentum 0.99 → ReLU → Dense 4;
    its dropout off), under the Flax module's names so that
    ``utils/jax_bridge.py`` loads its weights."""

    def __init__(self):
        super().__init__()
        from multimodal_lipread_torch.nn.common import BatchNorm

        self.Dense_0 = nn.Linear(16, 32)
        self.BatchNorm_0 = BatchNorm(32, momentum=0.99)
        self.Dense_1 = nn.Linear(32, NUM_CLASSES)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.BatchNorm_0(self.Dense_0(x))))


class Tiny(nn.Module):
    """tests/test_elastic_resume.py's ``_Tiny``: Dense 16 → ReLU → Dense 4."""

    def __init__(self, features: int = 20):
        super().__init__()
        self.Dense_0 = nn.Linear(features, 16)
        self.Dense_1 = nn.Linear(16, NUM_CLASSES)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x.reshape(x.shape[0], -1))))


def mlp_data(n: int, seed: int):
    """tests/test_mesh_invariance.py's data."""
    from multimodal_lipread_torch.train.trainer import ArrayDataset

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 16)).astype(np.float32)
    labels = (np.arange(n) % NUM_CLASSES).astype(np.int32)
    for i, label in enumerate(labels):
        x[i, label * 3 : label * 3 + 3] += 2.0
    return ArrayDataset(inputs=(x,), labels=labels)


def tiny_data(n: int = 48, seed: int = 0, features: int = 20):
    """tests/test_elastic_resume.py's data."""
    from multimodal_lipread_torch.train.trainer import ArrayDataset

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)
    x = rng.standard_normal((n, features)).astype(np.float32) * 0.1
    for i, label in enumerate(labels):
        x[i, label * 5 : label * 5 + 5] += 2.0
    return ArrayDataset(inputs=(x,), labels=labels)


def trainer_config(workdir: str, tag: str, **kw):
    from multimodal_lipread_torch.train.trainer import TrainerConfig

    cfg = dict(model_name=f"m_{tag}", num_classes=NUM_CLASSES, batch_size=16, epochs=3, learning_rate=1e-2,
               weight_decay=1e-4, test_every_epoch=False, seed=0,
               metrics_dir=os.path.join(workdir, tag, "m"), checkpoints_dir=os.path.join(workdir, tag, "c"))
    cfg.update(kw)
    return TrainerConfig(**cfg)


def one_step_records(trainer, ds) -> Dict[str, Any]:
    """The losses (over every rank), the reduced gradients and the BatchNorm
    statistics after each step of ``ds``'s unshuffled batches."""
    import torch.distributed as dist

    from multimodal_lipread_torch.parallel.distributed import is_initialized

    out: Dict[str, Any] = {"loss": [], "grads": [], "stats": []}
    for inputs, labels, weights in trainer.batches(ds, False, np.random.default_rng(0)):
        s = trainer.train_step(inputs, labels, weights).double()
        if is_initialized():
            dist.all_reduce(s)
        out["loss"].append(float(s[0] / s[3]))
        out["grads"].append({n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()})
        out["stats"].append({n: b.detach().cpu().clone() for n, b in trainer.model.named_buffers()})
    return out


def history(result: Dict[str, Any]) -> List[Dict[str, float]]:
    keys = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc", "lr")
    return [{k: h[k] for k in keys if k in h} for h in result["history"]]


# ------------------------------------------------------------------ cases


def case_dp(rank: int, world: int, workdir: str, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Data parallelism: one step per batch at lr 0 (n = 24, batch 16, the
    second batch padded), a 3-epoch fit, an elastic run's first 2 epochs,
    a preempted and resumed run against an uninterrupted one, and a
    streaming run over uneven shards."""
    from multimodal_lipread_torch.data.grain_loader import StreamingDataset
    from multimodal_lipread_torch.train.trainer import Trainer

    from multimodal_lipread_torch.parallel.mesh import get_mesh, replicate

    out: Dict[str, Any] = {}
    weights = inputs["weights"]
    held = [torch.full((3,), float(rank + 1)), torch.arange(4.0) * (rank + 1)]
    replicate(get_mesh(), held)
    out["replicated"] = held

    t = Trainer(BnMlp(), trainer_config(workdir, f"step{rank}", learning_rate=0.0), device="cpu")
    t.init_state()
    t.load_weights({"params": weights["params"], "batch_stats": weights["batch_stats"]})
    out["step"] = one_step_records(t, mlp_data(24, 0))

    t = Trainer(BnMlp(), trainer_config(workdir, f"fit{rank}"), device="cpu")
    t.init_state()
    t.load_weights({"params": weights["params"], "batch_stats": weights["batch_stats"]})
    out["fit"] = history(t.fit(mlp_data(40, 0), mlp_data(24, 1), None, progress=None))
    out["fit_batch_size"] = t.batch_size

    elastic = trainer_config(inputs["elastic_dir"], "elastic", epochs=2, weight_decay=0.0, rolling_checkpoint=True)
    Trainer(Tiny(), elastic, device="cpu").fit(tiny_data(48, 0), tiny_data(16, 1), progress=None)

    # preemption: rank 1 asks in epoch 2; every rank stops at its end
    def tiny_trainer(tag):
        return Trainer(Tiny(), trainer_config(workdir, tag, epochs=4, weight_decay=0.0, rolling_checkpoint=True,
                                              handle_preemption=True), device="cpu")

    full = tiny_trainer("uninterrupted").fit(tiny_data(48, 0), tiny_data(16, 1), progress=None)
    pre = tiny_trainer("preempt")
    step = pre.train_step

    def train_step(*args):
        stats = step(*args)
        if rank == 1 and pre.step == 4:  # the first step of epoch 2 (3 steps an epoch)
            pre.request_preemption()
        return stats

    pre.train_step = train_step
    stopped = pre.fit(tiny_data(48, 0), tiny_data(16, 1), progress=None)
    resumed = tiny_trainer("preempt").fit(tiny_data(48, 0), tiny_data(16, 1), resume=True, progress=None)
    out["preempt"] = {"stopped": bool(stopped.get("preempted")), "stopped_epochs": len(stopped["history"]),
                      "resumed": history(resumed), "full": history(full)}

    # streaming over 65 records: shards of 33 and 32, 4 rows a rank a step
    source = [{"x": np.full((20,), i, np.float32) / 65.0, "label": i % NUM_CLASSES} for i in range(65)]
    ds = StreamingDataset(source, ("x",), seed=0)
    st = Trainer(Tiny(), trainer_config(workdir, f"stream{rank}", batch_size=8, epochs=2,
                                        lr_schedule="linear_warmup", learning_rate=1e-2), device="cpu")
    lrs: List[float] = []
    set_lr = st._set_lr
    st._set_lr = lambda lr: (lrs.append(float(lr)), set_lr(lr))
    res = st.fit(ds, tiny_data(16, 1), progress=None)
    out["stream"] = {"len": len(ds), "shard": (ds.shard_index, ds.shard_count), "rows": st.stream_batch_rows(),
                     "global_batches": ds.global_batches(st.stream_batch_rows()), "lrs": lrs, "history": history(res)}
    return out


def mlp_steps(workdir: str, tag: str, inputs: Dict[str, Any], device: str) -> Dict[str, Any]:
    """``one_step_records`` of ``BnMlp`` from ``inputs['weights']`` at
    ``inputs['lr']`` on ``inputs['n']`` rows, on ``device``."""
    from multimodal_lipread_torch.train.trainer import Trainer

    t = Trainer(BnMlp(), trainer_config(workdir, tag, learning_rate=inputs["lr"]), device=device)
    t.init_state()
    t.load_weights(inputs["weights"])
    return one_step_records(t, mlp_data(inputs["n"], 0))


def case_mlp_steps(rank: int, world: int, workdir: str, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """:func:`mlp_steps` on this rank (the card tests: NCCL at world 1, two
    gloo ranks sharing the card)."""
    return mlp_steps(workdir, f"steps{rank}", inputs, os.environ["MLT_TEST_DEVICE"])


def case_graph_steps(rank: int, world: int, workdir: str, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """``BnMlp`` device-resident for 3 epochs of 10 steps, eager and as CUDA
    graphs of 4 steps (the card tests: DDP over NCCL at world 1)."""
    from multimodal_lipread_torch.train.trainer import Trainer

    device = os.environ["MLT_TEST_DEVICE"]
    out: Dict[str, Any] = {}
    for k in (1, 4):
        t = Trainer(BnMlp(), trainer_config(workdir, f"graph{k}", device_resident=True, steps_per_dispatch=k),
                    device=device)
        t.init_state()
        t.load_weights(inputs["weights"])
        out[k] = history(t.fit(mlp_data(160, 0), mlp_data(48, 1), None, progress=None))
        out[f"graphs{k}"] = len(t._graphs)
    return out


def case_audio(rank: int, world: int, workdir: str, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """``pipelines.audio.main`` on this rank."""
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.pipelines.audio import main

    cfg = Config.from_dict({**inputs["config"], "output": {"base_dir": os.path.join(workdir, f"run{rank}"),
                                                           "plots": False}})
    return {"history": history(main(cfg, device="cpu"))}


def bert_trainer(workdir: str, tag: str, model, mesh=None, rules=(), **kw):
    from multimodal_lipread_torch.train.trainer import Trainer

    cfg = trainer_config(workdir, tag, **{"batch_size": 8, "epochs": 1, "learning_rate": 1e-3, "weight_decay": 0.0,
                                          "param_partition_rules": tuple(rules), **kw})
    return Trainer(model, cfg, device="cpu", mesh=mesh)


def ids_dataset(ids: np.ndarray, labels: np.ndarray):
    from multimodal_lipread_torch.train.trainer import ArrayDataset

    return ArrayDataset(inputs=(ids,), labels=labels)


def cue_main(inputs: Dict[str, Any], workdir: str, rank: int, **training) -> Dict[str, Any]:
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.pipelines.cues import main

    cfg = Config.from_dict({
        "dataset": {"root_dir": inputs["cue_root"], "cue_root": inputs["cue_root"]},
        "model": {"name": "bert", "bert_size": "tiny"},
        "training": {"epochs": 1, "batch_size": 8, "learning_rate": 1e-3, **training},
        "output": {"base_dir": os.path.join(workdir, f"cues{rank}"), "plots": False},
    })
    result = main(cfg, device="cpu")
    return {"history": history(result), "best": os.path.join(workdir, f"cues{rank}", "models_trained",
                                                                "bert_best.pt")}


def case_tp(rank: int, world: int, workdir: str, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Tensor parallelism at degree 2: the cut shapes, 3 steps and an
    evaluation, checkpoints to and from data parallelism, and the cue
    pipeline."""
    from multimodal_lipread_torch.models.bert import BERT_TP_RULES, BertClassifier, BertConfig
    from multimodal_lipread_torch.parallel.mesh import get_mesh_2d

    cfg = BertConfig(**inputs["bert_config"])
    ds = ids_dataset(inputs["ids"], inputs["labels"])
    mesh = get_mesh_2d(2)
    out: Dict[str, Any] = {}

    t = bert_trainer(workdir, f"tp{rank}", BertClassifier(cfg, NUM_CLASSES), mesh, BERT_TP_RULES)
    t.init_state()
    t.load_weights({"params": inputs["params"], "batch_stats": {}})
    out["losses"] = [t.train_single_batch(ds, seed=s) for s in range(3)]
    ev = t.evaluate(ds)
    out["eval"] = (ev.loss, ev.acc)
    out["shapes"] = {n: tuple(p.shape) for n, p in t.model.named_parameters()}
    moments = {}
    for i, name in enumerate(t._opt_names):
        state = t.optimizer.state[t.optimizer.param_groups[0]["params"][i]]
        moments[name] = (tuple(state["exp_avg"].shape), tuple(state["exp_avg_sq"].shape))
    out["moments"] = moments
    out["heads"] = t.model.layer0.attention.num_heads

    # a data-parallel checkpoint resumes tensor-parallel, and the other way
    dp_to_tp = bert_trainer(inputs["dp_dir"], "elastic", BertClassifier(cfg, NUM_CLASSES), mesh, BERT_TP_RULES,
                            epochs=2, rolling_checkpoint=True)
    res = dp_to_tp.fit(ds, ds, resume=True, progress=None)
    out["dp_to_tp"] = {"history": history(res),
                       "query_shape": tuple(dp_to_tp.model.layer0.attention.query.weight.shape)}
    bert_trainer(inputs["tp_dir"], "elastic", BertClassifier(cfg, NUM_CLASSES), mesh, BERT_TP_RULES,
                 rolling_checkpoint=True).fit(ds, ds, progress=None)

    out["pipeline"] = cue_main(inputs, workdir, rank, tensor_parallel=2)
    return out


def case_pp(rank: int, world: int, workdir: str, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """GPipe with S = world stages (M = S unless given): the forward and the
    gradients, 3 steps and an evaluation, the cut shapes, the exported
    checkpoint, the refusals and (at S = 2) the cue pipeline."""
    import torch.nn.functional as F

    from multimodal_lipread_torch.models.bert import BERT_PP_RULES, BertConfig, PipelinedBertClassifier
    from multimodal_lipread_torch.parallel.pipeline import gpipe_train_step, get_mesh_pp, reduce_grads

    cfg = BertConfig(**inputs["bert_config"])
    S = world
    mesh = get_mesh_pp(S)
    ids, labels = torch.from_numpy(inputs["ids"]), torch.from_numpy(inputs["labels"]).long()
    out: Dict[str, Any] = {}

    def model(m=0):
        net = PipelinedBertClassifier(cfg, NUM_CLASSES, num_stages=S, mesh=mesh, num_microbatches=m)
        net.load_state_dict(inputs["stacked"])
        return net

    net = model().eval()
    with torch.no_grad():
        out["logits"] = net(ids).numpy()
    net.train()
    ones = torch.ones(len(ids))
    stats = gpipe_train_step(net, ids, labels, ones, ones, torch.tensor(float(len(ids))), mesh, S)
    reduce_grads(net, mesh)
    out["mean_ce"] = float(stats[0] / stats[3])
    out["grads"] = {n: p.grad.clone() for n, p in net.named_parameters()}
    with torch.no_grad():
        out["mean_ce_plain"] = float(F.cross_entropy(net.eval()(ids).float(), labels))

    ds = ids_dataset(inputs["ids"][: inputs["train_rows"]], inputs["labels"][: inputs["train_rows"]])
    t = bert_trainer(workdir, f"pp{rank}", model(), mesh, BERT_PP_RULES)
    t.init_state()
    t.load_weights({"params": inputs["stacked"], "batch_stats": {}})
    out["losses"] = [t.train_single_batch(ds, seed=s) for s in range(3)]
    ev = t.evaluate(ds)
    out["eval"] = (ev.loss, ev.acc)
    out["shapes"] = {n: tuple(p.shape) for n, p in t.model.named_parameters()}
    out["moments"] = {name: tuple(t.optimizer.state[p]["exp_avg"].shape)
                      for name, p in zip(t._opt_names, t.optimizer.param_groups[0]["params"])}
    out["exported"] = t._export_state()["params"]
    with torch.no_grad():
        out["trained_logits"] = t.model.eval()(torch.from_numpy(ds.inputs[0])).numpy()

    refused = {}
    for name, build in {
        "microbatches": lambda: model(3)(ids[:8]),
        "mixup": lambda: bert_trainer(workdir, "x", model(), mesh, BERT_PP_RULES, mixup_alpha=0.2),
        "remat": lambda: bert_trainer(workdir, "x", model(), mesh, BERT_PP_RULES, remat=True),
        "batchnorm": lambda: bert_trainer(workdir, "x", BnMlp(), mesh, BERT_PP_RULES),
    }.items():
        try:
            build()
            refused[name] = None
        except (ValueError, NotImplementedError) as e:
            refused[name] = f"{type(e).__name__}: {e}"
    out["refused"] = refused
    if S == 2:
        out["pipeline"] = cue_main(inputs, workdir, rank, pipeline_parallel=2)
    return out


def case_ckpt(rank: int, world: int, workdir: str, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """The orbax checkpoint backends over the ranks, every rank writing one
    shared directory under ``inputs['shared']``: ``Tiny`` data-parallel for
    2 epochs with ``orbax_async`` rolling checkpoints (its history and
    final state returned), then BERT at tensor_parallel 2 with ``orbax``
    (its history and the full parameters it exports)."""
    from multimodal_lipread_torch.models.bert import BERT_TP_RULES, BertClassifier, BertConfig
    from multimodal_lipread_torch.parallel.mesh import get_mesh_2d
    from multimodal_lipread_torch.train.trainer import Trainer

    shared = inputs["shared"]
    out: Dict[str, Any] = {}
    t = Trainer(Tiny(), trainer_config(shared, "ddp", epochs=2, weight_decay=0.0, rolling_checkpoint=True,
                                       checkpoint_backend="orbax_async"), device="cpu")
    res = t.fit(tiny_data(48, 0), tiny_data(16, 1), progress=None)
    out["ddp"] = {"history": history(res), "state": t._export_state(opt_to_cpu=True)}

    tp = bert_trainer(shared, "tp", BertClassifier(BertConfig(**inputs["bert_config"]), NUM_CLASSES), get_mesh_2d(2),
                      BERT_TP_RULES, rolling_checkpoint=True, checkpoint_backend="orbax")
    tp.init_state()
    tp.load_weights({"params": inputs["params"], "batch_stats": {}})
    ds = ids_dataset(inputs["ids"], inputs["labels"])
    out["tp"] = {"history": history(tp.fit(ds, ds, progress=None)), "params": tp._export_state()["params"],
                 "query_shape": tuple(tp.model.layer0.attention.query.weight.shape)}
    return out


def case_mixup(rank: int, world: int, workdir: str, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Mixup over the data-parallel ranks (``training.mixup_alpha`` 0.4, an
    MLP with BatchNorm and dropout): 3 steps on the unshuffled batches of 48
    rows at batch 16 at lr 0 and at lr 1e-2, each step's mix (this rank's
    mixed inputs and soft labels), the bytes of the last exchange, and the
    same steps with remat; a 3-epoch fit (its last batch padded) and the
    dropout generator after it; one step with the last global row at weight
    0 against the step without mixup (dropout off); and one step at the
    fixed λ and permutation of ``inputs``."""
    from multimodal_lipread_torch.nn.common import MLP
    from multimodal_lipread_torch.train import trainer as trainer_module
    from multimodal_lipread_torch.train.trainer import Trainer

    def make(tag, dropout=0.3, **kw):
        cfg = trainer_config(workdir, f"{tag}{rank}", **{"mixup_alpha": 0.4, **kw})
        t = Trainer(MLP(16, (32,), NUM_CLASSES, dropout_rate=dropout, use_batchnorm=True), cfg, device="cpu")
        t.init_state()
        return t

    mixes: List[Any] = []
    mix, draw = trainer_module.mixup, trainer_module.draw_mixup

    def recording_mix(*args, **kwargs):
        out = mix(*args, **kwargs)
        mixes.append((out[0][0].detach().clone(), out[1].detach().clone()))
        return out

    out: Dict[str, Any] = {}
    trainer_module.mixup = recording_mix
    try:
        for key, kw in (("lr0", {"learning_rate": 0.0}), ("lr", {}), ("remat_lr", {"remat": True})):
            del mixes[:]
            t = make(key, **kw)
            out[key] = one_step_records(t, mlp_data(48, 0))
            out[key]["mixes"] = list(mixes)
            out[key]["params"] = {n: p.detach().clone() for n, p in t.model.named_parameters()}
            out[key]["exchange_bytes"] = t.exchange_bytes
        t = make("fit")
        out["fit"] = history(t.fit(mlp_data(40, 0), mlp_data(24, 1), None, progress=None))
        out["generator"] = t.dropout_generator.get_state()

        rows = 16 // world
        x = torch.from_numpy(mlp_data(16, 0).inputs[0][rank * rows:(rank + 1) * rows])
        labels = torch.from_numpy(mlp_data(16, 0).labels[rank * rows:(rank + 1) * rows]).long()
        weights = torch.ones(rows)
        if rank == world - 1:
            weights[-1] = 0.0
        padded = {}
        for tag, alpha in (("off", 0.0), ("on", 0.4)):
            t = make(f"pad_{tag}", dropout=0.0, mixup_alpha=alpha)
            stats = t.train_step((x,), labels, weights)
            padded[tag] = (stats, {n: p.detach().clone() for n, p in t.model.named_parameters()})
        out["padded"] = padded

        lam, perm = torch.tensor(inputs["lam"]), torch.as_tensor(inputs["perm"]).long()
        trainer_module.draw_mixup = lambda *args, **kwargs: (lam, perm)
        del mixes[:]
        make("fixed", dropout=0.0).train_step((x,), labels, torch.ones(rows))
        out["fixed"] = mixes[0]
    finally:
        trainer_module.mixup, trainer_module.draw_mixup = mix, draw
    return out


def main(argv: List[str]) -> int:
    case, workdir = argv
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    from multimodal_lipread_torch.parallel.distributed import maybe_initialize_distributed

    maybe_initialize_distributed(os.environ["MLT_TEST_DEVICE"], init_method="file://" + os.path.join(workdir, "store"),
                                 backend=os.environ["MLT_TEST_BACKEND"])
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    result = globals()[f"case_{case}"](rank, world, workdir, inputs)
    torch.save(result, os.path.join(workdir, f"result_{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
