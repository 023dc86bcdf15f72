"""The orbax checkpoint backends of the port (``train/checkpoint.py``:
``torch.distributed.checkpoint`` directories) on the CPU, at small shapes:

- the port's trainer with ``checkpoint_backend: orbax`` against the JAX
  trainer's, from the same weights, on tests/test_torch_trainer.py's MLP and
  small vgg_lstm cases: the history, the file names, and the parameters
  read back from the two ``.orbax`` directories (the JAX one restored with
  orbax and carried across by ``utils/jax_bridge``);
- exact resume for all three backends; an ``orbax_async`` fit on disk when
  ``fit`` returns; an async save that has copied the state before the next
  optimizer step changes it in place;
- atomic replacement: a save that fails half-way leaves the previous
  checkpoint readable and nothing partial under the final name, and the
  background failure is re-raised by ``wait_for_async_saves``;
- serving a ``.orbax`` directory gives the ``.pt`` file's logits bit for
  bit and reads no Adam key;
- ``pipelines.audio.main`` trains, resumes and serves with ``orbax_async``;
- two gloo ranks write one shared directory, each tensor once, which
  resumes at one rank; BERT at tensor_parallel 2 saves the full tensors;
- an unknown backend raises ``ValueError``.
"""

import json
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from test_torch_trainer import CASES, HISTORY_RTOL, NUM_CLASSES, PARAM_P99_PER_LR, _configs, _data
from torch_dist_worker import Tiny, bert_trainer, history, ids_dataset, run_ranks, tiny_data, trainer_config
from torch_parity_utils import one_torch_thread, random_variables  # noqa: F401

from multimodal_lipread_tpu.train.trainer import ArrayDataset as JArrayDataset
from multimodal_lipread_tpu.train.trainer import Trainer as JTrainer

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.nn import MLP
from multimodal_lipread_torch.train import checkpoint as ckpt
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax

BACKENDS = ("msgpack", "orbax", "orbax_async")
# The JAX trainer's and the port's histories and saved tensors after a fit
# of 6 steps from the same weights. The MLP's hold 1e-4. The vgg_lstm's are
# held at tests/test_torch_trainer.py's HISTORY_RTOL: in this fit's batch
# order the two float32 forwards round a few max-pool windows' two largest
# inputs the other way from the third step on (1.4e-3 apart there; 2e-6 in
# the first step), and the trajectories part as that file's header says.
RTOL = {"mlp_bn": 1e-4, "vgg_lstm": HISTORY_RTOL}
STEPS = 6  # 20 rows in batches of 8, 2 epochs


# --- the port's orbax fit against the JAX trainer's ---------------------------


@pytest.fixture(scope="module", params=sorted(CASES))
def fits(request, tmp_path_factory):
    """The JAX trainer and the port's fit 2 epochs with ``orbax`` rolling
    and best checkpoints from the same weights; the port's also with
    ``msgpack``."""
    tmp = tmp_path_factory.mktemp(f"orbax_{request.param}")
    jmodel, pmodel, shape, off, lr, kwargs = CASES[request.param]()
    x, y = _data(20, shape, seed=1, offset=off)
    val, test = (_data(12, shape, seed=s, offset=off) for s in (2, 3))
    jcfg, _ = _configs(tmp, lr, {**kwargs, "checkpoint_backend": "orbax", "rolling_checkpoint": True}, "jax")
    jt = JTrainer(jmodel, jcfg)
    jt.init_state((x,))
    v = random_variables(jmodel, x[:2], seed=5)
    host = jax.tree_util.tree_map(np.asarray, jt.state)
    jt.state = jt._place({**host, "params": v["params"], "batch_stats": v.get("batch_stats", {})})
    jfit = jt.fit(JArrayDataset((x,), y), JArrayDataset((val[0],), val[1]), JArrayDataset((test[0],), test[1]),
                  progress=None)
    pfit = {}
    for backend in ("orbax", "msgpack"):
        side = "torch" if backend == "orbax" else "torch_pt"
        _, pcfg = _configs(tmp, lr, {**kwargs, "checkpoint_backend": backend, "rolling_checkpoint": True}, side)
        pt = Trainer(CASES[request.param]()[1] if pfit else pmodel, pcfg, device="cpu")
        pt.init_state()
        pt.model.load_state_dict(state_dict_from_jax(v["params"], v.get("batch_stats", {})), strict=True)
        pfit[backend] = pt.fit(ArrayDataset((x,), y), ArrayDataset((val[0],), val[1]),
                               ArrayDataset((test[0],), test[1]), progress=None)
    return dict(jfit=jfit, pfit=pfit["orbax"], msgpack=pfit["msgpack"], tmp=tmp, rtol=RTOL[request.param], lr=lr)


def test_orbax_fit_history_matches_jax(fits):
    jh, ph = fits["jfit"]["history"], fits["pfit"]["history"]
    rtol = fits["rtol"]
    assert [h["epoch"] for h in ph] == [h["epoch"] for h in jh] == [1, 2]
    for key in ("train_loss", "val_loss", "test_loss", "lr"):
        np.testing.assert_allclose([h[key] for h in ph], [h[key] for h in jh], rtol=rtol, err_msg=key)
    for key in ("train_acc", "val_acc", "test_acc"):
        assert [h[key] for h in ph] == [h[key] for h in jh], key
    np.testing.assert_allclose(fits["pfit"]["final_test_loss"], fits["jfit"]["final_test_loss"], rtol=rtol)


def test_orbax_fit_equals_the_msgpack_fit(fits):
    keys = ("train_loss", "train_acc", "val_loss", "val_acc", "test_loss", "test_acc", "lr")
    assert [[h[k] for k in keys] for h in fits["pfit"]["history"]] == [[h[k] for k in keys]
                                                                      for h in fits["msgpack"]["history"]]
    assert fits["pfit"]["final_test_loss"] == fits["msgpack"]["final_test_loss"]


def test_orbax_fit_writes_the_jax_file_names(fits):
    tmp = fits["tmp"]
    names = sorted(os.listdir(tmp / "torch" / "ckpt"))
    assert names == sorted(os.listdir(tmp / "jax" / "ckpt")) == ["m_best.orbax", "m_checkpoint.orbax"]
    assert fits["pfit"]["best_checkpoint"] == str(tmp / "torch" / "ckpt" / "m_best.orbax")


@pytest.mark.parametrize("kind", ["best", "checkpoint"])
def test_orbax_tensors_match_the_jax_orbax_directory(fits, kind):
    tmp = fits["tmp"]
    with ocp.StandardCheckpointer() as reader:
        theirs = reader.restore(os.path.abspath(tmp / "jax" / "ckpt" / f"m_{kind}.orbax"))
    ours = ckpt.load_checkpoint_orbax(str(tmp / "torch" / "ckpt" / f"m_{kind}.orbax"))
    want = state_dict_from_jax(theirs["state"]["params"], theirs["state"].get("batch_stats", {}))
    got = {**ours["state"]["params"], **ours["state"]["batch_stats"]}
    pt = ckpt.load_checkpoint(str(tmp / "torch_pt" / "ckpt" / f"m_{kind}.pt"))["state"]
    rtol = fits["rtol"]
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], {**pt["params"], **pt["batch_stats"]}[name]), name
        # a bias straight before a BatchNorm has an exactly zero gradient
        # (training-mode BatchNorm subtracts it again), so Adam steps it by
        # about ±lr on rounding noise in either trainer; it changes no output
        feeds_bn = name.endswith(".bias") and any(b in name for b in ("dense", "conv", "fc1"))
        atol = 2 * STEPS * fits["lr"] if feeds_bn or rtol > 1e-4 else rtol
        torch.testing.assert_close(got[name], want[name], rtol=rtol, atol=atol, msg=name)
    for key in ("epoch", "scheduler_has_best", "scheduler_bad_epochs"):
        assert ours[key] == theirs[key], key
    for key in ("val_acc", "best_val_acc", "scheduler_lr", "scheduler_best"):
        assert ours[key] == pytest.approx(float(theirs[key]), rel=rtol), key
    assert int(ours["state"]["step"]) == int(theirs["state"]["step"])


# --- resume, durability, the snapshot at save --------------------------------


def _mlp_trainer(tmp, epochs, backend, **kwargs):
    cfg = TrainerConfig(model_name="m", num_classes=NUM_CLASSES, batch_size=8, epochs=epochs, learning_rate=1e-2,
                        seed=3, rolling_checkpoint=True, scheduler_patience=0, checkpoint_backend=backend,
                        metrics_dir=str(tmp / "metrics"), checkpoints_dir=str(tmp / "ckpt"), **kwargs)
    return Trainer(MLP(10, (16,), NUM_CLASSES, 0.3, True), cfg, device="cpu")


def _splits():
    return [ArrayDataset((x,), y) for x, y in (_data(n, (10,), seed=s) for n, s in ((21, 1), (9, 2), (9, 3)))]


@pytest.mark.parametrize("backend", BACKENDS)
def test_resume_is_exact_for_every_backend(tmp_path, backend):
    # dropout on: the resumed run must also restore the dropout generator
    splits = _splits()
    whole = _mlp_trainer(tmp_path / "whole", 3, backend).fit(*splits, progress=None)
    _mlp_trainer(tmp_path / "cut", 1, backend).fit(*splits, progress=None)
    resumed = _mlp_trainer(tmp_path / "cut", 3, backend).fit(*splits, resume=True, progress=None)
    keys = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc", "test_loss", "test_acc", "lr")
    assert [[h[k] for k in keys] for h in resumed["history"]] == [[h[k] for k in keys] for h in whole["history"][1:]]
    assert resumed["final_test_loss"] == whole["final_test_loss"]
    suffix = ".pt" if backend == "msgpack" else ".orbax"
    assert sorted(os.listdir(tmp_path / "cut" / "ckpt")) == [f"m_best{suffix}", f"m_checkpoint{suffix}"]


def test_async_fit_is_on_disk_when_fit_returns(tmp_path):
    trainer = _mlp_trainer(tmp_path, 2, "orbax_async")
    result = trainer.fit(*_splits(), progress=None)
    assert ckpt._pending == []
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["m_best.orbax", "m_checkpoint.orbax"]
    rolling = ckpt.load_checkpoint_orbax(str(tmp_path / "ckpt" / "m_checkpoint.orbax"))
    assert rolling["epoch"] == 2
    assert set(rolling["state"]["opt_state"]["state"]) == set(range(len(trainer.trainable_parameters())))
    for name, value in trainer.model.state_dict().items():
        assert torch.equal({**rolling["state"]["params"], **rolling["state"]["batch_stats"]}[name], value), name
    # a fresh trainer resumes from it: nothing left of 2 epochs, one more of 3
    again = _mlp_trainer(tmp_path, 2, "orbax_async").fit(*_splits(), resume=True, progress=None)
    assert again["history"] == [] and again["final_test_loss"] == result["final_test_loss"]
    more = _mlp_trainer(tmp_path, 3, "orbax_async").fit(*_splits(), resume=True, progress=None)
    assert [h["epoch"] for h in more["history"]] == [3]


def test_async_save_holds_the_state_from_before_the_next_step(tmp_path):
    trainer = _mlp_trainer(tmp_path, 1, "orbax_async")
    trainer.init_state()
    ds = _splits()[0]
    batches = list(trainer.batches(ds, True, np.random.default_rng(0)))
    trainer.train_step(*batches[0])
    tree = trainer.checkpoint_tree(1, 50.0, 50.0)
    before = {i: {k: v.clone() for k, v in s.items()} for i, s in trainer.optimizer.state_dict()["state"].items()}
    params = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    ckpt.save_checkpoint_orbax(str(tmp_path / "snap.orbax"), tree, async_save=True)
    trainer.train_step(*batches[1])  # Adam's moments change in place
    moved = trainer.optimizer.state_dict()["state"][0]["exp_avg"]
    assert not torch.equal(moved, before[0]["exp_avg"])
    ckpt.wait_for_async_saves()
    back = ckpt.load_checkpoint_orbax(str(tmp_path / "snap.orbax"))
    for i, state in before.items():
        for k, v in state.items():
            assert torch.equal(back["state"]["opt_state"]["state"][i][k], v), (i, k)
    for k, v in params.items():
        assert torch.equal({**back["state"]["params"], **back["state"]["batch_stats"]}[k], v), k


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_failed_save_keeps_the_previous_checkpoint(tmp_path, monkeypatch, async_save):
    from torch.distributed.checkpoint import FileSystemWriter

    path = str(tmp_path / "m_best.orbax")
    first = {"epoch": 1, "state": {"params": {"w": torch.arange(6.0)}, "batch_stats": {}}}
    ckpt.save_checkpoint_orbax(path, first, async_save=async_save)
    ckpt.wait_for_async_saves()

    def broken(self, plan, planner):
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, "__0_0.distcp"), "wb") as f:
            f.write(b"half")  # a partial file, then the failure
        raise OSError("disk full")

    monkeypatch.setattr(FileSystemWriter, "write_data", broken)
    second = {"epoch": 2, "state": {"params": {"w": torch.zeros(6)}, "batch_stats": {}}}
    if async_save:
        ckpt.save_checkpoint_orbax(path, second, async_save=True)
        with pytest.raises(BaseException, match="disk full"):
            ckpt.wait_for_async_saves()
    else:
        with pytest.raises(BaseException, match="disk full"):
            ckpt.save_checkpoint_orbax(path, second)
    assert ckpt._pending == []
    assert os.listdir(tmp_path) == ["m_best.orbax"]
    back = ckpt.load_checkpoint_orbax(path)
    assert back["epoch"] == 1 and torch.equal(back["state"]["params"]["w"], torch.arange(6.0))
    assert back["state"]["batch_stats"] == {}
    monkeypatch.undo()
    ckpt.save_checkpoint_orbax(path, second, async_save=async_save)  # the next save replaces it
    ckpt.wait_for_async_saves()
    assert ckpt.load_checkpoint_orbax(path)["epoch"] == 2 and os.listdir(tmp_path) == ["m_best.orbax"]


def test_single_process_saves_and_reads_warn_nothing(tmp_path):
    import warnings

    tree = {"epoch": 1, "state": {"params": {"w": torch.ones(3)}, "batch_stats": {}}, "classes": ["a", "b"]}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for async_save in (False, True, False):
            ckpt.save_checkpoint_orbax(str(tmp_path / "m.orbax"), tree, async_save=async_save)
        ckpt.wait_for_async_saves()
        assert ckpt.load_checkpoint_orbax(str(tmp_path / "m.orbax"))["classes"] == ["a", "b"]
    assert [str(w.message) for w in seen] == []


@pytest.mark.parametrize("backend", ["zarr", "orbax-async", ""])
def test_unknown_backend_raises(tmp_path, backend):
    with pytest.raises(ValueError, match="msgpack, orbax, orbax_async"):
        _mlp_trainer(tmp_path, 1, backend)


# --- serving from a .orbax directory -------------------------------------------


def _bert_tiny():
    from multimodal_lipread_torch.models.bert import BertClassifier, bert_tiny_config

    cfg = bert_tiny_config(vocab_size=64)
    return BertClassifier(cfg, NUM_CLASSES), np.random.default_rng(0).integers(3, 64, (5, 12)).astype(np.int64)


def _mlp_bn():
    return MLP(10, (16,), NUM_CLASSES, 0.0, True), np.random.default_rng(0).standard_normal((5, 10)).astype(np.float32)


@pytest.mark.parametrize("build", [_mlp_bn, _bert_tiny], ids=["mlp_bn", "bert_tiny"])
def test_orbax_directory_serves_the_pt_logits_and_reads_no_adam_key(tmp_path, monkeypatch, build):
    import torch.distributed.checkpoint as dcp

    model, x = build()
    trainer = Trainer(model, TrainerConfig(model_name="m", num_classes=NUM_CLASSES, batch_size=4,
                                           metrics_dir=str(tmp_path / "m"), checkpoints_dir=str(tmp_path / "c"),
                                           class_names=("a", "b", "c", "d")), device="cpu")
    trainer.init_state()
    y = np.arange(len(x)) % NUM_CLASSES
    trainer.train_single_batch(ArrayDataset((x,), y.astype(np.int32)))
    tree = trainer.checkpoint_tree(1, 50.0, 50.0)
    ckpt.save_checkpoint(str(tmp_path / "m_best.pt"), tree)
    ckpt.save_checkpoint_orbax(str(tmp_path / "m_best.orbax"), tree)
    read = []
    load = dcp.load
    monkeypatch.setattr(dcp, "load", lambda state_dict, **kw: (read.extend(state_dict), load(state_dict, **kw))[1])
    logits = {}
    for suffix in (".pt", ".orbax"):
        with torch.device("meta"):
            fresh = build()[0]
        predictor = serving.Predictor.from_checkpoint(fresh, str(tmp_path / f"m_best{suffix}"), batch_size=4,
                                                      device="cpu")
        logits[suffix] = predictor.predict_logits(x)
    assert np.array_equal(logits[".pt"], logits[".orbax"]) and np.isfinite(logits[".pt"]).all()
    assert read and not [k for k in read if "opt_state" in k or k.startswith("dropout_rng")]
    state, classes = serving.read_checkpoint(str(tmp_path / "m_best.orbax"))
    assert set(state) == {"params", "batch_stats"} and classes == ["a", "b", "c", "d"]


def test_audio_pipeline_trains_resumes_and_serves_with_orbax_async(tmp_path, capsys):
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.data.glips import scan_glips
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.pipelines import audio as audio_pipeline

    root = make_synthetic_glips(str(tmp_path / "GLips_4"), clips_per_split=3, seed=2)

    def cfg(backend, base):
        return Config.from_dict({
            "dataset": {"root_dir": root, "num_classes": 4, "input_size": 117},
            "model": {"name": "vgg_lstm", "version": 11},
            "training": {"batch_size": 8, "epochs": 1, "learning_rate": 1e-3, "seed": 0, "rolling_checkpoint": True,
                         "checkpoint_backend": backend},
            "output": {"base_dir": str(tmp_path / base), "plots": False},
        })

    ran = {b: audio_pipeline.main(cfg(b, b), device="cpu") for b in ("msgpack", "orbax_async")}
    assert history(ran["orbax_async"]) == history(ran["msgpack"])
    assert ran["orbax_async"]["final_test_loss"] == ran["msgpack"]["final_test_loss"]
    best = ran["orbax_async"]["best_checkpoint"]
    assert best.endswith("vgg_lstm_best.orbax") and os.path.isdir(best)
    clips = [e.path for e in scan_glips(root).by_split("test")]
    served = {b: serving.predict_audio_clips(cfg(b, b), ran[b]["best_checkpoint"], clips, 4, device="cpu")
              for b in ran}
    assert [r["logits"] for r in served["orbax_async"]] == [r["logits"] for r in served["msgpack"]]
    # the serving CLI takes the .orbax directory as --checkpoint
    cfg("orbax_async", "orbax_async").save(str(tmp_path / "cfg.yaml"))
    capsys.readouterr()
    serving.main(["--pipeline", "audio", "--config", str(tmp_path / "cfg.yaml"), "--checkpoint", best,
                  "--batch-size", "4", "--device", "cpu", *clips[:3]])
    printed = json.loads(capsys.readouterr().out)
    assert [r["logits"] for r in printed] == [r["logits"] for r in served["orbax_async"][:3]]
    resumed = audio_pipeline.main(cfg("orbax_async", "orbax_async"), resume=True, device="cpu")
    assert resumed["history"] == []


# --- two ranks, one shared directory -------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import dataclasses

    from multimodal_lipread_torch.models.bert import BertClassifier
    from test_torch_tensor_parallel import _config, _data as bert_data

    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    ids, labels = bert_data()
    params = {k: v.clone() for k, v in BertClassifier(_config(), NUM_CLASSES).state_dict().items()}
    two = run_ranks("ckpt", 2, str(tmp / "two"), {"shared": str(tmp / "shared"), "bert_config":
                                                   dataclasses.asdict(_config()), "ids": ids, "labels": labels,
                                                   "params": params})
    # the same BERT run at one rank, without a process group
    one = bert_trainer(str(tmp / "one"), "tp", BertClassifier(_config(), NUM_CLASSES), rolling_checkpoint=True,
                       checkpoint_backend="orbax")
    one.init_state()
    one.load_weights({"params": params, "batch_stats": {}})
    one_history = history(one.fit(ids_dataset(ids, labels), ids_dataset(ids, labels), progress=None))
    return {"two": two, "tmp": tmp, "one": one, "one_history": one_history}


def test_two_ranks_write_one_directory_each_tensor_once(ranks):
    from torch.distributed.checkpoint import FileSystemReader

    base = ranks["tmp"] / "shared" / "ddp" / "c"
    assert sorted(os.listdir(base)) == ["m_ddp_best.orbax", "m_ddp_checkpoint.orbax"]
    for name in os.listdir(base):
        files = sorted(os.listdir(base / name))
        assert files == [".metadata", "__0_0.distcp", "__1_0.distcp"], files
        storage = FileSystemReader(str(base / name)).read_metadata().storage_data
        written = sum(os.path.getsize(base / name / f) for f in files if f.endswith(".distcp"))
        # every byte written is one item's, and no item is written twice
        assert sum(info.length for info in storage.values()) == written
        assert len({(i.relative_path, i.offset) for i in storage.values()}) == len(storage)
    a, b = (r["ddp"] for r in ranks["two"])
    assert a["history"] == b["history"] and len(a["history"]) == 2


def test_world_2_orbax_checkpoint_resumes_at_world_1(ranks):
    tmp, rank0 = ranks["tmp"], ranks["two"][0]["ddp"]
    want = {**rank0["state"]["params"], **rank0["state"]["batch_stats"]}
    resumed = Trainer(Tiny(), trainer_config(str(tmp / "shared"), "ddp", epochs=2, weight_decay=0.0,
                                             rolling_checkpoint=True, checkpoint_backend="orbax_async"), device="cpu")
    assert resumed.fit(tiny_data(48, 0), tiny_data(16, 1), resume=True, progress=None)["history"] == []
    for name, value in resumed.model.state_dict().items():
        assert torch.equal(value, want[name]), name
    assert resumed.step == rank0["state"]["step"]
    more = Trainer(Tiny(), trainer_config(str(tmp / "shared"), "ddp", epochs=3, weight_decay=0.0,
                                          rolling_checkpoint=True, checkpoint_backend="orbax"), device="cpu")
    assert [h["epoch"] for h in history(more.fit(tiny_data(48, 0), tiny_data(16, 1), resume=True,
                                                 progress=None))] == [3]


def test_tensor_parallel_orbax_checkpoint_holds_the_world_1_full_tensors(ranks):
    from test_torch_tensor_parallel import _config

    h = _config().hidden_size
    saved = ckpt.load_checkpoint_orbax(str(ranks["tmp"] / "shared" / "tp" / "c" / "m_tp_checkpoint.orbax"))
    one = ckpt.load_checkpoint_orbax(str(ranks["tmp"] / "one" / "tp" / "c" / "m_tp_checkpoint.orbax"))
    exported = ranks["two"][0]["tp"]["params"]
    assert ranks["two"][0]["tp"]["query_shape"] == (h // 2, h)  # cut while training
    assert set(saved["state"]["params"]) == set(one["state"]["params"]) == set(exported)
    assert saved["state"]["batch_stats"] == {}
    for name, value in saved["state"]["params"].items():
        assert value.shape == one["state"]["params"][name].shape, name
        assert torch.equal(value, exported[name]), name
        # 2 Adam steps at lr 1e-3 in two float32 runs whose gradients differ
        # by rounding (tests/test_torch_trainer.py's bounds): every element
        # within 2 lr a step, 99 % within 2 % of lr, except the key bias,
        # whose gradient is exactly zero (softmax ignores a shift shared by
        # every key), so that it steps by about ±lr on rounding noise
        diff = (value - one["state"]["params"][name]).abs().flatten()
        assert float(diff.max()) <= 2 * 2 * 1e-3, name
        if not name.endswith("attention.key.bias"):
            assert float(diff.quantile(0.99)) <= PARAM_P99_PER_LR * 1e-3, name
    for r in ranks["two"]:
        np.testing.assert_allclose([x["train_loss"] for x in r["tp"]["history"]],
                                   [x["train_loss"] for x in ranks["one_history"]], rtol=2e-4)
