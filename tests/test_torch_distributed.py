"""The port's process-group start-up, meshes and partition rules
(``parallel/distributed.py``, ``parallel/mesh.py``) in one process on the
CPU: nothing starts without the launcher's environment, gloo starts at
world 1 with it, the mesh constructors check their shapes, and the rules
resolve and fail as the JAX package's do (tests/test_tensor_parallel.py,
tests/test_pipeline_parallel.py)."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_parity_utils import one_torch_thread  # noqa: F401

from multimodal_lipread_torch.models.bert import BERT_PP_RULES, BERT_TP_RULES
from multimodal_lipread_torch.parallel import distributed as pdist
from multimodal_lipread_torch.parallel.mesh import (
    gather_state,
    get_mesh,
    get_mesh_2d,
    pad_to_multiple,
    place_state,
    resolve_partition_spec,
    shard_batch,
)
from multimodal_lipread_torch.parallel.pipeline import get_mesh_pp

LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_launcher(monkeypatch):
    for key in LAUNCHER_ENV:
        monkeypatch.delenv(key, raising=False)
    assert not pdist.is_initialized()


@pytest.fixture
def world_of_one(monkeypatch, no_launcher):
    """The default group at world 1, destroyed after the test."""
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


def test_nothing_starts_without_the_launchers_environment(no_launcher):
    assert pdist.maybe_initialize_distributed("cpu") is False
    assert not pdist.is_initialized()
    assert (pdist.rank(), pdist.world_size(), pdist.is_primary()) == (0, 1, True)
    assert get_mesh() is None and get_mesh_2d(1) is None and get_mesh_pp(1) is None


def test_gloo_starts_at_world_1_from_the_environment(world_of_one):
    with socket.socket() as s:  # a free port on this host
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in (("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", str(port))):
        world_of_one.setenv(key, value)
    assert pdist.maybe_initialize_distributed("cpu") is True
    assert dist.get_backend() == "gloo" and (pdist.rank(), pdist.world_size()) == (0, 1)
    assert pdist.maybe_initialize_distributed("cpu") is True  # a second call keeps the group


def test_meshes_at_world_1_from_an_init_method(world_of_one, tmp_path):
    assert pdist.maybe_initialize_distributed("cpu", init_method=f"file://{tmp_path / 'store'}") is True
    mesh = get_mesh()
    assert mesh.mesh_dim_names == ("data",) and tuple(mesh.shape) == (1,)
    mesh2 = get_mesh_2d(1)
    assert mesh2.mesh_dim_names == ("data", "model") and tuple(mesh2.shape) == (1, 1)
    pp = get_mesh_pp(1)
    assert pp.mesh_dim_names == ("data", "stage")
    t = torch.arange(4.0)
    dist.all_reduce(t)
    assert t.tolist() == [0.0, 1.0, 2.0, 3.0]


def test_mesh_constructors_check_their_shapes(no_launcher):
    with pytest.raises(ValueError, match="must divide"):
        get_mesh_2d(3)
    with pytest.raises(ValueError, match="must divide"):
        get_mesh_2d(0)
    with pytest.raises(ValueError, match="must divide"):
        get_mesh_pp(2)


def test_rule_resolution_as_the_jax_test():
    # tests/test_tensor_parallel.py::test_rule_resolution on the port's names
    assert resolve_partition_spec(BERT_TP_RULES, "layer0.attention.query.weight") == ("model", None)
    assert resolve_partition_spec(BERT_TP_RULES, "layer0.attention.out.weight") == (None, "model")
    assert resolve_partition_spec(BERT_TP_RULES, "layer0.output.weight") == (None, "model")
    for name in ("layer0.output_norm.weight", "layer0.attention.out.bias", "embeddings.word_embeddings.weight",
                 "pooler.weight", "classifier.weight"):
        assert resolve_partition_spec(BERT_TP_RULES, name) == ()
    assert resolve_partition_spec(BERT_PP_RULES, "encoder.attention.query.weight") == ("stage", "...")
    assert resolve_partition_spec(BERT_PP_RULES, "embeddings.layer_norm.weight") == ()


MESH = {"data": (2, 0), "model": (4, 1)}  # {axis: (size, this rank's coordinate)}


def test_bad_rules_fail_loudly():
    # tests/test_tensor_parallel.py::test_bad_rules_fail_loudly
    with pytest.raises(ValueError, match="not divisible"):
        place_state(MESH, {"w": torch.zeros(6, 4)}, ((r"w$", ("model", None)),))
    with pytest.raises(ValueError, match="not in mesh axes"):
        place_state(MESH, {"w": torch.zeros(8, 4)}, ((r"w$", ("expert", None)),))
    with pytest.raises(ValueError, match="rank"):
        place_state(MESH, {"w": torch.zeros(8, 4)}, ((r"w$", ("model",)),))
    # tests/test_pipeline_parallel.py: the "..." marker still checks the leading rank
    with pytest.raises(ValueError, match="leading dims"):
        place_state({"stage": (2, 0)}, {"w": torch.zeros(4)}, ((r"w$", ("stage", None, "...")),))


def test_place_state_cuts_this_ranks_chunk():
    w = torch.arange(32.0).reshape(8, 4)
    got = place_state(MESH, {"w": w, "b": torch.ones(3)}, ((r"w$", ("model", None)),))
    torch.testing.assert_close(got["w"], w[2:4])  # coordinate 1 of 4 along dim 0
    assert got["b"] is not None and got["b"].shape == (3,)
    stacked = place_state({"stage": (2, 1)}, {"encoder.x": torch.arange(24.0).reshape(4, 3, 2)}, BERT_PP_RULES)
    torch.testing.assert_close(stacked["encoder.x"], torch.arange(12.0, 24.0).reshape(2, 3, 2))
    # one rank's gather puts its chunk back at its offset (the others add theirs by all-reduce)
    back = gather_state(MESH, got, ((r"w$", ("model", None)),), {"w": (8, 4), "b": (3,)})
    torch.testing.assert_close(back["w"][2:4], w[2:4])
    assert float(back["w"][:2].abs().sum()) == 0.0


def test_pad_and_shard_batch():
    a = np.arange(10).reshape(5, 2)
    padded = pad_to_multiple(a, 4)
    assert padded.shape == (8, 2) and (padded[5:] == 0).all()
    assert pad_to_multiple(a, 5) is a
    assert (shard_batch({"data": (4, 2)}, padded) == padded[4:6]).all()
    assert (shard_batch(None, a) == a).all()
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"data": (3, 0)}, padded)
