"""Mixup over several data-parallel ranks on the CPU: the JAX step mixes the
global batch with one λ and one permutation of its rows, and so does every
rank of the port (``Trainer._mixup``: the same draw on every rank, this
rank's rows mixed with the global rows the permutation points to, the
global batch put together by an all-reduce of zeroed buffers).

The ranks run in processes of ``tests/torch_dist_worker.py`` (its ``mixup``
case: an MLP with BatchNorm and dropout, ``mixup_alpha`` 0.4), one at world
1 and two over gloo. Held:

- the two ranks' mixed rows of every step, joined, equal world 1's bit for
  bit, inputs and soft labels;
- 3 steps at lr 0 (the same weights at every step): losses, summed
  gradients and BatchNorm statistics as tests/test_torch_ddp.py holds one
  step (atol 1e-6, rtol 1e-5); 3 steps at lr 1e-2 and a 3-epoch fit, the
  losses within its fit bound (5e-3) and the parameters at 1e-5 (all but
  the bias before the BatchNorm, whose gradient is rounding noise);
- the same steps with remat equal the steps without it on each rank
  (under DDP; the recompute draws the forward's masks);
- a weight-0 row on one rank leaves every rank unmixed;
- the dropout generators agree across ranks and worlds after ``fit``;
- at a fixed λ and permutation, the joined mix equals the JAX package's
  ``mixup`` of the global batch.
"""

import jax
import numpy as np
import pytest
import torch

from torch_dist_worker import NUM_CLASSES, mlp_data, run_ranks
from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)

from multimodal_lipread_tpu.data.augment import mixup as jmixup

STEP_ATOL, STEP_RTOL = 1e-6, 1e-5  # tests/test_torch_ddp.py
FIT_RTOL = 5e-3
PARAM_ATOL = 1e-5
# the bias before the BatchNorm: BatchNorm subtracts it again, so its
# gradient is rounding noise whose sign differs between worlds, and Adam
# moves it by ±lr whatever the gradient's size (PERF.md, PR 14)
PRE_BN_BIAS = "dense0.bias"
ALPHA = 0.4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mixup_ranks")
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)  # what the JAX mixup draws from ``key``
    inputs = {"lam": float(jax.random.beta(k1, ALPHA, ALPHA)),
              "perm": np.asarray(jax.random.permutation(k2, 16)).astype(np.int64)}
    (one,) = run_ranks("mixup", 1, str(tmp / "one"), inputs)
    two = run_ranks("mixup", 2, str(tmp / "two"), inputs)
    return {"one": one, "two": two, "key": key}


def _joined(two, key, step, part):
    return torch.cat([r[key]["mixes"][step][part] for r in two])


@pytest.mark.parametrize("key", ["lr0", "lr", "remat_lr"])
def test_two_ranks_mixed_rows_joined_equal_world_1_bit_for_bit(runs, key):
    one, two = runs["one"], runs["two"]
    assert len(one[key]["mixes"]) == 3
    for step in range(3):
        for part in (0, 1):  # the inputs, the soft labels
            want = one[key]["mixes"][step][part]
            got = _joined(two, key, step, part)
            assert got.shape == want.shape and torch.equal(got, want), (key, step, part)
    mixed = one[key]["mixes"][0][0]
    assert not torch.equal(mixed, torch.from_numpy(mlp_data(48, 0).inputs[0][:16]))  # it did mix


def test_two_rank_mixup_steps_equal_world_1(runs):
    one = runs["one"]["lr0"]
    for rank_result in runs["two"]:
        two = rank_result["lr0"]
        np.testing.assert_allclose(two["loss"], one["loss"], atol=STEP_ATOL, rtol=0)
        for g2, g1 in zip(two["grads"], one["grads"]):
            for name in g1:
                np.testing.assert_allclose(g2[name].numpy(), g1[name].numpy(), atol=STEP_ATOL, rtol=STEP_RTOL,
                                           err_msg=name)
        for s2, s1 in zip(two["stats"], one["stats"]):
            for name in s1:
                np.testing.assert_allclose(s2[name].numpy(), s1[name].numpy(), atol=STEP_ATOL, rtol=STEP_RTOL,
                                           err_msg=name)
        np.testing.assert_allclose(rank_result["lr"]["loss"], runs["one"]["lr"]["loss"], rtol=FIT_RTOL)
        for name, p in runs["one"]["lr"]["params"].items():
            if name == PRE_BN_BIAS:
                continue
            np.testing.assert_allclose(rank_result["lr"]["params"][name].numpy(), p.numpy(), atol=PARAM_ATOL,
                                       rtol=0, err_msg=name)
        got, want = rank_result["fit"], runs["one"]["fit"]
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a["train_loss"] == pytest.approx(b["train_loss"], rel=FIT_RTOL)
            assert a["val_loss"] == pytest.approx(b["val_loss"], rel=FIT_RTOL)


def test_remat_under_ddp_equals_plain_steps(runs):
    for result in [runs["one"]] + runs["two"]:
        plain, remat = result["lr"], result["remat_lr"]
        np.testing.assert_allclose(remat["loss"], plain["loss"], atol=STEP_ATOL, rtol=0)
        for g2, g1 in zip(remat["grads"], plain["grads"]):
            for name in g1:
                np.testing.assert_allclose(g2[name].numpy(), g1[name].numpy(), atol=STEP_ATOL, rtol=STEP_RTOL,
                                           err_msg=name)
        for name, p in plain["params"].items():
            np.testing.assert_allclose(remat["params"][name].numpy(), p.numpy(), atol=STEP_ATOL, rtol=0,
                                       err_msg=name)


def test_a_weight_0_row_on_one_rank_leaves_every_rank_unmixed(runs):
    for result in [runs["one"]] + runs["two"]:
        (off, off_params), (on, on_params) = result["padded"]["off"], result["padded"]["on"]
        assert torch.equal(on, off)
        assert all(torch.equal(on_params[n], off_params[n]) for n in off_params)


def test_dropout_generators_agree_across_ranks_and_worlds_after_fit(runs):
    want = runs["one"]["generator"]
    assert all(r["generator"].equal(want) for r in runs["two"])


def test_exchange_moves_the_global_inputs_and_labels(runs):
    # 16 global rows of 16 float32 features and a float32 label, one buffer
    assert all(r["lr0"]["exchange_bytes"] == 16 * (16 + 1) * 4 for r in runs["two"])
    assert runs["one"]["lr0"]["exchange_bytes"] == 0


def test_joined_mix_at_a_fixed_lambda_and_permutation_equals_jax(runs):
    ds = mlp_data(16, 0)
    onehot = np.eye(NUM_CLASSES, dtype=np.float32)[ds.labels]
    (jx,), jy = jmixup(runs["key"], (ds.inputs[0],), onehot, ALPHA)
    for got_x, got_y in ([runs["one"]["fixed"][0], runs["one"]["fixed"][1]],
                         [torch.cat([r["fixed"][0] for r in runs["two"]]),
                          torch.cat([r["fixed"][1] for r in runs["two"]])]):
        np.testing.assert_allclose(got_x.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
