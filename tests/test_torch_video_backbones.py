"""The port's frame backbones (ResNet 18/34/50, ShuffleNetV2 0.5/1.0,
MobileNetV2) against the JAX package's at the same weights (bridged from
the JAX variables, see tests/torch_parity_utils.py), at 44 × 44, B=2, at
1e-4: eval mode (running statistics) in float32; train mode (batch
statistics) and the running statistics it updates in float64 on both
sides. In train mode at B=2 the last stages' BatchNorms normalize over 8
values each, and both packages' float32 forwards stray from float64 there
(ResNet50: the port by 6e-4, the JAX package by 2e-3, on outputs of ~3), so
only float64 tells a different function from rounding; in float64 the two
agree to ~1e-12. Also the port's ResNet18 against the torchvision golden
(tests/goldens/resnet18.npz)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_utils as G
from torch_parity_utils import load_bridged, one_torch_thread, random_variables  # noqa: F401 (autouse)

from multimodal_lipread_tpu.models.backbones import mobilenet as jmobilenet
from multimodal_lipread_tpu.models.backbones import resnet as jresnet
from multimodal_lipread_tpu.models.backbones import shufflenet as jshufflenet

from multimodal_lipread_torch.models.backbones import MobileNetV2, ResNet, ShuffleNetV2
from multimodal_lipread_torch.models.backbones import mobilenet as pmobilenet
from multimodal_lipread_torch.models.backbones import shufflenet as pshufflenet

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
TOL = 1e-4

# name → (the JAX module at a dtype, the port's module)
BACKBONES = {
    "resnet18": (lambda d: jresnet.ResNet(18, dtype=d), lambda: ResNet(18)),
    "resnet34": (lambda d: jresnet.ResNet(34, dtype=d), lambda: ResNet(34)),
    "resnet50": (lambda d: jresnet.ResNet(50, dtype=d), lambda: ResNet(50)),
    "shufflenet0.5": (lambda d: jshufflenet.ShuffleNetV2(0.5, dtype=d), lambda: ShuffleNetV2(0.5)),
    "shufflenet1.0": (lambda d: jshufflenet.ShuffleNetV2(1.0, dtype=d), lambda: ShuffleNetV2(1.0)),
    "mobilenet_v2": (lambda d: jmobilenet.MobileNetV2(dtype=d), lambda: MobileNetV2()),
}


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_matches_jax_in_eval_and_train(name):
    jfn, pfn = BACKBONES[name]
    x = np.random.default_rng(1).random((2, 44, 44, 3), np.float32)
    jm = jfn(jnp.float32)
    v = random_variables(jm, x, seed=3)
    pm = load_bridged(pfn(), v)
    assert pm.feature_dim == jm.feature_dim

    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x))
    with torch.no_grad():
        got = pm(_nchw(x)).numpy()
    assert got.shape == want.shape == (2, jm.feature_dim)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        want, mutated = jax.jit(lambda v, x: jfn(jnp.float64).apply(v, x, train=True, mutable=["batch_stats"]))(
            v64, x.astype(np.float64))
        want = np.asarray(want)
        new_stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), mutated["batch_stats"])
    assert want.dtype == np.float64
    pm = pm.double().train()
    with torch.no_grad():
        got = pm(_nchw(x).double()).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    stats = _stats_f64(new_stats)
    ours = pm.state_dict()
    running = [k for k in ours if "running_" in k]
    assert running and set(running) == set(stats)
    for key in running:
        np.testing.assert_allclose(ours[key].numpy(), stats[key], rtol=TOL, atol=TOL, err_msg=key)


def _stats_f64(tree, prefix=""):
    """JAX batch_stats → {port running-statistic name: float64 array},
    with the ``BatchNorm_0`` level dropped as the bridge drops it."""
    if "mean" in tree:
        return {prefix + "running_mean": tree["mean"], prefix + "running_var": tree["var"]}
    out = {}
    for key, child in tree.items():
        out.update(_stats_f64(child, prefix if key == "BatchNorm_0" else f"{prefix}{key}."))
    return out


@pytest.mark.parametrize("version", [18, 50])
def test_resnet_final_map_matches_jax(version):
    # the unpooled map reaches ~300 here (He-scaled weights through 50
    # layers): held to 1e-4 of its largest value, float32's relative reach
    x = np.random.default_rng(2).random((1, 44, 44, 3), np.float32)
    jm = jresnet.ResNet(version)
    v = random_variables(jm, x, seed=4)
    pm = load_bridged(ResNet(version), v)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False, False))(v, x))
    with torch.no_grad():
        got = pm(_nchw(x), pool=False).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 2, 2, jm.feature_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def _torchvision_to_port(name: str) -> str:
    """torchvision resnet names → the port's (the JAX names)."""
    for i in range(1, 5):
        for b in range(3):
            name = name.replace(f"layer{i}.{b}.", f"layer{i}_{b}.")
    return name.replace("downsample.0.", "downsample_conv.").replace("downsample.1.", "downsample_bn.")


def test_resnet18_matches_the_torchvision_golden():
    z = np.load(os.path.join(GOLDENS, "resnet18.npz"))
    sd = G.synth_state(G.resnet18_spec(), G.SEED)
    pm = ResNet(18)
    pm.load_state_dict({_torchvision_to_port(k): torch.from_numpy(v) for k, v in sd.items()
                        if not k.endswith("num_batches_tracked")}, strict=True)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(z["x"])).numpy()
    np.testing.assert_allclose(got, z["want"], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("channels", [4, 48, 116])
def test_channel_shuffle_matches_jax(channels):
    x = np.random.default_rng(5).standard_normal((2, 3, 5, channels)).astype(np.float32)  # NHWC
    want = np.asarray(jshufflenet.channel_shuffle(jnp.asarray(x), 2))
    got = pshufflenet.channel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("v", [3, 8, 15.9, 16, 27.5, 96 * 0.25, 576 // 4, 1000.0])
def test_make_divisible_matches_jax(v):
    assert pmobilenet._make_divisible(v) == jmobilenet._make_divisible(v)


@pytest.mark.parametrize("cls, arg", [(ResNet, 20), (ShuffleNetV2, 2.0)])
def test_unknown_backbone_sizes_raise(cls, arg):
    with pytest.raises(ValueError):
        cls(arg)
