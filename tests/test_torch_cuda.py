"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and ``nvcc`` and carries the ``cuda``
marker; without a card each skips (decided inside the ``cuda_device``
fixture). This file imports neither JAX nor the JAX package, so it also
runs where only PyTorch is installed. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from multimodal_lipread_torch.models.audio import VGGWithLSTMClassifier
from multimodal_lipread_torch.models.frontend import WaveToLogMel
from multimodal_lipread_torch.ops import logmel_cuda
from multimodal_lipread_torch.ops.logmel import NUM_SAMPLES, log_mel_reference

TOL = 1e-4  # the JAX package's Pallas-vs-XLA bound (tests/test_logmel.py)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _waves(batch, device, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((batch, NUM_SAMPLES)) * 1000).astype(np.float32)).to(device)


@pytest.mark.cuda
# 37 and 133 fit no multiple of the tiling; 133 clips = 532 blocks leave a
# partial last wave on 132 SMs
@pytest.mark.parametrize("batch", [1, 3, 32, 37, 128, 133])
@pytest.mark.parametrize("normalize", [True, False])
def test_logmel_kernel_matches_plain_version(cuda_device, batch, normalize):
    wave = _waves(batch, cuda_device, seed=batch)
    wave[0, 5000:9000] = 0.0  # a silent stretch: spectral nulls
    before = logmel_cuda.launch_count
    got = logmel_cuda.log_mel(wave, normalize)
    torch.cuda.synchronize()
    assert logmel_cuda.launch_count == before + 1
    assert got.shape == (batch, 80, 126) and got.dtype == torch.float32
    torch.testing.assert_close(got, log_mel_reference(wave, normalize), rtol=0, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [3, 37])
def test_logmel_kernel_standardizes_each_clip(cuda_device, batch):
    wave = _waves(batch, cuda_device, seed=7)
    wave[1] *= 50.0  # clips of very different loudness
    out = logmel_cuda.log_mel(wave, True).double()
    flat = out.reshape(batch, -1)
    torch.testing.assert_close(flat.mean(1), torch.zeros_like(flat[:, 0]), rtol=0, atol=1e-5)
    torch.testing.assert_close(flat.std(1), torch.ones_like(flat[:, 0]), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_logmel_kernel_is_repeatable_and_leaves_its_scratch_clean(cuda_device):
    wave = _waves(37, cuda_device, seed=4)
    first = logmel_cuda.log_mel(wave, True)
    again = logmel_cuda.log_mel(wave, True)
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    _partials, tickets = logmel_cuda._scratch(wave.device, stream)
    assert int(tickets.abs().sum()) == 0  # every clip's last block reset its ticket


@pytest.mark.cuda
def test_logmel_kernel_launch_config(cuda_device):
    cfg = logmel_cuda.launch_config(32, cuda_device)
    assert (cfg["grid_x"], cfg["grid_y"]) == (logmel_cuda.KERNEL_TILES, 32)
    assert cfg["local_bytes"] == 0  # no spills
    assert cfg["blocks_per_sm"] >= 1 and cfg["registers"] <= 255 and cfg["clusters_of_4"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
def test_logmel_kernel_phase_times(cuda_device, normalize):
    wave = _waves(5, cuda_device, seed=6)
    before = logmel_cuda.launch_count
    phases = logmel_cuda.phase_times(wave, normalize)
    assert logmel_cuda.launch_count == before + 1
    assert ("standardize" in phases) == normalize
    for name, (mean, largest) in ((k, v) for k, v in phases.items() if k != "launch"):
        assert 0 <= mean <= largest < phases["launch"], name
    assert phases["dft"][0] > phases["mel"][0]  # the DFT is the bulk of the work


@pytest.mark.cuda
def test_logmel_kernel_rejects_what_it_does_not_take(cuda_device):
    wave = _waves(2, cuda_device)
    with pytest.raises(TypeError):
        logmel_cuda.log_mel(wave.double())
    with pytest.raises(ValueError):
        logmel_cuda.log_mel(torch.zeros((NUM_SAMPLES, 2), device=cuda_device).t())


@pytest.mark.cuda
def test_logmel_kernel_keeps_clips_apart(cuda_device):
    wave = _waves(8, cuda_device, seed=1)
    full = logmel_cuda.log_mel(wave)
    one = logmel_cuda.log_mel(wave[5:6].contiguous())
    torch.testing.assert_close(full[5:6], one, rtol=0, atol=0)


@pytest.mark.cuda
def test_wave_to_logmel_runs_the_kernel(cuda_device):
    torch.manual_seed(0)
    net = VGGWithLSTMClassifier(4, version=11, lstm_hidden=16).to(cuda_device).eval()
    wave = _waves(4, cuda_device, seed=2)
    before = logmel_cuda.launch_count
    with torch.inference_mode():
        got = WaveToLogMel(net, 117)(wave)
        want = net(log_mel_reference(wave, True)[:, :80, :117])
    assert logmel_cuda.launch_count == before + 1
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
