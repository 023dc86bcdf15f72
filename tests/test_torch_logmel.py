"""The port's log-mel frontend against the JAX package's.

The plain version (``log_mel_reference``) is held to ``log_mel_xla`` and to
the Pallas kernel in interpret mode at 1e-4 (the JAX package's own
Pallas-vs-XLA bound, tests/test_logmel.py), and to the committed torch
golden at that golden's bounds (tests/test_goldens.py). The CUDA kernel
itself runs only on a card: its tests are in tests/test_torch_cuda.py.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

from multimodal_lipread_tpu.ops import logmel as jlm
from multimodal_lipread_tpu.ops.logmel_pallas import log_mel_pallas

from multimodal_lipread_torch.ops import _build
from multimodal_lipread_torch.ops import logmel as plm
from multimodal_lipread_torch.ops import logmel_cuda
from multimodal_lipread_torch.tools import logmel_tf32_emulation as tf32

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
TOL = 1e-4


@pytest.fixture(scope="module")
def waves():
    # int16-range waveforms, one with a silent stretch (spectral nulls)
    w = (np.random.default_rng(42).standard_normal((3, plm.NUM_SAMPLES)) * 5000).astype(np.float32)
    w[1, 4000:9000] = 0.0
    return w


@pytest.mark.parametrize(
    "name", ["hann_window", "dft_basis", "mel_filterbank", "mel_filterbank_padded", "dft_basis_split"]
)
def test_tables_match_jax(name):
    got, want = getattr(plm, name)(), getattr(jlm, name)()
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


def test_constants_match_jax():
    for name in ("N_FFT", "HOP_LENGTH", "N_MELS", "NUM_SAMPLES", "NUM_FRAMES", "N_FREQS",
                 "FREQ_PAD", "N_BLOCKS", "_BLOCK_PAD", "PAD", "LOG_EPS", "NORM_EPS"):
        assert getattr(plm, name) == getattr(jlm, name), name


def test_block_signal_matches_jax(waves):
    got = plm.block_signal(torch.from_numpy(waves)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlm.block_signal(waves)))


@pytest.mark.parametrize("normalize", [True, False])
def test_reference_matches_xla(waves, normalize):
    got = plm.log_mel_reference(torch.from_numpy(waves), normalize).numpy()
    want = np.asarray(jlm.log_mel_xla(waves, normalize=normalize))
    assert got.shape == (3, plm.N_MELS, plm.NUM_FRAMES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_reference_matches_pallas_interpret(waves, normalize):
    got = plm.log_mel_reference(torch.from_numpy(waves), normalize).numpy()
    want = np.asarray(log_mel_pallas(waves, normalize=normalize, interpret=True))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_reference_matches_golden():
    z = np.load(os.path.join(GOLDENS, "logmel.npz"))
    wave = torch.from_numpy(z["waves"])
    np.testing.assert_allclose(plm.log_mel_reference(wave, False).numpy(), z["want_raw"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(plm.log_mel_reference(wave, True).numpy(), z["want_norm"], rtol=1e-3, atol=1e-3)


def test_reference_standardizes_each_clip(waves):
    out = plm.log_mel_reference(torch.from_numpy(waves), True).double()
    flat = out.reshape(out.shape[0], -1)
    np.testing.assert_allclose(flat.mean(1).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(flat.std(1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_log_mel_on_cpu_is_the_plain_version(waves, normalize):
    before = logmel_cuda.launch_count
    wave = torch.from_numpy(waves)
    torch.testing.assert_close(logmel_cuda.log_mel(wave, normalize), plm.log_mel_reference(wave, normalize),
                               rtol=0, atol=0)
    assert logmel_cuda.launch_count == before  # the kernel did not run


@pytest.mark.parametrize("shape", [(20000,), (2, 19999), (2, 1, 20000)])
def test_log_mel_rejects_bad_shapes(shape):
    with pytest.raises(ValueError):
        logmel_cuda.log_mel(torch.zeros(shape))


def test_log_mel_refuses_a_waveform_that_requires_a_gradient(waves):
    # the kernel has no backward, so its plain version on the CPU refuses too
    wave = torch.from_numpy(waves).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        logmel_cuda.log_mel(wave)
    with torch.no_grad():  # no gradient is asked for, so none is lost
        torch.testing.assert_close(logmel_cuda.log_mel(wave), plm.log_mel_reference(wave.detach()), rtol=0, atol=0)


def test_kernel_basis_layout():
    basis, full = logmel_cuda.kernel_basis(), plm.dft_basis()
    cols = logmel_cuda.KERNEL_FREQ_COLS
    assert cols == 224  # 201 frequencies padded to the kernel's 7 warps x 32 columns
    assert basis.shape == (plm.N_FFT, 2 * cols) and basis.dtype == np.float32
    np.testing.assert_array_equal(basis[:, : plm.N_FREQS], full[:, : plm.N_FREQS])
    np.testing.assert_array_equal(basis[:, cols : cols + plm.N_FREQS], full[:, plm.FREQ_PAD : plm.FREQ_PAD + plm.N_FREQS])
    assert not basis[:, plm.N_FREQS : cols].any() and not basis[:, cols + plm.N_FREQS :].any()


def test_kernel_basis_reproduces_the_dft():
    # the kernel's (400, 448) layout and the package's (400, 512) one give
    # the same log-mel when the frames are multiplied out in float64
    wave = torch.from_numpy(np.random.default_rng(3).standard_normal((2, plm.NUM_SAMPLES)) * 1000)
    padded = torch.nn.functional.pad(wave[:, None], (plm.PAD, plm.PAD), mode="reflect")[:, 0]
    frames = padded.unfold(-1, plm.N_FFT, plm.HOP_LENGTH)  # (B, 126, 400)
    fb = torch.from_numpy(plm.mel_filterbank()).double()

    def logmel(basis, half):
        spec = frames @ torch.from_numpy(basis).double()
        power = spec[..., : plm.N_FREQS] ** 2 + spec[..., half : half + plm.N_FREQS] ** 2
        return torch.log(power @ fb + plm.LOG_EPS)

    got = logmel(logmel_cuda.kernel_basis(), logmel_cuda.KERNEL_FREQ_COLS)
    torch.testing.assert_close(got, logmel(plm.dft_basis(), plm.FREQ_PAD), rtol=1e-12, atol=1e-12)


def test_kernel_mel_table_rebuilds_the_filterbank():
    first, bands = logmel_cuda.kernel_mel_table()
    band = logmel_cuda.KERNEL_MEL_BAND
    assert first.shape == (plm.N_MELS,) and first.dtype == np.int32
    assert bands.shape == (plm.N_MELS, band) and bands.dtype == np.float32
    assert first.min() >= 0 and first.max() + band <= plm.N_FREQS  # bands stay inside the spectrum
    fb = np.zeros((plm.N_FREQS, plm.N_MELS), np.float32)
    for m in range(plm.N_MELS):
        fb[first[m] : first[m] + band, m] = bands[m]
    np.testing.assert_array_equal(fb, plm.mel_filterbank())
    assert np.count_nonzero(bands) == np.count_nonzero(plm.mel_filterbank())


@pytest.mark.parametrize("normalize", [True, False])
def test_float64_through_kernel_tables_matches_reference_and_xla(waves, normalize):
    # the function the kernel computes, summed exactly through its own tables
    # (224-column basis, mel bands), against both fp32 versions at 1e-4
    got = logmel_cuda.log_mel_float64(torch.from_numpy(waves), normalize)
    assert got.dtype == torch.float64 and got.shape == (3, plm.N_MELS, plm.NUM_FRAMES)
    ref = plm.log_mel_reference(torch.from_numpy(waves), normalize).numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    xla = np.asarray(jlm.log_mel_xla(waves, normalize=normalize))
    np.testing.assert_allclose(got.numpy(), xla, rtol=TOL, atol=TOL)


def test_tf32_emulation_roundings():
    x = (np.random.default_rng(5).standard_normal(4096) * 1000).astype(np.float32)
    hi = tf32.to_tf32(x)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()  # 10 mantissa bits left
    np.testing.assert_array_less(np.abs(x - hi), np.abs(x) * 2.0**-11 * 1.0001)  # to nearest
    v = x.astype(np.float64) * (1 + 1e-9)
    rz, rn = tf32.to_f32(v, toward_zero=True), tf32.to_f32(v)
    assert (np.abs(rz.astype(np.float64)) <= np.abs(v)).all()
    assert (np.abs(rz - rn) <= np.spacing(np.abs(rn))).all()


def test_nvcc_command_targets_hopper_without_torch_headers():
    cmd = _build.nvcc_command("nvcc", "logmel", _build.BUILD_DIR / "x.so")
    joined = " ".join(cmd)
    for flag in ("arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-fPIC", "-Xptxas -v"):
        assert flag in joined
    assert not any(a.startswith("-I") for a in cmd)  # no PyTorch headers
    with open(_build.source_path("logmel")) as f:
        src = f.read()
    assert 'extern "C" int mlt_logmel_forward' in src
    assert "#include <torch" not in src and "#include <ATen" not in src


def test_library_path_is_content_keyed_under_build():
    path = _build.library_path("logmel")
    assert path.parent == _build.PACKAGE_DIR.parent / "build" / "torch_kernels"
    assert path.name.startswith("liblogmel-") and path.suffix == ".so"
    with open(_build.PACKAGE_DIR.parent / ".gitignore") as f:
        assert "build/" in f.read().split()


def _fake_nvcc(tmp_path, body):
    """A stand-in nvcc under $CUDA_HOME/bin running ``body`` (Python)."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys, time\nout = sys.argv[sys.argv.index('-o') + 1]\n{body}\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(tmp_path / "cuda")


def test_build_all_builds_once_and_reports_ptxas(tmp_path, monkeypatch):
    body = ("print('ptxas info    : Used 96 registers, 35776 bytes smem')\n"
            "open(out, 'wb').write(b'lib')")
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(tmp_path, body))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.build_all(_build.KERNELS)["logmel"]
    assert first.path.read_bytes() == b"lib" and first.path.parent == tmp_path / "build"
    assert first.ptxas_lines() == ["ptxas info    : Used 96 registers, 35776 bytes smem"]
    assert not list((tmp_path / "build").glob("*.tmp.so"))  # renamed into place
    again = _build.build_all(_build.KERNELS)["logmel"]
    assert again.path == first.path and again.seconds == 0.0


@pytest.mark.parametrize(
    "body, message",
    [("print('error: boom'); sys.exit(1)", "boom"), ("time.sleep(30)", "timed out")],
)
def test_build_all_raises_on_failure(tmp_path, monkeypatch, body, message):
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(tmp_path, body))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=message):
        _build.build_all(["logmel"], timeout=2)
    assert not list((tmp_path / "build").iterdir())
