#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``multimodal_lipread_torch``).

    python3 chip_smoke.py [--seed 0]

On one CUDA card (an H100 is the target), in order, each phase printing
its lines and any failure ending the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``). TF32 is left
   at the process default: the port's forwards set their own precision
   (``utils/precision.py``: no TF32 for a float32 model), and every check
   below runs the model under that same helper;
2. build: every kernel under ``multimodal_lipread_torch/csrc`` with plain
   ``nvcc`` (one process per source, all at once), with the ``-Xptxas -v``
   report of registers, shared memory and spills;
3. kernel vs plain: per batch (B = 32 and 128), the kernel's launch
   configuration (grid, shared memory, registers, spills, blocks per SM,
   waves, and how many 4-block clusters would fit); the kernel's and the
   plain version's error against a float64 evaluation of the same function
   (a diagnostic); the log-mel kernel against ``log_mel_reference`` on the
   card in both normalize modes, to 1e-4 absolute; times of the kernel, the
   plain version and a ``torch.stft`` log-mel (a partial yardstick: no
   single PyTorch call computes the whole function) with CUDA events; the
   time of each phase inside the kernel, from its own timestamps;
4. serve: a GLips-shaped tree of WAV clips made from ``--seed`` in a
   temporary directory, a full-width vgg_lstm (VGG16-BN, BiLSTM 2 x 128,
   4 classes, input 117, float32) with weights drawn from ``--seed``, saved
   as a checkpoint and served through ``Predictor.from_checkpoint`` and
   ``predict_audio_clips``: three requests of 32, 32 and 16 clips (the last
   padded) through the streaming branch, the same clips through the
   features-first branch, and the same requests to a resident
   ``Predictor``. The kernel's launch count is set to 0 before this phase
   and must be above 0 after it; the logits must be finite and agree with
   the same model run on ``log_mel_reference`` features;
5. train: the port's synthetic GLips corpus from ``--seed`` (4 words, 68
   clips per split: each split featurized in one kernel launch of 256 clips
   and one of 16, each epoch 8 full batches and one padded batch of 16);
   the native WAV decoder's time for the 816 clips against the Python
   decoder's; the kernel against ``log_mel_reference`` at B = 256 and 16, to
   1e-4, and its time at B = 256; then, with the kernel's launch count set
   to 0, ``pipelines.audio.main`` trains the full-width vgg_lstm (VGG16-BN,
   BiLSTM 2 x 128, 4 classes, input 117, float32, batch 32, lr 5e-4,
   wd 1e-4) for 3 epochs from a ``Config.from_dict``: every loss finite, the
   epoch-3 train loss below epoch 1's, the final test run on the reloaded
   best checkpoint, which then serves through ``Predictor.from_checkpoint``
   with the same accuracy. Then: the train step's time (forward + backward
   + Adam) at B=32 by CUDA events, training clips/s per epoch, the card's
   idle share over an epoch (``torch.profiler``), host batching + H2D per
   step, one epoch at ``model.dtype: bfloat16`` (parameters stay float32,
   losses finite), the first 3 training steps on the card against the
   same 3 steps of the port on the CPU at lr 1e-5, and the card's first 3
   steps at the trained lr 5e-4 against a float64 run of them on the card.

The line before the last is ``{"kernels": [...]}``, one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

KERNEL_TOL = 1e-4  # the JAX package's Pallas-vs-XLA bound (tests/test_logmel.py)
# Served logits vs the same model on plain-version features: the kernel's
# 1e-4 input bound carried through 13 convolutions and the BiLSTM in fp32.
LOGITS_TOL = 1e-3
KERNEL_BATCHES = (32, 128)
SERVE_BATCH = 32
WORDS = ("abend", "bereits", "cirka", "dabei")
CLIPS_PER_WORD = 20  # 80 clips: requests of 32, 32 and 16
VGG_VERSION = 16
TIMING_WARMUP, TIMING_ITERS = 5, 50
BREAKDOWN_ITERS = 10
# [train]: 272 clips per split, featurized in kernel launches of 256 and 16
# clips; an epoch is 8 batches of 32 and one of 16 padded to 32
TRAIN_CLIPS_PER_SPLIT = 68
TRAIN_CHUNKS = (256, 16)
TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_LR, TRAIN_WD = 32, 3, 5e-4, 1e-4
STEP_ITERS = 20
# The card's first training steps against the CPU's. Adam's first steps
# move nearly every weight by ±lr whatever the size of its gradient, so two
# correct float32 runs part in proportion to lr: after 3 steps the card's
# float32 run is 1.7e-2 from a float64 run of the same steps at lr 5e-4,
# 3.2e-3 at lr 3e-5 and 4.5e-5 at lr 1e-5 on an H100
# (multimodal_lipread_torch/tools/train_drift.py; PERF.md). So the card is
# held to the CPU at lr 1e-5, and, at the trained lr, to a float64 run on
# the card within DRIFT_RTOL: per step, twice the largest distance that
# `train_drift --lrs 5e-4 --no-cpu --seeds 0 0 1 2 3 4 5 6 7` read on an
# H100 (DRIFT_SEEDS_MAX; PERF.md).
PARITY_STEPS, PARITY_LR, PARITY_RTOL = 3, 1e-5, 1e-3
DRIFT_SEEDS_MAX = np.array([2.652e-6, 2.117e-3, 3.135e-2])
DRIFT_RTOL = 2 * DRIFT_SEEDS_MAX


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, warmup: int = TIMING_WARMUP, iters: int = TIMING_ITERS) -> float:
    """Mean milliseconds of ``fn`` on the card, after warm-up, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", f"{name} | power limit: {smi} | count {torch.cuda.device_count()} | "
                  f"torch {torch.__version__} CUDA {torch.version.cuda}")
    log("device", f"process default allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
                  f"cudnn={torch.backends.cudnn.allow_tf32} (a float32 model's forward and backward "
                  f"turn both off)")
    return {"name": name, "smi": smi}


def phase_build() -> None:
    from multimodal_lipread_torch.ops import _build

    t0 = time.perf_counter()
    results = _build.build_all(_build.KERNELS)
    log("build", f"{len(results)} kernel(s) in {time.perf_counter() - t0:.2f} s with plain nvcc")
    for r in results.values():
        log("build", f"{r.name}: {r.seconds:.2f} s -> {os.path.relpath(r.path, REPO)}")
        for line in r.ptxas_lines():
            log("build", f"  {line}")


def stft_log_mel(wave: torch.Tensor, window: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """Log-mel through torch.stft (cuFFT) + power + mel matmul + log + standardize."""
    from multimodal_lipread_torch.ops.logmel import HOP_LENGTH, LOG_EPS, N_FFT, standardize

    spec = torch.stft(wave, N_FFT, HOP_LENGTH, N_FFT, window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.real.square() + spec.imag.square()
    mel = (power.transpose(-1, -2) @ fb).transpose(-1, -2)
    return standardize(torch.log(mel + LOG_EPS))


def logmel_bound_ms(batch: int) -> tuple:
    """(bound ms, 'operations' or 'bytes') of the log-mel at ``batch`` clips:
    the DFT at 201 frequencies and the mel product over the filterbank's
    nonzero weights (no zero padding, no zero weights) at the fp32 peak,
    against each kernel input (waveforms, basis, mel table) read once and the
    output written once."""
    from multimodal_lipread_torch.ops.logmel_cuda import kernel_basis, kernel_mel_table
    from multimodal_lipread_torch.ops.logmel import N_FFT, N_FREQS, N_MELS, NUM_FRAMES, NUM_SAMPLES

    first, bands = kernel_mel_table()
    flops = batch * (2 * NUM_FRAMES * N_FFT * 2 * N_FREQS + 2 * NUM_FRAMES * np.count_nonzero(bands))
    nbytes = (batch * (NUM_SAMPLES + N_MELS * NUM_FRAMES) * 4
              + kernel_basis().nbytes + first.nbytes + bands.nbytes)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernel(seed: int) -> dict:
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.ops.logmel import log_mel_reference, mel_filterbank

    rng = np.random.default_rng(seed)
    window = torch.hann_window(400, device=DEVICE, dtype=torch.float32)
    window_n = window / window.square().sum().sqrt()  # normalized=True
    fb = torch.from_numpy(np.ascontiguousarray(mel_filterbank())).to(DEVICE)
    max_err, rows, failures = 0.0, {}, []
    for batch in KERNEL_BATCHES:
        cfg = logmel_cuda.launch_config(batch)
        blocks, sms = cfg["grid_x"] * cfg["grid_y"], torch.cuda.get_device_properties(0).multi_processor_count
        log("kernel", f"logmel B={batch} launch: grid ({cfg['grid_x']}, {cfg['grid_y']}) x {cfg['threads']} threads, "
                      f"dynamic smem {cfg['dynamic_smem_bytes']} B + static {cfg['static_smem_bytes']} B, "
                      f"{cfg['registers']} registers, {cfg['local_bytes']} B local (spills), "
                      f"{cfg['blocks_per_sm']} block(s)/SM: {blocks} blocks in "
                      f"{-(-blocks // (cfg['blocks_per_sm'] * sms))} wave(s) on {sms} SMs, no cluster "
                      f"(4-block clusters, one per clip, would fit {cfg['clusters_of_4']} at once)")
        wave = torch.from_numpy((rng.standard_normal((batch, 20000)) * 1000).astype(np.float32)).to(DEVICE)
        # diagnostic: both fp32 versions against an exact (float64) evaluation
        exact = {n: logmel_cuda.log_mel_float64(wave, n) for n in (False, True)}
        diag = {n: ((logmel_cuda.log_mel(wave, n).double() - exact[n]).abs().max().item(),
                    (log_mel_reference(wave, n).double() - exact[n]).abs().max().item()) for n in (False, True)}
        log("kernel", f"logmel B={batch} vs float64 on the card (diagnostic): normalize=False kernel "
                      f"{diag[False][0]:.3e} plain {diag[False][1]:.3e} | normalize=True kernel "
                      f"{diag[True][0]:.3e} plain {diag[True][1]:.3e}")
        for normalize in (True, False):
            got = logmel_cuda.log_mel(wave, normalize)
            want = log_mel_reference(wave, normalize)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            ok = bool(torch.isfinite(got).all()) and err <= KERNEL_TOL
            log("kernel", f"logmel B={batch} normalize={normalize}: max abs err {err:.3e} "
                          f"(tolerance {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append((batch, normalize, err))
        stft_err = (stft_log_mel(wave, window_n, fb) - log_mel_reference(wave, True)).abs().max().item()
        ms = cuda_ms(lambda: logmel_cuda.log_mel(wave, True))
        raw_ms = cuda_ms(lambda: logmel_cuda.log_mel(wave, False))
        plain = cuda_ms(lambda: log_mel_reference(wave, True))
        stft = cuda_ms(lambda: stft_log_mel(wave, window_n, fb))
        bound, bound_by = logmel_bound_ms(batch)
        rows[batch] = {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by}
        phases = [logmel_cuda.phase_times(wave, True) for _ in range(3)][-1]  # warm
        log("kernel", f"logmel B={batch} normalize=True phases, mean / max over blocks in us: " + ", ".join(
            f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in phases.items() if k != "launch")
            + f"; first start to last end {phases['launch']:.2f} us (timestamps on)")
        log("kernel", f"logmel B={batch} normalize=True: kernel {ms:.4f} ms ({100 * bound / ms:.1f} % of bound; "
                      f"normalize=False {raw_ms:.4f} ms) | plain {plain:.4f} ms | "
                      f"bound {bound:.4f} ms ({bound_by}) | torch.stft log-mel {stft:.4f} ms "
                      f"(partial yardstick, max abs err {stft_err:.2e}) | {torch.cuda.get_device_name(0)}")
    if failures:
        raise SystemExit(f"log-mel kernel disagrees with its plain version: {failures}")
    return {"max_abs_err": max_err, "rows": rows}


def write_corpus(root: str, rng: np.random.Generator) -> list:
    """GLips-shaped test split: per word a harmonic pair plus noise, int16 range."""
    from multimodal_lipread_torch.data.audio_io import SAMPLE_RATE, TARGET_SAMPLES, write_wav

    t = np.arange(TARGET_SAMPLES) / SAMPLE_RATE
    paths = []
    for wi, word in enumerate(WORDS):
        f0 = 180.0 + 90.0 * wi
        for i in range(CLIPS_PER_WORD):
            wave = (6000 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
                    + 2500 * np.sin(2 * np.pi * 2.7 * f0 * t)
                    + 1500 * rng.standard_normal(TARGET_SAMPLES))
            path = os.path.join(root, "lipread_files", word, "test", f"{word}_{2 * i:04d}-{2 * i + 1:04d}.wav")
            write_wav(path, wave)
            paths.append(path)
    return paths


def init_weights(model: torch.nn.Module, gen: torch.Generator) -> None:
    """He-normal matrices and kernels, BatchNorm scales near 1 with plausible
    running statistics, small biases: eval-mode activations stay
    non-degenerate through the 13 convolutions, so every weight matters."""
    from multimodal_lipread_torch.nn import BatchNorm

    with torch.no_grad():
        for mod in model.modules():
            is_bn = isinstance(mod, BatchNorm)
            for name, p in mod.named_parameters(recurse=False):
                noise = torch.randn(p.shape, generator=gen)
                if p.ndim > 1:
                    p.copy_(noise * (2.0 / p[0].numel()) ** 0.5)
                elif is_bn and name == "weight":
                    p.copy_(1.0 + 0.1 * noise)
                else:
                    p.copy_(0.05 * noise)
            if is_bn:
                mod.running_mean.copy_(0.1 * torch.randn(mod.running_mean.shape, generator=gen))
                mod.running_var.copy_(1.0 + 0.1 * torch.rand(mod.running_var.shape, generator=gen))


def request_breakdown(net: torch.nn.Module, clips: list) -> dict:
    """Milliseconds of each stage of one request: WAV decode (host clock),
    then on the card's timeline (CUDA events) the host-to-device copy, the
    log-mel kernel, the vgg_lstm forward and the copy of the logits back;
    ``device idle`` is the share of the request's wall time outside those."""
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.pipelines.common import decode_waveforms
    from multimodal_lipread_torch.utils.precision import model_precision

    names = ("decode", "H2D", "log-mel", "vgg_lstm", "D2H")
    totals = np.zeros(len(names) + 1)
    iters = BREAKDOWN_ITERS
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode(), model_precision(torch.float32):
        for _ in range(iters):
            t0 = time.perf_counter()
            waves = decode_waveforms(clips)
            t_decode = time.perf_counter() - t0
            ev[0].record()
            wave = torch.from_numpy(waves).to(DEVICE)
            ev[1].record()
            mel = logmel_cuda.log_mel(wave, True)[:, :80, :117]
            ev[2].record()
            logits = net(mel)
            ev[3].record()
            logits.cpu()
            ev[4].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            device = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
            totals += [t_decode * 1e3, *device, 100.0 * (1.0 - sum(device) / (wall * 1e3))]
    out = dict(zip(names, totals[:-1] / iters))
    return {**out, "device idle %": totals[-1] / iters}


def phase_serve(seed: int, device_info: dict) -> int:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.models.frontend import WaveToLogMel
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.ops.logmel import log_mel_reference
    from multimodal_lipread_torch.pipelines.common import decode_waveforms
    from multimodal_lipread_torch.train.checkpoint import module_state, save_checkpoint
    from multimodal_lipread_torch.utils.precision import model_precision

    tmp = tempfile.mkdtemp(prefix="mlt_chip_smoke_")
    try:
        root = os.path.join(tmp, "GLips_4")
        clips = write_corpus(root, np.random.default_rng(seed + 1))
        requests = [clips[i : i + SERVE_BATCH] for i in range(0, len(clips), SERVE_BATCH)]

        def config(streaming: bool) -> Config:
            return Config.from_dict({
                "dataset": {"root_dir": root, "num_classes": len(WORDS), "input_size": 117,
                            "streaming": streaming},
                "model": {"name": "vgg_lstm", "version": VGG_VERSION, "dtype": "float32"},
            })

        cfg_stream, cfg_feat = config(True), config(False)
        model = serving.build_audio_model(cfg_feat)
        gen = torch.Generator().manual_seed(seed)
        init_weights(model, gen)
        n_params = sum(p.numel() for p in model.parameters())
        ckpt_feat, ckpt_stream = os.path.join(tmp, "vgg_lstm_best.pt"), os.path.join(tmp, "vgg_lstm_stream_best.pt")
        meta = {"epoch": 0, "val_acc": 0.0, "scheduler_lr": 0.0}
        save_checkpoint(ckpt_feat, {**meta, "state": module_state(model)})
        save_checkpoint(ckpt_stream, {**meta, "state": module_state(WaveToLogMel(model, 117))})
        log("serve", f"vgg_lstm VGG{VGG_VERSION}-BN + BiLSTM 2x128, {n_params} parameters, fp32; "
                     f"{len(clips)} WAV clips in requests of {[len(r) for r in requests]}")

        serving.predict_audio_clips(cfg_stream, ckpt_stream, requests[0], SERVE_BATCH, device=DEVICE)  # warm-up
        torch.cuda.synchronize()

        logmel_cuda.launch_count = 0
        stream_logits = []
        for i, req in enumerate(requests):
            t0 = time.perf_counter()
            res = serving.predict_audio_clips(cfg_stream, ckpt_stream, req, SERVE_BATCH, device=DEVICE)
            dt = time.perf_counter() - t0
            stream_logits += [r["logits"] for r in res]
            log("serve", f"predict_audio_clips (streaming) request {i}: {len(req)} clips, {dt * 1e3:.2f} ms "
                         f"incl. model build + checkpoint load + WAV decode | {device_info['smi']}")
        feat = serving.predict_audio_clips(cfg_feat, ckpt_feat, clips, SERVE_BATCH, device=DEVICE)
        predictor = serving.Predictor.from_checkpoint(
            WaveToLogMel(serving.build_audio_model(cfg_feat), 117), ckpt_stream, SERVE_BATCH, device=DEVICE)
        resident, total_s = [], 0.0
        for i, req in enumerate(requests):
            t0 = time.perf_counter()
            logits = predictor.predict_logits(decode_waveforms(req))
            dt = time.perf_counter() - t0
            total_s += dt
            resident.append(logits)
            log("serve", f"resident Predictor request {i}: {len(req)} clips, {dt * 1e3:.2f} ms "
                         f"(WAV decode + H2D + log-mel kernel + vgg_lstm + D2H), "
                         f"{len(req) / dt:.1f} clips/s | {device_info['smi']}")
        torch.cuda.synchronize()
        launches = logmel_cuda.launch_count
        log("serve", f"resident Predictor: {len(clips)} clips in {total_s * 1e3:.2f} ms, "
                     f"{len(clips) / total_s:.1f} clips/s | {device_info['smi']}")
        log("serve", f"log-mel kernel launches while serving: {launches}")
        if launches < 1:
            raise SystemExit("serving never launched the log-mel kernel")
        net = predictor.model.model
        stages = request_breakdown(net, requests[0])
        log("serve", f"one request of {len(requests[0])} clips, mean of {BREAKDOWN_ITERS}: " + ", ".join(
            f"{k} {v:.3f}" + ("" if k.endswith("%") else " ms") for k, v in stages.items()) + f" | {device_info['smi']}")

        # the same model on plain-version features, in the same batches
        waves = torch.from_numpy(decode_waveforms(clips)).to(DEVICE)
        with torch.inference_mode(), model_precision(torch.float32):  # the served path's precision
            ref = torch.cat([net(log_mel_reference(waves[i : i + SERVE_BATCH], True)[:, :80, :117])
                             for i in range(0, len(clips), SERVE_BATCH)]).cpu().numpy()
        spread = float(np.ptp(ref, axis=0).max())
        log("serve", f"logits: scale {float(np.abs(ref).max()):.3f}, largest spread across clips {spread:.3f}, "
                     f"predicted classes {np.bincount(ref.argmax(-1), minlength=len(WORDS)).tolist()}")
        if not spread >= 10 * LOGITS_TOL:
            raise SystemExit("the logits barely depend on the input: the comparison below could not fail")
        served = {
            "streaming": np.asarray(stream_logits),
            "features_first": np.asarray([r["logits"] for r in feat]),
            "resident": np.concatenate(resident),
        }
        for name, logits in served.items():
            if logits.shape != (len(clips), len(WORDS)) or not np.isfinite(logits).all():
                raise SystemExit(f"{name}: logits of shape {logits.shape}, finite={np.isfinite(logits).all()}")
            err = float(np.abs(logits - ref).max())
            ok = np.allclose(logits, ref, rtol=LOGITS_TOL, atol=LOGITS_TOL)
            log("serve", f"{name} logits vs plain-version features: max abs err {err:.3e} "
                         f"(tolerance {LOGITS_TOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name} logits disagree with the plain-version features")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def device_busy_s(fn) -> tuple:
    """(busy s, wall s) of the card while ``fn`` runs: the union of the
    device activities ``torch.profiler`` records, and the profiled wall
    time (which the profiler's own host work lengthens)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None, wall
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) * 1e-6, wall


def phase_train(seed: int, device_info: dict) -> dict:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.data import native_io
    from multimodal_lipread_torch.data.audio_io import load_waveform
    from multimodal_lipread_torch.data.glips import scan_glips
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.models.audio import get_audio_model
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.ops.logmel import log_mel_reference
    from multimodal_lipread_torch.pipelines import audio as audio_pipeline
    from multimodal_lipread_torch.pipelines.common import decode_waveforms, load_audio_datasets
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    smi = device_info["smi"]
    tmp = tempfile.mkdtemp(prefix="mlt_chip_smoke_train_")
    try:
        root = make_synthetic_glips(os.path.join(tmp, "GLips_4"), words=WORDS,
                                    clips_per_split=TRAIN_CLIPS_PER_SPLIT, seed=seed)
        index = scan_glips(root)
        paths = [e.path for e in index.entries]
        log("train", f"synthetic GLips corpus from --seed: {len(paths)} WAV clips, "
                     f"{len(index.by_split('train'))} per split, {len(index.classes)} words")

        # host decode: the native decoder against the Python one
        t0 = time.perf_counter()
        native_io.get_lib()
        log("train", f"native decoder built with g++ in {time.perf_counter() - t0:.2f} s "
                     f"-> {os.path.relpath(native_io.library_path(), REPO)}")
        native_s, python_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            native = decode_waveforms(paths)
            native_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            python = np.stack([load_waveform(p) for p in paths])
            python_s.append(time.perf_counter() - t0)
        if not np.array_equal(native, python):
            raise SystemExit("the native decoder and the Python decoder disagree")
        log("train", f"decode {len(paths)} clips, median of 3: native {np.median(native_s) * 1e3:.2f} ms, "
                     f"Python {np.median(python_s) * 1e3:.2f} ms ({np.median(python_s) / np.median(native_s):.1f}x), "
                     f"bit-equal | host CPU ({os.cpu_count()} cores)")

        # the kernel at the featurization's batch sizes
        wave = torch.from_numpy(decode_waveforms([e.path for e in index.by_split("train")])).to(DEVICE)
        max_err, start = 0.0, 0
        for size in TRAIN_CHUNKS:
            chunk = wave[start : start + size]
            start += size
            got, want = logmel_cuda.log_mel(chunk, True), log_mel_reference(chunk, True)
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            ok = chunk.shape[0] == size and bool(torch.isfinite(got).all()) and err <= KERNEL_TOL
            log("train", f"logmel B={size} normalize=True vs plain: max abs err {err:.3e} "
                         f"(tolerance {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"log-mel kernel disagrees with its plain version at B={size}")
        big = wave[: TRAIN_CHUNKS[0]]
        row256 = {"ms": cuda_ms(lambda: logmel_cuda.log_mel(big, True)),
                  "plain_ms": cuda_ms(lambda: log_mel_reference(big, True))}
        row256["bound_ms"], row256["bound_by"] = logmel_bound_ms(TRAIN_CHUNKS[0])
        log("train", f"logmel B={TRAIN_CHUNKS[0]} normalize=True: kernel {row256['ms']:.4f} ms "
                     f"({100 * row256['bound_ms'] / row256['ms']:.1f} % of bound) | plain {row256['plain_ms']:.4f} ms | "
                     f"bound {row256['bound_ms']:.4f} ms ({row256['bound_by']}) | {smi}")

        # the training pipeline, end to end
        cfg = Config.from_dict({
            "dataset": {"root_dir": root, "num_classes": len(WORDS), "input_size": 117},
            "model": {"name": "vgg_lstm", "version": VGG_VERSION, "dtype": "float32"},
            "training": {"batch_size": TRAIN_BATCH, "epochs": TRAIN_EPOCHS, "learning_rate": TRAIN_LR,
                         "weight_decay": TRAIN_WD, "seed": seed},
            "output": {"base_dir": os.path.join(tmp, "run"), "plots": False},
        })
        logmel_cuda.launch_count = 0
        t0 = time.perf_counter()
        result = audio_pipeline.main(cfg, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = logmel_cuda.launch_count
        log("train", f"pipelines.audio.main: vgg_lstm VGG{VGG_VERSION}-BN + BiLSTM 2x128, float32, "
                     f"batch {TRAIN_BATCH}, {TRAIN_EPOCHS} epochs in {wall:.2f} s (featurization, model build, "
                     f"training, evaluation, checkpoints); log-mel kernel launches: {launches}")
        if launches < 1:
            raise SystemExit("training never launched the log-mel kernel")
        hist = result["history"]
        for h in hist:
            log("train", f"epoch {h['epoch']}: train {h['train_loss']:.4f}/{h['train_acc']:.2f}% "
                         f"val {h['val_loss']:.4f}/{h['val_acc']:.2f}% test {h['test_loss']:.4f}/{h['test_acc']:.2f}% "
                         f"lr {h['lr']:.2e}, {h['seconds']:.3f} s, {h['clips_per_sec']:.1f} clips/s "
                         f"(train + val + test) | {smi}")
        losses = [h[k] for h in hist for k in ("train_loss", "val_loss", "test_loss")]
        if len(hist) != TRAIN_EPOCHS or not np.isfinite(losses).all():
            raise SystemExit(f"training gave {len(hist)} epochs, losses {losses}")
        if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
            raise SystemExit("the train loss did not fall from epoch 1 to the last epoch")
        best = result.get("best_checkpoint")
        if not best or not os.path.isfile(best) or not np.isfinite(result.get("final_test_loss", np.nan)):
            raise SystemExit("no best checkpoint, or no final test on it")
        log("train", f"final test on the reloaded best checkpoint (best val acc {result['best_val_acc']:.2f}%): "
                     f"loss {result['final_test_loss']:.4f}, acc {result['final_test_acc']:.2f}%")

        # the trained checkpoint serves
        test = index.by_split("test")
        served = serving.predict_audio_clips(cfg, best, [e.path for e in test], TRAIN_BATCH, device=DEVICE)
        logits = np.asarray([r["logits"] for r in served])
        labels = np.asarray([index.class_to_idx[e.word] for e in test])
        if logits.shape != (len(test), len(WORDS)) or not np.isfinite(logits).all():
            raise SystemExit(f"serving the trained checkpoint gave logits of shape {logits.shape}")
        served_acc = 100.0 * float((logits.argmax(-1) == labels).mean())
        log("train", f"served the best checkpoint through Predictor.from_checkpoint: {len(test)} test clips, "
                     f"accuracy {served_acc:.2f}% (final test {result['final_test_acc']:.2f}%)")
        if abs(served_acc - result["final_test_acc"]) > 100.0 / len(test) + 1e-9:
            raise SystemExit("the served checkpoint's accuracy differs from the final test's")

        # train-step time, epoch rate, idle share, host batching
        datasets, _ = load_audio_datasets(root, device=DEVICE)
        train_ds = datasets["train"]

        def trainer_for(model, device=DEVICE, lr=TRAIN_LR, name="vgg_lstm", epochs=1):
            return Trainer(model, TrainerConfig(
                model_name=name, num_classes=len(WORDS), batch_size=TRAIN_BATCH, epochs=epochs,
                learning_rate=lr, weight_decay=TRAIN_WD, seed=seed, host_prefetch=0,
                metrics_dir=os.path.join(tmp, name, device, "metrics"),
                checkpoints_dir=os.path.join(tmp, name, device, "models_trained")), device=device)

        trainer = trainer_for(get_audio_model("vgg_lstm", len(WORDS), version=VGG_VERSION))
        trainer.init_state()
        batch = next(trainer.batches(train_ds, True, np.random.default_rng(seed)))
        step_ms = cuda_ms(lambda: trainer.train_step(*batch), warmup=3, iters=STEP_ITERS)
        torch.cuda.synchronize()
        t0, n = time.perf_counter(), 0
        for _ in trainer.batches(train_ds, True, np.random.default_rng(seed)):
            torch.cuda.synchronize()
            n += 1
        host_ms = (time.perf_counter() - t0) / n * 1e3
        rng = np.random.default_rng(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_epoch(train_ds, rng)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        busy_s, prof_s = device_busy_s(lambda: trainer.train_epoch(train_ds, rng))
        log("train", f"train step (forward + backward + Adam) at B={TRAIN_BATCH}, float32: {step_ms:.3f} ms "
                     f"(CUDA events, mean of {STEP_ITERS}) | {smi}")
        log("train", f"training epoch ({len(train_ds)} clips, {n} steps, no evaluation): {epoch_s * 1e3:.2f} ms, "
                     f"{len(train_ds) / epoch_s:.1f} clips/s | host batching + H2D {host_ms:.3f} ms per step "
                     f"(gather, pin, copy, synchronized) | {smi}")
        log("train", "card idle over a training epoch: " + (
            "not measured: the profiler recorded no device activity" if busy_s is None else
            f"{100.0 * (1.0 - busy_s / epoch_s):.1f} % (device activity {busy_s * 1e3:.2f} ms in a profiled epoch, "
            f"torch.profiler, over the unprofiled epoch's {epoch_s * 1e3:.2f} ms; the profiled epoch took "
            f"{prof_s * 1e3:.2f} ms)") + f" | {smi}")

        # one epoch at model.dtype: bfloat16
        bf16 = trainer_for(get_audio_model("vgg_lstm", len(WORDS), version=VGG_VERSION, dtype=torch.bfloat16),
                           name="vgg_lstm_bf16")
        bf_hist = bf16.fit(train_ds, datasets["val"], None, progress=None)["history"]
        bf_step_ms = cuda_ms(lambda: bf16.train_step(*batch), warmup=3, iters=STEP_ITERS)
        f32_state = all(t.dtype == torch.float32 for t in list(bf16.model.parameters()) + list(bf16.model.buffers()))
        bf_losses = [bf_hist[0]["train_loss"], bf_hist[0]["val_loss"]]
        log("train", f"bfloat16 epoch: train {bf_losses[0]:.4f} val {bf_losses[1]:.4f}, {bf_hist[0]['seconds']:.3f} s; "
                     f"step at B={TRAIN_BATCH} {bf_step_ms:.3f} ms; parameters and buffers float32: {f32_state} | {smi}")
        if not f32_state or not np.isfinite(bf_losses).all():
            raise SystemExit("bfloat16 training changed the parameters' dtype or gave a non-finite loss")

        # the card's first steps against the CPU's, and a float64 run on the card
        from multimodal_lipread_torch.tools.train_drift import first_steps

        card, cpu, exact = (np.asarray(first_steps(train_ds, device, dtype, PARITY_LR, PARITY_STEPS, seed,
                                                   os.path.join(tmp, "parity"), TRAIN_BATCH, VGG_VERSION))
                            for device, dtype in ((DEVICE, torch.float32), ("cpu", torch.float32),
                                                  (DEVICE, torch.float64)))
        rel = np.abs(card / cpu - 1.0)
        ok = bool(np.all(rel <= PARITY_RTOL))
        log("train", f"first {PARITY_STEPS} steps at lr {PARITY_LR:g}, dropout 0, same init and batches, "
                     f"float32: card {card.tolist()} cpu {cpu.tolist()} relative {rel.tolist()} "
                     f"(tolerance {PARITY_RTOL:g}) {'ok' if ok else 'FAIL'}; against float64 on the card "
                     f"(diagnostic): card {np.abs(card / exact - 1).tolist()} cpu {np.abs(cpu / exact - 1).tolist()}")
        if not ok:
            raise SystemExit("the card's training steps disagree with the CPU's")
        card, exact = (np.asarray(first_steps(train_ds, DEVICE, dtype, TRAIN_LR, PARITY_STEPS, seed,
                                              os.path.join(tmp, "drift"), TRAIN_BATCH, VGG_VERSION))
                       for dtype in (torch.float32, torch.float64))
        rel = np.abs(card / exact - 1.0)
        ok = bool(np.all(rel <= DRIFT_RTOL))
        log("train", f"first {PARITY_STEPS} steps at the trained lr {TRAIN_LR:g}, dropout 0, same init and batches: "
                     f"card float32 {card.tolist()} float64 on the card {exact.tolist()} relative {rel.tolist()} "
                     f"(tolerance {DRIFT_RTOL.tolist()}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the card's float32 training steps at the trained lr stray from float64")
        return {"launches": launches, "max_abs_err": max_err, "row256": row256}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    device_info = phase_device()
    phase_build()
    kernel = phase_kernel(args.seed)
    launches = phase_serve(args.seed, device_info)
    train = phase_train(args.seed, device_info)
    launches += train["launches"]
    row = kernel["rows"][SERVE_BATCH]
    print(json.dumps({"kernels": [{
        "name": "logmel",
        "route": "cuda",
        "source": "multimodal_lipread_torch/csrc/logmel.cu",
        "replaces": "multimodal_lipread_tpu/ops/logmel_pallas.py:107",
        "launches": launches,
        "max_abs_err": max(kernel["max_abs_err"], train["max_abs_err"]),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
