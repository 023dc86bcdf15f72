#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``multimodal_lipread_torch``).

    python3 chip_smoke.py [--seed 0]

On one CUDA card (an H100 is the target), in order ([zoo], 14, runs
last; [ckpt], 33, follows [ddp]), each phase printing its lines and any
failure ending the run with a non-zero exit:

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
   + Adam) at B=32 by CUDA events, its FLOPs and device activities, training
   clips/s per epoch, the card's idle share over an epoch
   (``torch.profiler``), host batching + H2D per step, one epoch at ``model.dtype: bfloat16`` (parameters stay float32,
   losses finite), the first 3 training steps on the card against the
   same 3 steps of the port on the CPU at lr 1e-5, and the card's first 3
   steps at the trained lr 5e-4 against a float64 run of them on the card;
6. video-train: the port's synthetic lip corpus from ``--seed`` (4 words,
   32 clips per split, kept uint8: an epoch is 8 steps of 16) and the
   ``.npy`` load time of it; ``pipelines.video.main`` trains
   ``configs/visual_config.yaml``'s ``resnet_trans`` at its widths
   (ResNet18 over 29 frames of 44 x 44 x 3, a 256-d projection,
   sinusoidal positions, a 2-layer 4-head post-LN Transformer with FF 1024,
   dropout 0.2, batch 16, lr 5e-5, wd 1e-5, ReduceLROnPlateau on the val
   accuracy) for 3 epochs in float32 from a ``Config.from_dict``: every
   loss finite, the epoch-3 train loss below epoch 1's, the final test on
   the reloaded best checkpoint, which serves with the same accuracy. Then
   the train step's time at B=16 by CUDA events, its FLOPs and device
   activities, training clips/s per epoch, the card's idle share over an epoch, host batching + H2D per
   step, the first 3 steps on the card against the CPU at lr 1e-5, and the
   card's first 3 float32 steps at the trained lr 5e-5 against a float64
   run of them on the card;
7. video-serve: the best checkpoint in a resident ``Predictor`` and behind
   ``serving.predict_clips(pipeline="video")``, requests of 16 lip-region
   ``.npy`` files: each request's time, clips/s, a breakdown of one
   request (host ``.npy`` load, uint8 H2D, forward, D2H, card idle), and
   the card's logits against the same weights on the CPU, to 1e-3;
8. av-train: the port's synthetic corpus from ``--seed`` with audio and
   lips (4 words, 32 aligned clips per split, lips kept uint8), featurized
   by ``load_av_datasets`` with the kernel's launch count set to 0 (above 0
   after, and the mels held to the plain version's to 1e-4); then, with the
   count set to 0 again, ``pipelines.audio_video.main`` trains
   ``configs/av_config.yaml``'s ``middle_fusion_mobilenet`` at its widths
   (log-mel 80 x 117, MobileNetV3-small over 29 frames of 44 x 44 x 3, a
   1-layer BiLSTM 256, ``fc1`` 37 632 -> 512; float32, batch 8, lr 1e-4, no
   weight decay, no LR schedule) for 3 epochs from a ``Config.from_dict``:
   every loss finite, the epoch-3 train loss below epoch 1's, the final
   test on the reloaded best checkpoint, which serves with the same
   accuracy. Then the train step's time at B=8 by CUDA events, its device
   activities and device time by kernel, training clips/s per epoch, the
   card's idle share over an epoch, host batching + H2D per step, the first
   3 steps on the card against the CPU at lr 1e-5, and the card's first 3
   float32 steps at lr 1e-4 against a float64 run of them on the card;
9. av-serve: the best checkpoint behind ``serving.predict_clips(pipeline=
   "audio_video")`` and in a resident ``Predictor``, requests of 16
   ``wav,npy`` groups, each of which must launch the log-mel kernel: each
   request's time, clips/s, a breakdown of one request (WAV decode, ``.npy``
   load, H2D, log-mel kernel, forward, D2H, card idle), and the card's
   logits against the same weights fed plain-version features on the card
   and against the CPU, to 1e-3;
10. cues-train: the port's synthetic corpus from ``--seed`` with cue
   descriptions (4 words, 32 clips per split; the emotion records pooled
   and split 90/10 by ``training.split_seed``: 346 train, 38 val), as
   ``HashingTokenizer`` ids of length 32 (the repository ships no Hugging
   Face weights); ``pipelines.cues.main`` trains ``configs/cues_config.yaml``
   with the overrides ``--set model.name=bert --set model.bert_size=base
   --set training.learning_rate=5e-5 --set training.epochs=2`` (bert-base
   widths from a random initialization, batch 8, balanced class weights,
   ``linear_warmup``, train/val logs only) in float32: every loss finite, the
   epoch-2 train loss below epoch 1's, the best checkpoint reloaded into a
   ``Predictor`` classifies the val split with the best val accuracy. Then
   the train step's time at B=8 by CUDA events, its FLOPs and device
   activities, training clips/s per epoch, the card's idle share over an
   epoch, host batching + H2D per step, the first 3 steps on the card
   against the CPU at lr 1e-5, and the card's first 3 float32 steps at lr
   5e-5 against a float64 run of them on the card;
11. cues-serve: the best checkpoint in a resident ``Predictor`` and behind
   ``serving.predict_clips(pipeline="cues")``, 8 requests of 16 cue ``.txt``
   files: each request's time, clips/s, a breakdown of one request (read +
   tokenize, H2D, forward, D2H, card idle), and the card's logits against
   the same weights on the CPU, to 1e-3;
12. ac-train: the synthetic corpus from ``--seed`` with audio and cues (4
   words, 68 clips per split, each split featurized in kernel launches of
   256 and 16 clips by ``load_audio_cue_datasets``, the mels held to the
   plain version to 1e-4; hashed mpnet cue embeddings); then, with the
   kernel's launch count set to 0, ``pipelines.audio_cues.main`` trains
   ``configs/ac_config.yaml``'s ``middle_fusion_mobile`` (MobileNetV2 over
   the 1 x 80 x 117 log-mel, the cue through Linear 768 -> 128, one-token
   4-head self-attention over the 1408-d concat, 256, 4) at batch 32, lr
   1e-3 with the 2-epoch warmup, plateau (min, 0.5, 3), for 3 epochs in
   float32, with the checks and measurements of [av-train] (the card's
   float32 steps held to float64 at lr 1e-3);
13. ac-serve: requests of 16 ``wav,txt`` groups behind ``predict_clips(
   pipeline="audio_cues")`` and to a resident ``Predictor``, each of which
   must launch the log-mel kernel: each request's time, clips/s, a
   breakdown of one request (WAV decode, log-mel kernel, cue embedding on
   the host, H2D, forward, D2H, card idle), and the logits against the same
   weights fed plain-version features on the card and against the CPU, to
   1e-3;
14. zoo: ``model.pretrained`` with ``arch: checkpoint`` grafts [video-train]'s
   best ``resnet_trans`` checkpoint's ``resnet`` into ``early_fusion_resnet``'s
   ``video_encoder.cnn`` (the tensors must equal the source); then one
   forward, backward and Adam step at full width on the card for the six
   other AV models (B=8, this one grafted), the seven other audio models
   (B=32), the video ``conformer`` (B=16), the ten other cue models (B=8 on
   their embedding kind's features of the [cues-train] records; ``bert_lite``
   at bert-base width in bf16, its logits held to the same weights in
   float32 on the CPU at the bf16 bound 5e-2) and the six other audio_cues
   models (B=32): every loss finite, each step's time, and eval logits
   against the same weights on the CPU, to 1e-3, and under a tenth of the
   CPU logits' spread across the compared rows; its cases of the cues_video
   and audio_cues_video models are listed under 19;
15. cv-train: the synthetic corpus from ``--seed`` with audio, lips and cue
   descriptions (4 words, 32 aligned clips per split, lips kept uint8,
   hashed mpnet cue embeddings); ``pipelines.cues_video.main`` trains
   ``configs/cv_config.yaml``'s ``middle_fusion_resnet`` (a trainable
   ResNet18 over 29 frames, a 2-layer BiLSTM 2 x 128, a
   ``SingleQueryAttention(256)`` queried by the projected cue, concat + MLP;
   float32, batch 8, lr 1e-4, wd 1e-5, plateau (min, 0.5, 3)) for 3 epochs
   with the checks and measurements of [av-train];
16. cv-serve: 8 requests of 16 ``txt,npy`` groups to a resident
   ``Predictor`` and two through ``predict_clips(pipeline="cues_video")``:
   each request's time, clips/s, a breakdown of one request (read + embed,
   ``.npy`` load, H2D, forward, D2H, card idle), and the logits against the
   CPU to 1e-3;
17. acv-train: the same corpus featurized by ``load_triple_datasets`` with
   the kernel's launch count set to 0 (above 0 after, the mels held to the
   plain version to 1e-4); then ``pipelines.audio_cues_video.main`` trains
   ``configs/acv_config.yaml``'s ``late_fusion_mobile`` (ResNet18 over the
   1 x 80 x 117 log-mel, MobileNetV2 over 29 frames + 2-layer BiLSTM, the
   plain cue MLP, per-modality logits fused by ``ModalityAttentionFusion``;
   batch 8, lr 1e-5, wd 1e-5) for 3 epochs with the same checks and
   measurements, its rolling checkpoint written;
18. acv-serve: 8 requests of 16 ``wav,txt,npy`` groups, each launching the
   log-mel kernel, with the breakdown (WAV decode, log-mel kernel, read +
   embed, ``.npy`` load, H2D, forward, D2H, card idle) and the logits
   against plain-version features and the CPU to 1e-3;
19. frozen: acv_config's recipe on ``early_fusion_mobile`` (audio ResNet18
   and video MobileNetV2 frozen) through ``pipelines.audio_cues_video.main``
   for 2 epochs, (a) with ``training.frozen_bn_eval``, (b) with
   ``training.cache_frozen_features``, (c) by default: every frozen
   parameter bit-equal to its start, the frozen BatchNorms' running
   statistics moved in (c) only, (b)'s per-step losses equal to (a)'s to
   1e-5 relative, and the step time of each; [zoo] then adds one step of
   the six other cues_video models (B=8 on cue + lips) and the six other
   audio_cues_video models (B=8 on mel + cue + lips), their frozen
   parameters frozen.

20. crop-kernel (after 3): the lip-crop kernel (``csrc/crop_resize.cu``, a
   cluster of blocks per frame) against ``crop_resize_pad_reference`` on
   the card, on 6 sets of frames of 256 x 256 x 3 and boxes from
   ``--seed`` (failed detections, a negative width, edge-touching,
   whole-frame, square and exact 44 x 44 boxes among them) at 16 x 29 and
   32 x 29 frames, uint8 and normalized: the largest difference in uint8
   LSB (at most 1; bit-equal expected) and the count of differing values;
   its launch configuration (threads, blocks a cluster, stage and shared
   memory bytes, registers, spills, blocks per SM, resident clusters) and
   ``-Xptxas -v``'s report; its device time by replaying a CUDA graph of
   96 launches (cold: the launches rotate over the 6 sets, whose touched
   sectors exceed the 50 MB L2; warm: one set), ``torch.profiler``'s mean
   kernel time as a cross-check, its share of the bound (output bytes plus
   the distinct 32-byte sectors of source rows the gather needs, at the
   memory rate), the wrapper's time per call by CUDA events over
   back-to-back calls and the host's microseconds a call; the kernel's
   phases per block (``ops.crop_resize_cuda.phase_times``), also with 33
   frames alone on the card, its time a frame with 4640 frames in one
   launch (steady state), and a one-element kernel's graphed time (the
   launch floor); other launches (blocks a cluster, threads, stage bytes),
   cold, each held to the plain version; the plain version; and
   ``F.grid_sample`` over the same source coordinates (a partial
   yardstick) by the same cold graph replay;
21. stream-train (after 5): ``pipelines.audio.main`` with
   ``dataset.streaming`` on [train]'s corpus, 1 epoch: the log-mel kernel
   launches at least once per train step (``WaveToLogMel`` in the
   forward), and one step on the first unshuffled batch gives the
   features-first model's loss at the same weights, to 1e-4;
22. crop-train (after 7): ``visual_config.yaml``'s ``resnet_trans`` at
   its widths, batch 16, 2 epochs on 64 in-memory clips of 29 full
   256 x 256 frames and boxes from ``--seed``, streamed, with the crop
   kernel as ``device_preproc``: finite losses, the kernel launched every
   step, the first 3 losses equal to the same steps on an ``ArrayDataset``
   of the plain version's crops in the same order (1e-5, under
   ``cudnn.deterministic``); a per-step breakdown (host batch, H2D of the
   full frames, crop kernel, step, idle); 4 requests of 16 full-frame
   clips through ``Predictor(device_preproc=device_crop)`` against the
   plain crops, to 1e-3;
23. mp4 (after 22): ``pipelines.video.main`` on a synthetic ``.mp4`` tree
   (OpenCV ``mp4v``), 1 epoch with ``dataset.device_crop`` and 1 with
   ``dataset.host_crop_streaming``, and the host's decode + detect time
   per clip;
24. graphs (after 19, before [zoo]): device-resident training of
   [av-train]'s, [acv-train]'s, [cues-train]'s (bert-base) and
   [ac-train]'s models on 10 full batches of their train splits (cut, or
   repeated where smaller), eager against CUDA graphs of 4 steps (``steps_per_dispatch``):
   per-step losses over 2 epochs with one forced ReduceLROnPlateau halving,
   with dropout off and on, bit-equal expected and held to 1e-6 under
   ``cudnn.deterministic``; then, before and after, device activities and
   host launch calls per step, step time, clips/s and the idle share;
25. native-stream (after 23): ``dataset.loader_backend: native`` (the C++
   prefetcher of ``native/mlt_io.cpp``): [stream-train]'s corpus with
   ``wire_dtype: int16`` through ``pipelines.audio.main`` against the grain
   backend, 1 epoch each under ``cudnn.deterministic``, the per-step losses
   equal to 1e-6 (bit-equal expected) and the log-mel kernel in every step;
   host batch ms of the native loader and of the ``DataLoader`` with 0 and
   4 workers, and the card's idle share over a training epoch of the first
   two (4 workers are spawned anew every epoch: their first batch's wait);
   then [video-train]'s lips as native ``npy_u8`` records, byte-equal to
   ``LipClipSource``'s over a shuffled epoch, their host batch ms, and 1
   epoch of ``pipelines.video.main`` on them;
26. load-test: ``serving.load_test`` with 4 client threads on one card:
   [stream-train]'s checkpoint in a resident ``Predictor`` (32 waveforms a
   request, 25 requests a thread, the log-mel kernel in each), and
   [video-train]'s resnet_trans behind ``Predictor(device_preproc=
   device_crop)`` (16 full-frame clips of 29 x 256 x 256 x 3 a request, 10
   a thread, the crop kernel in each): p50, p90, p99, max and clips/s;
27. export: ``serving.export_pipeline`` on [stream-train]'s checkpoint
   (``torch.export`` over raw waveforms), loaded again and run on the card:
   the graph holds ``mlt.log_mel``, the run launches the kernel, and the
   logits equal the resident ``Predictor``'s to 1e-6;
28. serve-cold (after 18): one ``predict_clips`` call of 16 clips for
   cv, acv and bert-base from the run's checkpoints against the parent
   commit's way of making it and a resident request, in turns, with equal
   logits; the call's stages with the state copied from pinned and from
   pageable memory, in turns; and a request's 16 lip ``.npy`` files through
   ``np.load`` and through ``serving.load_lips``;
29. ddp (after [graphs], before [zoo]): ``pipelines.audio.main`` trains
   full-width vgg_lstm (B=32, 1 epoch, lr 1e-5, ``cudnn.deterministic``)
   on [train]'s corpus, the log-mel kernel featurizing, (0) without a
   process group, (a) as one rank over NCCL (DDP at world 1) and (b) as two
   ranks over gloo sharing the card (NCCL refuses two ranks on one device),
   and, where two cards are visible, (c) two ranks over NCCL: (a) bit-equal
   to (0) over every step (1e-6), and in (a)'s rank 3 device-resident epochs
   as CUDA graphs of 4 DDP steps (the NCCL all-reduce captured) against
   eager ones, bit-equal expected (1e-6); (b) and (c) against (a): step 1's loss to
   1e-5, its summed gradients in norm to 1e-2, the BatchNorm statistics
   after it to 1e-6, steps 2 and 3 to 1e-3; each run's step time (CUDA
   events) and its all-reduce share (``torch.profiler``). Every run writes
   ``checkpoint_backend: orbax_async`` rolling and best checkpoints, one
   directory per run shared by its ranks ([ckpt] (d) reads them). Ranks are
   spawned by ``torch.multiprocessing`` over a ``FileStore``, their lines
   tagged with the rank; a failing rank fails the run;
30. tp: ``pipelines.cues.main`` at bert-base width (cues_config's bert, 1
   epoch on a small cue corpus from ``--seed``) with
   ``training.tensor_parallel: 2`` on two ranks (gloo sharing the card, or
   NCCL across two cards) against tensor_parallel 1: the first 3 losses
   to 2e-4, the parameters and Adam moments cut as ``BERT_TP_RULES`` say,
   the step times and all-reduce share;
31. pp: the pipelined bert-base at S = 1, M = 4 as one rank over NCCL
   against ``BertClassifier`` at the same weights (dropout off): logits to
   1e-5 and one GPipe step's loss to 1e-5 relative; S = 2 where two cards
   are visible (gloo has no CUDA send/recv);
32. dp-serve: ``serving.predict_clips(..., data_parallel=True)`` (the
   CLI's ``--data-parallel``) over every visible card on [serve]'s
   vgg_lstm weights, streaming (the log-mel kernel in each replica's
   forward), against one resident ``Predictor``: logits to 1e-6, the
   kernel's launches counted;
33. ckpt (after [ddp]): the orbax checkpoint backends (``train/
   checkpoint.py``, ``torch.distributed.checkpoint`` directories). (a)
   ``pipelines.audio.main`` trains full-width vgg_lstm (B=32, 2 epochs,
   [train]'s corpus, ``cudnn.deterministic``) with ``orbax_async`` and
   rolling checkpoints and with ``msgpack``: histories and the final test
   accuracy bit-equal, the logits served from ``vgg_lstm_best.orbax``
   bit-equal to ``vgg_lstm_best.pt``'s, and ``--resume`` in a fresh
   ``main`` trains 0 epochs; (c) the device-resident vgg_lstm in CUDA
   graphs of 4 steps with ``orbax_async``: each epoch's rolling save
   (redirected to a directory of its own) bit-equal to the host snapshot
   taken when the save returned; (b) bert-base through
   ``pipelines.cues.main`` on [cues-train]'s corpus, 2 epochs with each
   backend: the milliseconds ``fit`` blocks in each save and in each wait,
   the bytes on disk, each epoch's train + val time and its wall time to
   the next epoch; (d) [ddp]'s directories: a ``__<rank>_0.distcp`` file
   per rank, each item written once, the rolling one bit-equal to rank 0's
   model after fit, and (b)'s resumed at world 1 with 0 epochs left. The
   log-mel kernel's launches of the phase are counted.

Every phase prints its wall time. The video and cue phases, [cv-*] and
[zoo] launch no hand-written kernel. The request breakdowns load lips
through ``serving.load_lips``. The line
before the last is ``{"kernels": [...]}``, one entry per kernel, with the
paths that launch it (the crop kernel's ``max_abs_err`` in uint8 LSB); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
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
# [video-train] / [video-serve]: configs/visual_config.yaml's resnet_trans
# on 4 words x 32 lip clips per split (an epoch is 8 steps of 16)
VIDEO_CLIPS_PER_SPLIT = 32
VIDEO_BATCH, VIDEO_EPOCHS, VIDEO_LR, VIDEO_WD = 16, 3, 5e-5, 1e-5
# the card's first 3 float32 steps at lr 5e-5 against float64 on the card:
# per step, twice the largest distance that `train_drift --pipeline video
# --model resnet_trans --lrs 5e-5 --no-cpu --seeds 0 0 1 2 3 4 5 6 7` read
# on an H100 (PERF.md)
VIDEO_DRIFT_SEEDS_MAX = np.array([1.851e-7, 3.668e-5, 1.906e-4])
VIDEO_DRIFT_RTOL = 2 * VIDEO_DRIFT_SEEDS_MAX
# [av-train] / [av-serve]: configs/av_config.yaml's middle_fusion_mobilenet
# on 4 words x 32 aligned clips per split (an epoch is 16 steps of 8)
AV_MODEL, AV_INPUT_SIZE = "middle_fusion_mobilenet", 117
AV_CLIPS_PER_SPLIT = 32
AV_BATCH, AV_EPOCHS, AV_LR = 8, 3, 1e-4
AV_REQUEST = 16
# the card's first 3 float32 steps at lr 1e-4 against float64 on the card:
# per step, twice the largest distance that `train_drift --pipeline
# audio_video --lrs 1e-4 --no-cpu --seeds 0 0 1 2 3 4 5 6 7` read on an
# H100 (PERF.md)
AV_DRIFT_SEEDS_MAX = np.array([1.564e-7, 7.830e-7, 9.295e-6])
AV_DRIFT_RTOL = 2 * AV_DRIFT_SEEDS_MAX
# [cues-train] / [cues-serve]: cues_config.yaml with bert at bert-base width
# on the emotion records of 4 words x 32 clips per split, pooled and split
# 90/10 (346 train: an epoch is 44 steps of 8)
CUES_CLIPS_PER_SPLIT = 32
CUES_SET = {"model.name": "bert", "model.bert_size": "base", "training.learning_rate": 5e-5,
            "training.epochs": 2}
CUES_BATCH, CUES_REQUEST, CUES_REQUESTS = 8, 16, 8
# the card's first 3 float32 steps at lr 5e-5 against float64 on the card:
# per step, twice the largest distance that `train_drift --pipeline cues
# --lrs 5e-5 --no-cpu --seeds 0 0 1 2 3 4 5 6 7` read on an H100 (PERF.md)
CUES_DRIFT_SEEDS_MAX = np.array([1.624e-7, 1.890e-6, 3.826e-6])
CUES_DRIFT_RTOL = 2 * CUES_DRIFT_SEEDS_MAX
# [ac-train] / [ac-serve]: configs/ac_config.yaml's middle_fusion_mobile on
# 4 words x 68 clips per split (an epoch is 8 steps of 32 and one of 16)
AC_MODEL, AC_INPUT_SIZE = "middle_fusion_mobile", 117
AC_CLIPS_PER_SPLIT = 68
AC_BATCH, AC_EPOCHS, AC_LR = 32, 3, 1e-3
AC_REQUEST, AC_REQUESTS = 16, 8
# the card's first 3 float32 steps at lr 1e-3 (no warmup) against float64
# on the card: per step, twice the largest distance that `train_drift
# --pipeline audio_cues --lrs 1e-3 --no-cpu --seeds 0 0 1 2 3 4 5 6 7` read
# on an H100 (PERF.md)
AC_DRIFT_SEEDS_MAX = np.array([3.473e-7, 1.417e-3, 1.533e-2])
AC_DRIFT_RTOL = 2 * AC_DRIFT_SEEDS_MAX
# [cv-train] / [cv-serve]: configs/cv_config.yaml's middle_fusion_resnet on
# 4 words x 32 aligned cue + lip clips per split (an epoch is 16 steps of 8);
# [acv-train] / [acv-serve] / [frozen] share the corpus, with audio
CV_MODEL = "middle_fusion_resnet"
CV_CLIPS_PER_SPLIT = 32
CV_BATCH, CV_EPOCHS, CV_LR, CV_WD = 8, 3, 1e-4, 1e-5
CV_REQUEST, CV_REQUESTS = 16, 8
# the card's first 3 float32 steps at lr 1e-4 against float64 on the card:
# per step, twice the largest distance that `train_drift --pipeline
# cues_video --lrs 1e-4 --no-cpu --seeds 0 0 1 2 3 4 5 6 7` read on an H100
# (PERF.md)
CV_DRIFT_SEEDS_MAX = np.array([1.743e-7, 2.094e-5, 8.057e-5])
CV_DRIFT_RTOL = 2 * CV_DRIFT_SEEDS_MAX
# configs/acv_config.yaml's late_fusion_mobile (an epoch is 16 steps of 8)
ACV_MODEL, ACV_INPUT_SIZE = "late_fusion_mobile", 117
ACV_BATCH, ACV_EPOCHS, ACV_LR, ACV_WD = 8, 3, 1e-5, 1e-5
ACV_REQUEST, ACV_REQUESTS = 16, 8
# the same at lr 1e-5: `train_drift --pipeline audio_cues_video --lrs 1e-5
# --no-cpu --seeds 0 0 1 2 3 4 5 6 7` (PERF.md)
ACV_DRIFT_SEEDS_MAX = np.array([3.402e-7, 6.244e-6, 1.643e-5])
ACV_DRIFT_RTOL = 2 * ACV_DRIFT_SEEDS_MAX
# [frozen]: acv_config's recipe on early_fusion_mobile (audio ResNet18 and
# video MobileNetV2 frozen), 2 epochs, run three ways; the cached run's
# per-step losses against the frozen_bn_eval run's
FROZEN_MODEL, FROZEN_EPOCHS, FROZEN_RTOL = "early_fusion_mobile", 2, 1e-5
# bert_lite computes in bf16: its logits against float32 ones
BF16_LOGITS_TOL = 5e-2
# [zoo]: one training step of each model the slice ported, at full width
ZOO_AV = ("early_fusion_resnet", "early_fusion_mobilenet", "late_fusion_mobilenet", "early_fusion_fast",
          "late_fusion_fast", "middle_fusion_fast")
ZOO_AUDIO = ("resnet", "resnet_lstm", "vgg", "lstm_resnet", "lstm_resnet_attn", "lstm_resnet_trans", "conformer")
ZOO_CUES = ("dense_nn", "minilm_lstm", "minilm_lstm_attn", "multi_attn", "transformer", "minilm_cnn_lstm",
            "minilm_cnn_bilstm_attn", "lstm_multi_attn", "linear", "bert_lite")
ZOO_AC = ("early_fusion_mobile", "late_fusion_mobile", "early_fusion_resnet", "middle_fusion_resnet",
          "late_fusion_resnet", "test_model")
ZOO_CV = ("early_fusion_mobile", "middle_fusion_mobile", "late_fusion_mobile", "early_fusion_resnet",
          "late_fusion_resnet", "test_model")
ZOO_ACV = ("early_fusion_mobile", "middle_fusion_mobile", "early_fusion_resnet", "middle_fusion_resnet",
           "late_fusion_resnet", "test_model")
ZOO_AUDIO_BATCH, ZOO_VIDEO_BATCH, ZOO_CPU_ROWS, ZOO_ITERS = 32, 16, 4, 5
# [crop-kernel]: the device-crop train step's frames (B = 16 and 32 clips of
# 29 GLips frames); [crop-train]: resnet_trans on 64 in-memory full-frame
# clips (4 steps of 16 an epoch), its first steps held to plain-crop steps
# (the same crops bit for bit; cuDNN's float32 sums in either run's order)
CROP_FRAME, CROP_CLIPS = (256, 256), (16, 32)
CROP_TRAIN_CLIPS, CROP_EPOCHS, CROP_PARITY_STEPS, CROP_PARITY_RTOL = 64, 2, 3, 1e-5
CROP_BREAKDOWN_STEPS, CROP_REQUEST, CROP_REQUESTS = 3, 16, 4
# [crop-kernel]: the timed launches rotate over frame sets whose touched
# sectors (9.81 MB a set at 16 x 29 frames) exceed the 50 MB L2 together, as
# a step finds its frames freshly copied to the card; launches captured in
# one CUDA graph, and its replays
CROP_COLD_SETS, CROP_GRAPH_LAUNCHES, CROP_GRAPH_REPLAYS = 6, 96, 5
# [crop-kernel]: frames timed alone on the card (one for every 4 SMs)
CROP_ALONE = 33
# [crop-kernel]: other launches, timed beside the default one, cold, uint8
# (blocks a cluster, threads a block, the cap on a block's staging bytes)
CROP_LAUNCHES = ((1, 256, 20480), (2, 128, 16384), (2, 256, 20480), (4, 128, 17408), (8, 64, 16384))
# [stream-train]: the streaming model's first-step loss against the
# features-first model's (the log-mel kernel runs on the same clips in both)
STREAM_RTOL = 1e-4
# [graphs]: device-resident epochs of 10 full batches (2 groups of K=4 and a
# tail of 2), eager (K=1) against CUDA graphs; graphed per-step losses held
# to eager ones
GRAPH_K, GRAPH_BATCHES, GRAPH_RTOL = 4, 10, 1e-6
# [mp4]: the video pipeline on rendered .mp4 clips (4 words x 8 per split)
MP4_CLIPS_PER_SPLIT, MP4_TIMED_CLIPS = 8, 8
# [native-stream]: the native backend's per-step losses against grain's on
# the same clips in the same order (the int16 wire is exact for PCM16, so
# bit-equal is expected under cudnn.deterministic); DataLoader worker counts
NATIVE_RTOL, NATIVE_LOADER_WORKERS = 1e-6, (0, 4)
# [load-test]: client threads on one card and requests per thread
LOAD_THREADS, LOAD_AUDIO_REQUESTS, LOAD_CROP_REQUESTS = 4, 25, 10
# [export] / [serve-cold]: the same weights through another path
EXPORT_TOL = 1e-6


# " rank r/W backend" inside a spawned rank ([ddp], [tp], [pp])
RANK_TAG = ""


def log(phase: str, msg: str) -> None:
    print(f"[{phase}{RANK_TAG}] {msg}", flush=True)


def timed(phase: str, fn, *args):
    """``fn(*args)``, its wall time printed under ``phase``."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(phase, f"phase wall time {time.perf_counter() - t0:.2f} s")
    return out


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


def phase_build() -> dict:
    from multimodal_lipread_torch.ops import _build

    t0 = time.perf_counter()
    results = _build.build_all(_build.KERNELS)
    log("build", f"{len(results)} kernel(s) in {time.perf_counter() - t0:.2f} s with plain nvcc")
    for r in results.values():
        log("build", f"{r.name}: {r.seconds:.2f} s -> {os.path.relpath(r.path, REPO)}")
        for line in r.ptxas_lines():
            log("build", f"  {line}")
    return results


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


def flop_counter():
    """``torch.utils.flop_counter.FlopCounterMode`` with the weight gradient
    of a grouped convolution counted per group. Its own formula takes a
    grouped (depthwise) convolution's weight gradient as a full product over
    the channels, ``groups`` times too many: MobileNetV3-small's depthwise
    convolutions made 57.7 of the 61.0 GFLOP it counted for an audio_video
    step (7.8 GFLOP counted per group)."""
    import torch.utils.flop_counter as fc

    def conv_backward(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
                      output_padding, groups, output_mask, out_shape, **_):
        args = (grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed, output_padding, groups)
        total = fc.conv_backward_flop(*args, output_mask, out_val=out_shape)
        if groups == 1 or not output_mask[1]:
            return total
        weight = fc.conv_backward_flop(*args, [False, True, False], out_val=out_shape)
        return total - weight + weight // groups

    return fc.FlopCounterMode(display=False, custom_mapping={torch.ops.aten.convolution_backward: conv_backward})


def profiled(fn) -> tuple:
    """(events, wall s) of ``torch.profiler`` (CPU and CUDA) around ``fn``,
    the card synchronized at both ends."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.events(), wall


def device_activities(events) -> list:
    """The kernels, copies and memsets that the profiler recorded on the
    device (not the device-side spans of its annotations such as
    ``Optimizer.step``, which also cover the gaps between their kernels)."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_seconds(activities: list):
    """The union of the activities' spans, in seconds (None for none)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in activities)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) * 1e-6


def device_busy_s(fn) -> tuple:
    """(busy s, wall s, {name: device s}) of the card while ``fn`` runs:
    the union of its device activities, the profiled wall time (which the
    profiler's own host work lengthens), and the device time of each kernel
    or copy by name."""
    events, wall = profiled(fn)
    activities = device_activities(events)
    by_name: dict = {}
    for e in activities:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
    return busy_seconds(activities), wall, by_name


def idle_line(busy_s, prof_s, epoch_s) -> str:
    if busy_s is None:
        return "not measured: the profiler recorded no device activity"
    return (f"{100.0 * (1.0 - busy_s / epoch_s):.1f} % (device activity {busy_s * 1e3:.2f} ms in a profiled epoch, "
            f"torch.profiler, over the unprofiled epoch's {epoch_s * 1e3:.2f} ms; the profiled epoch took "
            f"{prof_s * 1e3:.2f} ms)")


def train_measures(trainer, train_ds, seed: int) -> dict:
    """The train step's time (CUDA events, mean of ``STEP_ITERS``), its
    FLOPs (``flop_counter``) and device activities (one profiled step), host
    batching + H2D per step (synchronized), one unprofiled epoch's time and
    the card's busy time over a profiled one."""
    from torch.profiler import ProfilerActivity, profile

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
    busy_s, prof_s, by_name = device_busy_s(lambda: trainer.train_epoch(train_ds, rng))
    with flop_counter() as counter:
        trainer.train_step(*batch)
    activities = None
    if by_name:  # the profiler sees the card
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.train_step(*batch)
            torch.cuda.synchronize()
        activities = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False))
    return {"step_ms": step_ms, "flops": counter.get_total_flops(), "activities": activities, "host_ms": host_ms,
            "steps": n, "epoch_s": epoch_s, "busy_s": busy_s, "prof_s": prof_s, "by_name": by_name}


def log_train_measures(phase: str, m: dict, batch: str, n_clips: int, what: str, smi: str) -> None:
    tflops = m["flops"] / m["step_ms"] / 1e9
    log(phase, f"train step (forward + backward + Adam) at {batch}, float32: {m['step_ms']:.3f} ms (CUDA events, "
               f"mean of {STEP_ITERS}); {m['flops'] / 1e9:.2f} GFLOP of convolutions and matrix products "
               f"(torch.utils.flop_counter, grouped weight gradients per group), {tflops:.3f} TFLOP/s, "
               f"{100 * tflops * 1e12 / PEAK_FP32_FLOPS:.1f} % of the fp32 peak; {m['activities']} device activities "
               f"(kernels, copies, memsets) in one profiled step | {smi}")
    total = sum(m["by_name"].values())
    top = sorted(m["by_name"].items(), key=lambda kv: -kv[1])[:8]
    log(phase, f"device time by kernel over a profiled epoch ({total * 1e3:.2f} ms summed): " + "; ".join(
        f"{name[:70]} {t * 1e3:.2f} ms ({100 * t / max(total, 1e-12):.1f} %)" for name, t in top))
    log(phase, f"training epoch ({n_clips} clips, {m['steps']} steps, no evaluation): {m['epoch_s'] * 1e3:.2f} ms, "
               f"{n_clips / m['epoch_s']:.1f} clips/s | host batching + H2D {m['host_ms']:.3f} ms per step "
               f"({what}: gather, pin, copy, synchronized) | {smi}")
    log(phase, "card idle over a training epoch: " + idle_line(m["busy_s"], m["prof_s"], m["epoch_s"]) + f" | {smi}")


def check_first_steps(phase: str, train_ds, tmp: str, seed: int, lr: float, drift_rtol: np.ndarray, **kw) -> None:
    """The card's first ``PARITY_STEPS`` float32 steps against the CPU's at
    ``PARITY_LR`` (``PARITY_RTOL``), and against float64 on the card at the
    trained ``lr`` within ``drift_rtol`` per step."""
    from multimodal_lipread_torch.tools.train_drift import first_steps

    card, cpu, exact = (np.asarray(first_steps(train_ds, device, dtype, PARITY_LR, PARITY_STEPS, seed,
                                               os.path.join(tmp, "parity"), **kw))
                        for device, dtype in ((DEVICE, torch.float32), ("cpu", torch.float32),
                                              (DEVICE, torch.float64)))
    rel = np.abs(card / cpu - 1.0)
    ok = bool(np.all(rel <= PARITY_RTOL))
    log(phase, f"first {PARITY_STEPS} steps at lr {PARITY_LR:g}, dropout 0, same init and batches, "
               f"float32: card {card.tolist()} cpu {cpu.tolist()} relative {rel.tolist()} "
               f"(tolerance {PARITY_RTOL:g}) {'ok' if ok else 'FAIL'}; against float64 on the card "
               f"(diagnostic): card {np.abs(card / exact - 1).tolist()} cpu {np.abs(cpu / exact - 1).tolist()}")
    if not ok:
        raise SystemExit(f"[{phase}] the card's training steps disagree with the CPU's")
    card, exact = (np.asarray(first_steps(train_ds, DEVICE, dtype, lr, PARITY_STEPS, seed,
                                          os.path.join(tmp, "drift"), **kw))
                   for dtype in (torch.float32, torch.float64))
    rel = np.abs(card / exact - 1.0)
    ok = bool(np.all(rel <= drift_rtol))
    log(phase, f"first {PARITY_STEPS} steps at the trained lr {lr:g}, dropout 0, same init and batches: "
               f"card float32 {card.tolist()} float64 on the card {exact.tolist()} relative {rel.tolist()} "
               f"(tolerance {drift_rtol.tolist()}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[{phase}] the card's float32 training steps at the trained lr stray from float64")


def check_logits(phase: str, name: str, logits: np.ndarray, ref: np.ndarray, ref_name: str,
                 tol: float = LOGITS_TOL) -> None:
    ok = logits.shape == ref.shape and bool(np.isfinite(logits).all())
    err = float(np.abs(logits - ref).max()) if ok else float("nan")
    ok = ok and np.allclose(logits, ref, rtol=tol, atol=tol)
    log(phase, f"{name} card logits vs the same weights on {ref_name}: max abs err {err:.3e} "
               f"(tolerance {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[{phase}] {name}: the card's logits disagree with {ref_name}")


def serve_requests(phase: str, pipeline: str, cfg, best: str, requests: list, batch: int, what: str, smi: str,
                   api_requests: int = None, kernel: bool = False) -> tuple:
    """Requests of per-clip file groups, first through ``serving.predict_clips``
    (model build, checkpoint load, featurization and forward per call; the
    first ``api_requests`` of them, every one by default), then to a resident
    ``Predictor`` on ``serving._featurize_modalities``, each after one
    warm-up request: the calls' times, and the resident requests' time and
    clips/s. With ``kernel`` every request must launch the log-mel kernel.
    Returns each path's logits beside the number of clips it was given, the
    resident predictor and the kernel's launches after the first warm-up."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.ops import logmel_cuda

    def launched(before: int, name: str) -> None:
        if kernel and logmel_cuda.launch_count <= before:
            raise SystemExit(f"[{phase}] {name} did not launch the log-mel kernel")

    serving.predict_clips(cfg, best, pipeline, requests[0], batch, device=DEVICE)  # warm-up
    logmel_cuda.launch_count = 0
    through_api = []
    for i, req in enumerate(requests[:api_requests]):
        before, t0 = logmel_cuda.launch_count, time.perf_counter()
        res = serving.predict_clips(cfg, best, pipeline, req, batch, device=DEVICE)
        dt = time.perf_counter() - t0
        launched(before, f"predict_clips request {i}")
        through_api += [r["logits"] for r in res]
        if i < 2:
            log(phase, f"predict_clips(pipeline={pipeline!r}) request {i}: {len(req)} clips, {dt * 1e3:.2f} ms incl. "
                       f"model build + checkpoint load + {what} | {smi}")
    predictor = serving.Predictor.from_checkpoint(serving.build_model(pipeline, cfg), best, batch, device=DEVICE)

    def resident_request(req):
        return predictor.predict_logits(*serving._featurize_modalities(pipeline, cfg, req, device=DEVICE))

    resident_request(requests[0])  # warm-up
    resident, total_s = [], 0.0
    for i, req in enumerate(requests):
        before, t0 = logmel_cuda.launch_count, time.perf_counter()
        resident.append(resident_request(req))
        total_s += time.perf_counter() - t0
        launched(before, f"resident request {i}")
    n = sum(len(r) for r in requests)
    log(phase, f"resident Predictor: {n} clips in {len(requests)} requests of {batch}, {total_s * 1e3:.2f} ms, "
               f"{total_s / len(requests) * 1e3:.3f} ms per request, {n / total_s:.1f} clips/s ({what} + H2D + "
               f"forward + D2H)" + (f"; log-mel kernel launches while serving: {logmel_cuda.launch_count}"
                                    if kernel else "") + f" | {smi}")
    served = {"predict_clips": (np.asarray(through_api), sum(len(r) for r in requests[:api_requests])),
              "resident": (np.concatenate(resident), n)}
    return served, predictor, logmel_cuda.launch_count


def log_breakdown(phase: str, stages: dict, clips: int, smi: str) -> None:
    log(phase, f"one request of {clips} clips, mean of {BREAKDOWN_ITERS}: " + ", ".join(
        f"{k} {v:.3f}" + ("" if k.endswith("%") else " ms") for k, v in stages.items()) + f" | {smi}")


def check_served(phase: str, served: dict, refs: dict) -> None:
    """Every served logits array, which must hold one row per clip its path
    was given, against the same clips' rows of every reference (``refs``
    holds "the CPU"), once the CPU's logits are shown to depend on the input."""
    cpu = refs["the CPU"]
    spread = float(np.ptp(cpu, axis=0).max())
    log(phase, f"CPU logits: scale {float(np.abs(cpu).max()):.3f}, largest spread across clips {spread:.3f}")
    if not spread >= 10 * LOGITS_TOL:
        raise SystemExit(f"[{phase}] the logits barely depend on the input: the comparisons could not fail")
    for name, (logits, clips) in served.items():
        if len(logits) != clips:
            raise SystemExit(f"[{phase}] {name} answered {len(logits)} of the {clips} clips it was given")
        for ref_name, ref in refs.items():
            check_logits(phase, name, logits, ref[:clips], ref_name)


def check_served_accuracy(phase: str, logits: np.ndarray, labels: np.ndarray, final_test_acc: float) -> None:
    accuracy = 100.0 * float((logits.argmax(-1) == labels).mean())
    log(phase, f"served accuracy on the {len(labels)} test clips {accuracy:.2f}% (final test {final_test_acc:.2f}%)")
    if abs(accuracy - final_test_acc) > 100.0 / len(labels) + 1e-9:
        raise SystemExit(f"[{phase}] the served checkpoint's accuracy differs from the final test's")


def log_epochs(phase: str, hist: list, smi: str) -> None:
    for h in hist:
        test = f" test {h['test_loss']:.4f}/{h['test_acc']:.2f}%" if "test_loss" in h else ""
        log(phase, f"epoch {h['epoch']}: train {h['train_loss']:.4f}/{h['train_acc']:.2f}% "
                   f"val {h['val_loss']:.4f}/{h['val_acc']:.2f}%{test} lr {h['lr']:.2e}, {h['seconds']:.3f} s, "
                   f"{h['clips_per_sec']:.1f} clips/s (train + val{' + test' if test else ''}) | {smi}")


def check_history(phase: str, result: dict, epochs: int) -> str:
    """Every epoch's losses finite, the train loss lower in the last epoch
    than in the first, a best checkpoint and a final test on it; returns
    the best checkpoint."""
    hist = result["history"]
    losses = [h[k] for h in hist for k in ("train_loss", "val_loss", "test_loss")]
    if len(hist) != epochs or not np.isfinite(losses).all():
        raise SystemExit(f"[{phase}] training gave {len(hist)} epochs, losses {losses}")
    if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
        raise SystemExit(f"[{phase}] the train loss did not fall from epoch 1 to the last epoch")
    best = result.get("best_checkpoint")
    if not best or not os.path.isfile(best) or not np.isfinite(result.get("final_test_loss", np.nan)):
        raise SystemExit(f"[{phase}] no best checkpoint, or no final test on it")
    log(phase, f"final test on the reloaded best checkpoint (best val acc {result['best_val_acc']:.2f}%): "
               f"loss {result['final_test_loss']:.4f}, acc {result['final_test_acc']:.2f}%")
    return best


def timing_trainer(model: torch.nn.Module, name: str, batch: int, lr: float, wd: float, tmp: str, seed: int):
    """An initialized one-epoch trainer on the card for the step and epoch
    measures."""
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(model, TrainerConfig(
        model_name=name, num_classes=len(WORDS), batch_size=batch, epochs=1, learning_rate=lr, weight_decay=wd,
        seed=seed, host_prefetch=0, metrics_dir=os.path.join(tmp, "timing", name, "metrics"),
        checkpoints_dir=os.path.join(tmp, "timing", name, "ckpt")), device=DEVICE)
    trainer.init_state()
    return trainer


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
        log_train_measures("train", train_measures(trainer, train_ds, seed), f"B={TRAIN_BATCH}", len(train_ds),
                           "mels", smi)
        batch = next(trainer.batches(train_ds, True, np.random.default_rng(seed)))

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
        check_first_steps("train", train_ds, tmp, seed, TRAIN_LR, DRIFT_RTOL, batch_size=TRAIN_BATCH,
                          version=VGG_VERSION)
        return {"launches": launches, "max_abs_err": max_err, "row256": row256}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def video_config(root: str, base: str, seed: int, epochs: int = VIDEO_EPOCHS) -> "Config":
    """configs/visual_config.yaml's model and recipe on ``root``."""
    from multimodal_lipread_torch.config import Config

    return Config.from_dict({
        "dataset": {"root_dir": root, "num_classes": len(WORDS)},
        "model": {"name": "resnet_trans", "resnet_version": 18, "shufflenet_version": "0.5x",
                  "feature_dim": None, "dropout": None, "dtype": "float32"},
        "training": {"batch_size": VIDEO_BATCH, "epochs": epochs, "learning_rate": VIDEO_LR,
                     "weight_decay": VIDEO_WD, "seed": seed},
        "output": {"base_dir": base, "plots": False},
    })


def phase_video_train(seed: int, device_info: dict, tmp: str) -> dict:
    from multimodal_lipread_torch.data.glips import lip_regions_root
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.models.video import get_video_model
    from multimodal_lipread_torch.pipelines import video as video_pipeline
    from multimodal_lipread_torch.pipelines.common import load_video_datasets
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    smi = device_info["smi"]
    root = make_synthetic_glips(os.path.join(tmp, "GLips_4"), words=WORDS, clips_per_split=VIDEO_CLIPS_PER_SPLIT,
                                seed=seed, with_audio=False, with_lip_regions=True)
    lip_root = lip_regions_root(root)
    load_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        datasets, index = load_video_datasets(lip_root)
        load_s.append(time.perf_counter() - t0)
    lips = datasets["train"].inputs[0]
    log("video-train", f"synthetic lip corpus from --seed: {len(index.entries)} .npy files, "
                       f"{len(datasets['train'])} per split, {len(index.classes)} words, {lips.shape} {lips.dtype}; "
                       f"np.load of the corpus, median of 3: {np.median(load_s) * 1e3:.2f} ms "
                       f"({sum(d.inputs[0].nbytes for d in datasets.values()) / 2**20:.1f} MiB) | "
                       f"host CPU ({os.cpu_count()} cores)")

    cfg = video_config(root, os.path.join(tmp, "run"), seed)
    t0 = time.perf_counter()
    result = video_pipeline.main(cfg, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log("video-train", f"pipelines.video.main: resnet_trans (ResNet18, d 256, 2 layers x 4 heads, FF 1024), "
                       f"float32, batch {VIDEO_BATCH}, {VIDEO_EPOCHS} epochs in {wall:.2f} s (load, model build, "
                       f"training, evaluation, checkpoints)")
    hist = result["history"]
    for h in hist:
        log("video-train", f"epoch {h['epoch']}: train {h['train_loss']:.4f}/{h['train_acc']:.2f}% "
                           f"val {h['val_loss']:.4f}/{h['val_acc']:.2f}% test {h['test_loss']:.4f}/"
                           f"{h['test_acc']:.2f}% lr {h['lr']:.2e}, {h['seconds']:.3f} s, "
                           f"{h['clips_per_sec']:.1f} clips/s (train + val + test) | {smi}")
    losses = [h[k] for h in hist for k in ("train_loss", "val_loss", "test_loss")]
    if len(hist) != VIDEO_EPOCHS or not np.isfinite(losses).all():
        raise SystemExit(f"video training gave {len(hist)} epochs, losses {losses}")
    if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
        raise SystemExit("the video train loss did not fall from epoch 1 to the last epoch")
    best = result.get("best_checkpoint")
    results_txt = os.path.join(tmp, "run", "models_trained", "test_results.txt")
    if not best or not os.path.isfile(best) or not os.path.isfile(results_txt):
        raise SystemExit("no best checkpoint or no test_results.txt")
    log("video-train", f"final test on the reloaded best checkpoint (best val acc {result['best_val_acc']:.2f}%): "
                       f"loss {result['final_test_loss']:.4f}, acc {result['final_test_acc']:.2f}%")

    train_ds = datasets["train"]
    trainer = Trainer(get_video_model("resnet_trans", len(WORDS)), TrainerConfig(
        model_name="resnet_trans", num_classes=len(WORDS), batch_size=VIDEO_BATCH, epochs=1, learning_rate=VIDEO_LR,
        weight_decay=VIDEO_WD, seed=seed, host_prefetch=0, scheduler_mode="max",
        metrics_dir=os.path.join(tmp, "timing", "metrics"), checkpoints_dir=os.path.join(tmp, "timing", "ckpt")),
        device=DEVICE)
    trainer.init_state()
    log_train_measures("video-train", train_measures(trainer, train_ds, seed),
                       f"B={VIDEO_BATCH} ({VIDEO_BATCH * lips.shape[1]} frames)", len(train_ds), "uint8 lips", smi)
    del trainer
    check_first_steps("video-train", train_ds, tmp, seed, VIDEO_LR, VIDEO_DRIFT_RTOL, batch_size=VIDEO_BATCH,
                      pipeline="video", model_name="resnet_trans")
    return {"cfg": cfg, "best": best, "index": index, "final_test_acc": result["final_test_acc"]}


def video_request_breakdown(net: torch.nn.Module, paths: list) -> dict:
    """Milliseconds of each stage of one video request: the ``.npy`` load
    (host clock), then on the card's timeline (CUDA events) the uint8 copy
    to the card, the forward (scaling to [0, 1] included) and the copy of
    the logits back; ``device idle`` is the share of the wall time outside
    those."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.utils.precision import model_precision

    names = ("npy load", "uint8 H2D", "forward", "D2H")
    totals = np.zeros(len(names) + 1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode(), model_precision(torch.float32):
        for _ in range(BREAKDOWN_ITERS):
            t0 = time.perf_counter()
            lips = serving.load_lips(paths)
            t_load = time.perf_counter() - t0
            ev[0].record()
            x = torch.from_numpy(lips).to(DEVICE)
            ev[1].record()
            logits = net(x.to(torch.float32) / 255.0)
            ev[2].record()
            logits.cpu()
            ev[3].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            device = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
            totals += [t_load * 1e3, *device, 100.0 * (1.0 - sum(device) / (wall * 1e3))]
    out = dict(zip(names, totals[:-1] / BREAKDOWN_ITERS))
    return {**out, "device idle %": totals[-1] / BREAKDOWN_ITERS}


def phase_video_serve(video: dict, device_info: dict) -> None:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.pipelines.common import load_lip_sequences

    smi, cfg, best, index = device_info["smi"], video["cfg"], video["best"], video["index"]
    test = index.by_split("test")
    groups = [[e.path] for e in test]
    requests = [groups[i : i + VIDEO_BATCH] for i in range(0, len(groups), VIDEO_BATCH)]
    served, predictor, _ = serve_requests("video-serve", "video", cfg, best, requests, VIDEO_BATCH,
                                                         ".npy load", smi)
    log_breakdown("video-serve", video_request_breakdown(predictor.model, [g[0] for g in requests[0]]),
                  len(requests[0]), smi)
    check_served_accuracy("video-serve", served["resident"][0],
                          np.asarray([index.class_to_idx[e.word] for e in test]), video["final_test_acc"])
    cpu = serving.Predictor.from_checkpoint(serving.build_model("video", cfg), best, VIDEO_BATCH, device="cpu")
    ref = cpu.predict_logits(load_lip_sequences([g[0] for g in groups]))
    check_served("video-serve", served, {"the CPU": ref})


def av_config(root: str, base: str, seed: int, **model) -> "Config":
    """configs/av_config.yaml's model and recipe on ``root``."""
    from multimodal_lipread_torch.config import Config

    return Config.from_dict({
        "dataset": {"root_dir": root, "num_classes": len(WORDS), "audio_input_size": AV_INPUT_SIZE},
        "model": {"name": AV_MODEL, "dtype": "float32", **model},
        "training": {"batch_size": AV_BATCH, "epochs": AV_EPOCHS, "learning_rate": AV_LR, "seed": seed},
        "output": {"base_dir": base, "plots": False},
    })


def phase_av_train(seed: int, device_info: dict, tmp: str) -> dict:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.glips import align_modalities, lip_regions_root, scan_glips, scan_lip_regions
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.models.audio_video import get_av_model
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.ops.logmel import log_mel_reference
    from multimodal_lipread_torch.pipelines import audio_video as av_pipeline
    from multimodal_lipread_torch.pipelines.common import decode_waveforms

    smi = device_info["smi"]
    tmp = os.path.join(tmp, "av")  # apart from the video phases' corpus and runs
    root = make_synthetic_glips(os.path.join(tmp, "GLips_4"), words=WORDS, clips_per_split=AV_CLIPS_PER_SPLIT,
                                seed=seed, with_lip_regions=True)
    lip_root = lip_regions_root(root)
    logmel_cuda.launch_count = 0
    t0 = time.perf_counter()
    datasets, classes = av_pipeline.load_av_datasets(root, lip_root, input_size=AV_INPUT_SIZE, device=DEVICE)
    load_s = time.perf_counter() - t0
    featurize_launches = logmel_cuda.launch_count
    mels, lips = datasets["train"].inputs
    log("av-train", f"synthetic corpus from --seed: {sum(len(d) for d in datasets.values())} aligned wav + .npy "
                    f"clips, {len(datasets['train'])} per split, {len(classes)} words; mels {mels.shape} "
                    f"{mels.dtype}, lips {lips.shape} {lips.dtype}; load_av_datasets (decode, log-mel on the card, "
                    f"np.load) {load_s * 1e3:.2f} ms with {featurize_launches} log-mel kernel launches")
    if featurize_launches < 1:
        raise SystemExit("the AV featurization never launched the log-mel kernel")
    # the kernel's features against the plain version's on the same waves
    pairs = align_modalities(scan_glips(root), scan_lip_regions(lip_root), split="train")
    wave = torch.from_numpy(decode_waveforms([a.path for a, _v in pairs])).to(DEVICE)
    want = log_mel_reference(wave, True)[:, :80, :AV_INPUT_SIZE].cpu().numpy()
    max_err = float(np.abs(mels - want).max())
    ok = mels.shape == want.shape and bool(np.isfinite(mels).all()) and max_err <= KERNEL_TOL
    log("av-train", f"featurized mels vs plain-version features: max abs err {max_err:.3e} "
                    f"(tolerance {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the AV featurization disagrees with the plain log-mel")

    cfg = av_config(root, os.path.join(tmp, "run"), seed)
    logmel_cuda.launch_count = 0
    t0 = time.perf_counter()
    result = av_pipeline.main(cfg, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = logmel_cuda.launch_count
    n_params = sum(p.numel() for p in get_av_model(AV_MODEL, len(WORDS)).parameters())
    log("av-train", f"pipelines.audio_video.main: {AV_MODEL} (log-mel 80 x {AV_INPUT_SIZE}, MobileNetV3-small "
                    f"over 29 frames, BiLSTM 256, fc1 37632 -> 512; {n_params} parameters), float32, batch "
                    f"{AV_BATCH}, lr {AV_LR:g}, {AV_EPOCHS} epochs in {wall:.2f} s (featurization, model build, "
                    f"training, evaluation, checkpoints); log-mel kernel launches: {launches}")
    if launches < 1:
        raise SystemExit("AV training never launched the log-mel kernel")
    log_epochs("av-train", result["history"], smi)
    best = check_history("av-train", result, AV_EPOCHS)
    test = datasets["test"]
    predictor = serving.Predictor.from_checkpoint(serving.build_model("audio_video", cfg), best, AV_BATCH,
                                                  device=DEVICE)
    check_served_accuracy("av-train", predictor.predict_logits(*test.inputs), test.labels, result["final_test_acc"])

    train_ds = datasets["train"]
    trainer = timing_trainer(get_av_model(AV_MODEL, len(WORDS)), AV_MODEL, AV_BATCH, AV_LR, 0.0, tmp, seed)
    log_train_measures("av-train", train_measures(trainer, train_ds, seed),
                       f"B={AV_BATCH} ({AV_BATCH * lips.shape[1]} frames)", len(train_ds), "mels + uint8 lips", smi)
    del trainer
    check_first_steps("av-train", train_ds, tmp, seed, AV_LR, AV_DRIFT_RTOL, batch_size=AV_BATCH,
                      pipeline="audio_video", model_name=AV_MODEL)
    return {"cfg": cfg, "best": best, "root": root, "lip_root": lip_root, "datasets": datasets,
            "final_test_acc": result["final_test_acc"], "launches": featurize_launches + launches,
            "max_abs_err": max_err}


def av_request_breakdown(net: torch.nn.Module, group: list) -> dict:
    """Milliseconds of each stage of one audio_video request: WAV decode and
    ``.npy`` load (host clock), then on the card's timeline (CUDA events)
    the copies to the card (waves and uint8 lips), the log-mel kernel, the
    forward (the lips scaled to [0, 1] included) and the copy of the logits
    back; ``device idle`` is the share of the wall time outside those."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.pipelines.common import decode_waveforms
    from multimodal_lipread_torch.utils.precision import model_precision

    names = ("WAV decode", "npy load", "H2D", "log-mel", "forward", "D2H")
    totals = np.zeros(len(names) + 1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode(), model_precision(torch.float32):
        for _ in range(BREAKDOWN_ITERS):
            t0 = time.perf_counter()
            waves = decode_waveforms([g[0] for g in group])
            t1 = time.perf_counter()
            lips = serving.load_lips([g[1] for g in group])
            t2 = time.perf_counter()
            ev[0].record()
            wave, x = torch.from_numpy(waves).to(DEVICE), torch.from_numpy(lips).to(DEVICE)
            ev[1].record()
            mel = logmel_cuda.log_mel(wave, True)[:, :80, :AV_INPUT_SIZE]
            ev[2].record()
            logits = net(mel, x.to(torch.float32) / 255.0)
            ev[3].record()
            logits.cpu()
            ev[4].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            device = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
            totals += [(t1 - t0) * 1e3, (t2 - t1) * 1e3, *device, 100.0 * (1.0 - sum(device) / (wall * 1e3))]
    out = dict(zip(names, totals[:-1] / BREAKDOWN_ITERS))
    return {**out, "device idle %": totals[-1] / BREAKDOWN_ITERS}


def phase_av_serve(av: dict, device_info: dict) -> int:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.glips import align_modalities, scan_glips, scan_lip_regions
    from multimodal_lipread_torch.ops.logmel import log_mel_reference
    from multimodal_lipread_torch.pipelines.common import decode_waveforms, load_lip_sequences
    from multimodal_lipread_torch.utils.precision import model_precision

    smi, cfg, best = device_info["smi"], av["cfg"], av["best"]
    pairs = align_modalities(scan_glips(av["root"]), scan_lip_regions(av["lip_root"]), split="test")
    groups = [[a.path, v.path] for a, v in pairs]
    requests = [groups[i : i + AV_REQUEST] for i in range(0, len(groups), AV_REQUEST)]
    served, predictor, launches = serve_requests(
        "av-serve", "audio_video", cfg, best, requests, AV_REQUEST, "WAV decode + log-mel kernel + .npy load", smi,
        kernel=True)
    log_breakdown("av-serve", av_request_breakdown(predictor.model, requests[0]), len(requests[0]), smi)
    check_served_accuracy("av-serve", served["resident"][0], av["datasets"]["test"].labels, av["final_test_acc"])

    # the same weights on plain-version features on the card, and on the CPU
    waves = torch.from_numpy(decode_waveforms([g[0] for g in groups])).to(DEVICE)
    lips = load_lip_sequences([g[1] for g in groups])
    plain = log_mel_reference(waves, True)[:, :80, :AV_INPUT_SIZE].cpu().numpy()
    cpu = serving.Predictor.from_checkpoint(serving.build_model("audio_video", cfg), best, AV_REQUEST, device="cpu")
    with model_precision(torch.float32):
        ref_cpu = cpu.predict_logits(plain, lips)
    check_served("av-serve", served,
                 {"plain-version features on the card": predictor.predict_logits(plain, lips), "the CPU": ref_cpu})
    return launches


def cues_config(root: str, base: str, seed: int) -> "Config":
    """configs/cues_config.yaml on ``root`` with the ``CUES_SET`` overrides
    (this script reads no YAML, tests/test_torch_port_hygiene.py, so the
    file's keys are spelt out)."""
    from multimodal_lipread_torch.config import Config

    cfg = Config.from_dict({
        "dataset": {"root_dir": root, "cue_root": root, "cue_mode": "emotion",
                    "cache_dir": os.path.join(base, "cache"), "use_file_splits": False},
        "model": {"name": "multi_attn"},
        "training": {"batch_size": CUES_BATCH, "learning_rate": 0.001, "epochs": 30, "seed": seed,
                     "split_seed": 42, "val_fraction": 0.1},
        "output": {"base_dir": base, "plots": False},
    })
    for key, value in CUES_SET.items():
        cfg.set(key, value)
    return cfg


def phase_cues_train(seed: int, device_info: dict, tmp: str) -> dict:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.models.cues import get_cue_model
    from multimodal_lipread_torch.pipelines import cues as cues_pipeline
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    smi = device_info["smi"]
    tmp = os.path.join(tmp, "cues")
    root = make_synthetic_glips(os.path.join(tmp, "GLips_4"), words=WORDS, clips_per_split=CUES_CLIPS_PER_SPLIT,
                                seed=seed, with_cues=True)
    cfg = cues_config(root, os.path.join(tmp, "run"), seed)
    t0 = time.perf_counter()
    datasets, classes = cues_pipeline.load_cue_classification_data(
        root, "emotion", "bert_tok", val_fraction=0.1, seed=cfg.get("training.split_seed"), bert_size="base")
    load_s = time.perf_counter() - t0
    ids = datasets["train"].inputs[0]
    log("cues-train", f"synthetic cue corpus from --seed: {len(datasets['train'])} train + {len(datasets['val'])} val "
                      f"emotion records, {len(classes)} words; token ids {ids.shape} {ids.dtype}, "
                      f"{float((ids != 0).sum(1).mean()):.1f} of {ids.shape[1]} not padding on average; read + "
                      f"tokenize {load_s * 1e3:.2f} ms | host CPU ({os.cpu_count()} cores)")
    t0 = time.perf_counter()
    result = cues_pipeline.main(cfg, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_params = sum(p.numel() for p in get_cue_model("bert", len(WORDS), bert_size=CUES_SET["model.bert_size"]).parameters())
    epochs = CUES_SET["training.epochs"]
    log("cues-train", f"pipelines.cues.main: bert at bert-base width (12 layers, hidden 768, 12 heads, FFN 3072; "
                      f"{n_params} parameters), float32, batch {CUES_BATCH}, lr {CUES_SET['training.learning_rate']:g} "
                      f"linear_warmup, {epochs} epochs in {wall:.2f} s (tokenize, model build, training, "
                      f"evaluation, checkpoints)")
    hist = result["history"]
    log_epochs("cues-train", hist, smi)
    losses = [h[k] for h in hist for k in ("train_loss", "val_loss")]
    if len(hist) != epochs or not np.isfinite(losses).all() or "test_loss" in hist[0]:
        raise SystemExit(f"cue training gave {len(hist)} epochs, losses {losses}")
    if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
        raise SystemExit("the cue train loss did not fall from epoch 1 to the last epoch")
    best = result.get("best_checkpoint") or os.path.join(tmp, "run", "models_trained", "bert_best.pt")
    if not os.path.isfile(best):
        raise SystemExit("no cue best checkpoint")
    val = datasets["val"]
    predictor = serving.Predictor.from_checkpoint(serving.build_model("cues", cfg), best, CUES_REQUEST, device=DEVICE)
    served_acc = 100.0 * float((predictor.predict(*val.inputs) == val.labels).mean())
    log("cues-train", f"the best checkpoint ({os.path.getsize(best) / 2**20:.1f} MiB with Adam's moments) reloaded "
                      f"into a Predictor: val accuracy {served_acc:.2f}% (best val {result['best_val_acc']:.2f}%)")
    if abs(served_acc - result["best_val_acc"]) > 100.0 / len(val) + 1e-9:
        raise SystemExit("the served cue checkpoint's accuracy differs from the best val accuracy")
    del predictor

    train_ds = datasets["train"]
    trainer = Trainer(get_cue_model("bert", len(WORDS), bert_size="base"), TrainerConfig(
        model_name="bert", num_classes=len(WORDS), batch_size=CUES_BATCH, epochs=1,
        learning_rate=CUES_SET["training.learning_rate"], weight_decay=0.0, seed=seed, host_prefetch=0,
        metrics_dir=os.path.join(tmp, "timing", "metrics"), checkpoints_dir=os.path.join(tmp, "timing", "ckpt")),
        device=DEVICE)
    trainer.init_state()
    log_train_measures("cues-train", train_measures(trainer, train_ds, seed), f"B={CUES_BATCH} x 32 tokens",
                       len(train_ds), "int32 token ids", smi)
    del trainer
    check_first_steps("cues-train", train_ds, tmp, seed, CUES_SET["training.learning_rate"], CUES_DRIFT_RTOL,
                      batch_size=CUES_BATCH, pipeline="cues", model_name="bert")
    torch.cuda.empty_cache()
    return {"cfg": cfg, "best": best, "root": root, "tmp": tmp, "datasets": datasets}


def cues_request_breakdown(net: torch.nn.Module, paths: list) -> dict:
    """Milliseconds of each stage of one cues request: reading the text
    files and tokenizing them (host clock), then on the card's timeline
    (CUDA events) the copy of the int32 ids, the forward and the copy of
    the logits back; ``device idle`` is the share of the wall time outside
    those."""
    from multimodal_lipread_torch.models.bert import HashingTokenizer
    from multimodal_lipread_torch.utils.precision import model_precision

    names = ("read + tokenize", "H2D", "forward", "D2H")
    totals = np.zeros(len(names) + 1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    tokenizer = HashingTokenizer()
    with torch.inference_mode(), model_precision(torch.float32):
        for _ in range(BREAKDOWN_ITERS):
            t0 = time.perf_counter()
            texts = []
            for p in paths:
                with open(p, encoding="utf-8") as f:
                    texts.append(f.read().strip())
            ids = tokenizer(texts)
            t_host = time.perf_counter() - t0
            ev[0].record()
            x = torch.from_numpy(ids).to(DEVICE)
            ev[1].record()
            logits = net(x)
            ev[2].record()
            logits.cpu()
            ev[3].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            device = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
            totals += [t_host * 1e3, *device, 100.0 * (1.0 - sum(device) / (wall * 1e3))]
    out = dict(zip(names, totals[:-1] / BREAKDOWN_ITERS))
    return {**out, "device idle %": totals[-1] / BREAKDOWN_ITERS}


def write_cue_texts(folder: str, descriptions: list) -> list:
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, text in enumerate(descriptions):
        path = os.path.join(folder, f"cue_{i:04d}.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        paths.append(path)
    return paths


def phase_cues_serve(cues: dict, device_info: dict) -> None:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.cues import load_cue_records

    smi, cfg, best = device_info["smi"], cues["cfg"], cues["best"]
    records = load_cue_records(cues["root"], "emotion")[: CUES_REQUEST * CUES_REQUESTS]
    groups = [[p] for p in write_cue_texts(os.path.join(cues["tmp"], "requests"), [r.description for r in records])]
    requests = [groups[i : i + CUES_REQUEST] for i in range(0, len(groups), CUES_REQUEST)]
    # predict_clips builds bert-base and reads its 1.25 GB checkpoint per call: two calls
    served, predictor, _ = serve_requests("cues-serve", "cues", cfg, best, requests, CUES_REQUEST,
                                          "read + tokenize", smi, api_requests=2)
    log_breakdown("cues-serve", cues_request_breakdown(predictor.model, [g[0] for g in requests[0]]),
                  len(requests[0]), smi)
    labels = np.asarray([WORDS.index(r.word) for r in records])
    log("cues-serve", f"served accuracy on the {len(groups)} records (train and val) "
                      f"{100.0 * float((served['resident'][0].argmax(-1) == labels).mean()):.2f}%")
    ids = serving._featurize_modalities("cues", cfg, groups, device="cpu")[0]
    cpu = serving.Predictor.from_checkpoint(serving.build_model("cues", cfg), best, CUES_REQUEST, device="cpu")
    check_served("cues-serve", served,
                 {"the CPU": cpu.predict_logits(ids)})


def ac_config(root: str, base: str, seed: int) -> "Config":
    """configs/ac_config.yaml's model and recipe on ``root``."""
    from multimodal_lipread_torch.config import Config

    return Config.from_dict({
        "dataset": {"root_dir": root, "cue_root": root, "input_size": AC_INPUT_SIZE, "cue_mode": "emotion",
                    "embed_model": "mpnet", "cache_dir": os.path.join(base, "cache"), "num_classes": len(WORDS)},
        "model": {"name": AC_MODEL, "dtype": "float32"},
        "train": {"batch": AC_BATCH, "lr": AC_LR, "epochs": AC_EPOCHS, "seed": seed},
        "output": {"base_dir": base, "plots": False},
    })


def phase_ac_train(seed: int, device_info: dict, tmp: str) -> dict:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.cues import load_cue_records, records_by_key
    from multimodal_lipread_torch.data.glips import scan_glips
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.models.audio_cues import get_audio_cues_model
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.ops.logmel import log_mel_reference
    from multimodal_lipread_torch.pipelines import audio_cues as ac_pipeline
    from multimodal_lipread_torch.pipelines.common import decode_waveforms

    smi = device_info["smi"]
    tmp = os.path.join(tmp, "ac")
    root = make_synthetic_glips(os.path.join(tmp, "GLips_4"), words=WORDS, clips_per_split=AC_CLIPS_PER_SPLIT,
                                seed=seed, with_cues=True)
    logmel_cuda.launch_count = 0
    t0 = time.perf_counter()
    datasets, classes = ac_pipeline.load_audio_cue_datasets(root, root, input_size=AC_INPUT_SIZE, device=DEVICE)
    load_s = time.perf_counter() - t0
    featurize_launches = logmel_cuda.launch_count
    mels, cue_emb = datasets["train"].inputs
    log("ac-train", f"synthetic corpus from --seed: {sum(len(d) for d in datasets.values())} aligned wav + cue "
                    f"clips, {len(datasets['train'])} per split, {len(classes)} words; mels {mels.shape} {mels.dtype}, "
                    f"cue embeddings {cue_emb.shape} {cue_emb.dtype}; load_audio_cue_datasets (decode, log-mel on "
                    f"the card, read + hashing mpnet embedding) {load_s * 1e3:.2f} ms with {featurize_launches} "
                    f"log-mel kernel launches")
    if featurize_launches < 1:
        raise SystemExit("the audio_cues featurization never launched the log-mel kernel")
    cue_map = records_by_key(load_cue_records(root, "emotion"))
    entries = [e for e in scan_glips(root).by_split("train") if e.key in cue_map]
    wave = torch.from_numpy(decode_waveforms([e.path for e in entries])).to(DEVICE)
    want = log_mel_reference(wave, True)[:, :80, :AC_INPUT_SIZE].cpu().numpy()
    max_err = float(np.abs(mels - want).max())
    ok = mels.shape == want.shape and bool(np.isfinite(mels).all()) and max_err <= KERNEL_TOL
    log("ac-train", f"featurized mels vs plain-version features: max abs err {max_err:.3e} "
                    f"(tolerance {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the audio_cues featurization disagrees with the plain log-mel")

    cfg = ac_config(root, os.path.join(tmp, "run"), seed)
    logmel_cuda.launch_count = 0
    t0 = time.perf_counter()
    result = ac_pipeline.main(cfg, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = logmel_cuda.launch_count
    n_params = sum(p.numel() for p in get_audio_cues_model(AC_MODEL, len(WORDS)).parameters())
    log("ac-train", f"pipelines.audio_cues.main: {AC_MODEL} (MobileNetV2 over the 1 x 80 x {AC_INPUT_SIZE} log-mel, "
                    f"cue Linear 768 -> 128, 4-head self-attention over 1408, 256; {n_params} parameters), float32, "
                    f"batch {AC_BATCH}, lr {AC_LR:g} with a 2-epoch warmup, {AC_EPOCHS} epochs in {wall:.2f} s "
                    f"(featurization, model build, training, evaluation, checkpoints); log-mel kernel launches: "
                    f"{launches}")
    if launches < 1:
        raise SystemExit("audio_cues training never launched the log-mel kernel")
    log_epochs("ac-train", result["history"], smi)
    best = check_history("ac-train", result, AC_EPOCHS)
    test = datasets["test"]
    predictor = serving.Predictor.from_checkpoint(serving.build_model("audio_cues", cfg), best, AC_BATCH,
                                                  device=DEVICE)
    check_served_accuracy("ac-train", predictor.predict_logits(*test.inputs), test.labels, result["final_test_acc"])
    check_reestimated_bn("ac-train", serving.build_model("audio_cues", cfg),
                         os.path.join(os.path.dirname(best), f"{AC_MODEL}_checkpoint.pt"), datasets)

    train_ds = datasets["train"]
    trainer = timing_trainer(get_audio_cues_model(AC_MODEL, len(WORDS)), AC_MODEL, AC_BATCH, AC_LR, 0.0, tmp, seed)
    log_train_measures("ac-train", train_measures(trainer, train_ds, seed), f"B={AC_BATCH}", len(train_ds),
                       "mels + cue embeddings", smi)
    check_first_steps("ac-train", train_ds, tmp, seed, AC_LR, AC_DRIFT_RTOL, batch_size=AC_BATCH,
                      pipeline="audio_cues", model_name=AC_MODEL)
    return {"cfg": cfg, "best": best, "root": root, "tmp": tmp, "datasets": datasets,
            "final_test_acc": result["final_test_acc"], "launches": featurize_launches + launches,
            "max_abs_err": max_err}


def check_reestimated_bn(phase: str, model: torch.nn.Module, ckpt: str, datasets: dict) -> None:
    """The last epoch's weights (the rolling checkpoint) on the validation
    split in eval mode: with the running BatchNorm statistics that training
    left, then with each BatchNorm's statistics re-estimated as the mean of
    its train-mode batch statistics over the training split, the weights
    frozen. The second must exceed chance by 5 standard deviations of a
    guesser's accuracy on that many clips: the weights learned the task
    even where eval-mode accuracy with the running statistics does not show
    it (at lr 1e-3 those trail the weights: PERF.md §5)."""
    from multimodal_lipread_torch.nn.common import BatchNorm
    from multimodal_lipread_torch.train.checkpoint import load_checkpoint, load_module_state

    load_module_state(model, load_checkpoint(ckpt)["state"])
    model.to(DEVICE)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    val, train = datasets["val"], datasets["train"]

    def batches(ds):
        for i in range(0, len(ds) - AC_BATCH + 1, AC_BATCH):
            yield tuple(torch.from_numpy(x[i : i + AC_BATCH]).to(DEVICE) for x in ds.inputs)

    def val_acc() -> float:
        model.eval()
        pred = torch.cat([model(*xs).argmax(-1) for xs in batches(val)]).cpu().numpy()
        return 100.0 * float((pred == val.labels[: len(pred)]).mean())

    with torch.no_grad():
        running = val_acc()
        sums = [torch.zeros(2, b.num_features, device=DEVICE) for b in bns]
        model.train()
        n = 0
        for xs in batches(train):
            for b in bns:
                b.momentum = 0.0  # running stats := this batch's
            model(*xs)
            for t, b in zip(sums, bns):
                t += torch.stack([b.running_mean, b.running_var])
            n += 1
        for t, b in zip(sums, bns):
            b.running_mean.copy_(t[0] / n)
            b.running_var.copy_(t[1] / n)
        reestimated = val_acc()
    p = 1.0 / len(WORDS)
    floor = 100.0 * (p + 5 * np.sqrt(p * (1 - p) / (len(val) // AC_BATCH * AC_BATCH)))
    ok = reestimated >= floor
    log(phase, f"last epoch's weights on val, eval mode: {running:.2f}% with training's running BatchNorm "
               f"statistics, {reestimated:.2f}% with them re-estimated over the {n} training batches, weights frozen "
               f"(at least {floor:.2f}%: chance + 5 sd) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[{phase}] the trained weights do not classify the validation split")


def ac_request_breakdown(net: torch.nn.Module, group: list) -> dict:
    """Milliseconds of each stage of one audio_cues request: WAV decode
    (host clock), the log-mel kernel (CUDA events), reading the cue texts
    and embedding them on the host (``HashingEmbedder``, the backend
    wherever the sentence-transformers weights are absent), then on the
    card's timeline the copies to the card (waves and embeddings), the
    forward and the copy of the logits back; ``device idle`` is the share of
    the wall time outside the card's stages."""
    from multimodal_lipread_torch.data.cues import EMBED_DIMS, HashingEmbedder
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.pipelines.common import decode_waveforms
    from multimodal_lipread_torch.utils.precision import model_precision

    names = ("WAV decode", "log-mel kernel", "embed", "H2D", "forward", "D2H")
    totals = np.zeros(len(names) + 1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    embedder = HashingEmbedder(EMBED_DIMS["mpnet"])
    with torch.inference_mode(), model_precision(torch.float32):
        for _ in range(BREAKDOWN_ITERS):
            t0 = time.perf_counter()
            waves = decode_waveforms([g[0] for g in group])
            t1 = time.perf_counter()
            ev[0].record()
            wave = torch.from_numpy(waves).to(DEVICE)
            ev[1].record()
            mel = logmel_cuda.log_mel(wave, True)[:, :80, :AC_INPUT_SIZE]
            ev[2].record()
            t2 = time.perf_counter()
            texts = []
            for g in group:
                with open(g[1], encoding="utf-8") as f:
                    texts.append(f.read().strip())
            emb = embedder.encode(texts)
            t3 = time.perf_counter()
            ev[3].record()
            cue = torch.from_numpy(emb).to(DEVICE)
            ev[4].record()
            logits = net(mel, cue)
            ev[5].record()
            logits.cpu()
            ev[6].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            h2d = ev[0].elapsed_time(ev[1]) + ev[3].elapsed_time(ev[4])
            kernel, forward, d2h = ev[1].elapsed_time(ev[2]), ev[4].elapsed_time(ev[5]), ev[5].elapsed_time(ev[6])
            busy = h2d + kernel + forward + d2h
            totals += [(t1 - t0) * 1e3, kernel, (t3 - t2) * 1e3, h2d, forward, d2h,
                       100.0 * (1.0 - busy / (wall * 1e3))]
    out = dict(zip(names, totals[:-1] / BREAKDOWN_ITERS))
    return {**out, "device idle %": totals[-1] / BREAKDOWN_ITERS}


def phase_ac_serve(ac: dict, device_info: dict) -> int:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.cues import load_cue_records, records_by_key
    from multimodal_lipread_torch.data.glips import scan_glips
    from multimodal_lipread_torch.ops.logmel import log_mel_reference
    from multimodal_lipread_torch.pipelines.common import decode_waveforms
    from multimodal_lipread_torch.utils.precision import model_precision

    smi, cfg, best = device_info["smi"], ac["cfg"], ac["best"]
    cue_map = records_by_key(load_cue_records(ac["root"], "emotion"))
    entries = [e for e in scan_glips(ac["root"]).by_split("test") if e.key in cue_map][: AC_REQUEST * AC_REQUESTS]
    texts = write_cue_texts(os.path.join(ac["tmp"], "requests"), [cue_map[e.key].description for e in entries])
    groups = [[e.path, t] for e, t in zip(entries, texts)]
    requests = [groups[i : i + AC_REQUEST] for i in range(0, len(groups), AC_REQUEST)]
    served, predictor, launches = serve_requests(
        "ac-serve", "audio_cues", cfg, best, requests, AC_REQUEST, "WAV decode + log-mel kernel + cue embedding",
        smi, kernel=True)
    log_breakdown("ac-serve", ac_request_breakdown(predictor.model, requests[0]), len(requests[0]), smi)
    labels = ac["datasets"]["test"].labels[: len(groups)]
    log("ac-serve", f"served accuracy on {len(groups)} test clips "
                    f"{100.0 * float((served['resident'][0].argmax(-1) == labels).mean()):.2f}% (final test on all "
                    f"{len(ac['datasets']['test'])}: {ac['final_test_acc']:.2f}%)")

    waves = torch.from_numpy(decode_waveforms([g[0] for g in groups])).to(DEVICE)
    plain = log_mel_reference(waves, True)[:, :80, :AC_INPUT_SIZE].cpu().numpy()
    cue = serving._featurize_modalities("audio_cues", cfg, groups, device="cpu")[1]
    cpu = serving.Predictor.from_checkpoint(serving.build_model("audio_cues", cfg), best, AC_REQUEST, device="cpu")
    with model_precision(torch.float32):
        ref_cpu = cpu.predict_logits(plain, cue)
    check_served("ac-serve", served,
                 {"plain-version features on the card": predictor.predict_logits(plain, cue), "the CPU": ref_cpu})
    return launches


def fusion_config(root: str, base: str, seed: int, model: str, batch: int, lr: float, wd: float, epochs: int,
                  **training) -> "Config":
    """configs/cv_config.yaml's and configs/acv_config.yaml's schema on ``root``."""
    from multimodal_lipread_torch.config import Config

    return Config.from_dict({
        "dataset": {"root_dir": root, "cue_root": root, "input_size": ACV_INPUT_SIZE, "cue_mode": "emotion",
                    "embed_model": "mpnet", "cache_dir": os.path.join(base, "cache"), "num_classes": len(WORDS)},
        "model": {"name": model, "dtype": "float32"},
        "training": {"batch_size": batch, "learning_rate": lr, "weight_decay": wd, "epochs": epochs, "seed": seed,
                     **training},
        "output": {"base_dir": base, "plots": False},
    })


def phase_cv_train(seed: int, device_info: dict, tmp: str) -> dict:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.glips import lip_regions_root
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.models.cues_video import get_cues_video_model
    from multimodal_lipread_torch.pipelines import cues_video as cv_pipeline

    smi = device_info["smi"]
    tmp = os.path.join(tmp, "cv")
    root = make_synthetic_glips(os.path.join(tmp, "GLips_4"), words=WORDS, clips_per_split=CV_CLIPS_PER_SPLIT,
                                seed=seed, with_lip_regions=True, with_cues=True)
    lip_root = lip_regions_root(root)
    t0 = time.perf_counter()
    datasets, classes = cv_pipeline.load_cue_video_datasets(root, lip_root)
    load_s = time.perf_counter() - t0
    cue_emb, lips = datasets["train"].inputs
    log("cv-train", f"synthetic corpus from --seed: {sum(len(d) for d in datasets.values())} aligned cue + .npy "
                    f"clips, {len(datasets['train'])} per split, classes {classes} (the aligned train words); cue "
                    f"embeddings {cue_emb.shape} {cue_emb.dtype}, lips {lips.shape} {lips.dtype}; "
                    f"load_cue_video_datasets (np.load, read + hashing mpnet embedding) {load_s * 1e3:.2f} ms")

    cfg = fusion_config(root, os.path.join(tmp, "run"), seed, CV_MODEL, CV_BATCH, CV_LR, CV_WD, CV_EPOCHS)
    t0 = time.perf_counter()
    result = cv_pipeline.main(cfg, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_params = sum(p.numel() for p in get_cues_video_model(CV_MODEL, len(WORDS)).parameters())
    log("cv-train", f"pipelines.cues_video.main: {CV_MODEL} (ResNet18 over 29 frames, trainable; BiLSTM 2 x 128, "
                    f"2 layers; SingleQueryAttention(256) queried by the BatchNorm'd cue; concat -> 512 -> 4; "
                    f"{n_params} parameters), float32, batch {CV_BATCH}, lr {CV_LR:g}, wd {CV_WD:g}, {CV_EPOCHS} "
                    f"epochs in {wall:.2f} s (load, model build, training, evaluation, checkpoints)")
    log_epochs("cv-train", result["history"], smi)
    best = check_history("cv-train", result, CV_EPOCHS)
    test = datasets["test"]
    predictor = serving.Predictor.from_checkpoint(serving.build_model("cues_video", cfg), best, CV_BATCH, device=DEVICE)
    check_served_accuracy("cv-train", predictor.predict_logits(*test.inputs), test.labels, result["final_test_acc"])

    train_ds = datasets["train"]
    trainer = timing_trainer(get_cues_video_model(CV_MODEL, len(WORDS)), CV_MODEL, CV_BATCH, CV_LR, CV_WD,
                                    tmp, seed)
    log_train_measures("cv-train", train_measures(trainer, train_ds, seed),
                       f"B={CV_BATCH} ({CV_BATCH * lips.shape[1]} frames)", len(train_ds),
                       "cue embeddings + uint8 lips", smi)
    del trainer
    check_first_steps("cv-train", train_ds, tmp, seed, CV_LR, CV_DRIFT_RTOL, batch_size=CV_BATCH,
                      pipeline="cues_video", model_name=CV_MODEL)
    return {"cfg": cfg, "best": best, "root": root, "lip_root": lip_root, "tmp": tmp, "datasets": datasets,
            "final_test_acc": result["final_test_acc"]}


def read_texts(paths: list) -> list:
    texts = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            texts.append(f.read().strip())
    return texts


def fusion_request_breakdown(net: torch.nn.Module, group: list, audio: bool) -> dict:
    """Milliseconds of each stage of one cues_video (``audio`` false: cue
    text, lips) or audio_cues_video (WAV, cue text, lips) request: on the
    host clock the WAV decode, reading and embedding the cue texts
    (``HashingEmbedder``, the backend wherever the sentence-transformers
    weights are absent) and the ``.npy`` load; on the card's timeline (CUDA
    events) the log-mel kernel, the copies to the card (waves, embeddings,
    uint8 lips), the forward (lips scaled to [0, 1] included) and the copy
    of the logits back; ``device idle`` is the share of the wall time
    outside the card's stages."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.cues import EMBED_DIMS, HashingEmbedder
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.pipelines.common import decode_waveforms
    from multimodal_lipread_torch.utils.precision import model_precision

    totals: dict = {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    embedder = HashingEmbedder(EMBED_DIMS["mpnet"])
    with torch.inference_mode(), model_precision(torch.float32):
        for _ in range(BREAKDOWN_ITERS):
            stages = {}
            t0 = time.perf_counter()
            if audio:
                waves = decode_waveforms([g[0] for g in group])
                stages["WAV decode"] = (time.perf_counter() - t0) * 1e3
                ev[0].record()
                wave = torch.from_numpy(waves).to(DEVICE)
                ev[1].record()
                mel = logmel_cuda.log_mel(wave, True)[:, :80, :ACV_INPUT_SIZE]
                ev[2].record()
            t1 = time.perf_counter()
            emb = embedder.encode(read_texts([g[-2] for g in group]))
            t2 = time.perf_counter()
            lips = serving.load_lips([g[-1] for g in group])
            t3 = time.perf_counter()
            ev[3].record()
            cue, x = torch.from_numpy(emb).to(DEVICE), torch.from_numpy(lips).to(DEVICE)
            ev[4].record()
            lip = x.to(torch.float32) / 255.0
            logits = net(mel, cue, lip) if audio else net(cue, lip)
            ev[5].record()
            logits.cpu()
            ev[6].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if audio:
                stages["log-mel kernel"] = ev[1].elapsed_time(ev[2])
            stages["read + embed"], stages["npy load"] = (t2 - t1) * 1e3, (t3 - t2) * 1e3
            stages["H2D"] = ev[3].elapsed_time(ev[4]) + (ev[0].elapsed_time(ev[1]) if audio else 0.0)
            stages["forward"], stages["D2H"] = ev[4].elapsed_time(ev[5]), ev[5].elapsed_time(ev[6])
            busy = sum(stages[k] for k in ("log-mel kernel", "H2D", "forward", "D2H") if k in stages)
            stages["device idle %"] = 100.0 * (1.0 - busy / (wall * 1e3))
            for k, v in stages.items():
                totals[k] = totals.get(k, 0.0) + v / BREAKDOWN_ITERS
    return totals


def fusion_request_groups(run: dict, audio: bool, count: int) -> list:
    """``count`` test clips of the shared corpus as request groups: the cue
    text written to a file, with the clip's WAV first for audio_cues_video
    and its lip ``.npy`` last; returns them and their labels."""
    from multimodal_lipread_torch.data.cues import load_cue_records, records_by_key
    from multimodal_lipread_torch.data.glips import align_modalities, scan_glips, scan_lip_regions

    cue_map = records_by_key(load_cue_records(run["root"], "emotion"))
    pairs = [(a, v) for a, v in align_modalities(scan_glips(run["root"]), scan_lip_regions(run["lip_root"]),
                                                 split="test") if a.key in cue_map][:count]
    texts = write_cue_texts(os.path.join(run["tmp"], "requests"), [cue_map[a.key].description for a, _v in pairs])
    groups = [([a.path] if audio else []) + [t, v.path] for (a, v), t in zip(pairs, texts)]
    return groups, np.asarray([WORDS.index(a.word) for a, _v in pairs])


def phase_cv_serve(cv: dict, device_info: dict) -> None:
    from multimodal_lipread_torch import serving

    smi, cfg, best = device_info["smi"], cv["cfg"], cv["best"]
    groups, labels = fusion_request_groups(cv, False, CV_REQUEST * CV_REQUESTS)
    requests = [groups[i : i + CV_REQUEST] for i in range(0, len(groups), CV_REQUEST)]
    served, predictor, _ = serve_requests("cv-serve", "cues_video", cfg, best, requests, CV_REQUEST,
                                          "cue read + embedding + .npy load", smi, api_requests=2)
    log_breakdown("cv-serve", fusion_request_breakdown(predictor.model, requests[0], audio=False),
                  len(requests[0]), smi)
    check_served_accuracy("cv-serve", served["resident"][0], labels, cv["final_test_acc"])
    inputs = serving._featurize_modalities("cues_video", cfg, groups, device="cpu")
    cpu = serving.Predictor.from_checkpoint(serving.build_model("cues_video", cfg), best, CV_REQUEST, device="cpu")
    check_served("cv-serve", served, {"the CPU": cpu.predict_logits(*inputs)})


def phase_acv_train(seed: int, device_info: dict, cv: dict) -> dict:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.cues import load_cue_records, records_by_key
    from multimodal_lipread_torch.data.glips import align_modalities, scan_glips, scan_lip_regions
    from multimodal_lipread_torch.models.audio_cues_video import get_triple_model
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.ops.logmel import log_mel_reference
    from multimodal_lipread_torch.pipelines import audio_cues_video as acv_pipeline
    from multimodal_lipread_torch.pipelines.common import decode_waveforms

    smi, root, lip_root = device_info["smi"], cv["root"], cv["lip_root"]
    tmp = os.path.join(os.path.dirname(cv["tmp"]), "acv")
    logmel_cuda.launch_count = 0
    t0 = time.perf_counter()
    datasets, classes = acv_pipeline.load_triple_datasets(root, root, lip_root, input_size=ACV_INPUT_SIZE,
                                                          device=DEVICE)
    load_s = time.perf_counter() - t0
    featurize_launches = logmel_cuda.launch_count
    mels, cue_emb, lips = datasets["train"].inputs
    log("acv-train", f"[cv-train]'s corpus with its audio: {sum(len(d) for d in datasets.values())} aligned wav + "
                     f"cue + .npy clips, {len(datasets['train'])} per split, classes {classes} (the audio index's); "
                     f"mels {mels.shape} {mels.dtype}, cue embeddings {cue_emb.shape}, lips {lips.shape} {lips.dtype}; "
                     f"load_triple_datasets (decode, log-mel on the card, read + hashing mpnet embedding, np.load) "
                     f"{load_s * 1e3:.2f} ms with {featurize_launches} log-mel kernel launches")
    if featurize_launches < 1:
        raise SystemExit("the audio_cues_video featurization never launched the log-mel kernel")
    cue_map = records_by_key(load_cue_records(root, "emotion"))
    pairs = [(a, v) for a, v in align_modalities(scan_glips(root), scan_lip_regions(lip_root), split="train")
             if a.key in cue_map]
    wave = torch.from_numpy(decode_waveforms([a.path for a, _v in pairs])).to(DEVICE)
    want = log_mel_reference(wave, True)[:, :80, :ACV_INPUT_SIZE].cpu().numpy()
    max_err = float(np.abs(mels - want).max())
    ok = mels.shape == want.shape and bool(np.isfinite(mels).all()) and max_err <= KERNEL_TOL
    log("acv-train", f"featurized mels vs plain-version features: max abs err {max_err:.3e} "
                     f"(tolerance {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the audio_cues_video featurization disagrees with the plain log-mel")

    cfg = fusion_config(root, os.path.join(tmp, "run"), seed, ACV_MODEL, ACV_BATCH, ACV_LR, ACV_WD, ACV_EPOCHS)
    logmel_cuda.launch_count = 0
    t0 = time.perf_counter()
    result = acv_pipeline.main(cfg, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = logmel_cuda.launch_count
    n_params = sum(p.numel() for p in get_triple_model(ACV_MODEL, len(WORDS)).parameters())
    log("acv-train", f"pipelines.audio_cues_video.main: {ACV_MODEL} (ResNet18 over the 1 x 80 x {ACV_INPUT_SIZE} "
                     f"log-mel, MobileNetV2 over 29 frames + BiLSTM 2 x 128, 2 layers, the plain cue MLP; "
                     f"per-modality logits fused by ModalityAttentionFusion; {n_params} parameters), float32, "
                     f"batch {ACV_BATCH}, lr {ACV_LR:g}, wd {ACV_WD:g}, {ACV_EPOCHS} epochs in {wall:.2f} s "
                     f"(featurization, model build, training, evaluation, checkpoints); log-mel kernel launches: "
                     f"{launches}")
    if launches < 1:
        raise SystemExit("audio_cues_video training never launched the log-mel kernel")
    log_epochs("acv-train", result["history"], smi)
    best = check_history("acv-train", result, ACV_EPOCHS)
    if not os.path.isfile(os.path.join(os.path.dirname(best), f"{ACV_MODEL}_checkpoint.pt")):
        raise SystemExit("[acv-train] no rolling checkpoint")
    test = datasets["test"]
    predictor = serving.Predictor.from_checkpoint(serving.build_model("audio_cues_video", cfg), best, ACV_BATCH,
                                                  device=DEVICE)
    check_served_accuracy("acv-train", predictor.predict_logits(*test.inputs), test.labels, result["final_test_acc"])

    train_ds = datasets["train"]
    trainer = timing_trainer(get_triple_model(ACV_MODEL, len(WORDS)), ACV_MODEL, ACV_BATCH, ACV_LR, ACV_WD,
                                    tmp, seed)
    log_train_measures("acv-train", train_measures(trainer, train_ds, seed),
                       f"B={ACV_BATCH} ({ACV_BATCH * lips.shape[1]} frames)", len(train_ds),
                       "mels + cue embeddings + uint8 lips", smi)
    del trainer
    check_first_steps("acv-train", train_ds, tmp, seed, ACV_LR, ACV_DRIFT_RTOL, batch_size=ACV_BATCH,
                      pipeline="audio_cues_video", model_name=ACV_MODEL)
    return {"cfg": cfg, "best": best, "root": root, "lip_root": lip_root, "tmp": tmp, "datasets": datasets,
            "final_test_acc": result["final_test_acc"], "launches": featurize_launches + launches,
            "max_abs_err": max_err}


def phase_acv_serve(acv: dict, device_info: dict) -> int:
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.ops.logmel import log_mel_reference
    from multimodal_lipread_torch.pipelines.common import decode_waveforms
    from multimodal_lipread_torch.utils.precision import model_precision

    smi, cfg, best = device_info["smi"], acv["cfg"], acv["best"]
    groups, labels = fusion_request_groups(acv, True, ACV_REQUEST * ACV_REQUESTS)
    requests = [groups[i : i + ACV_REQUEST] for i in range(0, len(groups), ACV_REQUEST)]
    served, predictor, launches = serve_requests(
        "acv-serve", "audio_cues_video", cfg, best, requests, ACV_REQUEST,
        "WAV decode + log-mel kernel + cue embedding + .npy load", smi, api_requests=2, kernel=True)
    log_breakdown("acv-serve", fusion_request_breakdown(predictor.model, requests[0], audio=True),
                  len(requests[0]), smi)
    check_served_accuracy("acv-serve", served["resident"][0], labels, acv["final_test_acc"])
    waves = torch.from_numpy(decode_waveforms([g[0] for g in groups])).to(DEVICE)
    plain = log_mel_reference(waves, True)[:, :80, :ACV_INPUT_SIZE].cpu().numpy()
    _mel, cue, lips = serving._featurize_modalities("audio_cues_video", cfg, groups, device="cpu")
    cpu = serving.Predictor.from_checkpoint(serving.build_model("audio_cues_video", cfg), best, ACV_REQUEST,
                                            device="cpu")
    with model_precision(torch.float32):
        ref_cpu = cpu.predict_logits(plain, cue, lips)
    check_served("acv-serve", served, {"plain-version features on the card": predictor.predict_logits(plain, cue, lips),
                                       "the CPU": ref_cpu})
    return launches


def phase_frozen(seed: int, device_info: dict, acv: dict) -> int:
    """acv_config's recipe on ``early_fusion_mobile`` (audio ResNet18 and
    video MobileNetV2 frozen) through ``pipelines.audio_cues_video.main``,
    three ways: (a) ``training.frozen_bn_eval``, (b)
    ``training.cache_frozen_features``, (c) the default. Every frozen
    parameter must end bit-equal to its value when ``fit`` began; the frozen
    BatchNorms' running statistics must move in (c) only; (b)'s per-step
    losses must equal (a)'s to ``FROZEN_RTOL``. Returns the log-mel kernel's
    launches."""
    from multimodal_lipread_torch.models.audio_cues_video import FROZEN_PARAM_PREFIXES
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.pipelines import audio_cues_video as acv_pipeline
    from multimodal_lipread_torch.train.frozen_cache import cached_dataset
    from multimodal_lipread_torch.train.trainer import Trainer

    smi = device_info["smi"]
    prefixes = tuple(".".join(p) + "." for p in FROZEN_PARAM_PREFIXES[FROZEN_MODEL])
    fit, train_step = Trainer.fit, Trainer.train_step
    runs, launches = {}, 0
    for tag, training in (("a", {"frozen_bn_eval": True}), ("b", {"cache_frozen_features": True}), ("c", {})):
        seen: dict = {"steps": []}

        def capture_fit(self, *args, **kwargs):
            seen["trainer"] = self
            seen["initial"] = {k: v.clone() for k, v in self.model.state_dict().items() if k.startswith(prefixes)}
            return fit(self, *args, **kwargs)

        def capture_step(self, *args, **kwargs):
            stats = train_step(self, *args, **kwargs)
            seen["steps"].append(stats)
            return stats

        cfg = fusion_config(acv["root"], os.path.join(acv["tmp"], f"frozen_{tag}"), seed, FROZEN_MODEL, ACV_BATCH,
                            ACV_LR, ACV_WD, FROZEN_EPOCHS, **training)
        Trainer.fit, Trainer.train_step = capture_fit, capture_step
        logmel_cuda.launch_count = 0
        try:
            t0 = time.perf_counter()
            result = acv_pipeline.main(cfg, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            Trainer.fit, Trainer.train_step = fit, train_step
        launches += logmel_cuda.launch_count
        trainer = seen["trainer"]
        losses = np.asarray([(t[0] / t[3]).item() for t in seen["steps"]])
        final = {k: v for k, v in trainer.model.state_dict().items() if k.startswith(prefixes)}
        params = set(trainer.frozen_names())
        stats = [k for k in final if "running_" in k]
        params_equal = sorted(params) == sorted(k for k in final if k in params) and all(
            torch.equal(final[k], seen["initial"][k]) for k in params)
        stats_moved = sum(not torch.equal(final[k], seen["initial"][k]) for k in stats)
        hist = result["history"]
        log("frozen", f"({tag}) {FROZEN_MODEL} {training or 'default'}: main in {wall:.2f} s, {len(losses)} steps, "
                      f"epoch train losses {[round(h['train_loss'], 4) for h in hist]}, {len(params)} frozen "
                      f"parameters bit-equal to their start: {params_equal}; frozen BatchNorm statistics moved: "
                      f"{stats_moved} of {len(stats)}; log-mel kernel launches {logmel_cuda.launch_count}")
        if not params_equal or not np.isfinite(losses).all() or len(hist) != FROZEN_EPOCHS:
            raise SystemExit(f"[frozen] ({tag}) a frozen parameter moved, or the run did not finish")
        if (stats_moved > 0) != (tag == "c"):
            raise SystemExit(f"[frozen] ({tag}) the frozen BatchNorms' running statistics "
                             f"{'did not move' if tag == 'c' else 'moved'}")
        ds = acv["datasets"]["train"]
        if tag == "b":  # the features the run trained on
            ds = cached_dataset(trainer, ds, lambda raw, f: (f[0], raw[1], f[1]))
        batch = next(trainer.batches(ds, True, np.random.default_rng(seed)))
        runs[tag] = {"losses": losses,
                     "step_ms": cuda_ms(lambda: trainer.train_step(*batch), warmup=3, iters=STEP_ITERS)}
        del trainer, seen
    rel = np.abs(runs["b"]["losses"] / runs["a"]["losses"] - 1.0)
    ok = runs["a"]["losses"].shape == runs["b"]["losses"].shape and bool(np.all(rel <= FROZEN_RTOL))
    log("frozen", f"(b) cached against (a) frozen_bn_eval, per step over {len(rel)} steps: largest relative "
                  f"difference {rel.max():.3e} (tolerance {FROZEN_RTOL:g}) {'ok' if ok else 'FAIL'}")
    log("frozen", f"train step at B={ACV_BATCH} (CUDA events, mean of {STEP_ITERS}): (a) with the frozen forward "
                  f"{runs['a']['step_ms']:.3f} ms, (b) on cached features {runs['b']['step_ms']:.3f} ms, (c) "
                  f"{runs['c']['step_ms']:.3f} ms | {smi}")
    if not ok:
        raise SystemExit("[frozen] the cached run's losses differ from the frozen_bn_eval run's")
    return launches


def cue_zoo_inputs(cues: dict) -> dict:
    """Each cue embedding kind's features of ``CUES_BATCH`` [cues-train]
    records taken from the words in turn (the first rows, which [zoo]
    holds to the CPU, are of different words), and their labels."""
    from multimodal_lipread_torch.data.cues import load_cue_records
    from multimodal_lipread_torch.data.tfidf import TfidfVectorizer
    from multimodal_lipread_torch.models.cues import cue_embedding_kind
    from multimodal_lipread_torch.pipelines.cues import _featurize

    records = load_cue_records(cues["root"], "emotion")
    by_word = [[i for i, r in enumerate(records) if r.word == w] for w in WORDS]
    rows = [ids[j] for j in range(min(map(len, by_word))) for ids in by_word][:CUES_BATCH]
    picked = [records[i] for i in rows]
    cache = cues["cfg"].get("dataset.cache_dir")
    kinds = {cue_embedding_kind(n) for n in ZOO_CUES} - {"tfidf"}
    feats = {k: _featurize(picked, k, cache, bert_size="base") for k in kinds}
    # the TF-IDF vocabulary is fitted on the whole pool, as the pipeline fits it
    feats["tfidf"] = TfidfVectorizer().fit_transform([r.description for r in records])[rows].astype(np.float32)
    labels = np.asarray([WORDS.index(r.word) for r in picked], np.int32)
    return {"feats": feats, "labels": labels}


def zoo_trainer(name: str, model: torch.nn.Module, batch: int, tmp: str, seed: int, frozen: tuple = ()):
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(model, TrainerConfig(
        model_name=name, num_classes=len(WORDS), batch_size=batch, learning_rate=1e-4, seed=seed, host_prefetch=0,
        frozen_param_prefixes=frozen, metrics_dir=os.path.join(tmp, "zoo", name, "m"), checkpoints_dir=os.path.join(tmp, "zoo", name, "c")),
        device=DEVICE)
    trainer.init_state()
    return trainer


def zoo_step(trainer, inputs: tuple, labels: np.ndarray, tol: float = LOGITS_TOL) -> dict:
    """One forward + backward + Adam step on the card (finite loss), the
    mean step time over ``ZOO_ITERS`` more, and the eval logits on the first
    ``ZOO_CPU_ROWS`` rows against a copy of the same weights on the CPU,
    computing in float32 there. The card's error must also stay under a
    tenth of the CPU logits' largest spread across those rows, so that a
    forward that ignored its input would fail even where a random
    initialization leaves the logits nearly constant."""
    import copy

    from multimodal_lipread_torch.utils.precision import model_precision

    xs = tuple(torch.from_numpy(x).to(DEVICE) for x in inputs)
    y = torch.from_numpy(labels.astype(np.int64)).to(DEVICE)
    w = torch.ones(len(labels), device=DEVICE)
    loss_sum, _c, _n, wsum = trainer.train_step(xs, y, w).tolist()
    step_ms = cuda_ms(lambda: trainer.train_step(xs, y, w), warmup=1, iters=ZOO_ITERS)
    model = trainer.model.eval()
    rows = tuple(trainer._prepare(x[:ZOO_CPU_ROWS]) for x in xs)
    cpu_model = copy.deepcopy(model).cpu()
    cpu_model.dtype = torch.float32
    with torch.no_grad(), model_precision(torch.float32):
        card = model(*rows).float().cpu().numpy()
        cpu = cpu_model(*(x.cpu() for x in rows)).float().numpy()
    err = float(np.abs(card - cpu).max())
    spread = float(np.ptp(cpu, axis=0).max())
    ok = (bool(np.isfinite(loss_sum) and np.isfinite(card).all()) and np.allclose(card, cpu, rtol=tol, atol=tol)
          and err <= spread / 10)
    return {"loss": loss_sum / wsum, "step_ms": step_ms, "err": err, "ok": ok, "spread": spread,
            "scale": float(np.abs(cpu).max()), "params": sum(p.numel() for p in model.parameters())}


def phase_zoo(seed: int, device_info: dict, av: dict, video_best: str, tmp: str, cues: dict, ac: dict, cv: dict,
              acv: dict) -> None:
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.models import audio_cues_video, cues_video
    from multimodal_lipread_torch.models.audio import get_audio_model
    from multimodal_lipread_torch.models.audio_cues import get_audio_cues_model
    from multimodal_lipread_torch.models.cues import cue_embedding_kind, get_cue_model
    from multimodal_lipread_torch.models.audio_video import get_av_model
    from multimodal_lipread_torch.models.video import get_video_model
    from multimodal_lipread_torch.pipelines.common import load_pretrained_backbones
    from multimodal_lipread_torch.train.checkpoint import load_checkpoint, load_module_state

    smi = device_info["smi"]
    mels, lips = av["datasets"]["train"].inputs
    labels = av["datasets"]["train"].labels
    av_in, audio_in, video_in = ((mels[:AV_BATCH], lips[:AV_BATCH]), (mels[:ZOO_AUDIO_BATCH],),
                                 (lips[:ZOO_VIDEO_BATCH],))

    # model.pretrained on the card: [video-train]'s resnet into early_fusion_resnet
    grafted = zoo_trainer("early_fusion_resnet", get_av_model("early_fusion_resnet", len(WORDS)), AV_BATCH, tmp, seed)
    spec = {"arch": "checkpoint", "path": video_best, "source_submodule": ["resnet"],
            "submodule": ["video_encoder", "cnn"]}
    count = load_pretrained_backbones(grafted, Config.from_dict({"model": {"pretrained": [spec]}}))
    source = {k[len("resnet."):]: v for coll in ("params", "batch_stats")
              for k, v in load_checkpoint(video_best)["state"][coll].items() if k.startswith("resnet.")}
    got = {k: v.cpu() for k, v in grafted.model.video_encoder.cnn.state_dict().items()}
    equal = sorted(got) == sorted(source) and all(torch.equal(got[k], source[k]) for k in source)
    log("zoo", f"model.pretrained arch: checkpoint: [video-train]'s best resnet_trans 'resnet' ({len(source)} "
               f"tensors) grafted into early_fusion_resnet's video_encoder.cnn on the card: {count} backbone, "
               f"tensors equal the source: {equal}")
    if count != 1 or not equal:
        raise SystemExit("the grafted backbone differs from its source checkpoint")

    cue_in = cue_zoo_inputs(cues)
    ac_in, ac_labels = tuple(x[:AC_BATCH] for x in ac["datasets"]["train"].inputs), ac["datasets"]["train"].labels
    cases = ([("audio_video", n, lambda n=n: get_av_model(n, len(WORDS)), av_in, labels) for n in ZOO_AV]
             + [("audio", n, lambda n=n: get_audio_model(n, len(WORDS)), audio_in, labels) for n in ZOO_AUDIO]
             + [("video", "conformer", lambda: get_video_model("conformer", len(WORDS)), video_in, labels)]
             + [("cues", n, lambda n=n: get_cue_model(n, len(WORDS), bert_size="base",
                                                     input_dim=cue_in["feats"][cue_embedding_kind(n)].shape[-1]),
                 (cue_in["feats"][cue_embedding_kind(n)],), cue_in["labels"]) for n in ZOO_CUES]
             + [("audio_cues", n, lambda n=n: get_audio_cues_model(n, len(WORDS)), ac_in, ac_labels) for n in ZOO_AC]
             + [("cues_video", n, lambda n=n: cues_video.get_cues_video_model(n, len(WORDS)),
                 tuple(x[:CV_BATCH] for x in cv["datasets"]["train"].inputs), cv["datasets"]["train"].labels)
                for n in ZOO_CV]
             + [("audio_cues_video", n, lambda n=n: audio_cues_video.get_triple_model(n, len(WORDS)),
                 tuple(x[:ACV_BATCH] for x in acv["datasets"]["train"].inputs), acv["datasets"]["train"].labels)
                for n in ZOO_ACV])
    frozen = {"cues_video": cues_video.FROZEN_PARAM_PREFIXES,
              "audio_cues_video": audio_cues_video.FROZEN_PARAM_PREFIXES}
    bad = []
    for kind, name, build, inputs, case_labels in cases:
        batch = len(inputs[0])
        trainer = grafted if name == "early_fusion_resnet" and kind == "audio_video" else zoo_trainer(
            f"{kind}_{name}", build(), batch, tmp, seed, frozen.get(kind, {}).get(name, ()))
        bf16 = trainer.compute_dtype == torch.bfloat16
        tol = BF16_LOGITS_TOL if bf16 else LOGITS_TOL
        from_trained = ""
        if name == "bert_lite":
            # bert-base at random init gives nearly the same logits for any
            # input; [cues-train]'s trained weights (the same parameters)
            # make them depend on it
            load_module_state(trainer.model, load_checkpoint(cues["best"])["state"])
            from_trained = ", from [cues-train]'s best bert weights"
        r = zoo_step(trainer, inputs, case_labels[:batch], tol)
        log("zoo", f"{kind} {name} at B={batch}: {r['params']} parameters, first step loss {r['loss']:.4f}, step "
                   f"(forward + backward + Adam, {'bfloat16' if bf16 else 'float32'}) {r['step_ms']:.3f} ms (CUDA "
                   f"events, mean of {ZOO_ITERS}); eval logits vs the CPU in float32 on {ZOO_CPU_ROWS} rows: max abs "
                   f"err {r['err']:.3e} (tolerance {tol:g}, and a tenth of the CPU logits' largest spread across "
                   f"rows {r['spread']:.3e}; their scale {r['scale']:.3f}){from_trained} "
                   f"{'ok' if r['ok'] else 'FAIL'} | {smi}")
        if not r["ok"]:
            bad.append(f"{kind} {name}")
        del trainer
    if bad:
        raise SystemExit(f"[zoo] a non-finite loss, or card logits that disagree with the CPU by more than the "
                         f"tolerance or a tenth of how far the logits move with the input, for {bad}")


def crop_boxes(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """``n`` margin-expanded int32 lip boxes in (h, w) frames from ``rng``:
    random mouth-sized boxes, and among them the cases the kernel must get
    right: a failed detection (0, 0, 0, 0), a negative width, boxes touching
    the frame's edges, the whole frame, a square and an exact 44 x 44."""
    from multimodal_lipread_torch.ops.crop_resize import expand_boxes

    x0, y0 = rng.integers(0, w - 40, n), rng.integers(0, h - 40, n)
    raw = np.stack([x0, y0, np.minimum(x0 + rng.integers(12, 110, n), w),
                    np.minimum(y0 + rng.integers(8, 70, n), h)], -1).astype(np.int32)
    boxes = expand_boxes(torch.from_numpy(raw), h, w).numpy()
    special = [(0, 0, 0, 0), (30, 12, 20, 40), (w - 60, h - 30, w, h), (0, 0, w, h), (0, h // 2, w, h // 2 + 9),
               (w // 2 - 30, h // 2 - 30, w // 2 + 30, h // 2 + 30), (7, 3, 51, 47)]
    for i, box in enumerate(special):
        boxes[(i * 37) % n] = box
    return boxes


def crop_bound(frames_shape: tuple, boxes: torch.Tensor, normalize: bool) -> tuple:
    """(bound ms, 'bytes') of the crop on these frames and boxes: the output
    written once, the boxes read once and, per frame with a valid box, every
    distinct 32-byte sector of the source rows that its bilinear gather
    needs (the rows times the sectors holding the columns it reads; a GLips
    row of 256 x 3 bytes starts on a sector boundary), at the card's memory
    rate. Its operations (some 30 fp32 flops a sampled byte) take a
    hundredth of that at the fp32 peak."""
    from multimodal_lipread_torch.ops.crop_resize import source_coords

    n, h, w, c = frames_shape
    y0, y1, _wy, x0, x1, _wx, in_region = source_coords(boxes, h, w)
    valid = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    in_rows, in_cols = in_region.any(2).int(), in_region.any(1).int()  # (n, 44)
    rows = torch.zeros((n, h), dtype=torch.int32, device=boxes.device)
    for y in (y0[..., 0], y1[..., 0]):
        rows.scatter_add_(1, y, in_rows)
    sectors = torch.zeros((n, -(-w * c // 32)), dtype=torch.int32, device=boxes.device)
    for x in (x0[:, 0, :], x1[:, 0, :]):
        for byte in (0, c - 1):
            sectors.scatter_add_(1, (x * c + byte) // 32, in_cols)
    touched = ((rows > 0).sum(1) * (sectors > 0).sum(1) * valid).sum().item() * 32
    out_bytes = n * 44 * 44 * c * (4 if normalize else 1)
    nbytes = touched + out_bytes + boxes.numel() * 4
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes", nbytes


def graph_ms(calls: list, launches: int = CROP_GRAPH_LAUNCHES, replays: int = CROP_GRAPH_REPLAYS) -> tuple:
    """(device ms per call, the graph): ``launches`` calls, taking the
    functions of ``calls`` in turn, captured in one CUDA graph after a
    warm-up on a side stream, and CUDA events around each of ``replays``
    replays; the mean replay over ``launches``. The host's work per call is
    captured away, so the number is the device's own."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / (replays * launches), graph


def profiled_kernel_ms(graph, name: str):
    """Mean device ms of the kernels named like ``name`` in one replay of
    ``graph``, by ``torch.profiler`` (None where it recorded none)."""
    events, _ = profiled(graph.replay)
    spans = [e.time_range.end - e.time_range.start for e in device_activities(events) if name in e.name]
    return sum(spans) / len(spans) * 1e-3 if spans else None


def host_us_per_call(fn, iters: int = TIMING_ITERS) -> float:
    """Host microseconds a call of ``fn`` takes to return (the enqueue; the
    card is synchronized before and after, outside the timing)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def crop_phases(times: dict) -> str:
    """``ops.crop_resize_cuda.phase_times``' microseconds on one line."""
    return (", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in times.items() if isinstance(v, tuple))
            + f"; a block {times['block']:.2f}, last start {times['last_start']:.2f}, launch {times['launch']:.2f}")


def crop_sets(gen: torch.Generator, rng: np.random.Generator, n: int) -> list:
    """``CROP_COLD_SETS`` sets of ``n`` uint8 frames of ``CROP_FRAME`` x 3,
    made on the card from ``gen``, each with its boxes from ``rng``."""
    return [(torch.randint(0, 256, (n, *CROP_FRAME, 3), dtype=torch.uint8, device=DEVICE, generator=gen),
             torch.from_numpy(crop_boxes(rng, n, *CROP_FRAME)).to(DEVICE)) for _ in range(CROP_COLD_SETS)]


def phase_crop_kernel(seed: int, device_info: dict, ptxas: list) -> dict:
    """The crop kernel against its plain version on the card, at the frame
    counts of the device-crop train step (B = 16 and 32 clips of 29 frames
    of 256 x 256 x 3), in both modes, on every frame set; its launch
    configuration; its device time by graph replay, cold (the launches
    rotate over ``CROP_COLD_SETS`` sets) and warm (one set), with
    ``torch.profiler``'s mean kernel time as a cross-check; the wrapper's
    time per call and the host's; ``F.grid_sample`` over the same source
    coordinates (a partial yardstick) by the same cold graph replay; the
    plain version; and the bound."""
    import torch.nn.functional as F

    from multimodal_lipread_torch.ops import crop_resize_cuda
    from multimodal_lipread_torch.ops.crop_resize import (
        crop_resize_pad_normalize_reference,
        crop_resize_pad_reference,
        source_coords,
    )

    smi = device_info["smi"]
    rng, gen = np.random.default_rng(seed), torch.Generator(device=DEVICE).manual_seed(seed)
    rows, max_lsb, failures = {}, 0.0, []
    for normalize in (False, True):
        cfg = crop_resize_cuda.launch_config(normalize=normalize)
        log("crop-kernel", f"crop normalize={normalize} launch: " + ", ".join(f"{k} {v}" for k, v in cfg.items()))
    for line in ptxas:
        log("crop-kernel", f"  {line}")
    for clips in CROP_CLIPS:
        n = clips * 29
        sets = crop_sets(gen, rng, n)
        for normalize in (False, True):
            kernel = crop_resize_cuda.crop_resize_pad_normalize if normalize else crop_resize_cuda.crop_resize_pad
            plain = crop_resize_pad_normalize_reference if normalize else crop_resize_pad_reference
            lsb, differing, blank = 0.0, 0, True
            for frames, boxes in sets:
                got, want = kernel(frames, boxes), plain(frames, boxes)
                torch.cuda.synchronize()
                diff = (got.double() - want.double()).abs() * (255.0 if normalize else 1.0)
                lsb, differing = max(lsb, float(diff.max())), differing + int((diff > 0).sum())
                blank = blank and bool((got[:1] == 0).all()) and got.shape == (n, 44, 44, 3)
            max_lsb = max(max_lsb, lsb)
            ok = lsb <= 1.0 + 1e-6 and blank
            log("crop-kernel", f"crop B={clips} x 29 frames normalize={normalize}, {CROP_COLD_SETS} frame sets: "
                               f"max abs diff {lsb:.3g} LSB, {differing} of {CROP_COLD_SETS * n * 44 * 44 * 3} "
                               f"values differ, degenerate box blank: {blank} (tolerance 1 LSB) "
                               f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append((clips, normalize, lsb))
            calls = [functools.partial(kernel, f, b) for f, b in sets]
            cold, graph = graph_ms(calls)
            prof = profiled_kernel_ms(graph, "crop_resize")
            del graph
            warm, _ = graph_ms(calls[:1])
            wrapper = cuda_ms(calls[0])
            host = host_us_per_call(calls[0])
            measured = [crop_bound((n, *CROP_FRAME, 3), b, normalize) for _f, b in sets]
            bound, bound_by = float(np.mean([m[0] for m in measured])), measured[0][1]
            nbytes = float(np.mean([m[2] for m in measured]))
            plain_ms = cuda_ms(functools.partial(plain, *sets[0]), warmup=2, iters=10)
            if not normalize:
                rows[clips] = {"ms": cold, "warm_ms": warm, "plain_ms": plain_ms, "bound_ms": bound,
                               "bound_by": bound_by}
            log("crop-kernel", f"crop B={clips} x 29 frames of {CROP_FRAME[0]} x {CROP_FRAME[1]} "
                               f"normalize={normalize}: kernel device time by graph replay of "
                               f"{CROP_GRAPH_LAUNCHES} launches, cold (over {CROP_COLD_SETS} frame sets) "
                               f"{cold:.5f} ms ({100 * bound / cold:.1f} % of bound), warm (one set) {warm:.5f} ms "
                               f"({100 * bound / warm:.1f} %); torch.profiler's mean kernel time, cold: "
                               + (f"{prof:.5f} ms" if prof is not None else "not measured (no device activity)")
                               + f" | wrapper per call (CUDA events over {TIMING_ITERS} back-to-back calls) "
                               f"{wrapper:.5f} ms, host {host:.1f} us a call | plain {plain_ms:.4f} ms | bound "
                               f"{bound:.5f} ms ({bound_by}: {nbytes / 1e6:.2f} MB of sectors, output and boxes, "
                               f"mean over the sets) | {smi}")
        tiny = torch.zeros(1, device=DEVICE)
        floor_ms, graph = graph_ms([functools.partial(tiny.add_, 1)])
        del graph
        phases = crop_resize_cuda.phase_times(*sets[-1])
        log("crop-kernel", f"crop B={clips} x 29 frames: phases of the default launch, us mean / max over the blocks "
                           f"(one launch on the last frame set): {crop_phases(phases)} | a one-element torch kernel "
                           f"by the same graph replay {floor_ms:.5f} ms (the launch floor) | {smi}")
        if clips == CROP_CLIPS[0]:
            # what holds the launch: a block's phases with the card to itself
            # (one frame for every 4 SMs), and the issue rate in steady state
            # (ten times the frames in one launch, so the waves overlap)
            alone = crop_resize_cuda.phase_times(sets[0][0][:CROP_ALONE], sets[0][1][:CROP_ALONE])
            many = torch.randint(0, 256, (10 * n, *CROP_FRAME, 3), dtype=torch.uint8, device=DEVICE, generator=gen)
            many_boxes = torch.from_numpy(crop_boxes(rng, 10 * n, *CROP_FRAME)).to(DEVICE)
            steady, graph = graph_ms([functools.partial(crop_resize_cuda.crop_resize_pad, many, many_boxes)],
                                     launches=CROP_GRAPH_LAUNCHES // 8)
            del graph, many, many_boxes
            log("crop-kernel", f"crop, {CROP_ALONE} frames alone on the card: {crop_phases(alone)} | {10 * n} frames "
                               f"in one launch: {steady:.5f} ms, {steady * 1e6 / (10 * n):.2f} ns a frame ("
                               f"{steady * 1e3 / 10:.2f} us for {n} frames at that rate) | {smi}")
        for cluster, threads, cap in CROP_LAUNCHES:
            ms, graph = graph_ms([functools.partial(crop_resize_cuda.crop, f, b, cluster=cluster, threads=threads,
                                                    stage_cap=cap) for f, b in sets])
            del graph
            cfg = crop_resize_cuda.launch_config(cluster=cluster, threads=threads, stage_cap=cap)
            equal = all(torch.equal(crop_resize_cuda.crop(f, b, cluster=cluster, threads=threads, stage_cap=cap),
                                    crop_resize_pad_reference(f, b)) for f, b in sets)
            if not equal:
                failures.append((clips, (cluster, threads, cap)))
            phases = crop_resize_cuda.phase_times(*sets[-1], cluster=cluster, threads=threads, stage_cap=cap)
            log("crop-kernel", f"crop B={clips} x 29 frames, launch {cluster} blocks x {threads} threads, stage "
                               f"{cfg['stage_bytes']} B: cold {ms:.5f} ms ({100 * rows[clips]['bound_ms'] / ms:.1f} % "
                               f"of bound) | {cfg['blocks_per_sm']} blocks/SM, {cfg['max_active_clusters']} clusters "
                               f"resident, {cfg['registers']} registers; equal to the plain version on every set: "
                               f"{equal} | phases: {crop_phases(phases)}")
        # the yardstick: one grid_sample over the same source coordinates,
        # on float NCHW copies of the frame sets made outside the timing
        grids = []
        for frames, boxes in sets:
            y0, _y1, wy, x0, _x1, wx, _in = source_coords(boxes, *CROP_FRAME)
            sy, sx = (y0.float() + wy).expand(n, 44, 44), (x0.float() + wx).expand(n, 44, 44)
            grid = torch.stack([sx / (CROP_FRAME[1] - 1) * 2 - 1, sy / (CROP_FRAME[0] - 1) * 2 - 1], -1)
            grids.append((frames.permute(0, 3, 1, 2).float().contiguous(), grid))
        library_ms, graph = graph_ms([functools.partial(F.grid_sample, x, g, mode="bilinear", align_corners=True)
                                      for x, g in grids])
        del graph, grids
        rows[clips]["library_ms"] = library_ms
        log("crop-kernel", f"crop B={clips} x 29 frames: F.grid_sample on float NCHW frames by the same cold graph "
                           f"replay {library_ms:.5f} ms (partial yardstick: no letterbox, pad or rounding) | {smi}")
        del sets
    if failures:
        raise SystemExit(f"crop kernel disagrees with its plain version: {failures}")
    return {"rows": rows, "max_abs_err": max_lsb}


class MemoryClips:
    """A full-frame clip source held in memory, made from a seed: per clip
    29 frames of ``CROP_FRAME`` uint8 with a grey background, a lip patch of
    the clip's class brightness and stripes inside its box, and the
    margin-expanded box (``FullFrameClipSource``'s records, without a
    video decode)."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        h, w = CROP_FRAME
        self.labels = rng.integers(0, len(WORDS), n).astype(np.int32)
        self.boxes = crop_boxes(rng, n * 29, h, w).reshape(n, 29, 4)  # failed detections among them
        self.frames = rng.integers(100, 140, (n, 29, h, w, 3), dtype=np.uint8)
        stripes = ((np.arange(h)[:, None] // 3) % 2 * 40).astype(np.uint8)
        for i in range(n):
            for t in range(29):
                x0, y0, x1, y1 = self.boxes[i, t]
                if x1 <= x0 or y1 <= y0:
                    continue
                patch = 40 + 45 * self.labels[i] + stripes[y0:y1, :, None] * (self.labels[i] % 2)
                self.frames[i, t, y0:y1, x0:x1] = np.broadcast_to(patch, (y1 - y0, x1 - x0, 3))

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int) -> dict:
        return {"frames": self.frames[i], "boxes": self.boxes[i], "label": self.labels[i]}


@contextlib.contextmanager
def recorded_losses():
    """Inside the block, every metrics row the trainer pushes (a step's
    (Σ loss·w, correct, Σ weights, Σ w), or a group's K rows) is kept as
    per-step losses, in order, in the list it yields."""
    from multimodal_lipread_torch.train import trainer as trainer_module

    losses: list = []
    push = trainer_module._Metrics.push

    def recorded(self, stats):
        rows = stats.reshape(-1, 4).double()
        losses.append(rows[:, 0] / rows[:, 3])
        push(self, stats)

    trainer_module._Metrics.push = recorded
    try:
        yield losses
    finally:
        trainer_module._Metrics.push = push


def flat_losses(recorded: list) -> np.ndarray:
    return torch.cat(recorded).cpu().numpy() if recorded else np.zeros(0)


def phase_crop_train(seed: int, device_info: dict, tmp: str) -> dict:
    """visual_config's resnet_trans at its widths, batch 16, trained 2 epochs
    on full frames streamed from memory with the crop kernel as
    ``device_preproc``; its first steps against the same steps on an
    ``ArrayDataset`` of the plain version's crops in the same order; a
    per-step breakdown; 4 requests of 16 full-frame clips through
    ``Predictor(device_preproc=device_crop)`` against the plain crops."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.grain_loader import StreamingDataset
    from multimodal_lipread_torch.models.video import get_video_model
    from multimodal_lipread_torch.ops import crop_resize_cuda
    from multimodal_lipread_torch.ops.crop_resize import crop_resize_pad_reference
    from multimodal_lipread_torch.train.checkpoint import save_checkpoint
    from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

    smi = device_info["smi"]
    t0 = time.perf_counter()
    source = MemoryClips(CROP_TRAIN_CLIPS, seed)
    stream = StreamingDataset(source, ("frames", "boxes"), seed=seed)
    log("crop-train", f"in-memory full-frame source from --seed: {len(source)} clips of 29 x {CROP_FRAME[0]} x "
                      f"{CROP_FRAME[1]} x 3 uint8 with boxes ({source.frames.nbytes / 2**20:.1f} MiB), made in "
                      f"{time.perf_counter() - t0:.2f} s")

    def trainer(name, **extra):
        t = Trainer(get_video_model("resnet_trans", len(WORDS)), TrainerConfig(
            model_name=name, num_classes=len(WORDS), batch_size=VIDEO_BATCH, epochs=CROP_EPOCHS,
            learning_rate=VIDEO_LR, weight_decay=VIDEO_WD, seed=seed, scheduler_mode="max",
            metrics_dir=os.path.join(tmp, "crop", name, "m"), checkpoints_dir=os.path.join(tmp, "crop", name, "c"),
            **extra), device=DEVICE)
        t.init_state()
        return t

    torch.backends.cudnn.deterministic = True  # both runs' steps repeat bit for bit (see [graphs])
    cropping = trainer("resnet_trans_crop", device_preproc=crop_resize_cuda.device_crop)
    crop_resize_cuda.launch_count = 0
    t0 = time.perf_counter()
    with recorded_losses() as recorded:
        epochs = [cropping.train_epoch(stream, np.random.default_rng(seed + e), epoch=e)
                  for e in range(1, CROP_EPOCHS + 1)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = crop_resize_cuda.launch_count
    losses = flat_losses(recorded)
    log("crop-train", f"resnet_trans, batch {VIDEO_BATCH}, {CROP_EPOCHS} epochs on streamed full frames, the crop "
                      f"kernel as device_preproc: {wall:.2f} s, {len(losses)} steps, epoch train losses "
                      f"{[round(m.loss, 4) for m in epochs]}, crop kernel launches {launches}")
    if launches < len(losses) or not np.isfinite(losses).all():
        raise SystemExit(f"[crop-train] {launches} crop launches for {len(losses)} steps, losses {losses}")
    # the same steps on the plain version's crops, in the same batch order
    lips = np.concatenate([crop_resize_pad_reference(torch.from_numpy(source.frames[i : i + 8]).to(DEVICE),
                                                     torch.from_numpy(source.boxes[i : i + 8]).to(DEVICE)).cpu().numpy()
                           for i in range(0, len(source), 8)])
    plain = trainer("resnet_trans_plain")
    with recorded_losses() as recorded:
        plain.train_epoch(ArrayDataset((lips,), source.labels), np.random.default_rng(seed + 1))
    torch.backends.cudnn.deterministic = False
    want = flat_losses(recorded)[:CROP_PARITY_STEPS]
    rel = np.abs(losses[:CROP_PARITY_STEPS] / want - 1.0)
    ok = bool(np.all(rel <= CROP_PARITY_RTOL))
    log("crop-train", f"first {CROP_PARITY_STEPS} steps, device crop {losses[:CROP_PARITY_STEPS].tolist()} vs plain "
                      f"crops {want.tolist()}: relative {rel.tolist()} (tolerance {CROP_PARITY_RTOL:g}) "
                      f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[crop-train] the device-crop steps differ from the plain-crop steps")

    # one step's breakdown: host batch, pin + H2D of the full frames, the
    # crop kernel, the train step (the crop included), card idle
    names = ("host batch", "H2D frames", "crop kernel", "step incl. crop")
    totals = np.zeros(len(names) + 1)
    batches = cropping.stream_batches(stream, 1, True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(CROP_BREAKDOWN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs, labels, weights = next(batches)
        host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in (*inputs, labels, weights)]
        t1 = time.perf_counter()
        ev[0].record()
        frames, boxes, y, w = (t.to(DEVICE, non_blocking=True) for t in host)
        ev[1].record()
        crop_resize_cuda.crop_resize_pad(frames, boxes)
        ev[2].record()
        cropping.train_step((frames, boxes), y, w)
        ev[3].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        device = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        totals += [(t1 - t0) * 1e3, *device, 100.0 * (1.0 - (device[0] + device[2]) / wall_ms)]
    stages = dict(zip(names, totals[:-1] / CROP_BREAKDOWN_STEPS))
    log("crop-train", f"per step at B={VIDEO_BATCH} (mean of {CROP_BREAKDOWN_STEPS}): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stages.items()) + f", card idle {totals[-1] / CROP_BREAKDOWN_STEPS:.1f} % | "
        f"{inputs[0].nbytes / 1e6:.1f} MB of frames a batch | {smi}")

    # serving full frames through the predictor's device crop
    ckpt = os.path.join(tmp, "crop", "resnet_trans_crop.pt")
    save_checkpoint(ckpt, cropping.checkpoint_tree(CROP_EPOCHS, 0.0, 0.0))
    crop_resize_cuda.launch_count = 0
    predictor = serving.Predictor.from_checkpoint(get_video_model("resnet_trans", len(WORDS)), ckpt, CROP_REQUEST,
                                                  device=DEVICE, device_preproc=crop_resize_cuda.device_crop)
    reference = serving.Predictor.from_checkpoint(get_video_model("resnet_trans", len(WORDS)), ckpt, CROP_REQUEST,
                                                  device=DEVICE)
    served, refs, total_s = [], [], 0.0
    for r in range(CROP_REQUESTS):
        sel = slice((r * CROP_REQUEST) % len(source), (r * CROP_REQUEST) % len(source) + CROP_REQUEST)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served.append(predictor.predict_logits(source.frames[sel], source.boxes[sel]))
        total_s += time.perf_counter() - t0
        refs.append(reference.predict_logits(lips[sel]))
    serve_launches = crop_resize_cuda.launch_count
    log("crop-train", f"Predictor(device_preproc=device_crop): {CROP_REQUESTS} requests of {CROP_REQUEST} full-frame "
                      f"clips in {total_s * 1e3:.2f} ms ({total_s / CROP_REQUESTS * 1e3:.3f} ms a request, "
                      f"{CROP_REQUESTS * CROP_REQUEST / total_s:.1f} clips/s; frames H2D, crop kernel, forward, D2H), "
                      f"crop kernel launches {serve_launches} | {smi}")
    if serve_launches < CROP_REQUESTS:
        raise SystemExit("[crop-train] serving did not launch the crop kernel")
    check_logits("crop-train", "device-crop Predictor", np.concatenate(served), np.concatenate(refs),
                 "plain-version crops on the card")
    return {"launches": launches + serve_launches}


def stream_config(root: str, base: str, seed: int) -> "Config":
    """audio_config.yaml's vgg_lstm on ``root``, streamed, 1 epoch."""
    from multimodal_lipread_torch.config import Config

    return Config.from_dict({
        "dataset": {"root_dir": root, "num_classes": len(WORDS), "input_size": 117, "streaming": True},
        "model": {"name": "vgg_lstm", "version": VGG_VERSION, "dtype": "float32"},
        "training": {"batch_size": TRAIN_BATCH, "epochs": 1, "learning_rate": TRAIN_LR,
                     "weight_decay": TRAIN_WD, "seed": seed},
        "output": {"base_dir": base, "plots": False},
    })


def phase_stream_train(seed: int, device_info: dict, tmp: str) -> dict:
    """``pipelines.audio.main`` with ``dataset.streaming: true`` on [train]'s
    WAV corpus, 1 epoch: the log-mel kernel runs in every step's forward;
    one step on the first unshuffled streaming batch against the
    features-first model's at the same weights. Returns the log-mel
    kernel's launches, the corpus, the config and the best checkpoint
    (``WaveToLogMel``: [native-stream], [load-test], [export])."""
    from multimodal_lipread_torch.data.glips import scan_glips
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.models.audio import get_audio_model
    from multimodal_lipread_torch.models.frontend import WaveToLogMel
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.pipelines import audio as audio_pipeline
    from multimodal_lipread_torch.pipelines.common import decode_waveforms, load_audio_datasets
    from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

    smi = device_info["smi"]
    tmp = os.path.join(tmp, "stream")
    root = make_synthetic_glips(os.path.join(tmp, "GLips_4"), words=WORDS, clips_per_split=TRAIN_CLIPS_PER_SPLIT,
                                seed=seed)
    cfg = stream_config(root, os.path.join(tmp, "run"), seed)
    logmel_cuda.launch_count = 0
    t0 = time.perf_counter()
    result = audio_pipeline.main(cfg, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = logmel_cuda.launch_count
    steps = -(-TRAIN_CLIPS_PER_SPLIT * len(WORDS) // TRAIN_BATCH)
    h = result["history"][0]
    log("stream-train", f"pipelines.audio.main with dataset.streaming: vgg_lstm VGG{VGG_VERSION}-BN, batch "
                        f"{TRAIN_BATCH}, 1 epoch in {wall:.2f} s (WAV decode per batch on the host, the log-mel "
                        f"kernel in every forward): train {h['train_loss']:.4f} val {h['val_loss']:.4f} test "
                        f"{h['test_loss']:.4f}, {h['clips_per_sec']:.1f} clips/s (train + val + test); log-mel "
                        f"kernel launches {launches} for {steps} train steps | {smi}")
    if launches < steps or not np.isfinite([h["train_loss"], h["val_loss"], h["test_loss"]]).all():
        raise SystemExit(f"[stream-train] {launches} log-mel launches for {steps} train steps, or a "
                         "non-finite loss")
    index = scan_glips(root)
    train = index.by_split("train")[:TRAIN_BATCH]
    labels = np.asarray([index.class_to_idx[e.word] for e in train])
    waves = decode_waveforms([e.path for e in train])
    mels = load_audio_datasets(root, device=DEVICE)[0]["train"].inputs[0][:TRAIN_BATCH]
    losses = []
    for model, x in ((WaveToLogMel(get_audio_model("vgg_lstm", len(WORDS), version=VGG_VERSION)), waves),
                     (get_audio_model("vgg_lstm", len(WORDS), version=VGG_VERSION), mels)):
        t = Trainer(model, TrainerConfig(model_name="s", num_classes=len(WORDS), batch_size=TRAIN_BATCH, seed=seed,
                                         learning_rate=TRAIN_LR, metrics_dir=os.path.join(tmp, "m"),
                                         checkpoints_dir=os.path.join(tmp, "c")), device=DEVICE)
        losses.append(t.train_single_batch(ArrayDataset((x,), labels)))
    rel = abs(losses[0] / losses[1] - 1.0)
    ok = rel <= STREAM_RTOL
    log("stream-train", f"one step on the first unshuffled batch: waveforms through WaveToLogMel {losses[0]:.7f} "
                        f"vs features first {losses[1]:.7f}, relative {rel:.3e} (tolerance {STREAM_RTOL:g}) "
                        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[stream-train] the streaming model's loss differs from the features-first model's")
    return {"launches": launches, "root": root, "cfg": cfg, "best": result["best_checkpoint"], "tmp": tmp}


def phase_mp4(seed: int, device_info: dict, tmp: str) -> int:
    """``pipelines.video.main`` on a synthetic ``.mp4`` tree (OpenCV's
    ``mp4v``, 96 x 96 frames, the centre backend's lip box), 1 epoch with
    ``dataset.device_crop`` and 1 with ``dataset.host_crop_streaming``; the
    host's decode + detect (+ crop) time per clip. Returns the crop
    kernel's launches."""
    from multimodal_lipread_torch.data.glips import scan_glips
    from multimodal_lipread_torch.data.grain_loader import FullFrameClipSource, HostCropClipSource
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.ops import crop_resize_cuda
    from multimodal_lipread_torch.pipelines import video as video_pipeline

    smi = device_info["smi"]
    root = make_synthetic_glips(os.path.join(tmp, "mp4", "GLips_4"), words=WORDS, clips_per_split=MP4_CLIPS_PER_SPLIT,
                                seed=seed, with_audio=False, with_video=True)
    index = scan_glips(root, exts=(".mp4",))
    entries = index.by_split("train")[:MP4_TIMED_CLIPS]
    for name, source in (("decode + detect (device_crop's host half)",
                          FullFrameClipSource(entries, index.class_to_idx, backend="center")),
                         ("decode + detect + crop (host_crop_streaming)",
                          HostCropClipSource(entries, index.class_to_idx, backend="center"))):
        t0 = time.perf_counter()
        for i in range(len(source)):
            source[i]
        log("mp4", f"host {name}: {(time.perf_counter() - t0) / len(source) * 1e3:.2f} ms a clip of 29 frames "
                   f"(96 x 96, mean of {len(source)}) | host CPU ({os.cpu_count()} cores)")
    launches = 0
    for knob in ("device_crop", "host_crop_streaming"):
        cfg = video_config(root, os.path.join(tmp, "mp4", knob), seed, epochs=1)
        cfg.set(f"dataset.{knob}", True)
        cfg.set("dataset.landmark_backend", "center")
        crop_resize_cuda.launch_count = 0
        t0 = time.perf_counter()
        result = video_pipeline.main(cfg, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h = result["history"][0]
        log("mp4", f"pipelines.video.main with dataset.{knob}: resnet_trans, batch {VIDEO_BATCH}, 1 epoch on "
                   f"{len(index.entries)} .mp4 clips in {wall:.2f} s: train {h['train_loss']:.4f} val "
                   f"{h['val_loss']:.4f} test {h['test_loss']:.4f}, {h['clips_per_sec']:.1f} clips/s (train + val "
                   f"+ test); crop kernel launches {crop_resize_cuda.launch_count} | {smi}")
        if not np.isfinite([h["train_loss"], h["val_loss"], h["test_loss"]]).all():
            raise SystemExit(f"[mp4] {knob}: a non-finite loss")
        if (crop_resize_cuda.launch_count > 0) != (knob == "device_crop"):
            raise SystemExit(f"[mp4] {knob}: the crop kernel launched {crop_resize_cuda.launch_count} times")
        launches += crop_resize_cuda.launch_count
    return launches


def host_batch_ms(ds, batch: int, epoch: int = 0) -> tuple:
    """(ms to the first batch, mean ms of each later one) of a shuffled
    epoch of ``ds`` assembled on the host (no copy to the card)."""
    times, t0 = [], time.perf_counter()
    for _ in ds.epoch_batches(epoch, True, batch):
        t1 = time.perf_counter()
        times.append(t1 - t0)
        t0 = t1
    return times[0] * 1e3, float(np.mean(times[1:])) * 1e3


def epoch_idle(trainer, ds) -> tuple:
    """(unprofiled epoch s, busy s, profiled s) of training epochs of ``ds``."""
    rng = np.random.default_rng(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_epoch(ds, rng, 1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    busy_s, prof_s, _ = device_busy_s(lambda: trainer.train_epoch(ds, rng, 2))
    return epoch_s, busy_s, prof_s


def phase_native_stream(seed: int, device_info: dict, stream: dict, video: dict) -> int:
    """The C++ prefetcher (``dataset.loader_backend: native``): [stream-train]'s
    WAV corpus with the int16 wire through ``pipelines.audio.main`` against
    the grain (``DataLoader``) backend, per-step losses over the same epoch
    order under ``cudnn.deterministic``; host batch ms (native, ``DataLoader``
    with 0 and 4 workers) and the card's idle share over a training epoch of
    each; then [video-train]'s lips as ``npy_u8`` records against
    ``LipClipSource``, byte for byte, and 1 epoch of ``pipelines.video.main``
    on them. Returns the log-mel kernel's launches."""
    from multimodal_lipread_torch.data.glips import AUDIO_EXTS, scan_glips, scan_lip_regions
    from multimodal_lipread_torch.data.grain_loader import (
        AudioClipSource,
        LipClipSource,
        NativeStreamingDataset,
        StreamingDataset,
    )
    from multimodal_lipread_torch.models.audio import get_audio_model
    from multimodal_lipread_torch.models.frontend import WaveToLogMel
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.pipelines import audio as audio_pipeline
    from multimodal_lipread_torch.pipelines import video as video_pipeline
    from multimodal_lipread_torch.pipelines.common import LIP_SHAPE
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    smi, tmp = device_info["smi"], stream["tmp"]
    losses, launches = {}, 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for backend in ("grain", "native"):
            cfg = stream_config(stream["root"], os.path.join(tmp, f"native_{backend}"), seed)
            cfg.set("dataset.loader_backend", backend)
            if backend == "native":
                cfg.set("dataset.wire_dtype", "int16")
            logmel_cuda.launch_count = 0
            t0 = time.perf_counter()
            with recorded_losses() as recorded:
                h = audio_pipeline.main(cfg, device=DEVICE)["history"][0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            losses[backend] = flat_losses(recorded)
            if backend == "native":
                launches = logmel_cuda.launch_count
            log("native-stream", f"pipelines.audio.main, dataset.loader_backend {backend}"
                                 f"{' (wire_dtype int16)' if backend == 'native' else ''}: vgg_lstm, batch {TRAIN_BATCH}, "
                                 f"1 epoch in {wall:.2f} s, train {h['train_loss']:.6f} val {h['val_loss']:.6f} test "
                                 f"{h['test_loss']:.6f}, {h['clips_per_sec']:.1f} clips/s (train + val + test); "
                                 f"log-mel kernel launches {logmel_cuda.launch_count} | {smi}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = losses["native"], losses["grain"]
    rel = float(np.max(np.abs(a / b - 1.0))) if a.shape == b.shape and len(a) else float("nan")
    ok = rel <= NATIVE_RTOL and launches >= len(a) > 0
    log("native-stream", f"per-step losses (train and evaluation, {len(a)} steps), native int16 wire vs grain: "
                         f"largest relative difference {rel:.3e} (tolerance {NATIVE_RTOL:g}; bit-equal expected) "
                         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[native-stream] the native backend's losses differ from the grain backend's, or the "
                         "log-mel kernel did not run every step")

    index = scan_glips(stream["root"], exts=AUDIO_EXTS)
    entries, c2i = index.by_split("train"), index.class_to_idx
    loaders = {"native (int16 wire)": NativeStreamingDataset(entries, c2i, "wav", (20000,), seed=seed,
                                                             wire_dtype="int16")}
    for workers in NATIVE_LOADER_WORKERS:
        loaders[f"DataLoader num_workers {workers}"] = StreamingDataset(AudioClipSource(entries, c2i), ("waveform",),
                                                                        seed=seed, worker_count=workers)
    for name, ds in loaders.items():
        first, later = host_batch_ms(ds, TRAIN_BATCH)
        if isinstance(ds, StreamingDataset) and ds.worker_count > 0:
            # the DataLoader spawns its workers anew every epoch: the first
            # batch's wait is the epoch's floor (8.6 s an epoch and the card
            # 98 % idle on an H100 at 700 W, PERF.md), so no training epoch here
            log("native-stream", f"{name}: host batch of {TRAIN_BATCH} WAV clips {later:.3f} ms (mean after the "
                                 f"first); the first batch, spawning the workers, {first:.2f} ms every epoch | host "
                                 f"CPU ({os.cpu_count()} cores)")
            continue
        model = WaveToLogMel(get_audio_model("vgg_lstm", len(WORDS), version=VGG_VERSION))
        trainer = Trainer(model, TrainerConfig(model_name="n", num_classes=len(WORDS), batch_size=TRAIN_BATCH,
                                               seed=seed, metrics_dir=os.path.join(tmp, "m"),
                                               checkpoints_dir=os.path.join(tmp, "c")), device=DEVICE)
        trainer.ensure_initialized()
        epoch_s, busy_s, prof_s = epoch_idle(trainer, ds)
        log("native-stream", f"{name}: host batch of {TRAIN_BATCH} WAV clips {later:.3f} ms (mean after the first; "
                             f"first {first:.2f} ms) | training epoch of {len(entries)} clips {epoch_s * 1e3:.2f} ms, "
                             f"{len(entries) / epoch_s:.1f} clips/s, card idle " + idle_line(busy_s, prof_s, epoch_s)
                             + f" | host CPU ({os.cpu_count()} cores) | {smi}")
    loaders["native (int16 wire)"].close()

    lip_index = scan_lip_regions(video_pipeline.resolve_lip_root(video["cfg"]))
    entries, c2i = lip_index.by_split("train"), lip_index.class_to_idx
    native = NativeStreamingDataset(entries, c2i, "npy_u8", LIP_SHAPE, seed=seed)
    grain = StreamingDataset(LipClipSource(entries, c2i), ("lip_regions",), seed=seed)
    same = all(np.array_equal(x[0], y[0]) and np.array_equal(lx, ly)
               for (x, lx), (y, ly) in zip(native.epoch_batches(0, True, VIDEO_BATCH),
                                           grain.epoch_batches(0, True, VIDEO_BATCH)))
    times = {name: host_batch_ms(ds, VIDEO_BATCH) for name, ds in (("native", native), ("grain", grain))}
    native.close()
    log("native-stream", f"npy_u8 records of {len(entries)} lip clips {LIP_SHAPE}: native vs LipClipSource over a "
                         f"shuffled epoch {'byte-equal' if same else 'DIFFER'}; host batch of {VIDEO_BATCH}: native "
                         f"{times['native'][1]:.3f} ms, grain (np.load) {times['grain'][1]:.3f} ms (means after the "
                         f"first) | host CPU ({os.cpu_count()} cores)")
    if not same:
        raise SystemExit("[native-stream] the native npy_u8 records differ from np.load's")
    cfg = video_config(video["cfg"].get("dataset.root_dir"), os.path.join(tmp, "native_video"), seed, epochs=1)
    cfg.set("dataset.streaming", True)
    cfg.set("dataset.loader_backend", "native")
    t0 = time.perf_counter()
    h = video_pipeline.main(cfg, device=DEVICE)["history"][0]
    torch.cuda.synchronize()
    log("native-stream", f"pipelines.video.main, streaming, loader_backend native: resnet_trans, batch {VIDEO_BATCH}, "
                         f"1 epoch in {time.perf_counter() - t0:.2f} s: train {h['train_loss']:.4f} val "
                         f"{h['val_loss']:.4f} test {h['test_loss']:.4f}, {h['clips_per_sec']:.1f} clips/s (train + "
                         f"val + test) | {smi}")
    if not np.isfinite([h["train_loss"], h["val_loss"], h["test_loss"]]).all():
        raise SystemExit("[native-stream] video: a non-finite loss")
    return launches


def log_load_test(phase: str, what: str, r: dict, smi: str) -> None:
    log(phase, f"load_test, {what}: {r['num_threads']} client threads x {r['requests'] // r['num_threads']} requests "
               f"of {r['batch']}: p50 {r['p50_ms']:.3f} ms, p90 {r['p90_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, max "
               f"{r['max_ms']:.3f} ms, {r['throughput_clips_per_s']:.1f} clips/s over {r['wall_s']:.3f} s | {smi}")


def phase_load_test(seed: int, device_info: dict, stream: dict, video: dict) -> tuple:
    """``serving.load_test`` on one card: [stream-train]'s ``WaveToLogMel``
    vgg_lstm in a resident ``Predictor`` (B=32 waveforms, the log-mel kernel
    in every request), then [video-train]'s resnet_trans behind
    ``Predictor(device_preproc=device_crop)`` on full-frame requests (B=16
    clips of 29 x 256 x 256 x 3 and their boxes, the crop kernel in every
    request). Returns the log-mel and the crop kernel's launches."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.glips import scan_glips
    from multimodal_lipread_torch.ops import crop_resize_cuda, logmel_cuda
    from multimodal_lipread_torch.ops.crop_resize_cuda import device_crop
    from multimodal_lipread_torch.pipelines.common import decode_waveforms

    smi = device_info["smi"]
    with torch.device("meta"):
        model = serving.build_audio_model(stream["cfg"])
    audio = serving.Predictor.from_checkpoint(model, stream["best"], SERVE_BATCH, device=DEVICE)
    waves = decode_waveforms([e.path for e in scan_glips(stream["root"]).by_split("test")][:SERVE_BATCH])
    logmel_cuda.launch_count = 0
    r = serving.load_test(audio, (waves,), LOAD_THREADS, LOAD_AUDIO_REQUESTS)
    mel_launches = logmel_cuda.launch_count
    log_load_test("load-test", f"audio vgg_lstm ({len(WORDS)} words) on raw waveforms, log-mel kernel launches "
                               f"{mel_launches}", r, smi)
    with torch.device("meta"):
        model = serving.build_model("video", video["cfg"])
    crop = serving.Predictor.from_checkpoint(model, video["best"], CROP_REQUEST, device=DEVICE,
                                             device_preproc=device_crop)
    clips = MemoryClips(CROP_REQUEST, seed)
    crop_resize_cuda.launch_count = 0
    r2 = serving.load_test(crop, (clips.frames, clips.boxes), LOAD_THREADS, LOAD_CROP_REQUESTS)
    crop_launches = crop_resize_cuda.launch_count
    log_load_test("load-test", f"video resnet_trans on full frames {clips.frames.shape[1:]} with the device crop, crop "
                               f"kernel launches {crop_launches}", r2, smi)
    want = (1 + LOAD_THREADS * LOAD_AUDIO_REQUESTS, 1 + LOAD_THREADS * LOAD_CROP_REQUESTS)
    if (mel_launches, crop_launches) != want or not np.isfinite([r["p99_ms"], r2["p99_ms"]]).all():
        raise SystemExit(f"[load-test] kernel launches {(mel_launches, crop_launches)}, expected {want} (one a "
                         "request and the warm-up)")
    return mel_launches, crop_launches


def phase_export(device_info: dict, stream: dict) -> int:
    """``serving.export_pipeline`` on [stream-train]'s checkpoint: the
    ``WaveToLogMel`` vgg_lstm over raw (32, 20000) waveforms through
    ``torch.export``, saved, loaded again and run on the card: the graph
    holds the log-mel kernel's operator, the run launches the kernel, and
    its logits equal a resident ``Predictor``'s to 1e-6. Returns the
    kernel's launches."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.glips import scan_glips
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.pipelines.common import decode_waveforms
    from multimodal_lipread_torch.utils.precision import model_precision

    smi = device_info["smi"]
    out = os.path.join(stream["tmp"], "vgg_lstm.pt2")
    t0 = time.perf_counter()
    serving.export_pipeline(stream["cfg"], stream["best"], "audio", out, SERVE_BATCH, device=DEVICE)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = torch.export.load(out)
    load_s = time.perf_counter() - t0
    ops = sorted({str(n.target) for n in program.graph.nodes if n.op == "call_function" and "mlt" in str(n.target)})
    waves = decode_waveforms([e.path for e in scan_glips(stream["root"]).by_split("test")][:SERVE_BATCH])
    with torch.device("meta"):
        model = serving.build_audio_model(stream["cfg"])
    want = serving.Predictor.from_checkpoint(model, stream["best"], SERVE_BATCH, device=DEVICE).predict_logits(waves)
    module = program.module()
    logmel_cuda.launch_count = 0
    with torch.inference_mode(), model_precision(torch.float32):
        x = torch.from_numpy(waves).to(DEVICE)
        got = module(x).cpu().numpy()
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: module(x), warmup=2, iters=10)
    launches = logmel_cuda.launch_count
    err = float(np.abs(got - want).max())
    ok = ops == ["mlt.log_mel.default"] and launches > 0 and np.isfinite(got).all() and err <= EXPORT_TOL
    log("export", f"torch.export of the streaming vgg_lstm in {export_s:.2f} s ({os.path.getsize(out) / 1e6:.1f} MB "
                  f".pt2), loaded in {load_s:.2f} s; custom ops in its graph {ops}; the loaded program on "
                  f"{SERVE_BATCH} waveforms: {ms:.3f} ms a call (CUDA events), log-mel kernel launches {launches}; "
                  f"logits vs the resident Predictor's max abs err {err:.3e} (tolerance {EXPORT_TOL:g}) "
                  f"{'ok' if ok else 'FAIL'} | {smi}")
    if not ok:
        raise SystemExit("[export] the exported program does not hold or launch the log-mel kernel, or its logits "
                         "differ from the Predictor's")
    return launches


def rebuild_predict(pipeline: str, cfg, best: str, groups: list, batch: int) -> np.ndarray:
    """A ``predict_clips`` call as the parent commit made it: the model built
    and initialized on the host, the whole checkpoint read, its state
    copied into the model, which then moves to the card."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.train.checkpoint import load_checkpoint, load_module_state

    model = serving.build_model(pipeline, cfg)
    load_module_state(model, load_checkpoint(best)["state"])
    predictor = serving.Predictor(model=model, batch_size=batch, device=DEVICE)
    return predictor.predict_logits(*serving._featurize_modalities(pipeline, cfg, groups, device=DEVICE))


def cold_call_breakdown(pipeline: str, cfg, best: str, groups: list, batch: int, pinned: bool) -> dict:
    """Milliseconds of each stage of one ``predict_clips`` call (host clock,
    the card synchronized after each): the memory-mapped read, the build on
    ``meta``, pinning the state (or not: ``pinned=False`` copies from the
    memory-mapped pages), its copy to the card, featurization and the
    forward with the logits back."""
    from multimodal_lipread_torch import serving

    stages, t0 = {}, time.perf_counter()

    def stage(name: str) -> None:
        nonlocal t0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stages[name] = (t1 - t0) * 1e3
        t0 = t1

    state, classes = serving.read_checkpoint(best)
    stage("mmap read")
    with torch.device("meta"):
        model = serving.build_model(pipeline, cfg, len(classes) if classes else None)
    stage("meta build")
    tensors = {**state["params"], **state["batch_stats"]}
    if pinned:
        tensors = {k: v.pin_memory() for k, v in tensors.items()}
    stage("pin" if pinned else "no pin")
    model.load_state_dict(tensors, strict=True, assign=True)
    model.to(DEVICE, non_blocking=True)
    stage(f"H2D of {sum(t.nbytes for t in tensors.values()) / 1e6:.1f} MB")
    inputs = serving._featurize_modalities(pipeline, cfg, groups, device=DEVICE)
    stage("featurize")
    serving.Predictor(model=model, batch_size=batch, device=DEVICE).predict_logits(*inputs)
    stage("forward + D2H")
    return stages


def phase_serve_cold(device_info: dict, cv: dict, acv: dict, cues: dict) -> int:
    """One ``predict_clips`` call of 16 clips for cv, acv and bert-base from
    the checkpoints the run wrote (a model built on ``meta``, the checkpoint
    memory-mapped, its ``state`` moved to the card from pinned memory),
    against the parent commit's way (``rebuild_predict``) and a resident
    request, in turns; the same logits expected. Then a request's 16 lip
    ``.npy`` files through ``np.load`` and through ``serving.load_lips``.
    Returns the log-mel kernel's launches."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.cues import load_cue_records
    from multimodal_lipread_torch.ops import logmel_cuda

    smi = device_info["smi"]
    records = load_cue_records(cues["root"], "emotion")[:CUES_REQUEST]
    runs = (("cues_video", cv, fusion_request_groups(cv, False, CV_REQUEST)[0], CV_REQUEST),
            ("audio_cues_video", acv, fusion_request_groups(acv, True, ACV_REQUEST)[0], ACV_REQUEST),
            ("cues", cues, [[p] for p in write_cue_texts(os.path.join(cues["tmp"], "cold"),
                                                        [r.description for r in records])], CUES_REQUEST))
    logmel_cuda.launch_count = 0
    for pipeline, run, groups, batch in runs:
        cfg, best = run["cfg"], run["best"]
        new, old = "predict_clips", "parent's predict_clips"
        times, logits = {new: [], old: []}, {}
        for name in (new, old, old, new):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == new:
                out = np.asarray([r["logits"] for r in serving.predict_clips(cfg, best, pipeline, groups, batch,
                                                                            device=DEVICE)])
            else:
                out = rebuild_predict(pipeline, cfg, best, groups, batch)
            times[name].append((time.perf_counter() - t0) * 1e3)
            logits[name] = out
        model = serving.load_model(functools.partial(serving.build_model, pipeline, cfg), best, DEVICE)[0]
        predictor = serving.Predictor(model=model, batch_size=batch, device=DEVICE)
        predictor.predict_logits(*serving._featurize_modalities(pipeline, cfg, groups, device=DEVICE))
        t0 = time.perf_counter()
        predictor.predict_logits(*serving._featurize_modalities(pipeline, cfg, groups, device=DEVICE))
        resident_ms = (time.perf_counter() - t0) * 1e3
        err = float(np.abs(logits[new] - logits[old]).max())
        size = os.path.getsize(best) / 1e6
        log("serve-cold", f"{pipeline} ({cfg.get('model.name')}, checkpoint {size:.1f} MB): one predict_clips call of "
                          f"{len(groups)} clips {times[new][0]:.2f} / {times[new][1]:.2f} ms (meta build, mmap, state "
                          f"only, pinned copy), the parent's way (host build + whole checkpoint read) "
                          f"{times[old][0]:.2f} / {times[old][1]:.2f} ms, in turns; a resident request "
                          f"{resident_ms:.2f} ms; logits max abs difference {err:.3e} | {smi}")
        if not err <= EXPORT_TOL:
            raise SystemExit(f"[serve-cold] {pipeline}: predict_clips' logits differ from the parent's way's")
        for pinned in (True, False, True, False):
            stages = cold_call_breakdown(pipeline, cfg, best, groups, batch, pinned)
            log("serve-cold", f"{pipeline} call by stage ({'pinned' if pinned else 'pageable'} copy): " + ", ".join(
                f"{k} {v:.2f} ms" for k, v in stages.items()) + f" | {smi}")
    paths = [g[-1] for g in runs[0][2]]
    old, new = [], []
    for _ in range(BREAKDOWN_ITERS):
        t0 = time.perf_counter()
        a = np.stack([np.load(p) for p in paths])
        t1 = time.perf_counter()
        b = serving.load_lips(paths)
        new.append((time.perf_counter() - t1) * 1e3)
        old.append((t1 - t0) * 1e3)
    same = a.dtype == b.dtype and np.array_equal(a, b)
    log("serve-cold", f"a request's {len(paths)} lip .npy files: np.load {np.mean(old):.3f} ms, serving.load_lips "
                      f"(native threaded loader) {np.mean(new):.3f} ms (means of {BREAKDOWN_ITERS}, in turns), "
                      f"{'byte-equal' if same else 'DIFFER'} | host CPU ({os.cpu_count()} cores)")
    if not same:
        raise SystemExit("[serve-cold] load_lips differs from np.load")
    return logmel_cuda.launch_count


def dispatch_measures(trainer, ds, seed: int) -> dict:
    """One unprofiled epoch's time; over one profiled epoch the card's busy
    time, its activities and the host's launch calls (kernel and graph
    launches, async copies and memsets) per step."""
    steps = -(-len(ds) // trainer.batch_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_epoch(ds, np.random.default_rng(seed))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    events, prof_s = profiled(lambda: trainer.train_epoch(ds, np.random.default_rng(seed)))
    activities = device_activities(events)
    launches = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cudaGraphLaunch", "cudaLaunchKernelExC",
                                                   "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync"))
    return {"epoch_s": epoch_s, "busy_s": busy_seconds(activities), "prof_s": prof_s,
            "activities": len(activities) / steps, "host_launches": launches / steps, "steps": steps}


def phase_graphs(seed: int, device_info: dict, tmp: str, datasets: dict) -> None:
    """Device-resident training of the launch-bound models, eager (K=1)
    against CUDA graphs of K=4 steps: per-step losses over 2 epochs with
    one forced ReduceLROnPlateau halving between them, with dropout off and
    on, under ``cudnn.deterministic`` (cuDNN's default float32 kernels sum
    in a run-dependent order, so that two eager runs part from the second
    step on: a diagnostic line shows by how much); then, before and after
    in the same run and with the default kernels, device activities and
    host launch calls per step, step time, clips/s an epoch and the card's
    idle share."""
    from multimodal_lipread_torch.tools.train_drift import PIPELINES, build
    from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

    smi = device_info["smi"]
    for pipeline, ds in datasets.items():
        spec = PIPELINES[pipeline]
        batch, lr = spec["batch"], spec["lrs"][0]
        # GRAPH_BATCHES full batches: the split cut, or its clips repeated
        n = GRAPH_BATCHES * batch
        reps = -(-n // len(ds))
        ds = ArrayDataset(tuple(np.concatenate([a] * reps)[:n] for a in ds.inputs), np.concatenate([ds.labels] * reps)[:n])

        def make(k, dropout):
            model = graph_model(pipeline, spec["model"]) if dropout else build(pipeline, spec["model"])
            t = Trainer(model, TrainerConfig(
                model_name=f"{pipeline}_k{k}", num_classes=len(WORDS), batch_size=batch, learning_rate=lr,
                weight_decay=spec["weight_decay"], seed=seed, scheduler_patience=0, device_resident=True,
                steps_per_dispatch=k, metrics_dir=os.path.join(tmp, "graphs", pipeline, str(k), "m"),
                checkpoints_dir=os.path.join(tmp, "graphs", pipeline, str(k), "c")), device=DEVICE)
            t.init_state()
            return t

        def run(trainer):
            with recorded_losses() as recorded:
                trainer.train_epoch(ds, np.random.default_rng(seed + 1))
                first = len(recorded)
                # force one halving: an improvement, then a worse epoch
                trainer.scheduler.step(1.0)
                trainer._set_lr(trainer.scheduler.step(2.0))
                trainer.train_epoch(ds, np.random.default_rng(seed + 2))
            losses = flat_losses(recorded)
            return losses, sum(len(r) for r in recorded[:first])

        if pipeline == next(iter(datasets)):  # how far two eager runs part with cuDNN's default kernels
            (la, _), (lb, _) = run(make(1, False)), run(make(1, False))
            log("graphs", f"{pipeline}: two eager runs with cuDNN's default (not deterministic) kernels, largest "
                          f"relative difference per step {np.abs(lb / la - 1.0).max():.3e} (diagnostic)")
        results = {}
        torch.backends.cudnn.deterministic = True  # so that eager steps repeat bit for bit
        for dropout in (False, True):
            eager, graphed = make(1, dropout), make(GRAPH_K, dropout)
            (le, split), (lg, _) = run(eager), run(graphed)
            rel = np.abs(lg / le - 1.0)
            equal = bool(le.shape == lg.shape and np.all(rel <= GRAPH_RTOL))
            log("graphs", f"{pipeline} {spec['model']} B={batch}, dropout {'on' if dropout else 'off'}: {len(le)} "
                          f"steps in 2 epochs (LR halved after step {split}, to {eager.scheduler.lr:g}), K={GRAPH_K} "
                          f"graphs vs eager per-step losses: largest relative difference {rel.max():.3e}, "
                          f"bit-equal {bool(np.array_equal(le, lg))} (tolerance {GRAPH_RTOL:g}) "
                          f"{'ok' if equal else 'FAIL' if not dropout else 'differs'}")
            if not equal and not dropout:
                raise SystemExit(f"[graphs] {pipeline}: graphed steps differ from eager ones with dropout off")
            if not equal:  # with dropout: no two replays may draw the same masks
                graphed.dropout_generator.manual_seed(seed)
                state = graphed.dropout_generator.get_state()
                pairs = []
                for _ in range(2):
                    graphed.dropout_generator.set_state(state)
                    idxs, ws = next(graphed._index_groups(len(ds), False, np.random.default_rng(0)))[1]
                    pairs.append(graphed._run_group("train", ds, None, idxs, ws).clone())
                same = torch.equal(pairs[0], pairs[1])
                log("graphs", f"{pipeline}: one group replayed twice from one saved generator state: losses "
                              f"{'equal' if same else 'differ'} (the replays "
                              f"{'repeat' if same else 'do not repeat'} their masks)")
                if same:
                    raise SystemExit(f"[graphs] {pipeline}: replays repeat their dropout masks")
            results[dropout] = (eager, graphed)
        torch.backends.cudnn.deterministic = False  # the measures run with the default kernels
        for name, trainer in (("eager K=1", results[False][0]), (f"graphs K={GRAPH_K}", results[False][1])):
            m = dispatch_measures(trainer, ds, seed)
            log("graphs", f"{pipeline} {name}: {m['activities']:.1f} device activities and {m['host_launches']:.1f} "
                          f"host launch calls per step; epoch of {len(ds)} clips, {m['steps']} steps: "
                          f"{m['epoch_s'] * 1e3:.2f} ms, {m['epoch_s'] / m['steps'] * 1e3:.3f} ms a step, "
                          f"{len(ds) / m['epoch_s']:.1f} clips/s; card idle "
                          + idle_line(m["busy_s"], m["prof_s"], m["epoch_s"]) + f" | {smi}")
        del results
        torch.cuda.empty_cache()


def graph_model(pipeline: str, name: str) -> torch.nn.Module:
    """The pipeline's model at full width with its own dropout rates."""
    if pipeline == "audio_video":
        from multimodal_lipread_torch.models.audio_video import get_av_model

        return get_av_model(name, len(WORDS))
    if pipeline == "cues":
        from multimodal_lipread_torch.models.cues import get_cue_model

        return get_cue_model(name, len(WORDS), bert_size="base")
    if pipeline == "audio_cues":
        from multimodal_lipread_torch.models.audio_cues import get_audio_cues_model

        return get_audio_cues_model(name, len(WORDS))
    from multimodal_lipread_torch.models.audio_cues_video import get_triple_model

    return get_triple_model(name, len(WORDS))

# ---------------------------------------------------------------- multi-GPU
# [ddp]: full-width vgg_lstm through pipelines.audio.main, 1 epoch at the
# parity lr, under cudnn.deterministic. Two ranks against one: the first
# step's loss to 1e-5, its summed gradients in norm (grad_rel_err) to 1e-2
# (measured 2.1e-3 in float32; in float64 on the CPU two ranks' VGG
# gradients equal one rank's to 2e-13, tests/test_torch_ddp.py holds the
# step at 1e-6) and the BatchNorm statistics after it to 1e-6; steps 2 and 3 follow
# Adam's first updates, which move every weight by about ±lr whatever its
# gradient's size, so a weight whose gradient is rounding noise (the
# ranks' half batches take other cuDNN and cuBLAS summation orders) steps
# either way: held to PARITY_RTOL, the bound for two float32
# implementations at this lr (measured 3.7e-5 and 1.8e-4).
DDP_EPOCHS, DDP_LR = 1, PARITY_LR
# graphed DDP steps: 3 epochs of 9 steps, so that groups are captured and
# replayed after DDP's 11 eager steps
DDP_GRAPH_EPOCHS, DDP_GRAPH_TOL = 3, 1e-6
DDP_WORLD1_TOL, DDP_STEP1_RTOL, DDP_GRAD_RTOL, DDP_BN_TOL, DDP_STEPS = 1e-6, 1e-5, 1e-2, 1e-6, 3
# [tp]: bert-base through pipelines.cues.main on a small cue corpus, 1 epoch
TP_DEGREE, TP_CLIPS_PER_SPLIT, TP_RTOL = 2, 4, 2e-4  # tests/test_tensor_parallel.py's bound
# [pp]: bert-base, S = 1 with M = 4 against BertClassifier (dropout off)
PP_MICROBATCHES, PP_ATOL, PP_LOSS_RTOL = 4, 1e-5, 1e-5  # tests/test_pipeline_parallel.py's bound
DP_SERVE_TOL = 1e-6  # tests/test_serving.py's bound for the JAX mesh


def spawn_ranks(target, world: int, backend: str, payload: dict, tmp: str) -> list:
    """``target(rank, world, payload)`` in ``world`` processes
    (``torch.multiprocessing.spawn``), each in the default group over
    ``backend`` through a ``FileStore`` under ``tmp``: NCCL with one card a
    rank, gloo with every rank on card 0. A failure or a non-zero exit on
    any rank raises here. Returns each rank's result."""
    run = tempfile.mkdtemp(prefix="ranks_", dir=tmp)
    torch.multiprocessing.spawn(_rank_main, args=(target.__name__, world, backend, payload, run), nprocs=world,
                                join=True)
    return [torch.load(os.path.join(run, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _rank_main(rank: int, target: str, world: int, backend: str, payload: dict, run: str) -> None:
    global RANK_TAG
    RANK_TAG = f" rank {rank}/{world} {backend}"
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank if backend == "nccl" else 0)})
    from multimodal_lipread_torch.parallel.distributed import maybe_initialize_distributed

    maybe_initialize_distributed(DEVICE, init_method="file://" + os.path.join(run, "store"), backend=backend)
    result = globals()[target](rank, world, payload)
    torch.save(result, os.path.join(run, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@contextlib.contextmanager
def recorded_steps():
    """Inside the block, every ``Trainer.train_step`` is timed (CUDA events,
    the card synchronized after it) and its stats row kept; the first
    step's BatchNorm running statistics, the trainer and its last batch are
    kept too."""
    from multimodal_lipread_torch.train import trainer as trainer_module

    rec: dict = {"rows": [], "ms": [], "bn": None, "grads": None, "trainer": None, "batch": None}
    step = trainer_module.Trainer.train_step

    def timed_step(self, inputs, labels, weights):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        stats = step(self, inputs, labels, weights)
        end.record()
        torch.cuda.synchronize()
        rec["ms"].append(start.elapsed_time(end))
        rec["rows"].append(stats.detach().double().cpu().numpy())
        if rec["bn"] is None:
            rec["bn"] = {n: b.detach().cpu().clone() for n, b in self.model.named_buffers() if "running_" in n}
            rec["grads"] = {n: p.grad.detach().cpu().clone() for n, p in self.model.named_parameters()
                            if p.grad is not None}
        rec["trainer"], rec["batch"] = self, (inputs, labels, weights)
        return stats

    trainer_module.Trainer.train_step = timed_step
    try:
        yield rec
    finally:
        trainer_module.Trainer.train_step = step


def allreduce_share(trainer, batch: tuple, steps: int = 3) -> dict:
    """``steps`` more train steps on ``batch`` under ``torch.profiler``: the
    union of the all-reduce spans (NCCL's kernels on the card, gloo's and
    NCCL's host-side all-reduce work) against the profiled wall time."""
    events, wall = profiled(lambda: [trainer.train_step(*batch) for _ in range(steps)])
    spans = [e for e in events if "allreduce" in e.name.lower().replace("_", "")
             and (e.device_type == torch.autograd.DeviceType.CUDA or e.name in ("gloo:all_reduce", "nccl:all_reduce"))]
    comm = busy_seconds(spans) or 0.0
    return {"comm_ms": comm * 1e3 / steps, "step_ms": wall * 1e3 / steps, "share": comm / wall}


def ddp_run(rank: int, world: int, payload: dict) -> dict:
    """[ddp]'s training on this process (the default group's world, or
    none): ``pipelines.audio.main`` with its steps recorded, the log-mel
    launches, and the all-reduce share of 3 more steps."""
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.pipelines import audio as audio_pipeline
    from multimodal_lipread_torch.train.checkpoint import module_state

    torch.backends.cudnn.deterministic = True
    cfg = Config.from_dict(payload["config"])
    cfg.set("output.base_dir", os.path.join(payload["base"], payload["label"]))
    with recorded_steps() as rec:
        logmel_cuda.launch_count = 0
        t0 = time.perf_counter()
        result = audio_pipeline.main(cfg, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = logmel_cuda.launch_count
    # the model as fit left it (what its rolling checkpoint holds), before
    # the timed steps below move it
    state = module_state(rec["trainer"].model) if rank == 0 else None
    share = allreduce_share(rec["trainer"], rec["batch"])
    ms = np.asarray(rec["ms"][1:])
    log("ddp", f"{payload['label']}: pipelines.audio.main {wall:.2f} s, {len(rec['ms'])} steps of "
               f"{rec['batch'][1].shape[0]} rows here, step median {np.median(ms):.3f} ms (CUDA events, steps 2+), "
               f"all-reduce {share['comm_ms']:.3f} ms of a {share['step_ms']:.3f} ms profiled step "
               f"({100 * share['share']:.1f} %), log-mel launches {launches} | {payload['smi']}")
    return {"rows": np.stack(rec["rows"]), "ms": rec["ms"], "bn": rec["bn"], "grads": rec["grads"],
            "launches": launches, "history": result["history"], "share": share, "label": payload["label"],
            "state": state}


def grad_rel_err(ref: dict, others: list) -> tuple:
    """Each gradient tensor's difference in norm over its own norm, that
    scale floored at 1e-3 of the model's largest tensor norm (a bias before
    a BatchNorm has a gradient that is rounding noise: training-mode
    BatchNorm subtracts it again): (the worst, its tensor, the largest
    element difference over the tensor's largest element there). A norm,
    not the elements: where the ranks' half batches round a max-pool
    window's two largest inputs the other way, the gradient goes to the
    other input, a difference of the gradient's own size at a few
    elements; summing instead of averaging, or losing a rank's share, moves
    the norm by half."""
    scale = max(float(g.norm()) for g in ref.values())
    errs = {n: float((o[n] - g).norm()) / max(float(g.norm()), 1e-3 * scale) for o in others for n, g in ref.items()}
    worst = max(errs, key=errs.get)
    elem = max(float((o[worst] - ref[worst]).abs().max()) for o in others) / float(ref[worst].abs().max())
    return errs[worst], worst, elem


def ddp_graph_run(rank: int, world: int, payload: dict) -> dict:
    """(a) and then, in the same rank, [ddp]'s training device-resident for
    ``DDP_GRAPH_EPOCHS`` epochs, eager and as CUDA graphs of 4 DDP steps
    (collectives included; DDP's first 11 steps run eagerly), their
    per-step losses (train and eval) kept."""
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.pipelines import audio as audio_pipeline

    out = ddp_run(rank, world, payload)
    losses = {}
    for k in (1, 4):
        cfg = Config.from_dict(payload["config"])
        for key, value in (("training.epochs", DDP_GRAPH_EPOCHS), ("training.device_resident", True),
                           ("training.steps_per_dispatch", k),
                           ("output.base_dir", os.path.join(payload["base"], f"graphs{k}"))):
            cfg.set(key, value)
        with recorded_losses() as rec:
            t0 = time.perf_counter()
            audio_pipeline.main(cfg, device=DEVICE)
            torch.cuda.synchronize()
        losses[k] = flat_losses(rec)
        log("ddp", f"(a) device-resident, steps_per_dispatch={k}: {DDP_GRAPH_EPOCHS} epochs in "
                   f"{time.perf_counter() - t0:.2f} s, {len(losses[k])} train and eval steps")
    return {**out, "graph_losses": losses}


def ddp_losses(runs: list) -> np.ndarray:
    """Per-step losses over every rank of a run: (Σ loss·w) / (Σ w)."""
    rows = sum(r["rows"] for r in runs)
    return rows[:, 0] / rows[:, 3]


def phase_ddp(seed: int, device_info: dict, tmp: str) -> dict:
    """DDP training of full-width vgg_lstm: no process group, NCCL at world
    1, two gloo ranks sharing the card (and NCCL across cards where two are
    visible), the steps held across them."""
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips

    smi = device_info["smi"]
    root = make_synthetic_glips(os.path.join(tmp, "ddp", "GLips_4"), words=WORDS,
                                clips_per_split=TRAIN_CLIPS_PER_SPLIT, seed=seed)
    payload = {"smi": smi, "base": os.path.join(tmp, "ddp"), "config": {
        "dataset": {"root_dir": root, "num_classes": len(WORDS), "input_size": 117},
        "model": {"name": "vgg_lstm", "version": VGG_VERSION, "dtype": "float32"},
        "training": {"batch_size": TRAIN_BATCH, "epochs": DDP_EPOCHS, "learning_rate": DDP_LR,
                     "weight_decay": TRAIN_WD, "seed": seed, "checkpoint_backend": "orbax_async",
                     "rolling_checkpoint": True}}}
    log("ddp", f"[train]'s corpus from --seed, vgg_lstm VGG{VGG_VERSION}-BN + BiLSTM 2x128, float32, batch "
               f"{TRAIN_BATCH}, {DDP_EPOCHS} epoch at lr {DDP_LR:g} (steps compared across worlds: a larger lr "
               f"amplifies reduction-order rounding through Adam), cudnn.deterministic")
    deterministic = torch.backends.cudnn.deterministic
    try:
        alone = ddp_run(0, 1, {**payload, "label": "no process group"})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log("ddp", "(a) NCCL at world 1: the NCCL path on the one card (DDP's all-reduce of one rank)")
    world1 = spawn_ranks(ddp_graph_run, 1, "nccl", {**payload, "label": "(a) world 1 NCCL"}, tmp)
    log("ddp", "(b) two ranks over gloo sharing card 0: NCCL refuses two ranks on one device, and gloo runs the "
               "all-reduce and broadcast that data parallelism needs on CUDA tensors")
    world2 = spawn_ranks(ddp_run, 2, "gloo", {**payload, "label": "(b) world 2 gloo, one card"}, tmp)
    runs = {"(a)": world1, "(b)": world2}
    if torch.cuda.device_count() >= 2:
        log("ddp", "(c) two ranks over NCCL, one card a rank")
        runs["(c)"] = spawn_ranks(ddp_run, 2, "nccl", {**payload, "label": "(c) world 2 NCCL"}, tmp)
    else:
        log("ddp", f"(c) two ranks over NCCL on two cards: not run, {torch.cuda.device_count()} card visible")

    want = ddp_losses([alone])
    got = ddp_losses(world1)
    err = float(np.abs(got - want).max())
    ok = got.shape == want.shape and err <= DDP_WORLD1_TOL and np.isfinite(got).all()
    log("ddp", f"(a) vs no process group: {len(got)} step losses, max abs diff {err:.3e} (tolerance "
               f"{DDP_WORLD1_TOL:g}, bit-equal expected: {bool(np.array_equal(got, want))}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[ddp] NCCL at world 1 departs from the run without a process group")
    eager, graphed = (world1[0]["graph_losses"][k] for k in (1, 4))
    err = float(np.abs(graphed - eager).max()) if graphed.shape == eager.shape else float("inf")
    ok = err <= DDP_GRAPH_TOL and np.isfinite(graphed).all()
    log("ddp", f"(a) CUDA graphs of 4 DDP steps over NCCL (the all-reduce captured) vs eager device-resident "
               f"steps: {len(graphed)} per-step losses, max abs diff {err:.3e} (tolerance {DDP_GRAPH_TOL:g}, bit-equal "
               f"expected under cudnn.deterministic) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[ddp] graphed DDP steps depart from eager ones")
    ref = world1[0]
    for label, ranks in list(runs.items())[1:]:
        got = ddp_losses(ranks)[:DDP_STEPS]
        rel = np.abs(got / ddp_losses(world1)[:DDP_STEPS] - 1.0)
        bn_err = max(float(((r["bn"][n] - ref["bn"][n]).abs() / (1.0 + ref["bn"][n].abs())).max())
                     for r in ranks for n in ref["bn"])
        grad_err, worst, elem = grad_rel_err(ref["grads"], [r["grads"] for r in ranks])
        apart = max(float((ranks[0]["grads"][n] - r["grads"][n]).abs().max()) for r in ranks for n in ref["grads"])
        log("ddp", f"{label}: the ranks' summed gradients differ by at most {apart:.3e} between ranks")
        ok = (rel[0] <= DDP_STEP1_RTOL and bool(np.all(rel[1:] <= PARITY_RTOL)) and bn_err <= DDP_BN_TOL
              and grad_err <= DDP_GRAD_RTOL and set(ranks[0]["grads"]) == set(ref["grads"]))
        log("ddp", f"{label} vs (a): first {DDP_STEPS} step losses {got.tolist()} relative {rel.tolist()} "
                   f"(tolerance {DDP_STEP1_RTOL:g} for step 1, {PARITY_RTOL:g} after Adam's first updates); step "
                   f"1's summed gradients, every rank, |diff| / |grad| per tensor at most {grad_err:.3e} (worst {worst}, "
                   f"whose largest element differs by {elem:.3e} of its largest; tolerance {DDP_GRAD_RTOL:g}); "
                   f"BatchNorm running statistics after step 1, max |diff| / (1 + |value|) "
                   f"{bn_err:.3e} (tolerance {DDP_BN_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"[ddp] {label} departs from one rank")
    for label, ranks in [("no process group", [alone])] + list(runs.items()):
        h = ranks[0]["history"][-1]
        log("ddp", f"{label}: epoch {h['epoch']} train {h['train_loss']:.4f}/{h['train_acc']:.2f}% val "
                   f"{h['val_loss']:.4f}/{h['val_acc']:.2f}% test {h['test_loss']:.4f}/{h['test_acc']:.2f}%, "
                   f"train step median {np.median(ranks[0]['ms'][1:]):.3f} ms, all-reduce share "
                   f"{100 * ranks[0]['share']['share']:.1f} % | {smi}")
    launches = alone["launches"] + sum(r["launches"] for ranks in runs.values() for r in ranks)
    if min([alone["launches"]] + [r["launches"] for ranks in runs.values() for r in ranks]) < 1:
        raise SystemExit("[ddp] a run never launched the log-mel kernel")
    return {"launches": launches, "runs": {"(0)": [alone], **runs}, "base": payload["base"],
            "config": payload["config"]}


def tp_run(rank: int, world: int, payload: dict) -> dict:
    """[tp]'s training on this process: ``pipelines.cues.main`` at bert-base
    width with ``training.tensor_parallel`` = the payload's degree, its
    steps recorded; at degree 2 the cut shapes are checked here."""
    from multimodal_lipread_torch.pipelines import cues as cues_pipeline

    cfg = cues_config(payload["root"], os.path.join(payload["base"], f"tp{payload['tp']}"), payload["seed"])
    cfg.set("training.epochs", 1)
    cfg.set("training.tensor_parallel", payload["tp"])
    with recorded_steps() as rec:
        t0 = time.perf_counter()
        result = cues_pipeline.main(cfg, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trainer = rec["trainer"]
    shapes = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
    moments = {trainer._opt_names[i]: tuple(trainer.optimizer.state[p]["exp_avg"].shape)
               for i, p in enumerate(trainer.optimizer.param_groups[0]["params"])}
    if payload["tp"] > 1:
        h, f, k = 768, 3072, payload["tp"]
        want = {"layer0.attention.query.weight": (h // k, h), "layer0.attention.out.weight": (h, h // k),
                "layer11.intermediate.weight": (f // k, h), "layer11.output.weight": (h, f // k),
                "layer11.output.bias": (h,), "embeddings.word_embeddings.weight": shapes[
                    "embeddings.word_embeddings.weight"]}
        bad = {n: (shapes[n], s) for n, s in want.items() if shapes[n] != s or moments[n] != s}
        if bad or trainer.model.layer0.attention.num_heads != 12 // k:
            raise SystemExit(f"[tp] cut shapes (got, want): {bad}")
        log("tp", f"parameters and Adam moments cut by BERT_TP_RULES: query {shapes['layer0.attention.query.weight']}"
                  f", attention out {shapes['layer0.attention.out.weight']}, intermediate "
                  f"{shapes['layer11.intermediate.weight']}, output {shapes['layer11.output.weight']}, "
                  f"{trainer.model.layer0.attention.num_heads} heads a rank")
    share = allreduce_share(trainer, rec["batch"])
    log("tp", f"tensor_parallel={payload['tp']}: pipelines.cues.main {wall:.2f} s, {len(rec['ms'])} steps, step "
              f"median {np.median(rec['ms'][1:]):.3f} ms (CUDA events), all-reduce {share['comm_ms']:.3f} ms of a "
              f"{share['step_ms']:.3f} ms profiled step | {payload['smi']}")
    rows = np.stack(rec["rows"])
    return {"losses": rows[:, 0] / rows[:, 3], "ms": rec["ms"], "history": result["history"]}


def phase_tp(seed: int, device_info: dict, tmp: str) -> None:
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips

    root = make_synthetic_glips(os.path.join(tmp, "tp", "GLips_4"), words=WORDS, clips_per_split=TP_CLIPS_PER_SPLIT,
                                seed=seed, with_audio=False, with_cues=True)
    payload = {"root": root, "base": os.path.join(tmp, "tp"), "seed": seed, "smi": device_info["smi"]}
    log("tp", f"cues_config's bert at bert-base width, float32, batch {CUES_BATCH}, 1 epoch on a cue corpus of "
              f"{TP_CLIPS_PER_SPLIT} clips a word and split from --seed")
    one = tp_run(0, 1, {**payload, "tp": 1})
    if torch.cuda.device_count() >= TP_DEGREE:
        backend, why = "nccl", "one card a rank"
    else:
        backend, why = "gloo", "two ranks share card 0 (NCCL refuses that; gloo's all-reduce and broadcast take " \
                               "CUDA tensors, and a tensor-parallel step needs no other collective)"
    log("tp", f"tensor_parallel={TP_DEGREE} over {backend}: {why}")
    two = spawn_ranks(tp_run, TP_DEGREE, backend, {**payload, "tp": TP_DEGREE}, tmp)
    want = one["losses"][:3]
    for r, ranked in enumerate(two):
        got = ranked["losses"][:3]
        ok = bool(np.allclose(got, want, rtol=TP_RTOL, atol=0)) and np.isfinite(ranked["losses"]).all()
        log("tp", f"rank {r}: first 3 losses {got.tolist()} against tensor_parallel=1 {want.tolist()} (rtol "
                  f"{TP_RTOL:g}) {'ok' if ok else 'FAIL'}; step median {np.median(ranked['ms'][1:]):.3f} ms against "
                  f"{np.median(one['ms'][1:]):.3f} ms at tensor_parallel=1 | {device_info['smi']}")
        if not ok:
            raise SystemExit("[tp] the tensor-parallel steps depart from tensor_parallel=1")


def pp_check(rank: int, world: int, payload: dict) -> dict:
    """[pp] on this process: the pipelined bert-base at S = ``world`` stages
    and M = ``PP_MICROBATCHES`` against ``BertClassifier`` at the same
    weights: eval logits, and one GPipe step's loss against the plain loss."""
    import torch.nn.functional as F

    from multimodal_lipread_torch.models.bert import (
        BertClassifier,
        PipelinedBertClassifier,
        bert_base_config,
        unstack_bert_layers,
    )
    from multimodal_lipread_torch.nn.common import flax_init_
    from multimodal_lipread_torch.parallel.pipeline import gpipe_forward, gpipe_train_step, get_mesh_pp, reduce_grads

    cfg = bert_base_config()
    cfg.dropout_rate = 0.0
    mesh = get_mesh_pp(world)
    pp = PipelinedBertClassifier(cfg, len(WORDS), num_stages=world, mesh=mesh, num_microbatches=PP_MICROBATCHES)
    flax_init_(pp, torch.Generator().manual_seed(payload["seed"]))
    plain = BertClassifier(cfg, len(WORDS))
    plain.load_state_dict(unstack_bert_layers(pp.state_dict(), cfg.num_layers))
    pp, plain = pp.to(DEVICE), plain.to(DEVICE).eval()
    ids = torch.from_numpy(payload["ids"]).to(DEVICE)
    labels = torch.from_numpy(payload["labels"]).long().to(DEVICE)
    from multimodal_lipread_torch.utils.precision import model_precision

    with model_precision(torch.float32), torch.no_grad():
        got = gpipe_forward(pp.eval(), ids, pp.key_mask(ids), mesh, PP_MICROBATCHES)
        want = plain(ids)
        plain_loss = float(F.cross_entropy(want.float(), labels))
    with model_precision(torch.float32):
        ones = torch.ones(len(ids), device=DEVICE)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        stats = gpipe_train_step(pp.train(), ids, labels, ones, ones, ones.sum(), mesh, PP_MICROBATCHES)
        reduce_grads(pp, mesh)
        end.record()
        torch.cuda.synchronize()
    err = float((got - want).abs().max())
    loss = float(stats[0] / stats[3])
    rel = abs(loss / plain_loss - 1.0)
    ok = err <= PP_ATOL and rel <= PP_LOSS_RTOL
    log("pp", f"S={world} M={PP_MICROBATCHES}: logits vs BertClassifier at the same weights, max abs err {err:.3e} "
              f"(tolerance {PP_ATOL:g}); one GPipe step's loss {loss:.6f} vs {plain_loss:.6f}, relative {rel:.2e} "
              f"(tolerance {PP_LOSS_RTOL:g}); the step {start.elapsed_time(end):.3f} ms (CUDA events, first "
              f"call) {'ok' if ok else 'FAIL'} | {payload['smi']}")
    if not ok:
        raise SystemExit(f"[pp] the pipelined BERT at S={world} departs from BertClassifier")
    return {"err": err, "rel": rel}


def phase_pp(seed: int, device_info: dict) -> None:
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 30522, size=(CUES_BATCH, 32)).astype(np.int64)
    ids[:, 0] = 1
    ids[: CUES_BATCH // 2, 20:] = 0
    payload = {"ids": ids, "labels": rng.integers(0, len(WORDS), size=CUES_BATCH), "seed": seed,
               "smi": device_info["smi"]}
    tmp = tempfile.mkdtemp(prefix="mlt_chip_smoke_pp_")
    try:
        log("pp", "S=1 over NCCL at world 1: the GPipe schedule with one stage and 4 microbatches, dropout off")
        spawn_ranks(pp_check, 1, "nccl", payload, tmp)
        if torch.cuda.device_count() >= 2:
            spawn_ranks(pp_check, 2, "nccl", payload, tmp)
        else:
            log("pp", f"S=2 not run: {torch.cuda.device_count()} card visible; the stages exchange activations by "
                      "send/recv, which gloo runs on the CPU only, so two stages on the card need two cards over "
                      "NCCL (ROADMAP.md, Queue 3 #16); tests/test_torch_pipeline_parallel.py holds S=2 and S=4 on "
                      "the CPU")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_dp_serve(seed: int, device_info: dict) -> int:
    """``predict_clips(..., data_parallel=True)`` (the CLI's
    ``--data-parallel``) over every visible card on [serve]'s vgg_lstm
    checkpoint, streaming (the log-mel kernel in each replica's forward),
    against one resident ``Predictor``."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.models.frontend import WaveToLogMel
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.pipelines.common import decode_waveforms
    from multimodal_lipread_torch.train.checkpoint import module_state, save_checkpoint

    tmp = tempfile.mkdtemp(prefix="mlt_chip_smoke_dp_")
    try:
        root = os.path.join(tmp, "GLips_4")
        clips = write_corpus(root, np.random.default_rng(seed + 1))
        cfg = Config.from_dict({"dataset": {"root_dir": root, "num_classes": len(WORDS), "input_size": 117,
                                            "streaming": True},
                                "model": {"name": "vgg_lstm", "version": VGG_VERSION, "dtype": "float32"}})
        model = serving.build_audio_model(Config.from_dict({**cfg.config, "dataset": {
            **cfg.config["dataset"], "streaming": False}}))
        init_weights(model, torch.Generator().manual_seed(seed))  # [serve]'s weights
        ckpt = os.path.join(tmp, "vgg_lstm_stream_best.pt")
        save_checkpoint(ckpt, {"epoch": 0, "val_acc": 0.0, "state": module_state(WaveToLogMel(model, 117))})
        devices = serving.replica_devices(DEVICE)
        logmel_cuda.launch_count = 0
        t0 = time.perf_counter()
        served = serving.predict_clips(cfg, ckpt, "audio", [[c] for c in clips], SERVE_BATCH, device=DEVICE,
                                       data_parallel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = logmel_cuda.launch_count
        got = np.asarray([r["logits"] for r in served], np.float32)
        single = serving.Predictor.from_checkpoint(serving.build_audio_model(cfg), ckpt, SERVE_BATCH, device=DEVICE)
        want = single.predict_logits(decode_waveforms(clips))
        err = float(np.abs(got - want).max())
        ok = got.shape == want.shape and err <= DP_SERVE_TOL and launches > 0
        log("dp-serve", f"{len(clips)} clips in batches of {SERVE_BATCH} over {len(devices)} replica(s) {devices} "
                        f"in {wall:.2f} s (build, load, decode, serve): logits vs one resident Predictor, max abs "
                        f"err {err:.3e} (tolerance {DP_SERVE_TOL:g}), log-mel launches {launches} "
                        f"{'ok' if ok else 'FAIL'} | {device_info['smi']}")
        if not ok:
            raise SystemExit("[dp-serve] data-parallel serving departs from one replica")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# [ckpt]: the orbax checkpoint backends (train/checkpoint.py, dcp directories)
CKPT_EPOCHS = 2
CKPT_BACKENDS = ("msgpack", "orbax", "orbax_async")


def tree_bytes(path: str) -> int:
    """Bytes on disk of a checkpoint file or directory."""
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def flat_tensors(tree, prefix: str = "") -> dict:
    """``{dotted path: tensor}`` of every tensor in a checkpoint tree."""
    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_tensors(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_tensors(v, f"{prefix}.{i}"))
    return out


def trees_equal(got, want) -> tuple:
    """(bit-equal, count of tensors compared, first differing path)."""
    a, b = flat_tensors(got), flat_tensors(want)
    if set(a) != set(b):
        return False, len(b), sorted(set(a) ^ set(b))[:3]
    for k in sorted(b):
        x, y = a[k].cpu(), b[k].cpu()
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            return False, len(b), k
    return True, len(b), None


@contextlib.contextmanager
def checkpoint_clock():
    """Inside the block, the host milliseconds of every ``Trainer.
    checkpoint_tree`` (the export), ``Trainer._save_ckpt`` (what ``fit``
    blocks in a save) and ``wait_for_async_saves`` in ``fit``, and the
    host clock at each ``train_epoch``'s start and each ``fit``'s end."""
    from multimodal_lipread_torch.train import trainer as trainer_module

    rec: dict = {"export": [], "save": [], "wait": [], "epoch_start": [], "fit_end": []}
    originals = (trainer_module.Trainer.checkpoint_tree, trainer_module.Trainer._save_ckpt,
                 trainer_module.wait_for_async_saves, trainer_module.Trainer.train_epoch, trainer_module.Trainer.fit)

    def clocked(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                rec[key].append((time.perf_counter() - t0) * 1e3)
        return run

    def epoch(self, *args, **kwargs):
        rec["epoch_start"].append(time.perf_counter())
        return originals[3](self, *args, **kwargs)

    def fit(self, *args, **kwargs):
        try:
            return originals[4](self, *args, **kwargs)
        finally:
            rec["fit_end"].append(time.perf_counter())

    trainer_module.Trainer.checkpoint_tree = clocked("export", originals[0])
    trainer_module.Trainer._save_ckpt = clocked("save", originals[1])
    trainer_module.wait_for_async_saves = clocked("wait", originals[2])
    trainer_module.Trainer.train_epoch = epoch
    trainer_module.Trainer.fit = fit
    try:
        yield rec
    finally:
        (trainer_module.Trainer.checkpoint_tree, trainer_module.Trainer._save_ckpt,
         trainer_module.wait_for_async_saves, trainer_module.Trainer.train_epoch, trainer_module.Trainer.fit) = originals


def epoch_walls(rec: dict) -> list:
    """Seconds from each epoch's start to the next one's (the last: to the
    end of ``fit``, its final test and waits included)."""
    marks = rec["epoch_start"] + rec["fit_end"][-1:]
    return [b - a for a, b in zip(marks, marks[1:])]


def ckpt_audio_config(root: str, base: str, seed: int, backend: str) -> "Config":
    from multimodal_lipread_torch.config import Config

    return Config.from_dict({
        "dataset": {"root_dir": root, "num_classes": len(WORDS), "input_size": 117},
        "model": {"name": "vgg_lstm", "version": VGG_VERSION, "dtype": "float32"},
        "training": {"batch_size": TRAIN_BATCH, "epochs": CKPT_EPOCHS, "learning_rate": TRAIN_LR,
                     "weight_decay": TRAIN_WD, "seed": seed, "rolling_checkpoint": True,
                     "checkpoint_backend": backend},
        "output": {"base_dir": base, "plots": False},
    })


def ckpt_history(result: dict) -> list:
    keys = ("epoch", "train_loss", "train_acc", "val_loss", "val_acc", "test_loss", "test_acc", "lr")
    return [[h[k] for k in keys if k in h] for h in result["history"]]


def ckpt_audio(seed: int, root: str, tmp: str) -> None:
    """[ckpt] (a): the audio pipeline with orbax_async against msgpack
    (histories bit-equal under ``cudnn.deterministic``), served from the
    .orbax directory against the .pt file, and resumed in a fresh main."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.data.glips import scan_glips
    from multimodal_lipread_torch.ops import logmel_cuda
    from multimodal_lipread_torch.pipelines import audio as audio_pipeline

    runs = {}
    for backend in ("msgpack", "orbax_async"):
        t0 = time.perf_counter()
        runs[backend] = audio_pipeline.main(ckpt_audio_config(root, os.path.join(tmp, backend), seed, backend),
                                            device=DEVICE)
        torch.cuda.synchronize()
        log("ckpt", f"(a) pipelines.audio.main vgg_lstm VGG{VGG_VERSION}-BN + BiLSTM 2x128 B={TRAIN_BATCH}, "
                    f"{CKPT_EPOCHS} epochs, rolling checkpoints, checkpoint_backend {backend}: "
                    f"{time.perf_counter() - t0:.2f} s, best {os.path.basename(runs[backend]['best_checkpoint'])}")
    want, got = (ckpt_history(runs[b]) for b in ("msgpack", "orbax_async"))
    same = got == want and runs["orbax_async"]["final_test_acc"] == runs["msgpack"]["final_test_acc"]
    log("ckpt", f"(a) history over {len(got)} epochs and final test acc {runs['orbax_async']['final_test_acc']:.2f}% "
                f"bit-equal to msgpack's: {same} {'ok' if same else 'FAIL'}")
    if not same or len(got) != CKPT_EPOCHS:
        raise SystemExit("[ckpt] the orbax_async run departs from the msgpack run")
    test = [e.path for e in scan_glips(root).by_split("test")]
    served = {}
    for backend, result in runs.items():
        t0 = time.perf_counter()
        out = serving.predict_audio_clips(ckpt_audio_config(root, os.path.join(tmp, backend), seed, backend),
                                          result["best_checkpoint"], test, TRAIN_BATCH, device=DEVICE)
        served[backend] = np.asarray([r["logits"] for r in out])
        log("ckpt", f"(a) served {len(test)} test clips from {os.path.basename(result['best_checkpoint'])} "
                    f"({tree_bytes(result['best_checkpoint']) / 2**20:.1f} MiB) in "
                    f"{(time.perf_counter() - t0) * 1e3:.1f} ms (read, build, featurize, classify)")
    ok = (served["orbax_async"].shape == (len(test), len(WORDS)) and np.isfinite(served["msgpack"]).all()
          and np.array_equal(served["orbax_async"], served["msgpack"]))
    log("ckpt", f"(a) logits served from vgg_lstm_best.orbax bit-equal to vgg_lstm_best.pt's: {ok} "
                f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[ckpt] serving the .orbax directory departs from serving the .pt file")
    resumed = audio_pipeline.main(ckpt_audio_config(root, os.path.join(tmp, "orbax_async"), seed, "orbax_async"),
                                  resume=True, device=DEVICE)
    ok = resumed["history"] == [] and resumed["final_test_acc"] == runs["orbax_async"]["final_test_acc"]
    log("ckpt", f"(a) --resume in a fresh main from the async rolling directory: {len(resumed['history'])} epochs "
                f"left to train, final test acc {resumed['final_test_acc']:.2f}% {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[ckpt] resuming from the async rolling checkpoint trained again")
    log("ckpt", f"(a) log-mel kernel launches so far: {logmel_cuda.launch_count}")
    if logmel_cuda.launch_count < 1:
        raise SystemExit("[ckpt] the audio path never launched the log-mel kernel")


def ckpt_graphs(seed: int, root: str, tmp: str) -> None:
    """[ckpt] (c): device-resident vgg_lstm in CUDA graphs of 4 steps with
    orbax_async, each epoch's rolling save written to a directory of its
    own and held to the host snapshot taken when the save returned (the
    next replay changes the parameters and Adam's moments in place)."""
    from multimodal_lipread_torch.models.audio import get_audio_model
    from multimodal_lipread_torch.pipelines.common import load_audio_datasets
    from multimodal_lipread_torch.train import checkpoint as ckpt
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    datasets, _ = load_audio_datasets(root, device=DEVICE)
    snaps: dict = {}
    save = Trainer._save_ckpt

    def save_each_epoch(self, path, tree):
        if "checkpoint" in os.path.basename(path):
            path = path.replace(".orbax", f"_e{tree['epoch']}.orbax")
            save(self, path, tree)
            snaps[path] = self._host_snapshot()["state"]
        else:
            save(self, path, tree)

    trainer = Trainer(get_audio_model("vgg_lstm", len(WORDS), version=VGG_VERSION), TrainerConfig(
        model_name="vgg_lstm", num_classes=len(WORDS), batch_size=TRAIN_BATCH, epochs=CKPT_EPOCHS,
        learning_rate=TRAIN_LR, weight_decay=TRAIN_WD, seed=seed, rolling_checkpoint=True,
        device_resident=True, steps_per_dispatch=GRAPH_K, checkpoint_backend="orbax_async",
        metrics_dir=os.path.join(tmp, "graphs", "metrics"),
        checkpoints_dir=os.path.join(tmp, "graphs", "models_trained")), device=DEVICE)
    Trainer._save_ckpt = save_each_epoch
    try:
        t0 = time.perf_counter()
        trainer.fit(datasets["train"], datasets["val"], None, progress=None)
        torch.cuda.synchronize()
    finally:
        Trainer._save_ckpt = save
    graphs = len(trainer._graphs)
    log("ckpt", f"(c) device-resident vgg_lstm, CUDA graphs of {GRAPH_K} steps ({graphs} captured), orbax_async, "
                f"{CKPT_EPOCHS} epochs in {time.perf_counter() - t0:.2f} s")
    for path, snap in sorted(snaps.items()):
        ok, count, where = trees_equal(ckpt.load_checkpoint_orbax(path)["state"], snap)
        log("ckpt", f"(c) {os.path.basename(path)} bit-equal to the host snapshot taken when its save returned "
                    f"({count} tensors: parameters, statistics, Adam's moments and steps): {ok}"
                    f"{'' if ok else f' (first difference {where})'} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("[ckpt] an async save did not hold the state it was given")
    if len(snaps) != CKPT_EPOCHS or (graphs < 1 and DEVICE == "cuda"):
        raise SystemExit(f"[ckpt] (c) saved {len(snaps)} epochs with {graphs} graphs")


def ckpt_backends(seed: int, cue_root: str, tmp: str, smi: str) -> None:
    """[ckpt] (b): bert-base through ``pipelines.cues.main`` with each
    backend: what ``fit`` blocks in each save, the bytes, the epochs' wall
    time and the waits."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.pipelines import cues as cues_pipeline

    best = {}
    for backend in CKPT_BACKENDS:
        base = os.path.join(tmp, f"cues_{backend}")
        cfg = cues_config(cue_root, base, seed)
        cfg.set("training.checkpoint_backend", backend)
        with checkpoint_clock() as rec:
            t0 = time.perf_counter()
            result = cues_pipeline.main(cfg, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        hist = result["history"]
        if len(hist) != CUES_SET["training.epochs"] or not np.isfinite([h["train_loss"] for h in hist]).all():
            raise SystemExit(f"[ckpt] (b) bert-base with {backend} gave {len(hist)} epochs")
        ckpts = os.path.join(base, "models_trained")
        sizes = {name: round(tree_bytes(os.path.join(ckpts, name)) / 2**20, 1) for name in sorted(os.listdir(ckpts))}
        log("ckpt", f"(b) bert-base, pipelines.cues.main {len(hist)} epochs with rolling checkpoints, "
                    f"checkpoint_backend {backend}: {wall:.2f} s; fit blocked in each save "
                    f"{[round(ms, 1) for ms in rec['save']]} ms, after each export (parameters to the host) "
                    f"{[round(ms, 1) for ms in rec['export']]} ms; waits {[round(ms, 1) for ms in rec['wait']]} ms; "
                    f"epoch train+val {[round(h['seconds'], 3) for h in hist]} s, epoch start to next start (last: "
                    f"to fit's end) {[round(s, 3) for s in epoch_walls(rec)]} s; on disk {sizes} MiB | {smi}")
        best[backend] = (cfg, os.path.join(ckpts, "bert_best." + ("pt" if backend == "msgpack" else "orbax")))
        torch.cuda.empty_cache()
    # a serving call's checkpoint load: the .pt file memory-mapped (Adam's
    # moments unpickled, not read) against the .orbax directory's weights
    # only, each into a model built on meta and moved to the card, in turns
    ms: dict = {b: [] for b in ("msgpack", "orbax")}
    for _ in range(3):
        for backend in ms:
            cfg, path = best[backend]
            t0 = time.perf_counter()
            model, _ = serving.load_model(functools.partial(serving.build_model, "cues", cfg), path, DEVICE)
            torch.cuda.synchronize()
            ms[backend].append((time.perf_counter() - t0) * 1e3)
            del model
    log("ckpt", f"(b) serving.load_model of the bert-base best checkpoint onto the card, 3 turns (page cache warm): "
                f".pt {[round(x, 1) for x in ms['msgpack']]} ms, .orbax {[round(x, 1) for x in ms['orbax']]} ms | {smi}")


def ckpt_ranks(ddp: dict) -> None:
    """[ckpt] (d): the directories [ddp]'s runs wrote with orbax_async (one
    per run, shared by its ranks, each item written once, holding rank 0's
    model), and (b)'s resumed at world 1 without a process group."""
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.pipelines import audio as audio_pipeline
    from multimodal_lipread_torch.train import checkpoint as ckpt
    from torch.distributed.checkpoint import FileSystemReader

    for label, ranks in ddp["runs"].items():
        ckpts = os.path.join(ddp["base"], ranks[0]["label"], "models_trained")
        for name in ("vgg_lstm_best.orbax", "vgg_lstm_checkpoint.orbax"):
            path = os.path.join(ckpts, name)
            files = sorted(os.listdir(path))
            storage = FileSystemReader(path).read_metadata().storage_data
            written = sum(os.path.getsize(os.path.join(path, f)) for f in files if f.endswith(".distcp"))
            once = sum(i.length for i in storage.values()) == written
            ok = files == [".metadata"] + [f"__{r}_0.distcp" for r in range(len(ranks))] and once
            line = f"(d) {label}: {name} files {files}, {written / 2**20:.1f} MiB of data, each item written once: {once}"
            if "checkpoint" in name:
                same, count, where = trees_equal(ckpt.load_checkpoint_orbax(path, ckpt.SERVING_KEYS)["state"],
                                                 ranks[0]["state"])
                ok = ok and same
                line += f"; parameters and statistics bit-equal to rank 0's model after fit ({count} tensors): {same}"
            log("ckpt", f"{line} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"[ckpt] (d) {label}'s {name} is not the one shared directory of its ranks")
    cfg = Config.from_dict(ddp["config"])
    cfg.set("output.base_dir", os.path.join(ddp["base"], ddp["runs"]["(b)"][0]["label"]))
    resumed = audio_pipeline.main(cfg, resume=True, device=DEVICE)
    ok = resumed["history"] == []
    log("ckpt", f"(d) (b)'s world-2 rolling directory resumed at world 1 without a process group: "
                f"{len(resumed['history'])} epochs left to train {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[ckpt] (d) the world-2 orbax checkpoint did not resume at world 1")


def phase_ckpt(seed: int, device_info: dict, tmp: str, cue_root: str, ddp: dict) -> int:
    """The orbax checkpoint backends on the card, (a) to (d); returns the
    log-mel kernel's launches in the phase."""
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.ops import logmel_cuda

    tmp = os.path.join(tmp, "ckpt")
    root = make_synthetic_glips(os.path.join(tmp, "GLips_4"), words=WORDS, clips_per_split=TRAIN_CLIPS_PER_SPLIT,
                                seed=seed)
    logmel_cuda.launch_count = 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ckpt_audio(seed, root, tmp)
        ckpt_graphs(seed, root, tmp)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    ckpt_backends(seed, cue_root, tmp, device_info["smi"])
    ckpt_ranks(ddp)
    launches = logmel_cuda.launch_count
    log("ckpt", f"log-mel kernel launches in the phase: {launches}")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    t_run = time.perf_counter()
    device_info = timed("device", phase_device)
    built = timed("build", phase_build)
    seed = args.seed
    kernel = timed("kernel", phase_kernel, seed)
    crop = timed("crop-kernel", phase_crop_kernel, seed, device_info, built["crop_resize"].ptxas_lines())
    launches = timed("serve", phase_serve, seed, device_info)
    train = timed("train", phase_train, seed, device_info)
    launches += train["launches"]
    tmp = tempfile.mkdtemp(prefix="mlt_chip_smoke_")
    try:
        stream = timed("stream-train", phase_stream_train, seed, device_info, tmp)
        launches += stream["launches"]
        video = timed("video-train", phase_video_train, seed, device_info, tmp)
        timed("video-serve", phase_video_serve, video, device_info)
        crop_launches = timed("crop-train", phase_crop_train, seed, device_info, tmp)["launches"]
        crop_launches += timed("mp4", phase_mp4, seed, device_info, tmp)
        launches += timed("native-stream", phase_native_stream, seed, device_info, stream, video)
        load_mel, load_crop = timed("load-test", phase_load_test, seed, device_info, stream, video)
        launches += load_mel
        crop_launches += load_crop
        launches += timed("export", phase_export, device_info, stream)
        av = timed("av-train", phase_av_train, seed, device_info, tmp)
        launches += av["launches"]
        launches += timed("av-serve", phase_av_serve, av, device_info)
        cues = timed("cues-train", phase_cues_train, seed, device_info, tmp)
        timed("cues-serve", phase_cues_serve, cues, device_info)
        ac = timed("ac-train", phase_ac_train, seed, device_info, tmp)
        launches += ac["launches"]
        launches += timed("ac-serve", phase_ac_serve, ac, device_info)
        cv = timed("cv-train", phase_cv_train, seed, device_info, tmp)
        timed("cv-serve", phase_cv_serve, cv, device_info)
        acv = timed("acv-train", phase_acv_train, seed, device_info, cv)
        launches += acv["launches"]
        launches += timed("acv-serve", phase_acv_serve, acv, device_info)
        launches += timed("serve-cold", phase_serve_cold, device_info, cv, acv, cues)
        launches += timed("frozen", phase_frozen, seed, device_info, acv)
        timed("graphs", phase_graphs, seed, device_info, tmp, {
            "audio_video": av["datasets"]["train"], "audio_cues_video": acv["datasets"]["train"],
            "cues": cues["datasets"]["train"], "audio_cues": ac["datasets"]["train"]})
        ddp = timed("ddp", phase_ddp, seed, device_info, tmp)
        ckpt_launches = timed("ckpt", phase_ckpt, seed, device_info, tmp, cues["root"], ddp)
        timed("tp", phase_tp, seed, device_info, tmp)
        timed("pp", phase_pp, seed, device_info)
        dp_launches = timed("dp-serve", phase_dp_serve, seed, device_info)
        launches += ddp["launches"] + ckpt_launches + dp_launches
        timed("zoo", phase_zoo, seed, device_info, av, video["best"], tmp, cues, ac, cv, acv)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("run", f"all phases in {time.perf_counter() - t_run:.1f} s")
    row = kernel["rows"][SERVE_BATCH]
    print(json.dumps({"kernels": [{
        "name": "logmel",
        "route": "cuda",
        "source": "multimodal_lipread_torch/csrc/logmel.cu",
        "replaces": "multimodal_lipread_tpu/ops/logmel_pallas.py:107",
        "launches": launches,
        "max_abs_err": max(kernel["max_abs_err"], train["max_abs_err"], av["max_abs_err"], ac["max_abs_err"],
                           acv["max_abs_err"]),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "paths": ["serve", "train", "stream-train", "native-stream", "load-test", "export", "av-train", "av-serve",
                  "ac-train", "ac-serve", "acv-train", "acv-serve", "serve-cold", "frozen", "ddp", "ckpt",
                  "dp-serve"],
    }, {
        "name": "crop_resize",
        "route": "cuda",
        "source": "multimodal_lipread_torch/csrc/crop_resize.cu",
        "replaces": "multimodal_lipread_tpu/ops/crop_resize.py:139",
        "launches": crop_launches,
        "max_abs_err": crop["max_abs_err"],
        "ms": crop["rows"][CROP_CLIPS[0]]["ms"],
        "plain_ms": crop["rows"][CROP_CLIPS[0]]["plain_ms"],
        "bound_ms": crop["rows"][CROP_CLIPS[0]]["bound_ms"],
        "bound_by": crop["rows"][CROP_CLIPS[0]]["bound_by"],
        "library_ms": crop["rows"][CROP_CLIPS[0]]["library_ms"],
        "paths": ["crop-train", "mp4", "load-test"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
