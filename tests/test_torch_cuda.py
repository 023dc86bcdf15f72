"""The port's CUDA kernels on the card, against their plain versions, and
the training and serving paths there: train steps on the card against the
CPU (audio vgg_lstm and video resnet_trans), the video model's forward and
the uint8 path of ``Predictor`` against the CPU, the BiLSTM's dropout
masks, the native WAV decoder's build, and the audio_video path (its
featurization through the log-mel kernel, a full-width train step, and
``predict_clips`` against the CPU).

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
from multimodal_lipread_torch.models.video import get_video_model
from multimodal_lipread_torch.ops import logmel_cuda
from multimodal_lipread_torch.ops.logmel import NUM_SAMPLES, log_mel_reference
from multimodal_lipread_torch.utils.precision import model_precision

TOL = 1e-4  # the JAX package's Pallas-vs-XLA bound (tests/test_logmel.py)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda")  # TF32 left at the process default: the path sets its own precision


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
    before = logmel_cuda.launch_count
    with pytest.raises(ValueError, match="no backward"):  # the kernel takes no gradient
        logmel_cuda.log_mel(wave.clone().requires_grad_())
    assert logmel_cuda.launch_count == before


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
    with torch.inference_mode(), model_precision(torch.float32):
        got = WaveToLogMel(net, 117)(wave)
        want = net(log_mel_reference(wave, True)[:, :80, :117])
    assert logmel_cuda.launch_count == before + 1
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_logmel_kernel_at_the_featurization_batches(cuda_device):
    # training featurizes each split in chunks of 256 clips and a ragged rest
    wave = _waves(272, cuda_device, seed=9)
    before = logmel_cuda.launch_count
    full = logmel_cuda.log_mel(wave[:256], True)
    rest = logmel_cuda.log_mel(wave[256:], True)
    torch.cuda.synchronize()
    assert logmel_cuda.launch_count == before + 2
    torch.testing.assert_close(full, log_mel_reference(wave[:256], True), rtol=0, atol=TOL)
    torch.testing.assert_close(rest, log_mel_reference(wave[256:], True), rtol=0, atol=TOL)


@pytest.mark.cuda
def test_train_steps_on_the_card_match_the_cpu(cuda_device, tmp_path):
    from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

    # lr 3e-5: Adam's first steps move nearly every weight by ±lr, so two
    # correct float32 runs part in proportion to lr (tests/test_torch_trainer.py)
    rng = np.random.default_rng(3)
    ds = ArrayDataset((rng.standard_normal((20, 80, 32)).astype(np.float32),), rng.integers(0, 4, 20).astype(np.int32))
    losses = {}
    for device in ("cuda", "cpu"):
        cfg = TrainerConfig(model_name="m", num_classes=4, batch_size=8, learning_rate=3e-5, seed=0,
                            metrics_dir=str(tmp_path / device / "m"), checkpoints_dir=str(tmp_path / device / "c"))
        trainer = Trainer(VGGWithLSTMClassifier(4, version=11, lstm_hidden=16, dropout_rate=0.0), cfg, device=device)
        trainer.init_state()
        out = [trainer.train_step(*batch).tolist() for batch in trainer.batches(ds, True, np.random.default_rng(0))]
        losses[device] = np.asarray([a[0] / a[3] for a in out])
        assert all(p.device.type == device for p in trainer.model.parameters())
    assert len(losses["cuda"]) == 3
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)


@pytest.mark.cuda
def test_the_path_sets_float32_precision_itself(cuda_device, tmp_path):
    # With TF32 allowed in the process (cuDNN's default), a float32 model's
    # forward and backward in Predictor and Trainer run without it, and the
    # process's setting is back afterwards.
    from multimodal_lipread_torch.serving import Predictor
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def flags():
        return cudnn.allow_tf32, matmul.allow_tf32

    saved = flags()
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        net = VGGWithLSTMClassifier(4, version=11, lstm_hidden=16, dropout_rate=0.0)
        seen = []
        net.register_forward_hook(lambda *_: seen.append(("forward", flags())))
        net.register_full_backward_hook(lambda *_: seen.append(("backward", flags())))
        Predictor(net, batch_size=4, device="cuda").predict_logits(np.zeros((4, 80, 32), np.float32))
        assert flags() == (True, True)
        cfg = TrainerConfig(model_name="m", num_classes=4, batch_size=4, seed=0,
                            metrics_dir=str(tmp_path / "m"), checkpoints_dir=str(tmp_path / "c"))
        trainer = Trainer(net, cfg, device="cuda")
        trainer.init_state()
        inputs = (torch.zeros((4, 80, 32), device="cuda"),)
        trainer.train_step(inputs, torch.zeros(4, dtype=torch.long, device="cuda"), torch.ones(4, device="cuda"))
        assert flags() == (True, True)
        assert [kind for kind, _ in seen] == ["forward", "forward", "backward"]
        assert all(f == (False, False) for _, f in seen), seen
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_native_decoder_builds_and_decodes(cuda_device, tmp_path):
    from multimodal_lipread_torch.data import audio_io, native_io
    from multimodal_lipread_torch.pipelines.common import decode_waveforms

    rng = np.random.default_rng(5)
    paths = []
    for i, n in enumerate((100, 20000, 25000)):
        paths.append(str(tmp_path / f"x{i}.wav"))
        audio_io.write_wav(paths[-1], rng.integers(-30000, 30000, n).astype(np.float32))
    assert native_io.get_lib() is not None and native_io.library_path().is_file()
    want = np.stack([audio_io.load_waveform(p) for p in paths])
    np.testing.assert_array_equal(decode_waveforms(paths), want)


def _resnet_trans(seed=0):
    from multimodal_lipread_torch.nn.common import flax_init_

    return flax_init_(get_video_model("resnet_trans", 4), torch.Generator().manual_seed(seed))


def _lips(n, t=29, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, t, 44, 44, 3)).astype(np.uint8)


@pytest.mark.cuda
def test_resnet_trans_forward_on_the_card_matches_the_cpu(cuda_device):
    # visual_config.yaml's widths; float32 without TF32 on both (model_precision)
    net = _resnet_trans().eval()
    x = torch.from_numpy(_lips(2)).float() / 255.0
    with torch.no_grad(), model_precision(torch.float32):
        want = net(x)
        got = net.to(cuda_device)(x.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_video_train_step_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

    # lr 1e-5: two correct float32 runs part in proportion to lr (chip_smoke.py)
    ds = ArrayDataset((_lips(8, t=5, seed=1),), np.arange(8, dtype=np.int32) % 4)
    losses = {}
    for device in ("cuda", "cpu"):
        cfg = TrainerConfig(model_name="m", num_classes=4, batch_size=4, learning_rate=1e-5, weight_decay=1e-5,
                            seed=0, metrics_dir=str(tmp_path / device / "m"),
                            checkpoints_dir=str(tmp_path / device / "c"))
        trainer = Trainer(get_video_model("resnet_trans", 4, dropout=0.0), cfg, device=device)
        trainer.init_state()
        out = [trainer.train_step(*batch).tolist() for batch in trainer.batches(ds, True, np.random.default_rng(0))]
        losses[device] = np.asarray([a[0] / a[3] for a in out])
    assert len(losses["cuda"]) == 2
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)


@pytest.mark.cuda
def test_predictor_takes_uint8_lips_on_the_card(cuda_device):
    from multimodal_lipread_torch.serving import Predictor

    lips = _lips(5, t=29, seed=2)
    net = _resnet_trans(1)
    want = Predictor(net, batch_size=4, device="cpu").predict_logits(lips)
    card = Predictor(net, batch_size=4, device="cuda")
    got = card.predict_logits(lips)  # 5 clips: one full batch and one padded
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(card.predict_logits(lips.astype(np.float32) / 255.0), got, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_bilstm_dropout_masks_come_from_the_trainers_generator_on_the_card(cuda_device):
    from multimodal_lipread_torch.nn import BiLSTM

    lstm = BiLSTM(12, 8, num_layers=2, dropout=0.5).to(cuda_device).train()
    x = torch.randn(3, 6, 12, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    lstm.dropout.generator = gen
    state = torch.cuda.get_rng_state()
    gen.manual_seed(1)
    a = lstm(x)
    gen.manual_seed(1)
    b = lstm(x)
    gen.manual_seed(2)
    c = lstm(x)
    assert torch.equal(torch.cuda.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture
def av_corpus(tmp_path):
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips

    return make_synthetic_glips(str(tmp_path / "GLips_4"), clips_per_split=3, seed=4, with_lip_regions=True)


@pytest.mark.cuda
def test_av_featurization_launches_the_kernel(cuda_device, av_corpus):
    from multimodal_lipread_torch.data.glips import align_modalities, lip_regions_root, scan_glips, scan_lip_regions
    from multimodal_lipread_torch.pipelines.audio_video import load_av_datasets
    from multimodal_lipread_torch.pipelines.common import decode_waveforms

    before = logmel_cuda.launch_count
    datasets, classes = load_av_datasets(av_corpus, lip_regions_root(av_corpus), device="cuda")
    assert logmel_cuda.launch_count == before + 3  # one launch per split of 12 clips
    pairs = align_modalities(scan_glips(av_corpus), scan_lip_regions(lip_regions_root(av_corpus)), split="test")
    wave = torch.from_numpy(decode_waveforms([a.path for a, _v in pairs])).to(cuda_device)
    want = log_mel_reference(wave, True)[:, :80, :117].cpu().numpy()
    mels, lips = datasets["test"].inputs
    assert mels.shape == (12, 80, 117) and lips.dtype == np.uint8 and len(classes) == 4
    np.testing.assert_allclose(mels, want, rtol=0, atol=TOL)


@pytest.mark.cuda
def test_av_train_step_on_the_card_is_finite(cuda_device, tmp_path):
    # av_config.yaml's middle_fusion_mobilenet at its widths, batch 8
    from multimodal_lipread_torch.models.audio_video import get_av_model
    from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

    rng = np.random.default_rng(6)
    ds = ArrayDataset((rng.standard_normal((8, 80, 117)).astype(np.float32), _lips(8, seed=6)),
                      np.arange(8, dtype=np.int32) % 4)
    cfg = TrainerConfig(model_name="m", num_classes=4, batch_size=8, learning_rate=1e-4, weight_decay=0.0,
                        seed=0, metrics_dir=str(tmp_path / "m"), checkpoints_dir=str(tmp_path / "c"))
    trainer = Trainer(get_av_model("middle_fusion_mobilenet", 4), cfg, device="cuda")
    trainer.init_state()
    (batch,) = list(trainer.batches(ds, True, np.random.default_rng(0)))
    loss_sum, _c, _n, wsum = trainer.train_step(*batch).tolist()
    assert np.isfinite(loss_sum) and wsum == 8.0
    assert all(p.device.type == "cuda" and torch.isfinite(p).all() for p in trainer.model.parameters())


@pytest.mark.cuda
def test_predict_clips_audio_video_on_the_card_matches_the_cpu(cuda_device, av_corpus, tmp_path):
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.data.glips import align_modalities, lip_regions_root, scan_glips, scan_lip_regions
    from multimodal_lipread_torch.nn.common import flax_init_
    from multimodal_lipread_torch.train.checkpoint import module_state, save_checkpoint

    cfg = Config.from_dict({"dataset": {"root_dir": av_corpus, "num_classes": 4, "audio_input_size": 117},
                            "model": {"name": "middle_fusion_mobilenet"}})
    model = flax_init_(serving.build_model("audio_video", cfg), torch.Generator().manual_seed(2))
    ckpt = str(tmp_path / "m.pt")
    save_checkpoint(ckpt, {"epoch": 1, "state": module_state(model), "val_acc": 0.0})
    pairs = align_modalities(scan_glips(av_corpus), scan_lip_regions(lip_regions_root(av_corpus)), split="test")
    groups = [[a.path, v.path] for a, v in pairs]
    before = logmel_cuda.launch_count
    card = serving.predict_clips(cfg, ckpt, "audio_video", groups, batch_size=8, device="cuda")
    assert logmel_cuda.launch_count == before + 1
    cpu = serving.predict_clips(cfg, ckpt, "audio_video", groups, batch_size=8, device="cpu")
    np.testing.assert_allclose([r["logits"] for r in card], [r["logits"] for r in cpu], rtol=1e-3, atol=1e-3)
    assert [r["paths"] for r in card] == groups
