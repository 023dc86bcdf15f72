"""The port's CUDA kernels on the card, against their plain versions, and
the training and serving paths there: train steps on the card against the
CPU (audio vgg_lstm and video resnet_trans), the video model's forward and
the uint8 path of ``Predictor`` against the CPU, the BiLSTM's dropout
masks, the native WAV decoder's build, the audio_video path (its
featurization through the log-mel kernel, a full-width train step, and
``predict_clips`` against the CPU), and the cue paths (a bert-base forward
on padded ids and an audio_cues train step against the CPU, int32 ids
through the ``Predictor``), and the frozen encoders of the audio_cues_video
models (frozen parameters bit-equal over card steps, ``frozen_bn_eval``
through ``model.train()``) and that pipeline's featurization through the
log-mel kernel; the lip-crop kernel against its plain version bit for bit
(any channel count and canvas, every cluster size, a wide frame staged in
chunks, frames off a 16-byte boundary, inside a CUDA graph), its launch
count and phase times, device-crop train steps against plain-crop ones,
the crop inside CUDA graphs of resident resnet_trans steps against the
same steps eager, CUDA-graphed train steps
against eager ones (dropout on), capturable optimizer checkpoints resuming
exactly and loading into a host-batching trainer and back, graphed
``remat`` steps against eager remat and plain ones and graphed mixup steps
against eager ones; the log-mel operator ``mlt::log_mel`` launching the
kernel, an exported (``torch.export``) wave model launching it, and
``serving.load_test`` with the device crop launching the crop kernel once a
request; the ``Predictor``'s CUDA graphs (served waveforms at 1, 7, 32 and
40 clips, four server threads at once, the device crop, int32 ids, two
replicas on one card) against the model called eagerly on the same padded
batch, ``serve.replays`` one a batch, and a forward that waits for the card
staying eager; a world-1 NCCL data-parallel step against the step without a
process group, and BatchNorm's global statistics over two gloo ranks
sharing the card against one rank, and CUDA graphs of DDP steps with the
NCCL all-reduce captured against eager steps (ranks from
``tests/torch_dist_worker.py``).

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


def _bert_base():
    from multimodal_lipread_torch.models.cues import get_cue_model
    from multimodal_lipread_torch.nn.common import flax_init_

    return flax_init_(get_cue_model("bert", 4, bert_size="base"), torch.Generator().manual_seed(3)).eval()


def _padded_ids(n, length=32, seed=0):
    from multimodal_lipread_torch.models.bert import HashingTokenizer

    rng = np.random.default_rng(seed)
    words = ("calm", "tense", "speaker", "mouth", "rapid", "slow", "lighting", "bright", "plain", "the")
    texts = [" ".join(rng.choice(words, size=int(rng.integers(1, 40)))) for _ in range(n)]
    return HashingTokenizer(8192, length)(texts)


@pytest.mark.cuda
def test_bert_base_forward_on_the_card_matches_the_cpu(cuda_device):
    # cues_config's bert at bert-base width on padded int32 ids, float32 without TF32 on both
    net = _bert_base()
    ids = torch.from_numpy(np.concatenate([_padded_ids(5), np.zeros((1, 32), np.int32)]))  # and an all-padding row
    assert (ids[:-1] == 0).any() and not ids[-1].any()  # padded rows, and one of padding only
    with torch.no_grad(), model_precision(torch.float32):
        want = net(ids)
        got = net.to(cuda_device)(ids.to(cuda_device)).cpu()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_audio_cues_train_step_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    from multimodal_lipread_torch.models.audio_cues import get_audio_cues_model
    from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

    # ac_config.yaml's middle_fusion_mobile at its widths; lr 1e-5 as above
    rng = np.random.default_rng(7)
    ds = ArrayDataset((rng.standard_normal((16, 80, 117)).astype(np.float32),
                       (rng.standard_normal((16, 768)) * 0.05).astype(np.float32)), np.arange(16, dtype=np.int32) % 4)
    losses = {}
    for device in ("cuda", "cpu"):
        cfg = TrainerConfig(model_name="m", num_classes=4, batch_size=8, learning_rate=1e-5, weight_decay=0.0,
                            seed=0, metrics_dir=str(tmp_path / device / "m"),
                            checkpoints_dir=str(tmp_path / device / "c"))
        model = get_audio_cues_model("middle_fusion_mobile", 4)
        for m in model.modules():  # dropout masks cannot agree across devices
            if hasattr(m, "rate"):
                m.rate = 0.0
        trainer = Trainer(model, cfg, device=device)
        trainer.init_state()
        out = [trainer.train_step(*batch).tolist() for batch in trainer.batches(ds, True, np.random.default_rng(0))]
        losses[device] = np.asarray([a[0] / a[3] for a in out])
    assert len(losses["cuda"]) == 2 and np.isfinite(losses["cuda"]).all()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)


@pytest.mark.cuda
def test_predictor_takes_int32_ids_on_the_card(cuda_device):
    from multimodal_lipread_torch.models.bert import BertClassifier, bert_small_config
    from multimodal_lipread_torch.nn.common import flax_init_
    from multimodal_lipread_torch.serving import Predictor

    net = flax_init_(BertClassifier(bert_small_config(), 4), torch.Generator().manual_seed(4))
    seen = []
    net.embeddings.word_embeddings.register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
    ids = _padded_ids(5, seed=1)
    want = Predictor(net, batch_size=4, device="cpu").predict_logits(ids)
    got = Predictor(net, batch_size=4, device="cuda").predict_logits(ids)  # one full batch, one padded
    assert seen == [torch.int32] * 4
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def _frozen_trainer(tmp_path, frozen_bn_eval, weight_decay=1e-3):
    # acv_config's early_fusion_mobile: audio ResNet18 and video MobileNetV2 frozen
    from multimodal_lipread_torch.models.audio_cues_video import FROZEN_PARAM_PREFIXES, get_triple_model
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    cfg = TrainerConfig(model_name="m", num_classes=4, batch_size=8, learning_rate=1e-3,
                        weight_decay=weight_decay, seed=0, frozen_param_prefixes=FROZEN_PARAM_PREFIXES[
                            "early_fusion_mobile"],
                        metrics_dir=str(tmp_path / "m"), checkpoints_dir=str(tmp_path / "c"))
    trainer = Trainer(get_triple_model("early_fusion_mobile", 4, frozen_bn_eval=frozen_bn_eval), cfg, device="cuda")
    trainer.init_state()
    return trainer


def _triple_batch(trainer, seed=7):
    from multimodal_lipread_torch.train.trainer import ArrayDataset

    rng = np.random.default_rng(seed)
    ds = ArrayDataset((rng.standard_normal((8, 80, 117)).astype(np.float32),
                       (rng.standard_normal((8, 768)) * 0.05).astype(np.float32), _lips(8, seed=seed)),
                      np.arange(8, dtype=np.int32) % 4)
    (batch,) = list(trainer.batches(ds, True, np.random.default_rng(0)))
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("frozen_bn_eval", [False, True])
def test_frozen_parameters_stay_bit_equal_over_card_steps(cuda_device, tmp_path, frozen_bn_eval):
    trainer = _frozen_trainer(tmp_path, frozen_bn_eval)
    start = {k: t.clone() for k, t in trainer.model.state_dict().items()}
    frozen = trainer.frozen_names()
    batch = _triple_batch(trainer)
    for _ in range(3):
        loss_sum, _c, _n, wsum = trainer.train_step(*batch).tolist()
        assert np.isfinite(loss_sum)
    end = trainer.model.state_dict()
    assert frozen and all(torch.equal(end[k], start[k]) for k in frozen)
    assert not torch.equal(end["fc1.weight"], start["fc1.weight"])
    stats = [k for k in end if k.startswith(("audio.resnet.", "video.cnn.")) and "running_" in k]
    moved = [k for k in stats if not torch.equal(end[k], start[k])]
    # frozen_bn_eval keeps the frozen BatchNorms on their running statistics through model.train()
    assert (moved == []) if frozen_bn_eval else (len(moved) == len(stats))


@pytest.mark.cuda
def test_frozen_bn_eval_survives_model_train_on_the_card(cuda_device, tmp_path):
    trainer = _frozen_trainer(tmp_path, frozen_bn_eval=True)
    batch = _triple_batch(trainer, seed=8)
    trainer.train_step(*batch)  # calls model.train()
    model = trainer.model
    assert model.training and model.fc1.training
    assert not any(m.training for m in list(model.audio.resnet.modules()) + list(model.video.cnn.modules()))
    with torch.no_grad():  # the frozen encoders give their eval-mode features in a training step
        x = tuple(trainer._prepare(t) for t in batch[0])
        with model_precision(torch.float32):
            train_feats = model(*x, return_frozen_features=True)
            model.eval()
            eval_feats = model(*x, return_frozen_features=True)
    for a, b in zip(train_feats, eval_feats):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_audio_cues_video_corpus_features_from_the_kernel(cuda_device, tmp_path):
    from multimodal_lipread_torch.data.cues import load_cue_records, records_by_key
    from multimodal_lipread_torch.data.glips import align_modalities, lip_regions_root, scan_glips, scan_lip_regions
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.pipelines.audio_cues_video import load_triple_datasets
    from multimodal_lipread_torch.pipelines.common import decode_waveforms

    root = make_synthetic_glips(str(tmp_path / "GLips_4"), clips_per_split=3, seed=9, with_lip_regions=True,
                                with_cues=True)
    before = logmel_cuda.launch_count
    datasets, classes = load_triple_datasets(root, root, lip_regions_root(root), device="cuda")
    assert logmel_cuda.launch_count == before + 3  # one launch per split of 12 clips
    cue_map = records_by_key(load_cue_records(root, "emotion"))
    pairs = [(a, v) for a, v in align_modalities(scan_glips(root), scan_lip_regions(lip_regions_root(root)),
                                                 split="val") if a.key in cue_map]
    wave = torch.from_numpy(decode_waveforms([a.path for a, _v in pairs])).to(cuda_device)
    want = log_mel_reference(wave, True)[:, :80, :117].cpu().numpy()
    mels, cues, lips = datasets["val"].inputs
    assert mels.shape == (12, 80, 117) and cues.shape == (12, 768) and lips.dtype == np.uint8 and len(classes) == 4
    np.testing.assert_allclose(mels, want, rtol=0, atol=TOL)


# --- the crop kernel, the device crop and CUDA graphs -------------------------


def _frames_and_boxes(n, device, seed=0, h=256, w=256):
    """uint8 frames and margin-expanded boxes, a failed detection first."""
    from multimodal_lipread_torch.ops.crop_resize import expand_boxes

    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)).to(device)
    x0, y0 = rng.integers(0, w - 40, n), rng.integers(0, h - 40, n)
    raw = np.stack([x0, y0, np.minimum(x0 + rng.integers(12, 110, n), w),
                    np.minimum(y0 + rng.integers(8, 70, n), h)], -1).astype(np.int32)
    boxes = expand_boxes(torch.from_numpy(raw), h, w)
    boxes[0] = 0
    return frames, boxes.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 29, 464])
@pytest.mark.parametrize("normalize", [False, True])
def test_crop_kernel_matches_plain_version(cuda_device, frames, normalize):
    from multimodal_lipread_torch.ops import crop_resize_cuda
    from multimodal_lipread_torch.ops.crop_resize import (
        crop_resize_pad_normalize_reference,
        crop_resize_pad_reference,
    )

    x, boxes = _frames_and_boxes(frames, cuda_device, seed=frames)
    kernel = crop_resize_cuda.crop_resize_pad_normalize if normalize else crop_resize_cuda.crop_resize_pad
    plain = crop_resize_pad_normalize_reference if normalize else crop_resize_pad_reference
    before = crop_resize_cuda.launch_count
    got = kernel(x, boxes)
    torch.cuda.synchronize()
    assert crop_resize_cuda.launch_count == before + 1
    assert got.shape == (frames, 44, 44, 3) and (got[0] == 0).all()
    torch.testing.assert_close(got, plain(x, boxes), rtol=0, atol=0)  # bit for bit


@pytest.mark.cuda
def test_crop_kernel_keeps_leading_axes_and_refuses_what_it_does_not_take(cuda_device):
    from multimodal_lipread_torch.ops import crop_resize_cuda

    x, boxes = _frames_and_boxes(12, cuda_device, seed=3, h=72, w=96)
    video = crop_resize_cuda.crop_resize_pad(x.reshape(3, 4, 72, 96, 3), boxes.reshape(3, 4, 4))
    torch.testing.assert_close(video.reshape(12, 44, 44, 3), crop_resize_cuda.crop_resize_pad(x, boxes))
    with pytest.raises(TypeError, match="int32"):
        crop_resize_cuda.crop_resize_pad(x, boxes.long())
    with pytest.raises(ValueError, match="one device"):
        crop_resize_cuda.crop_resize_pad(x, boxes.cpu())


def _crop_case(n, device, seed, h=256, w=256, c=3):
    """uint8 frames and ``chip_smoke.crop_boxes``' boxes (random mouths, a
    failed detection, a negative width, edges, the whole frame, a square and
    an exact 44 x 44)."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)).to(device)
    return frames, torch.from_numpy(chip_smoke.crop_boxes(rng, n, h, w)).to(device)


def _crop_equal(frames, boxes, target=(44, 44), **launch):
    """The kernel against the plain version in both modes, bit for bit (the
    stated tolerance is 1 LSB; 0 differing values expected)."""
    from multimodal_lipread_torch.ops import crop_resize_cuda
    from multimodal_lipread_torch.ops.crop_resize import (
        crop_resize_pad_normalize_reference,
        crop_resize_pad_reference,
    )

    for normalize, plain in ((False, crop_resize_pad_reference), (True, crop_resize_pad_normalize_reference)):
        got = crop_resize_cuda.crop(frames, boxes, target, normalize=normalize, **launch)
        torch.cuda.synchronize()
        want = plain(frames, boxes, target)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert int((got != want).sum()) == 0, f"normalize={normalize}: {int((got != want).sum())} values differ"


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("target", [(44, 44), (32, 48), (45, 37)])
def test_crop_kernel_takes_any_channels_and_canvas(cuda_device, channels, target):
    # rows of 122 * C bytes start off 16-byte boundaries (C = 1, 2, 3)
    frames, boxes = _crop_case(29, cuda_device, seed=channels, h=90, w=122, c=channels)
    _crop_equal(frames, boxes, target)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 29, 464, 928])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_crop_kernel_matches_plain_version_at_every_cluster_size(cuda_device, frames, cluster):
    x, boxes = _crop_case(frames, cuda_device, seed=frames + cluster)
    _crop_equal(x, boxes, cluster=cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster, cap", [(2, None), (4, None), (1, 4096), (2, 64)])
def test_crop_kernel_stages_a_wide_frame_in_chunks(cuda_device, cluster, cap):
    from multimodal_lipread_torch.ops import crop_resize_cuda

    frames, boxes = _crop_case(6, cuda_device, seed=11, h=1080, w=1920)
    boxes[1] = torch.tensor([0, 0, 1920, 1080])  # the whole frame: a band's window exceeds the stage
    plan = crop_resize_cuda.staging_plan(boxes, 1080, 1920, 3, cluster=cluster,
                                         stage=crop_resize_cuda.stage_bytes(
                                             1080, 1920, 3, cluster=cluster,
                                             cap=cap or crop_resize_cuda.STAGE_CAP))
    assert len(plan[1]) > cluster  # more than one round a band
    _crop_equal(frames, boxes, cluster=cluster, stage_cap=cap or crop_resize_cuda.STAGE_CAP)


@pytest.mark.cuda
def test_crop_kernel_takes_frames_off_a_16_byte_boundary(cuda_device):
    frames, boxes = _crop_case(29, cuda_device, seed=5)
    flat = torch.empty(frames.numel() + 5, dtype=torch.uint8, device=cuda_device)
    shifted = flat[5:].view(frames.shape)  # contiguous, its data 5 bytes past an aligned address
    shifted.copy_(frames)
    _crop_equal(shifted, boxes)


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [False, True])
def test_crop_kernel_in_a_cuda_graph_equals_eager(cuda_device, normalize):
    from multimodal_lipread_torch.ops import crop_resize_cuda

    frames, boxes = _crop_case(464, cuda_device, seed=13)
    fn = crop_resize_cuda.crop_resize_pad_normalize if normalize else crop_resize_cuda.crop_resize_pad
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(frames, boxes)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = crop_resize_cuda.launch_count
    with torch.cuda.graph(graph):
        captured = fn(frames, boxes)
    assert crop_resize_cuda.launch_count == before + 1
    frames.copy_(torch.flip(frames, [0]))  # the replay reads the frames as they are then
    boxes.copy_(torch.flip(boxes, [0]))
    graph.replay()
    before = crop_resize_cuda.launch_count
    eager = fn(frames, boxes)
    torch.cuda.synchronize()
    assert crop_resize_cuda.launch_count == before + 1
    assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_crop_kernel_counts_one_launch_a_call(cuda_device):
    from multimodal_lipread_torch.ops import crop_resize_cuda

    frames, boxes = _crop_case(29, cuda_device, seed=17)
    before = crop_resize_cuda.launch_count
    for k in range(1, 4):
        crop_resize_cuda.crop_resize_pad(frames, boxes)
        crop_resize_cuda.device_crop(frames, boxes)
        assert crop_resize_cuda.launch_count == before + 2 * k
    crop_resize_cuda.crop_resize_pad(frames[:0], boxes[:0])  # no frames: no launch
    assert crop_resize_cuda.launch_count == before + 6


@pytest.mark.cuda
def test_crop_kernel_phase_times_cover_the_launch(cuda_device):
    from multimodal_lipread_torch.ops import crop_resize_cuda

    frames, boxes = _crop_case(464, cuda_device, seed=19)
    t = crop_resize_cuda.phase_times(frames, boxes)
    assert set(crop_resize_cuda.PHASES) <= set(t) and t["launch"] >= t["block"] > 0
    cfg = crop_resize_cuda.launch_config()
    assert cfg["cluster"] == crop_resize_cuda.CLUSTER and cfg["max_active_clusters"] > 0 and cfg["local_bytes"] == 0


def _mlp_trainer(tmp_path, tag, device, **cfg):
    from multimodal_lipread_torch.nn.common import MLP
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    cfg = {"epochs": 2, "test_every_epoch": False, **cfg}
    return Trainer(MLP(12, (32, 32), 4, dropout_rate=0.3, use_batchnorm=True), TrainerConfig(
        model_name="m", num_classes=4, batch_size=8, learning_rate=1e-2, seed=3, host_prefetch=0,
        metrics_dir=str(tmp_path / tag / "m"), checkpoints_dir=str(tmp_path / tag / "c"), **cfg), device=device)


def _mlp_data(n, seed):
    from multimodal_lipread_torch.train.trainer import ArrayDataset

    rng = np.random.default_rng(seed)
    return ArrayDataset((rng.standard_normal((n, 12)).astype(np.float32),), rng.integers(0, 4, n))


@pytest.mark.cuda
def test_graphed_steps_equal_eager_steps_with_dropout_on(cuda_device, tmp_path):
    train, val = _mlp_data(44, 0), _mlp_data(40, 1)  # 6 and 5 batches: a group of 4 and a tail
    runs = {}
    for k in (1, 4):
        t = _mlp_trainer(tmp_path, f"k{k}", cuda_device, device_resident=True, steps_per_dispatch=k)
        runs[k] = (t.fit(train, val, progress=None), t)
    assert sorted(kind for kind, _ in runs[4][1]._graphs) == ["eval", "train"]
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    assert [[h[k] for k in keys] for h in runs[1][0]["history"]] == [[h[k] for k in keys]
                                                                       for h in runs[4][0]["history"]]
    a, b = runs[1][1].model.state_dict(), runs[4][1].model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert runs[1][1].step == runs[4][1].step == 12
    assert runs[1][1].dropout_generator.get_state().equal(runs[4][1].dropout_generator.get_state())


@pytest.mark.cuda
def test_capturable_checkpoints_resume_exactly_and_load_either_way(cuda_device, tmp_path):
    train, val = _mlp_data(40, 0), _mlp_data(16, 1)
    resident = {"device_resident": True, "steps_per_dispatch": 2, "rolling_checkpoint": True}
    whole_t = _mlp_trainer(tmp_path, "whole", cuda_device, **resident)
    whole = whole_t.fit(train, val, progress=None)
    _mlp_trainer(tmp_path, "cut", cuda_device, **{**resident, "epochs": 1}).fit(train, val, progress=None)
    resumed_t = _mlp_trainer(tmp_path, "cut", cuda_device, **resident)
    resumed = resumed_t.fit(train, val, resume=True, progress=None)
    assert resumed["history"][0]["train_loss"] == whole["history"][1]["train_loss"]
    a, b = whole_t.model.state_dict(), resumed_t.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a) and resumed_t.step == whole_t.step == 10
    # a capturable state into a host-batching trainer, and back
    host = _mlp_trainer(tmp_path, "cut", cuda_device, epochs=3, rolling_checkpoint=True)
    host.fit(train, val, resume=True, progress=None)
    assert all(isinstance(g["lr"], float) and not g["capturable"] for g in host.optimizer.param_groups)
    assert all(s["step"].device.type == "cpu" for s in host.optimizer.state.values())
    again = _mlp_trainer(tmp_path, "cut", cuda_device, **{**resident, "epochs": 4})
    again.fit(train, val, resume=True, progress=None)
    assert all(isinstance(g["lr"], torch.Tensor) and g["lr"].is_cuda and g["capturable"]
               for g in again.optimizer.param_groups)
    assert all(s["step"].is_cuda for s in again.optimizer.state.values()) and again.step == 20


def _resident_runs(tmp_path, device, runs, **cfg):
    """``{name: (history rows, trainer)}`` of device-resident fits of
    ``_mlp_trainer`` (dropout on) with each run's own settings on top of
    ``cfg``."""
    train, val = _mlp_data(44, 0), _mlp_data(40, 1)  # 6 and 5 batches: a group of 4 and a tail
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    out = {}
    for name, extra in runs.items():
        t = _mlp_trainer(tmp_path, name, device, device_resident=True, **cfg, **extra)
        out[name] = ([[h[k] for k in keys] for h in t.fit(train, val, progress=None)["history"]], t)
    return out


def _same_runs(a, b):
    (ha, ta), (hb, tb) = a, b
    assert ha == hb and ta.step == tb.step
    sa, sb = ta.model.state_dict(), tb.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert ta.dropout_generator.get_state().equal(tb.dropout_generator.get_state())


@pytest.mark.cuda
def test_graphed_remat_steps_equal_eager_remat_and_plain_steps(cuda_device, tmp_path):
    runs = _resident_runs(tmp_path, cuda_device, {
        "plain": {"steps_per_dispatch": 1}, "remat": {"steps_per_dispatch": 1, "remat": True},
        "graphed": {"steps_per_dispatch": 4, "remat": True}})
    assert sorted(kind for kind, _ in runs["graphed"][1]._graphs) == ["eval", "train"]
    _same_runs(runs["remat"], runs["plain"])
    _same_runs(runs["graphed"], runs["remat"])
    t = runs["graphed"][1]  # the twin that the recompute draws from ends where the dropout generator does
    assert t._twin_generator.get_state().equal(t.dropout_generator.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_graphed_mixup_steps_equal_eager_ones(cuda_device, tmp_path, remat):
    runs = _resident_runs(tmp_path, cuda_device, {"eager": {"steps_per_dispatch": 1},
                                                  "graphed": {"steps_per_dispatch": 4}},
                          mixup_alpha=0.4, remat=remat)
    assert sorted(kind for kind, _ in runs["graphed"][1]._graphs) == ["eval", "train"]
    _same_runs(runs["graphed"], runs["eager"])


@pytest.mark.cuda
def test_device_crop_train_steps_equal_plain_crop_steps(cuda_device, tmp_path):
    from multimodal_lipread_torch.ops.crop_resize import crop_resize_pad_reference
    from multimodal_lipread_torch.ops.crop_resize_cuda import device_crop
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    x, boxes = _frames_and_boxes(4 * 29, cuda_device, seed=5, h=96, w=96)
    frames, boxes = x.reshape(4, 29, 96, 96, 3), boxes.reshape(4, 29, 4)
    lips = crop_resize_pad_reference(frames, boxes)
    labels, weights = torch.tensor([0, 1, 2, 3], device=cuda_device), torch.ones(4, device=cuda_device)
    losses = []
    torch.backends.cudnn.deterministic = True  # cuDNN's default weight gradients sum in a run-dependent order
    try:
        for inputs, extra in (((frames, boxes), {"device_preproc": device_crop}), ((lips,), {})):
            t = Trainer(get_video_model("cnn", 4), TrainerConfig(
                model_name="c", num_classes=4, batch_size=4, seed=0, metrics_dir=str(tmp_path / "m"),
                checkpoints_dir=str(tmp_path / "c"), **extra), device=cuda_device)
            t.init_state()
            losses.append([t.train_step(inputs, labels, weights)[0].item() for _ in range(3)])
    finally:
        torch.backends.cudnn.deterministic = False
    assert losses[0] == losses[1]


@pytest.mark.cuda
def test_graphed_crop_steps_equal_eager_crop_steps(cuda_device, tmp_path):
    """The crop kernel inside CUDA graphs of K = 4 train steps of
    resnet_trans on full frames held on the card, against the same steps
    dispatched one by one: two epochs of 2 groups (the first eager, then
    captured; three replays) with bit-equal stats and parameters."""
    from multimodal_lipread_torch.ops.crop_resize_cuda import device_crop
    from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig

    frames, boxes = _frames_and_boxes(32 * 29, "cpu", seed=7, h=96, w=96)
    ds = ArrayDataset((frames.reshape(32, 29, 96, 96, 3).numpy(), boxes.reshape(32, 29, 4).numpy()),
                      np.arange(32) % 4)
    runs = []
    torch.backends.cudnn.deterministic = True  # cuDNN's default weight gradients sum in a run-dependent order
    try:
        for k in (1, 4):
            t = Trainer(get_video_model("resnet_trans", 4), TrainerConfig(
                model_name="r", num_classes=4, batch_size=4, seed=0, host_prefetch=0, device_resident=True,
                steps_per_dispatch=k, device_preproc=device_crop, metrics_dir=str(tmp_path / f"k{k}" / "m"),
                checkpoints_dir=str(tmp_path / f"k{k}" / "c")), device=cuda_device)
            t.init_state()
            rng = np.random.default_rng(0)
            runs.append(([t.train_epoch(ds, rng, epoch=e) for e in range(2)], t))
    finally:
        torch.backends.cudnn.deterministic = False
    (eager, te), (graphed, tg) = runs
    assert [k for k, _ in tg._graphs] == ["train"] and te.step == tg.step == 16
    assert [(m.loss, m.acc) for m in eager] == [(m.loss, m.acc) for m in graphed]
    a, b = te.model.state_dict(), tg.model.state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert te.dropout_generator.get_state().equal(tg.dropout_generator.get_state())


@pytest.mark.cuda
def test_the_log_mel_operator_is_the_kernel_on_the_card(cuda_device):
    wave = _waves(3, cuda_device, seed=4)
    before = logmel_cuda.launch_count
    got = torch.ops.mlt.log_mel(wave, True)
    assert logmel_cuda.launch_count == before + 1 and got.is_contiguous()
    torch.testing.assert_close(got, log_mel_reference(wave, True), rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_an_exported_wave_model_launches_the_kernel(cuda_device, tmp_path):
    from multimodal_lipread_torch import serving

    torch.manual_seed(0)
    net = WaveToLogMel(VGGWithLSTMClassifier(4, version=11, lstm_hidden=16), 117).to(cuda_device).eval()
    wave = _waves(4, cuda_device, seed=6)
    program = serving.export_program(net, (wave.cpu().numpy(),))
    assert "mlt.log_mel.default" in {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    torch.export.save(program, str(tmp_path / "net.pt2"))
    module = torch.export.load(str(tmp_path / "net.pt2")).module()
    before = logmel_cuda.launch_count
    with torch.inference_mode(), model_precision(torch.float32):
        got = module(wave)
        want = net(wave)
    assert logmel_cuda.launch_count == before + 2
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_load_test_with_the_device_crop_launches_the_kernel(cuda_device):
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.ops import crop_resize_cuda
    from multimodal_lipread_torch.ops.crop_resize_cuda import device_crop

    x, boxes = _frames_and_boxes(2 * 29, cuda_device, seed=7, h=96, w=96)
    frames, boxes = x.reshape(2, 29, 96, 96, 3).cpu().numpy(), boxes.reshape(2, 29, 4).cpu().numpy()
    from torch.profiler import ProfilerActivity, profile

    predictor = serving.Predictor(get_video_model("cnn", 4), batch_size=2, device="cuda", device_preproc=device_crop)
    before = crop_resize_cuda.launch_count
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = serving.load_test(predictor, (frames, boxes), num_threads=3, requests_per_thread=4)
    # the warm-up request calls the kernel eagerly, the first timed one on the
    # replica's stream and under the capture; the other 11 replay the graph,
    # which launches it on the card
    assert crop_resize_cuda.launch_count == before + 3 and r["requests"] == 12 and r["p99_ms"] > 0
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA and "crop_resize" in e.name()]
    assert len(kernels) == 13


def _mlp_weights():
    from torch_dist_worker import BnMlp

    from multimodal_lipread_torch.nn.common import flax_init_

    model = flax_init_(BnMlp(), torch.Generator().manual_seed(7))
    params = {n for n, _ in model.named_parameters()}
    sd = model.state_dict()
    return {"params": {k: v for k, v in sd.items() if k in params},
            "batch_stats": {k: v for k, v in sd.items() if k not in params}}


@pytest.mark.cuda
def test_world_1_nccl_ddp_steps_equal_the_steps_without_a_group(cuda_device, tmp_path):
    from torch_dist_worker import mlp_steps, run_ranks

    inputs = {"weights": _mlp_weights(), "lr": 1e-2, "n": 40}
    (ranked,) = run_ranks("mlp_steps", 1, str(tmp_path / "nccl"), inputs, device="cuda", backend="nccl")
    alone = mlp_steps(str(tmp_path / "alone"), "alone", inputs, "cuda")
    np.testing.assert_allclose(ranked["loss"], alone["loss"], atol=1e-6, rtol=0)
    for g1, g2 in zip(ranked["grads"] + ranked["stats"], alone["grads"] + alone["stats"]):
        for name in g2:
            np.testing.assert_allclose(g1[name].numpy(), g2[name].numpy(), atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.cuda
def test_batchnorm_over_two_gloo_ranks_on_the_card_equals_one_rank(cuda_device, tmp_path):
    from torch_dist_worker import mlp_steps, run_ranks

    inputs = {"weights": _mlp_weights(), "lr": 0.0, "n": 24}  # the second batch holds 8 padding rows
    two = run_ranks("mlp_steps", 2, str(tmp_path / "gloo"), inputs, device="cuda", backend="gloo")
    one = mlp_steps(str(tmp_path / "one"), "one", inputs, "cuda")
    for ranked in two:
        np.testing.assert_allclose(ranked["loss"], one["loss"], atol=1e-6, rtol=0)
        for g1, g2 in zip(ranked["grads"] + ranked["stats"], one["grads"] + one["stats"]):
            for name in g2:
                np.testing.assert_allclose(g1[name].numpy(), g2[name].numpy(), atol=1e-6, rtol=1e-5, err_msg=name)


@pytest.mark.cuda
def test_graphed_ddp_steps_over_nccl_equal_eager_ones(cuda_device, tmp_path):
    from torch_dist_worker import run_ranks

    torch.backends.cudnn.deterministic = True
    (ranked,) = run_ranks("graph_steps", 1, str(tmp_path / "graphs"), {"weights": _mlp_weights()}, device="cuda",
                          backend="nccl")
    assert ranked["graphs4"] >= 1  # captured after DDP's 11 eager steps, then replayed
    assert ranked[4] == ranked[1]



# ---------------------------------------------------------------- served graphs


def _wave_model(seed=0):
    from multimodal_lipread_torch.nn.common import flax_init_

    net = WaveToLogMel(VGGWithLSTMClassifier(4, version=16, lstm_hidden=128), input_size=117)
    return flax_init_(net, torch.Generator().manual_seed(seed))


def _eager_logits(predictor, *inputs):
    """The predictor's model called directly on the card, one replica's
    share of a batch at a time, on the inputs padded to whole fixed batches
    with zero rows."""
    from multimodal_lipread_torch.serving import _cast

    b, n = predictor.batch_size, inputs[0].shape[0]
    share = b // len(predictor.replicas)
    padded = [np.pad(a, [(0, -(-n // b) * b - n)] + [(0, 0)] * (a.ndim - 1)) for a in inputs]
    outs = []
    with torch.inference_mode(), model_precision(torch.float32):
        for s in range(0, padded[0].shape[0], share):
            xs = tuple(torch.from_numpy(a[s : s + share]).to("cuda") for a in padded)
            if predictor.device_preproc is not None:
                xs = tuple(predictor.device_preproc(*xs))
            outs.append(predictor.model(*(_cast(x) for x in xs)).float().cpu())
    return torch.cat(outs).numpy()[:n]


def _traced_counters(fn):
    from torch.profiler import ProfilerActivity, profile

    from multimodal_lipread_torch.utils import trace

    with profile(activities=[ProfilerActivity.CUDA]):
        out = fn()
    return out, trace.last_session()["counters"]


def _same_logits(got, want):
    # the graph replays the eager forward's kernels on the same padded batch
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 32, 40])
def test_served_waves_replay_the_eager_forward(cuda_device, k):
    from multimodal_lipread_torch.serving import Predictor

    predictor = Predictor(_wave_model(k), batch_size=32, device="cuda")
    waves = _waves(k, "cpu", seed=k).numpy()
    first = predictor.predict_logits(waves[:3])  # the first request runs eagerly
    assert not predictor.replicas[0].fixed
    second = predictor.predict_logits(waves[:5])  # eager on the replica's stream, then the capture
    assert [f.graph is not None for f in predictor.replicas[0].fixed.values()] == [True]
    got, counters = _traced_counters(lambda: predictor.predict_logits(waves))
    _same_logits(first, _eager_logits(predictor, waves[:3]))
    _same_logits(second, _eager_logits(predictor, waves[:5]))
    _same_logits(got, _eager_logits(predictor, waves))
    assert counters["serve.replays"] == -(-k // 32)  # one a batch
    assert counters["serve.rows"] == k and counters.get("serve.rows_padded", 0) == -(-k // 32) * 32 - k


@pytest.mark.cuda
def test_server_threads_each_get_their_own_rows(cuda_device):
    import threading

    from multimodal_lipread_torch.serving import Predictor

    predictor = Predictor(_wave_model(3), batch_size=32, device="cuda")
    requests = [_waves(k, "cpu", seed=100 + k).numpy() for k in (3, 17, 32, 9)]
    predictor.predict_logits(requests[0])
    got = [[] for _ in requests]
    start = threading.Barrier(len(requests))

    def serve(i):
        start.wait()
        for _ in range(5):
            got[i].append(predictor.predict_logits(requests[i]))

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    # the capture ran in one of the threads while the others served
    assert [f.graph is not None for f in predictor.replicas[0].fixed.values()] == [True]
    for req, outs in zip(requests, got):
        want = _eager_logits(predictor, req)
        for out in outs:
            _same_logits(out, want)


@pytest.mark.cuda
def test_served_device_crop_replays_the_eager_forward(cuda_device):
    from multimodal_lipread_torch.ops.crop_resize_cuda import device_crop
    from multimodal_lipread_torch.serving import Predictor

    x, boxes = _frames_and_boxes(5 * 29, cuda_device, seed=21, h=96, w=96)
    frames, boxes = x.reshape(5, 29, 96, 96, 3).cpu().numpy(), boxes.reshape(5, 29, 4).cpu().numpy()
    predictor = Predictor(get_video_model("cnn", 4), batch_size=4, device="cuda", device_preproc=device_crop)
    predictor.predict_logits(frames[:4], boxes[:4])
    predictor.predict_logits(frames[1:], boxes[1:])  # the capture
    got, counters = _traced_counters(lambda: predictor.predict_logits(frames, boxes))  # one full batch, one padded
    _same_logits(got, _eager_logits(predictor, frames, boxes))
    assert counters["serve.replays"] == 2


@pytest.mark.cuda
def test_served_int32_ids_give_the_eager_forward(cuda_device):
    from multimodal_lipread_torch.models.bert import BertClassifier, bert_small_config
    from multimodal_lipread_torch.nn.common import flax_init_
    from multimodal_lipread_torch.serving import Predictor

    net = flax_init_(BertClassifier(bert_small_config(), 4), torch.Generator().manual_seed(6))
    ids = _padded_ids(7, seed=2)
    predictor = Predictor(net, batch_size=4, device="cuda")
    predictor.predict_logits(ids[:4])
    predictor.predict_logits(ids[2:])  # the capture
    got, counters = _traced_counters(lambda: predictor.predict_logits(ids))
    _same_logits(got, _eager_logits(predictor, ids))
    assert counters["serve.replays"] == 2


class _WaitsForTheCard(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.head = torch.nn.Linear(6, 4)

    def forward(self, x):
        scale = 1.0 + float(x.abs().amax()) * 0.0  # a host read: cannot be captured
        return self.head(x) * scale


@pytest.mark.cuda
def test_a_forward_that_waits_for_the_card_stays_eager(cuda_device):
    from multimodal_lipread_torch.serving import Predictor

    torch.manual_seed(0)
    predictor = Predictor(_WaitsForTheCard(), batch_size=4, device="cuda")
    x = np.random.default_rng(0).standard_normal((6, 6)).astype(np.float32)
    first = predictor.predict_logits(x[:4])  # the first request runs eagerly
    with pytest.warns(RuntimeWarning, match="runs eagerly"):
        got, counters = _traced_counters(lambda: predictor.predict_logits(x))  # its capture fails
    _same_logits(first, _eager_logits(predictor, x[:4]))
    _same_logits(got, _eager_logits(predictor, x))
    assert counters.get("serve.replays", 0) == 0 and counters["serve.rows"] == 6
    (replica,) = predictor.replicas
    assert [f.graph for f in replica.fixed.values()] == [None]


@pytest.mark.cuda
def test_two_replicas_on_one_card_replay_the_eager_forward(cuda_device):
    # a stream, a lock and a graph each, on half of every batch; the
    # replicas hold equal weights, so the model's eager halves are the reference
    from multimodal_lipread_torch.serving import Predictor

    predictor = Predictor(_wave_model(5), batch_size=32, device="cuda", devices=["cuda:0", "cuda:0"])
    waves = _waves(40, "cpu", seed=5).numpy()
    first = predictor.predict_logits(waves[:3])
    predictor.predict_logits(waves[3:9])  # the captures
    got, counters = _traced_counters(lambda: predictor.predict_logits(waves))
    a, b = predictor.replicas
    assert a.model is not b.model and a.stream != b.stream
    assert all(f.graph is not None for r in (a, b) for f in r.fixed.values())
    _same_logits(first, _eager_logits(predictor, waves[:3]))
    _same_logits(got, _eager_logits(predictor, waves))
    assert counters["serve.replays"] == 2 * 2  # two batches, two replicas
