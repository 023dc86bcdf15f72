"""The port's streaming data path on the CPU (``data/grain_loader.py``, the
trainer's ``stream_batches`` and ``device_preproc``, the pipelines'
``dataset.streaming``, ``dataset.device_crop`` and
``dataset.host_crop_streaming`` branches, ``Predictor.device_preproc``):

- an unshuffled epoch yields the records in index order; a shuffled one
  covers every record of the shard once, the same for a given (seed,
  epoch); the shard split and ``global_batches`` are the JAX
  ``StreamingDataset``'s (grain's shuffled order is not sought);
- a short loader batch is padded as the JAX trainer's ``_stream_batches``
  pads it (run on the same dataset);
- a streaming epoch trains and evaluates exactly as the ``ArrayDataset``
  epoch in the same order, also with the device crop as ``device_preproc``
  against an ``ArrayDataset`` of the plain crops;
- the audio pipeline streams waveforms through ``WaveToLogMel`` and takes
  the loss of the features-first model on the first batch; the video
  pipeline trains with ``device_crop`` and with ``host_crop_streaming`` at
  B=2 on 96 × 96 ``.mp4`` clips, and its checkpoint serves full frames
  through ``Predictor(device_preproc=device_crop)``."""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)

from multimodal_lipread_tpu.data.grain_loader import StreamingDataset as JStreamingDataset
from multimodal_lipread_tpu.models.video import get_video_model as jget_video_model
from multimodal_lipread_tpu.parallel.mesh import get_mesh
from multimodal_lipread_tpu.train.trainer import Trainer as JTrainer
from multimodal_lipread_tpu.train.trainer import TrainerConfig as JTrainerConfig

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.glips import scan_glips, scan_lip_regions, lip_regions_root
from multimodal_lipread_torch.data.grain_loader import (
    FullFrameClipSource,
    HostCropClipSource,
    LipClipSource,
    StreamingDataset,
)
from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
from multimodal_lipread_torch.models.audio import get_audio_model
from multimodal_lipread_torch.models.frontend import WaveToLogMel
from multimodal_lipread_torch.models.video import get_video_model
from multimodal_lipread_torch.ops.crop_resize import crop_resize_pad_reference
from multimodal_lipread_torch.ops.crop_resize_cuda import device_crop
from multimodal_lipread_torch.pipelines import audio as paudio_pipeline
from multimodal_lipread_torch.pipelines import video as pvideo_pipeline
from multimodal_lipread_torch.pipelines.common import decode_waveforms, load_audio_datasets
from multimodal_lipread_torch.train.trainer import ArrayDataset, Trainer, TrainerConfig


class MemorySource:
    """Records made from a seed: ``x`` (3,) float32, ``frames`` (2, 24, 32, 3)
    uint8 and ``boxes`` (2, 4) int32 (lip boxes inside the frame)."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.standard_normal((n, 3)).astype(np.float32)
        self.frames = rng.integers(0, 256, (n, 2, 24, 32, 3), dtype=np.uint8)
        x0, y0 = rng.integers(0, 16, (n, 2)), rng.integers(0, 12, (n, 2))
        self.boxes = np.stack([x0, y0, x0 + rng.integers(4, 16, (n, 2)), y0 + rng.integers(4, 12, (n, 2))],
                              -1).astype(np.int32)
        self.labels = rng.integers(0, 4, n).astype(np.int32)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"x": self.x[i], "frames": self.frames[i], "boxes": self.boxes[i], "label": self.labels[i]}


def _labels_of(ds, epoch, shuffle, bs=4):
    return np.concatenate([labels for _inputs, labels in ds.epoch_batches(epoch, shuffle, bs)])


def test_unshuffled_epoch_is_in_index_order():
    src = MemorySource(10)
    ds = StreamingDataset(src, ("x",))
    batches = list(ds.epoch_batches(0, False, 4))
    assert [len(b[1]) for b in batches] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate([b[0][0] for b in batches]), src.x)
    np.testing.assert_array_equal(np.concatenate([b[1] for b in batches]), src.labels)
    assert batches[0][1].dtype == np.int32


@pytest.mark.parametrize("shard_index, shard_count", [(0, 1), (0, 3), (2, 3)])
def test_shuffled_epochs_cover_their_shard_once(shard_index, shard_count):
    src = MemorySource(11)
    src.labels = np.arange(11, dtype=np.int32)  # label = record index
    ds = StreamingDataset(src, ("x",), seed=5, shard_index=shard_index, shard_count=shard_count)
    epochs = [_labels_of(ds, e, True) for e in (1, 2)]
    for e, labels in zip((1, 2), epochs):
        assert len(labels) == len(ds) and sorted(labels) == sorted(ds.epoch_order(e, True))
    assert not np.array_equal(epochs[0], epochs[1])
    np.testing.assert_array_equal(_labels_of(ds, 1, True), epochs[0])  # deterministic per (seed, epoch)
    if shard_count == 1:
        assert sorted(epochs[0]) == list(range(11))
    assert set(np.concatenate([StreamingDataset(src, ("x",), seed=5, shard_index=i, shard_count=shard_count)
                               .epoch_order(1, True) for i in range(shard_count)])) == set(range(11))


@pytest.mark.parametrize("n, count", [(10, 1), (10, 3), (11, 4), (3, 4)])
def test_shard_lengths_and_global_batches_are_the_jax_ones(n, count):
    src = MemorySource(n)
    for i in range(count):
        ours = StreamingDataset(src, ("x",), shard_index=i, shard_count=count)
        theirs = JStreamingDataset(src, ("x",), shard_index=i, shard_count=count)
        assert len(ours) == len(theirs)
        assert [ours.global_batches(b) for b in (1, 2, 4)] == [theirs.global_batches(b) for b in (1, 2, 4)]
    np.testing.assert_array_equal(ours.example_inputs(3)[0], theirs.example_inputs(3)[0])


@pytest.mark.parametrize("n, count, index", [(10, 1, 0), (9, 2, 1)])
def test_short_batches_are_padded_as_the_jax_trainer_pads_them(tmp_path, n, count, index):
    ds = StreamingDataset(MemorySource(n), ("x", "frames"), shard_index=index, shard_count=count)
    jtrainer = JTrainer(jget_video_model("cnn", 4), JTrainerConfig(
        model_name="j", num_classes=4, batch_size=4, metrics_dir=str(tmp_path / "jm"),
        checkpoints_dir=str(tmp_path / "jc")), mesh=get_mesh(jax.devices()[:1]))
    ptrainer = Trainer(get_video_model("cnn", 4), TrainerConfig(
        model_name="p", num_classes=4, batch_size=4, metrics_dir=str(tmp_path / "pm"),
        checkpoints_dir=str(tmp_path / "pc")), device="cpu")
    theirs = list(jtrainer._stream_batches(ds, 0, shuffle=False))
    ours = list(ptrainer.stream_batches(ds, 0, shuffle=False))
    assert len(ours) == len(theirs) == ds.global_batches(4)
    for (inputs, labels, weights), (jinputs, jlabels, jweights) in zip(ours, theirs):
        for a, b in zip(inputs, jinputs):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(labels, np.asarray(jlabels))
        np.testing.assert_array_equal(weights, np.asarray(jweights))


def _trainers(tmp_path, model_fn, **cfg):
    out = []
    for tag in ("array", "stream"):
        t = Trainer(model_fn(), TrainerConfig(
            model_name=tag, num_classes=4, batch_size=4, learning_rate=1e-2, seed=1,
            metrics_dir=str(tmp_path / tag / "m"), checkpoints_dir=str(tmp_path / tag / "c"), **cfg), device="cpu")
        t.init_state()
        out.append(t)
    return out


def _same_epochs(array_t, array_ds, stream_t, stream_ds, seed):
    for epoch in (1, 2):
        want = array_t.train_epoch(array_ds, np.random.default_rng(seed + epoch))
        got = stream_t.train_epoch(stream_ds, np.random.default_rng(123), epoch=epoch)
        assert (got.loss, got.acc) == (want.loss, want.acc)
    assert array_t.evaluate(array_ds) == stream_t.evaluate(stream_ds)
    a, b = array_t.model.state_dict(), stream_t.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_streaming_epoch_trains_as_the_array_epoch_in_its_order(tmp_path):
    from multimodal_lipread_torch.nn.common import MLP

    src = MemorySource(12, seed=3)
    array_t, stream_t = _trainers(tmp_path, lambda: MLP(3, (8,), 4, dropout_rate=0.2, use_batchnorm=True))
    _same_epochs(array_t, ArrayDataset((src.x,), src.labels), stream_t, StreamingDataset(src, ("x",), seed=7), 7)


def test_the_device_crop_as_device_preproc_trains_as_plain_crops(tmp_path):
    src = MemorySource(8, seed=4)
    lips = crop_resize_pad_reference(torch.from_numpy(src.frames), torch.from_numpy(src.boxes)).numpy()
    array_t = _trainers(tmp_path / "a", lambda: get_video_model("cnn", 4))[0]
    stream_t = _trainers(tmp_path / "b", lambda: get_video_model("cnn", 4), device_preproc=device_crop)[1]
    _same_epochs(array_t, ArrayDataset((lips,), src.labels), stream_t,
                 StreamingDataset(src, ("frames", "boxes"), seed=2), 2)


def test_loader_workers_give_the_same_batches(tmp_path):
    root = make_synthetic_glips(str(tmp_path / "GLips_4"), clips_per_split=2, seed=1, with_audio=False,
                                with_lip_regions=True)
    index = scan_lip_regions(lip_regions_root(root))
    source = LipClipSource(index.by_split("train"), index.class_to_idx)
    inline = list(StreamingDataset(source, ("lip_regions",), seed=3).epoch_batches(1, True, 3))
    workers = list(StreamingDataset(source, ("lip_regions",), seed=3, worker_count=2).epoch_batches(1, True, 3))
    assert len(inline) == len(workers) == 3
    for (a, la), (b, lb) in zip(inline, workers):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(la, lb)


# --- pipelines ---------------------------------------------------------------


def _audio_cfg(root, base, **dataset):
    return Config.from_dict({
        "dataset": {"root_dir": root, "num_classes": 4, "input_size": 117, **dataset},
        "model": {"name": "vgg_lstm", "version": 11},
        "training": {"batch_size": 4, "epochs": 1, "learning_rate": 1e-3, "seed": 0},
        "output": {"base_dir": base, "plots": False},
    })


def test_audio_pipeline_streams_waveforms_through_the_log_mel(tmp_path):
    root = make_synthetic_glips(str(tmp_path / "GLips_4"), clips_per_split=2, seed=2)
    result = paudio_pipeline.main(_audio_cfg(root, str(tmp_path / "run"), streaming=True), device="cpu")
    assert len(result["history"]) == 1 and np.isfinite(result["final_test_loss"])
    served = serving.predict_audio_clips(_audio_cfg(root, str(tmp_path / "run"), streaming=True),
                                         result["best_checkpoint"],
                                         [e.path for e in scan_glips(root).by_split("test")], 4, device="cpu")
    assert len(served) == 8 and all(np.isfinite(r["logits"]).all() for r in served)
    # one step on the first unshuffled batch: the streaming model's loss is
    # the features-first model's at the same weights
    index = scan_glips(root)
    waves = decode_waveforms([e.path for e in index.by_split("train")][:4])
    mels = load_audio_datasets(root, device="cpu")[0]["train"].inputs[0][:4]
    labels = np.asarray([index.class_to_idx[e.word] for e in index.by_split("train")][:4])
    losses = []
    for model, x in ((WaveToLogMel(get_audio_model("vgg_lstm", 4, version=11)), waves),
                     (get_audio_model("vgg_lstm", 4, version=11), mels)):
        t = Trainer(model, TrainerConfig(model_name="s", num_classes=4, batch_size=4, seed=0,
                                         metrics_dir=str(tmp_path / "m"), checkpoints_dir=str(tmp_path / "c")),
                    device="cpu")
        losses.append(t.train_single_batch(ArrayDataset((x,), labels)))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


@pytest.fixture(scope="module")
def mp4_corpus(tmp_path_factory):
    return make_synthetic_glips(str(tmp_path_factory.mktemp("mp4") / "GLips_4"), clips_per_split=2, seed=4,
                                with_audio=False, with_video=True)


def _video_cfg(root, base, **dataset):
    return Config.from_dict({
        "dataset": {"root_dir": root, "num_classes": 4, "landmark_backend": "center", **dataset},
        "model": {"name": "cnn"},
        "training": {"batch_size": 2, "epochs": 1, "learning_rate": 1e-3, "seed": 0},
        "output": {"base_dir": base, "plots": False},
    })


@pytest.mark.parametrize("knob", ["device_crop", "host_crop_streaming"])
def test_video_pipeline_trains_on_mp4_clips(mp4_corpus, tmp_path, knob):
    result = pvideo_pipeline.main(_video_cfg(mp4_corpus, str(tmp_path / knob), **{knob: True}), device="cpu")
    assert len(result["history"]) == 1 and np.isfinite(result["history"][0]["train_loss"])
    assert os.path.isfile(os.path.join(tmp_path, knob, "models_trained", "test_results.txt"))


def test_a_device_crop_checkpoint_serves_full_frames(mp4_corpus, tmp_path):
    cfg = _video_cfg(mp4_corpus, str(tmp_path / "run"), device_crop=True)
    best = pvideo_pipeline.main(cfg, device="cpu")["best_checkpoint"]
    index = scan_glips(mp4_corpus, exts=(".mp4",))
    source = FullFrameClipSource(index.by_split("test"), index.class_to_idx, backend="center", frame_shape=(96, 96))
    records = [source[i] for i in range(3)]  # a padded last batch at 2
    frames, boxes = np.stack([r["frames"] for r in records]), np.stack([r["boxes"] for r in records])
    pickle.loads(pickle.dumps(source))  # the detector stays out of the pickle
    assert "_extractor" not in source.__getstate__()
    got = serving.Predictor.from_checkpoint(serving.build_model("video", cfg), best, 2, device="cpu",
                                            device_preproc=device_crop).predict_logits(frames, boxes)
    lips = crop_resize_pad_reference(torch.from_numpy(frames), torch.from_numpy(boxes)).numpy()
    want = serving.Predictor.from_checkpoint(serving.build_model("video", cfg), best, 2,
                                             device="cpu").predict_logits(lips)
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(got, want)
    host = HostCropClipSource(index.by_split("test"), index.class_to_idx, backend="center")
    assert np.abs(host[0]["lip_regions"].astype(int) - lips[0].astype(int)).max() <= 1
