"""The video pipeline's resident full-frame path on the CPU
(``dataset.device_crop`` with ``training.device_resident``): every split's
full frames and lip boxes read once into an ``ArrayDataset``
(``pipelines.video.full_frame_dataset``), held on the device, the crop run
inside each step as the trainer's ``device_preproc``, K steps a dispatch.

- the read keeps every clip, in index order, whatever the read batches,
  and refuses clips of two frame sizes;
- the pipeline trains on rendered ``.mp4`` clips that way, and a traced
  epoch records the placing (``data.resident_place``, with
  ``data.resident_bytes``), one ``trainer.preproc`` a step and the eager
  steps of its groups (``trainer.eager_steps``);
- K-step groups give the per-step dispatch's epochs and parameters bit for
  bit;
- the benchmark's plain ``resnet_trans`` (``benchmark/reference``) against
  the port's: its crop bit for bit against the port's plain crop, its
  forward, loss and gradients on seeded weights."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)

from benchmark import weights
from benchmark.reference import resnet_trans as ref
from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
from multimodal_lipread_torch.models.video import get_video_model
from multimodal_lipread_torch.nn.common import Dropout
from multimodal_lipread_torch.ops.crop_resize import crop_resize_pad_reference, expand_boxes
from multimodal_lipread_torch.ops.crop_resize_cuda import device_crop
from multimodal_lipread_torch.pipelines import video as pvideo
from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig
from multimodal_lipread_torch.utils import trace

CFG = {"dataset": {"num_classes": 4}}


class FrameSource:
    """``n`` clips of ``t`` uint8 frames of (h, w, 3) with boxes inside
    them, from a seed; ``sizes`` gives some clips another frame size."""

    def __init__(self, n, t=3, h=40, w=48, seed=0, sizes=None):
        rng = np.random.default_rng(seed)
        self.frames = [rng.integers(0, 256, (t,) + (sizes or {}).get(i, (h, w)) + (3,), dtype=np.uint8)
                       for i in range(n)]
        x0, y0 = rng.integers(0, w // 2, (n, t)), rng.integers(0, h // 2, (n, t))
        self.boxes = np.stack([x0, y0, x0 + rng.integers(4, w // 2, (n, t)), y0 + rng.integers(3, h // 2, (n, t))],
                              -1).astype(np.int32)
        self.labels = (np.arange(n) % 4).astype(np.int32)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"frames": self.frames[i], "boxes": self.boxes[i], "label": self.labels[i]}


@pytest.mark.parametrize("n", [5, 40], ids=["one_read", "two_reads"])
def test_full_frame_dataset_reads_every_clip_in_order(n):
    source = FrameSource(n, seed=n)
    ds = pvideo.full_frame_dataset(source)
    frames, boxes = ds.inputs
    assert frames.shape == (n, 3, 40, 48, 3) and frames.dtype == np.uint8
    assert boxes.shape == (n, 3, 4) and boxes.dtype == np.int32
    np.testing.assert_array_equal(frames, np.stack(source.frames))
    np.testing.assert_array_equal(boxes, source.boxes)
    np.testing.assert_array_equal(ds.labels, source.labels)


@pytest.mark.parametrize("odd", [3, pvideo.READ_BATCH], ids=["inside_a_read", "a_read_of_its_own"])
def test_full_frame_dataset_refuses_two_frame_sizes(odd):
    with pytest.raises(ValueError, match="same shape|one shape"):
        pvideo.full_frame_dataset(FrameSource(36, seed=1, sizes={odd: (40, 40)}))


def _video_cfg(root, base, **training):
    return Config.from_dict({
        "dataset": {"root_dir": root, "num_classes": 4, "landmark_backend": "center", "device_crop": True},
        "model": {"name": "cnn"},
        "training": {"batch_size": 2, "epochs": 1, "learning_rate": 1e-3, "seed": 0, "device_resident": True,
                     "steps_per_dispatch": 2, **training},
        "output": {"base_dir": base, "plots": False},
    })


def test_video_pipeline_trains_resident_full_frames(tmp_path):
    root = make_synthetic_glips(str(tmp_path / "GLips_4"), clips_per_split=2, seed=4, with_audio=False,
                                with_video=True)
    result = pvideo.main(_video_cfg(root, str(tmp_path / "run"), profile_dir=str(tmp_path / "trace")), device="cpu")
    assert len(result["history"]) == 1 and np.isfinite(result["history"][0]["train_loss"])
    assert np.isfinite(result["final_test_loss"])
    session = trace.last_session()  # the traced first epoch: 8 train clips of 29 frames of 96 x 96
    counters = session["counters"]
    assert counters["data.resident_bytes"] == 8 * 29 * 96 * 96 * 3 + 8 * 29 * 4 * 4 + 8 * 8
    assert counters["trainer.eager_steps"] == 4 and "trainer.replays" not in counters  # the CPU runs groups eagerly
    names = [s["name"] for s in session["spans"]]
    assert names.count("data.resident_place") == 1 and names.count("trainer.preproc") == 4
    assert names.count("trainer.group") == 2


def _trainer(tmp_path, k, model="resnet_trans"):
    return Trainer(get_video_model(model, 4), TrainerConfig(
        model_name="r", num_classes=4, batch_size=2, learning_rate=1e-3, seed=0, host_prefetch=0,
        device_resident=True, steps_per_dispatch=k, device_preproc=device_crop,
        metrics_dir=str(tmp_path / f"k{k}" / "m"), checkpoints_dir=str(tmp_path / f"k{k}" / "c")), device="cpu")


def test_k_step_groups_equal_per_step_dispatch(tmp_path):
    ds = pvideo.full_frame_dataset(FrameSource(10, seed=3))  # 5 steps: two groups of 2 and a tail
    runs = []
    for k in (1, 2):
        t = _trainer(tmp_path, k)
        t.init_state()
        rng = np.random.default_rng(0)
        with profile(activities=[ProfilerActivity.CPU]):
            epochs = [t.train_epoch(ds, rng, epoch=e) for e in range(2)]
        runs.append((epochs, t, trace.last_session()))
    (per_step, ta, sa), (grouped, tb, sb) = runs
    assert [(m.loss, m.acc) for m in per_step] == [(m.loss, m.acc) for m in grouped]
    a, b = ta.model.state_dict(), tb.model.state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a) and ta.step == tb.step == 10
    assert ta.dropout_generator.get_state().equal(tb.dropout_generator.get_state())
    assert "trainer.eager_steps" not in sa["counters"] and sb["counters"]["trainer.eager_steps"] == 8


def _boxes(n, h, w, seed):
    rng = np.random.default_rng(seed)
    x0, y0 = rng.integers(0, w - 20, n), rng.integers(0, h - 20, n)
    raw = np.stack([x0, y0, np.minimum(x0 + rng.integers(4, 40, n), w), np.minimum(y0 + rng.integers(3, 30, n), h)],
                   -1).astype(np.int32)
    boxes = expand_boxes(torch.from_numpy(raw), h, w)
    special = [(0, 0, 0, 0), (30, 12, 20, 40), (w - 30, h - 15, w, h), (0, 0, w, h), (0, h // 2, w, h // 2 + 5),
               (7, 3, 51, 47)]
    for i, box in enumerate(special):
        boxes[(i * 7) % n] = torch.tensor(box)
    return boxes


@pytest.mark.parametrize("h,w", [(64, 64), (72, 96)])
def test_reference_crop_equals_the_ports_plain_crop(h, w):
    n = 58
    frames = torch.from_numpy(np.random.default_rng(h).integers(0, 256, (n, h, w, 3), dtype=np.uint8))
    boxes = _boxes(n, h, w, seed=w)
    assert torch.equal(ref.crop(frames, boxes), crop_resize_pad_reference(frames, boxes))


def _both_sides(train, dtype):
    """(reference logits and loss, program logits and loss, the parameter
    names, the reference's parameters) on seeded weights in ``dtype``: 2
    clips of 29 frames of 64 x 64."""
    w = {n: t.to(dtype) for n, t in weights.make(ref.param_spec(CFG), 5, torch.device("cpu")).items()}
    model = get_video_model("resnet_trans", 4, dtype=dtype).to(dtype)
    model.load_state_dict(w, strict=True)
    model.train(train)
    program_gen, reference_gen = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = program_gen
    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 29, 64, 64, 3), dtype=np.uint8))
    boxes = _boxes(58, 64, 64, seed=2).reshape(2, 29, 4)
    labels = torch.tensor([1, 3])
    names = [n for n, _p in model.named_parameters()]
    params = {n: t.clone().requires_grad_(n in names) for n, t in w.items()}
    ours = ref.forward(params, CFG, (frames, boxes), train, reference_gen)
    theirs = model(device_crop(frames, boxes)[0].to(dtype) / 255.0)
    losses = [torch.nn.functional.cross_entropy(x, labels) for x in (ours, theirs)]
    return (ours, losses[0]), (theirs, losses[1]), names, params, model


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_trans_forward_loss_and_gradients_match_the_reference(train):
    """In float32 the logits agree to 1e-4 of their scale; in float64 the
    logits, the loss and every gradient to round-off (float32 gradients of
    a train-mode ResNet part by up to 2 % where BatchNorm's backward
    cancels)."""
    (ours, _), (theirs, _), _names, _params, _model = _both_sides(train, torch.float32)
    scale = float(ours.detach().abs().max())
    np.testing.assert_allclose(theirs.detach().numpy(), ours.detach().numpy(), atol=1e-4 * scale, rtol=0)
    (ours, ours_loss), (theirs, theirs_loss), names, params, model = _both_sides(train, torch.float64)
    np.testing.assert_allclose(theirs.detach().numpy(), ours.detach().numpy(), atol=1e-10, rtol=0)
    np.testing.assert_allclose(theirs_loss.item(), ours_loss.item(), rtol=1e-12)
    ours_grads = torch.autograd.grad(ours_loss, [params[n] for n in names])
    theirs_grads = torch.autograd.grad(theirs_loss, list(model.parameters()))
    floor = 1e-6 * float(np.median([float(g.norm()) for g in ours_grads]))
    for name, g_ref, g_prog in zip(names, ours_grads, theirs_grads):
        if float(g_ref.norm()) < floor:  # a key bias: the softmax cancels it, leaving round-off alone
            assert "self_attn.key.bias" in name, name
            continue
        assert float((g_prog - g_ref).norm() / g_ref.norm()) < 1e-10, name
