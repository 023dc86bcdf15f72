"""``model.pretrained`` in the port: the converters of
``utils/torch_import.py`` against the JAX package's followed by the bridge
(``state_dict_from_jax``), bit for bit, on torchvision-named state dicts
(the stand-ins of tests/test_torch_import*.py, and generated ones for
resnet34/50 and vgg16), ``adapt_first_conv_to_1ch``, ``graft_backbone``'s
mismatch errors, and ``pipelines.common.load_pretrained_backbones``
through the audio, video and audio_video pipelines' trainers, with
``arch: checkpoint`` taking a subtree of one of the port's checkpoints."""

import os

import numpy as np
import pytest
import torch
import torch.nn as tnn

from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)
from test_torch_import import _TorchResNet18, _torch_vgg11_bn_features
from test_torch_import_mobilenet import _randomize_bn_stats, _TorchMobileNetV2, _TorchMobileNetV3Small
from test_torch_import_shufflenet import _TorchShuffleNetV2

from multimodal_lipread_tpu.utils import torch_import as jti

from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.models.audio import get_audio_model
from multimodal_lipread_torch.models.audio_video import get_av_model
from multimodal_lipread_torch.models.backbones import VGG, MobileNetV2, MobileNetV3Small, ResNet, ShuffleNetV2
from multimodal_lipread_torch.models.video import get_video_model
from multimodal_lipread_torch.nn import LSTM
from multimodal_lipread_torch.nn.common import flax_init_
from multimodal_lipread_torch.pipelines.common import load_pretrained_backbones
from multimodal_lipread_torch.train.checkpoint import module_state, save_checkpoint
from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig
from multimodal_lipread_torch.utils import torch_import as pti
from multimodal_lipread_torch.utils.jax_bridge import state_dict_from_jax


def _torchvision_resnet(version):
    """A torchvision-named resnet state dict with random tensors, from the
    port's ResNet names (layer1_0 → layer1.0, downsample_conv/bn →
    downsample.0/1) and a num_batches_tracked per BatchNorm."""
    g = torch.Generator().manual_seed(version)
    sd = {}
    for name, t in ResNet(version).state_dict().items():
        tv = name.replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
        for stage in range(1, 5):
            tv = tv.replace(f"layer{stage}_", f"layer{stage}.")
        sd[tv] = torch.randn(t.shape, generator=g)
        if tv.endswith("running_var"):
            sd[tv] = sd[tv].abs() + 0.5
            sd[tv.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    return sd


def _torch_vgg_bn_features(version):
    cfg = {11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
           16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]}[version]
    if version == 11:
        return _torch_vgg11_bn_features()
    layers, c_in = [], 3
    for v in cfg:
        if v == "M":
            layers.append(tnn.MaxPool2d(2, 2))
        else:
            layers += [tnn.Conv2d(c_in, v, 3, padding=1), tnn.BatchNorm2d(v), tnn.ReLU(True)]
            c_in = v
    return tnn.Sequential(*layers)


def _standin(arch):
    """(torchvision-named state dict, the port backbone it converts into)."""
    torch.manual_seed(0)
    if arch == "resnet18":
        m = _TorchResNet18()
        _randomize_bn_stats(m)
        return m.state_dict(), ResNet(18)
    if arch in ("resnet34", "resnet50"):
        return _torchvision_resnet(int(arch[-2:])), ResNet(int(arch[-2:]))
    if arch.startswith("vgg"):
        f = _torch_vgg_bn_features(int(arch[3:]))
        _randomize_bn_stats(f)
        return {f"features.{k}": v for k, v in f.state_dict().items()}, VGG(int(arch[3:]), in_channels=3)
    if arch == "mobilenet_v2":
        m = _TorchMobileNetV2()
        _randomize_bn_stats(m)
        return m.state_dict(), MobileNetV2()
    if arch == "mobilenet_v3_small":
        m = _TorchMobileNetV3Small()
        _randomize_bn_stats(m)
        return m.state_dict(), MobileNetV3Small()
    if arch.startswith("shufflenet"):
        width = 0.5 if arch.endswith("0_5") else 1.0
        m = _TorchShuffleNetV2(width)
        _randomize_bn_stats(m)
        return m.state_dict(), ShuffleNetV2(width)
    raise KeyError(arch)


_CONVERTERS = {
    "resnet18": (lambda s: pti.convert_resnet(s, 18), lambda s: jti.convert_resnet(s, 18)),
    "resnet34": (lambda s: pti.convert_resnet(s, 34), lambda s: jti.convert_resnet(s, 34)),
    "resnet50": (lambda s: pti.convert_resnet(s, 50), lambda s: jti.convert_resnet(s, 50)),
    "vgg11": (lambda s: pti.convert_vgg_bn(s, 11), lambda s: jti.convert_vgg_bn(s, 11)),
    "vgg16": (lambda s: pti.convert_vgg_bn(s, 16), lambda s: jti.convert_vgg_bn(s, 16)),
    "mobilenet_v2": (pti.convert_mobilenet_v2, jti.convert_mobilenet_v2),
    "mobilenet_v3_small": (pti.convert_mobilenet_v3_small, jti.convert_mobilenet_v3_small),
    "shufflenet_v2_x0_5": (lambda s: pti.convert_shufflenet_v2(s, 0.5), lambda s: jti.convert_shufflenet_v2(s, 0.5)),
    "shufflenet_v2_x1_0": (lambda s: pti.convert_shufflenet_v2(s, 1.0), lambda s: jti.convert_shufflenet_v2(s, 1.0)),
}


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", sorted(_CONVERTERS))
def test_converter_equals_jax_converter_then_bridge(arch):
    sd, backbone = _standin(arch)
    ours, theirs = _CONVERTERS[arch]
    want_tree = theirs(sd)
    want = state_dict_from_jax(want_tree["params"], want_tree["batch_stats"])
    got = ours(sd)
    _assert_bit_equal(got, want)
    backbone.load_state_dict(got, strict=True)  # every name and shape of the port's backbone
    for k, t in got.items():  # a copy, not a view of the source
        assert all(t.data_ptr() != s.data_ptr() for s in sd.values()), k


def test_converters_from_a_pth_file(tmp_path):
    sd, _ = _standin("resnet18")
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    _assert_bit_equal(pti.convert_resnet(path, 18), pti.convert_resnet(sd, 18))
    assert pti.load_state_dict({"a": np.ones(2, np.float64)})["a"].dtype == torch.float32


@pytest.mark.parametrize("layers, bidirectional", [(2, True), (1, False)])
def test_lstm_converter_equals_jax(layers, bidirectional):
    torch.manual_seed(1)
    sd = tnn.LSTM(12, 8, num_layers=layers, bidirectional=bidirectional, batch_first=True).state_dict()
    got = pti.convert_lstm(sd, layers, bidirectional)
    _assert_bit_equal(got, state_dict_from_jax(jti.convert_lstm(sd, layers, bidirectional)["params"]))
    LSTM(12, 8, num_layers=layers, bidirectional=bidirectional).load_state_dict(got, strict=True)


def test_adapt_1ch_equals_jax():
    sd, _ = _standin("resnet18")
    got = pti.adapt_first_conv_to_1ch(pti.convert_resnet(sd, 18))
    want_tree = jti.adapt_first_conv_to_1ch(jti.convert_resnet(sd, 18))
    _assert_bit_equal(got, state_dict_from_jax(want_tree["params"], want_tree["batch_stats"]))
    assert got["conv1.weight"].shape == (64, 1, 7, 7)
    ResNet(18, in_channels=1).load_state_dict(got, strict=True)


def test_graft_backbone_replaces_the_subtree_and_names_mismatches():
    model = get_audio_model("resnet", 4)
    sd, _ = _standin("resnet18")
    backbone = pti.adapt_first_conv_to_1ch(pti.convert_resnet(sd, 18))
    grafted = pti.graft_backbone(model.state_dict(), backbone, "resnet")
    model.load_state_dict(grafted, strict=True)
    assert torch.equal(model.resnet.conv1.weight, backbone["conv1.weight"])
    assert torch.equal(model.resnet.layer4_1.bn2.running_var, backbone["layer4_1.bn2.running_var"])
    with pytest.raises(ValueError, match=r"mismatch.*conv1\.weight"):  # the 3-channel conv1
        pti.graft_backbone(model.state_dict(), pti.convert_resnet(sd, 18), "resnet")
    with pytest.raises(ValueError, match=r"missing=\['layer1_0"):
        pti.graft_backbone(model.state_dict(), {k: v for k, v in backbone.items() if "layer1_0" not in k}, "resnet")
    with pytest.raises(ValueError, match="extra"):
        pti.graft_backbone(model.state_dict(), {**backbone, "nope.weight": torch.zeros(1)}, "resnet")
    with pytest.raises(ValueError, match="no submodule"):
        pti.graft_backbone(model.state_dict(), backbone, "vgg")


def _trainer(model, tmp_path):
    t = Trainer(model, TrainerConfig(model_name="m", num_classes=4, metrics_dir=str(tmp_path / "m"),
                                     checkpoints_dir=str(tmp_path / "c")), device="cpu")
    t.init_state()
    return t


def test_load_pretrained_backbones_grafts_torchvision_weights(tmp_path):
    sd, _ = _standin("resnet18")
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    trainer = _trainer(get_audio_model("resnet", 4), tmp_path)
    head = trainer.model.classifier.fc1.weight.clone()
    cfg = Config.from_dict({"model": {"pretrained": {"arch": "resnet18", "path": path, "submodule": ["resnet"],
                                                     "adapt_1ch": True}}})
    assert load_pretrained_backbones(trainer, cfg) == 1
    want = pti.adapt_first_conv_to_1ch(pti.convert_resnet(sd, 18))
    for k, t in want.items():
        assert torch.equal(trainer.model.resnet.state_dict()[k], t), k
    assert torch.equal(trainer.model.classifier.fc1.weight, head)  # the rest keeps its initialization
    assert load_pretrained_backbones(trainer, Config.from_dict({})) == 0


def test_load_pretrained_backbones_from_a_checkpoint(tmp_path):
    # a video run's resnet into a fusion model's video encoder, as chip_smoke.py does on the card
    video = flax_init_(get_video_model("resnet_attn", 4), torch.Generator().manual_seed(3))
    path = str(tmp_path / "resnet_attn_best.pt")
    save_checkpoint(path, {"epoch": 1, "state": module_state(video), "val_acc": 50.0})
    trainer = _trainer(get_av_model("early_fusion_resnet", 4), tmp_path)
    audio = {k: v.clone() for k, v in trainer.model.audio_encoder.state_dict().items()}
    cfg = Config.from_dict({"model": {"pretrained": [{"arch": "checkpoint", "path": path,
                                                      "source_submodule": ["resnet"],
                                                      "submodule": ["video_encoder", "cnn"]}]}})
    assert load_pretrained_backbones(trainer, cfg) == 1
    source = video.resnet.state_dict()
    grafted = trainer.model.video_encoder.cnn.state_dict()
    assert sorted(grafted) == sorted(source)
    assert all(torch.equal(grafted[k], source[k]) for k in source)
    assert all(torch.equal(trainer.model.audio_encoder.state_dict()[k], v) for k, v in audio.items())
    # the whole model when source_submodule is left out: a ResNet checkpoint into the same place
    whole = str(tmp_path / "resnet.pt")
    save_checkpoint(whole, {"epoch": 1, "state": module_state(ResNet(18)), "val_acc": 0.0})
    cfg = Config.from_dict({"model": {"pretrained": {"arch": "checkpoint", "path": whole,
                                                     "submodule": "video_encoder.cnn"}}})
    assert load_pretrained_backbones(trainer, cfg) == 1
    with pytest.raises(ValueError, match="no submodule 'vgg'"):
        load_pretrained_backbones(trainer, Config.from_dict({"model": {"pretrained": {
            "arch": "checkpoint", "path": path, "source_submodule": ["vgg"], "submodule": ["video_encoder", "cnn"]}}}))


def test_load_pretrained_backbones_refuses_what_it_cannot_honour(tmp_path):
    trainer = _trainer(get_audio_model("resnet", 4), tmp_path)
    for spec, error in (({"arch": "alexnet", "path": "x", "submodule": ["resnet"]}, ValueError),
                        ({"arch": "resnet18", "submodule": ["resnet"]}, ValueError),
                        ({"arch": "resnet18", "path": str(tmp_path / "missing.pth"), "submodule": ["resnet"]},
                         FileNotFoundError)):
        with pytest.raises(error):
            load_pretrained_backbones(trainer, Config.from_dict({"model": {"pretrained": spec}}))


@pytest.mark.parametrize("pipeline", ["audio", "video"])
def test_pipelines_graft_before_training(pipeline, tmp_path, monkeypatch):
    # each pipeline calls load_pretrained_backbones between the
    # initialization and the fit: a missing file stops it before training
    from multimodal_lipread_torch.pipelines import audio as paudio_pipeline
    from multimodal_lipread_torch.pipelines import video as pvideo_pipeline
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips

    root = make_synthetic_glips(str(tmp_path / "GLips_4"), clips_per_split=1, seed=0, with_lip_regions=True)
    fits = []
    monkeypatch.setattr(Trainer, "fit", lambda self, *a, **k: fits.append(self) or {"history": []})
    spec = {"arch": "resnet18", "path": str(tmp_path / "missing.pth"), "submodule": ["resnet"]}
    cfg = Config.from_dict({"dataset": {"root_dir": root, "num_classes": 4},
                            "model": {"name": "resnet" if pipeline == "audio" else "resnet_lstm", "pretrained": spec},
                            "output": {"base_dir": str(tmp_path / "run"), "plots": False}})
    main = paudio_pipeline.main if pipeline == "audio" else pvideo_pipeline.main
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        main(cfg, device="cpu")
    assert not fits
    sd, _ = _standin("resnet18")
    torch.save(sd, spec["path"])
    if pipeline == "audio":
        spec["adapt_1ch"] = True
    cfg.set("model.pretrained", spec)
    main(cfg, device="cpu")
    (trainer,) = fits
    assert torch.equal(trainer.model.resnet.layer2_0.conv1.weight, sd["layer2.0.conv1.weight"])
    assert os.path.isfile(spec["path"])
