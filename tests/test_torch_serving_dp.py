"""Data-parallel serving of the port on the CPU (the JAX ``Predictor.mesh``
and ``--data-parallel``): two CPU replicas give the one-replica logits
within 1e-6, through ``Predictor``, ``predict_clips`` and the CLI, and a
batch size that the replica count does not divide raises, as in the JAX
package."""

import json

import numpy as np
import pytest
import torch

from torch_parity_utils import one_torch_thread  # noqa: F401

from multimodal_lipread_torch import serving
from multimodal_lipread_torch.config import Config
from multimodal_lipread_torch.data.glips import scan_glips
from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
from multimodal_lipread_torch.nn.common import flax_init_
from multimodal_lipread_torch.train.checkpoint import module_state, save_checkpoint

TOL = 1e-6  # tests/test_serving.py's bound for the JAX mesh


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_serve")
    root = make_synthetic_glips(str(tmp / "GLips_4"), clips_per_split=2, seed=5)
    config = Config.from_dict({"dataset": {"root_dir": root, "num_classes": 4, "input_size": 117},
                               "model": {"name": "vgg_lstm", "version": 11}})
    model = serving.build_audio_model(config)
    flax_init_(model, torch.Generator().manual_seed(0))
    ckpt = str(tmp / "vgg_lstm_best.pt")
    save_checkpoint(ckpt, {"state": module_state(model), "classes": scan_glips(root).classes})
    clips = [e.path for e in scan_glips(root).entries][:10]
    return {"config": config, "ckpt": ckpt, "clips": clips, "model": model}


def _logits(results):
    return np.asarray([r["logits"] for r in results], np.float32)


def test_two_cpu_replicas_give_the_one_replica_logits(served):
    from multimodal_lipread_torch.pipelines.common import compute_logmel_features, decode_waveforms

    feats = compute_logmel_features(decode_waveforms(served["clips"]), device="cpu")
    one = serving.Predictor(model=served["model"], batch_size=4, device="cpu").predict_logits(feats)
    two = serving.Predictor(model=_copy(served), batch_size=4, devices=["cpu", "cpu"])
    assert len(two.replicas) == 2 and two.replicas[1].model is not two.model
    got = two.predict_logits(feats)  # 10 clips: batches of 4, 4 and 2 (+ 2 padding rows)
    assert got.shape == one.shape == (10, 4)
    np.testing.assert_allclose(got, one, atol=TOL, rtol=0)


def _copy(served):
    model = serving.build_audio_model(served["config"])
    model.load_state_dict(served["model"].state_dict())
    return model


def test_batch_not_divisible_by_the_replicas_raises(served):
    with pytest.raises(ValueError, match="multiple of the 2 replicas"):
        serving.Predictor(model=_copy(served), batch_size=5, devices=["cpu", "cpu"])
    assert serving.replica_devices("cpu") == ["cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no card visible"):
            serving.replica_devices("cuda")


def test_predict_clips_data_parallel_equals_single_device(served):
    args = (served["config"], served["ckpt"], "audio", [[c] for c in served["clips"]], 4)
    one = serving.predict_clips(*args, device="cpu")
    two = serving.predict_clips(*args, device="cpu", devices=["cpu", "cpu"])
    assert [r["word"] for r in two] == [r["word"] for r in one]
    np.testing.assert_allclose(_logits(two), _logits(one), atol=TOL, rtol=0)


def test_cli_data_parallel(served, tmp_path, capsys, monkeypatch):
    cfg_path = str(tmp_path / "cfg.yaml")
    served["config"].save(cfg_path)
    base = ["--pipeline", "audio", "--config", cfg_path, "--checkpoint", served["ckpt"], "--device", "cpu"]
    serving.main(base + ["--batch-size", "4"] + served["clips"])
    one = json.loads(capsys.readouterr().out)
    # the CPU is one device: stand two replicas in for two cards
    monkeypatch.setattr(serving, "replica_devices", lambda device: ["cpu", "cpu"])
    serving.main(base + ["--batch-size", "4", "--data-parallel"] + served["clips"])
    two = json.loads(capsys.readouterr().out)
    np.testing.assert_allclose(_logits(two), _logits(one), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="multiple of the 2 replicas"):
        serving.main(base + ["--batch-size", "3", "--data-parallel"] + served["clips"])
