"""The port's plotting functions (``multimodal_lipread_torch/utils/
visualize.py``) against the JAX package's on the same logs and inputs:
``collect_final_accuracies`` (TXT footers, and the CSV-only fallback of the
cue classifiers), ``cues_compare_from_logs`` (the accuracies it charts and
the PNG), ``plot_cue_comparison`` and ``plot_lip_sequence_grid`` (uint8 and
float sequences: PNGs of the JAX one's pixel size). The port reads the CSV
logs with ``csv``, the JAX package with pandas."""

import numpy as np
import pytest
from matplotlib import image as mpimg

from multimodal_lipread_tpu.utils import visualize as jvis

from multimodal_lipread_torch.utils import visualize as tvis
from multimodal_lipread_torch.utils.metrics_log import MetricLogger

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _logs(folder, final_acc=None, columns="full", model="m", val_accs=(40.0, 52.5)):
    """The port trainer's logs of a 2-epoch run: per-epoch CSV and TXT, and
    the TXT footer where ``final_acc`` is given."""
    log = MetricLogger(str(folder), model, columns=columns)
    for epoch, val_acc in enumerate(val_accs, start=1):
        log.log_epoch(epoch, 1.0 / epoch, 50.0 + epoch, 1.1 / epoch, val_acc,
                      *((1.2 / epoch, 45.0 + epoch) if columns == "full" else (None, None)))
    if final_acc is not None:
        log.log_final(0.75, final_acc)


@pytest.fixture
def metrics_dirs(tmp_path):
    emo, env = tmp_path / "emotion", tmp_path / "environment"
    _logs(emo, model="multi_attn", columns="train_val", val_accs=(61.25, 65.0))  # the CSV fallback
    _logs(emo, final_acc=58.33, model="dense_nn")
    _logs(emo, model="bert", columns="train_val", val_accs=(30.0, 42.5))
    _logs(env, model="multi_attn", columns="train_val", val_accs=(39.4, 37.5))
    _logs(env, final_acc=44.44, model="transformer")
    # a TXT footer written twice (a resumed run): the last one counts
    with open(env / "transformer_training_log.txt", "a") as f:
        f.write("Final Test Loss: 0.7000, Final Test Acc: 47.22%\n")
    (env / "orphan_training_log.txt").write_text("Epoch 1\n")  # no footer, no CSV: left out
    return emo, env


def test_collect_final_accuracies_equals_jax(metrics_dirs):
    for folder in metrics_dirs:
        got, want = tvis.collect_final_accuracies(str(folder)), jvis.collect_final_accuracies(str(folder))
        assert got == want
    assert tvis.collect_final_accuracies(str(metrics_dirs[0])) == {"bert": 42.5, "dense_nn": 58.33,
                                                                    "multi_attn": 65.0}
    assert tvis.collect_final_accuracies(str(metrics_dirs[1])) == {"multi_attn": 37.5, "transformer": 47.22}


def test_cues_compare_from_logs_charts_the_jax_accuracies(metrics_dirs, tmp_path, monkeypatch):
    charted = {}
    for name, module in (("port", tvis), ("jax", jvis)):
        real = module.plot_cue_comparison

        def spy(accuracies, out_path, *args, _name=name, _real=real, **kwargs):
            charted[_name] = accuracies
            return _real(accuracies, out_path, *args, **kwargs)

        monkeypatch.setattr(module, "plot_cue_comparison", spy)
        out = module.cues_compare_from_logs(*map(str, metrics_dirs), str(tmp_path / name / "cmp.png"))
        with open(out, "rb") as f:
            assert f.read(8) == PNG_MAGIC
    assert charted["port"] == charted["jax"]
    assert list(charted["port"]) == ["bert", "dense_nn", "multi_attn", "transformer"]
    assert charted["port"]["transformer"] == [0.0, 47.22]


def test_plot_cue_comparison_matches_the_jax_png_size(tmp_path):
    acc = {"dense": [54.4, 40.6], "attn": [65.0, 39.4], "bert": [70.1, 41.0]}
    got = tvis.plot_cue_comparison(acc, str(tmp_path / "port" / "bars.png"))
    want = jvis.plot_cue_comparison(acc, str(tmp_path / "jax" / "bars.png"))
    assert mpimg.imread(got).shape == mpimg.imread(want).shape


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_plot_lip_sequence_grid_matches_the_jax_png_size(tmp_path, dtype):
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 255, (29, 44, 44, 3), dtype=np.uint8)
    if dtype == "float32":
        seq = (seq / 255.0).astype(np.float32)
        seq[0, 0, 0] = (-0.5, 1.5, 0.5)  # outside [0, 1]: clipped
    got = tvis.plot_lip_sequence_grid(seq, str(tmp_path / "port" / "grid.png"))
    want = jvis.plot_lip_sequence_grid(seq, str(tmp_path / "jax" / "grid.png"))
    with open(got, "rb") as f:
        assert f.read(8) == PNG_MAGIC
    assert mpimg.imread(got).shape == mpimg.imread(want).shape
