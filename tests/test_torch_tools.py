"""The port's offline tools against the JAX package's, on the CPU:
``data/frame_extraction.py`` (three JPEGs per ``.mp4`` of a GLips tree,
the same names and bytes) and ``tools/data_clean.py`` (the label-leak
sanitizer, the same JSON files), each through its function and its CLI."""

import json
import os

import numpy as np
import pytest

from multimodal_lipread_tpu.data import frame_extraction as jframe_extraction
from multimodal_lipread_tpu.tools import data_clean as jdata_clean

from multimodal_lipread_torch.data import frame_extraction
from multimodal_lipread_torch.tools import data_clean


def _tree(root) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def video_tree(tmp_path_factory):
    """A GLips tree of two words with small .mp4 clips of 7 and 10 frames
    (each frame its own grey level) and one file that is not a video."""
    import cv2
    root = tmp_path_factory.mktemp("frames") / "GLips"
    for word, split, name, frames in (("abend", "train", "abend_00001.mp4", 7),
                                      ("abend", "val", "abend_00002.mp4", 10),
                                      ("dabei", "test", "dabei_00003.mp4", 10)):
        path = root / "lipread_files" / word / split / name
        path.parent.mkdir(parents=True, exist_ok=True)
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (32, 24))
        for i in range(frames):
            writer.write(np.full((24, 32, 3), 20 * i, np.uint8))
        writer.release()
    (root / "lipread_files" / "dabei" / "test" / "notes.txt").write_text("not a video")
    return str(root)


def test_extract_dataset_frames_equals_jax(video_tree, tmp_path):
    got = frame_extraction.extract_dataset_frames(video_tree, str(tmp_path / "ours"))
    want = jframe_extraction.extract_dataset_frames(video_tree, str(tmp_path / "theirs"))
    assert got == want == (3, 9)
    ours, theirs = _tree(tmp_path / "ours"), _tree(tmp_path / "theirs")
    assert sorted(ours) == sorted(theirs) and ours == theirs
    assert "val/abend/abend_00002_frame1.jpg" in ours and "train/abend/abend_00001_frame3.jpg" in ours


def test_frame_extraction_cli_and_frame_choice(video_tree, tmp_path, capsys):
    import cv2

    frame_extraction.main(["--root", video_tree, "--out", str(tmp_path / "cli"), "--num-frames", "2"])
    assert "Extracted 6 frames from 3 videos" in capsys.readouterr().out
    # frames int(i * total / n): 0 and 5 of the 10-frame clip, whose grey
    # levels step by 20 a frame (mp4v and JPEG move them by a few levels)
    levels = [cv2.imread(str(tmp_path / "cli" / "val" / "abend" / f"abend_00002_frame{k}.jpg")).mean()
              for k in (1, 2)]
    np.testing.assert_allclose(levels, [0, 100], atol=8)
    assert frame_extraction.extract_frames_from_video(str(tmp_path / "missing.mp4"), str(tmp_path / "x"), "m") == 0


@pytest.fixture
def cue_dir(tmp_path):
    d = tmp_path / "Descriptions_Emotion"
    d.mkdir()
    records = {
        "abend.json": [
            {"word": "abend", "sequence_id": "00001", "description": "Der Sprecher sagt 'Abend' am ABEND."},
            {"word": "abend", "sequence_id": "00002", "description": "Abendlich ruhig, kein Wort."},
        ],
        "dabei.json": [{"word": "dabei", "sequence_id": "00003", "description": 'Er ist "dabei", ganz dabei!'}],
    }
    for name, rows in records.items():
        (d / name).write_text(json.dumps(rows, ensure_ascii=False), encoding="utf-8")
    (d / "readme.txt").write_text("skipped")
    return str(d)


@pytest.mark.parametrize("word, text", [
    ("abend", "Der Sprecher sagt 'Abend' am ABEND."),
    ("abend", "Abendlich ruhig"),
    ("c++", "c++ is not a word boundary case"),
    ("dabei", '"dabei" und dabei.'),
])
def test_sanitize_text_equals_jax(word, text):
    assert data_clean.sanitize_text(word, text) == jdata_clean.sanitize_text(word, text)


def test_sanitize_tree_equals_jax(cue_dir, tmp_path):
    got = data_clean.sanitize_tree(cue_dir, str(tmp_path / "ours"))
    want = jdata_clean.sanitize_tree(cue_dir, str(tmp_path / "theirs"))
    assert got == want == 2
    assert _tree(tmp_path / "ours") == _tree(tmp_path / "theirs")
    with open(tmp_path / "ours" / "abend.json", encoding="utf-8") as f:
        assert json.load(f)[0]["description"] == 'Der Sprecher sagt "target word" am "target word".'


def test_data_clean_cli_on_a_file(cue_dir, tmp_path, capsys):
    out = str(tmp_path / "one" / "dabei.json")
    data_clean.main(["--input", os.path.join(cue_dir, "dabei.json"), "--output", out])
    assert capsys.readouterr().out.strip() == "Sanitized entries modified: 1"
    jdata_clean.sanitize_descriptions(os.path.join(cue_dir, "dabei.json"), str(tmp_path / "j.json"))
    with open(out, "rb") as a, open(tmp_path / "j.json", "rb") as b:
        assert a.read() == b.read()
