"""The port's copies of the JAX package's host tools against the JAX ones,
offline: ``tools/cue_generation.py`` (a fake LLM client, the same frames:
byte-identical JSON, the prompts, the rate limiter, the retries, the
interim checkpoints) and ``tools/fetch_weights.py`` (the URL table, the
sha256-prefix check, the reuse of a verified file and the message without
egress, with ``urlopen`` made to fail: nothing is downloaded)."""

import hashlib
import json
import os

import pytest

from multimodal_lipread_tpu.tools import cue_generation as jcue
from multimodal_lipread_tpu.tools import fetch_weights as jfetch

from multimodal_lipread_torch.tools import cue_generation as pcue
from multimodal_lipread_torch.tools import fetch_weights as pfetch


def _frames(root, stems, per_stem=3):
    os.makedirs(root, exist_ok=True)
    for stem in stems:
        for k in range(per_stem):
            with open(os.path.join(root, f"{stem}_frame{k}.jpg"), "wb") as f:
                f.write(f"jpg {stem} {k}".encode())
    return str(root)


def _client(calls):
    def complete(prompt, paths):
        calls.append((prompt, tuple(os.path.basename(p) for p in paths)))
        return f"a calm face ({len(paths)} frames, {os.path.basename(paths[0])})"

    return complete


@pytest.mark.parametrize("mode", ["emotion", "environment"])
def test_cue_json_is_byte_identical_to_jax(tmp_path, mode):
    frames = _frames(tmp_path / "frames", ["wort_0001-0002", "wort_0003-0004", "wort_12-345", "bad_stem"])
    outs, calls = {}, {}
    for side, mod in (("jax", jcue), ("torch", pcue)):
        calls[side] = []
        out = tmp_path / side / f"lipreading_analysis_results_{mode}_wort_train.json"
        mod.generate_cues_for_word(frames, str(out), "wort", mode=mode, client=_client(calls[side]),
                                   rate_limiter=mod.RateLimiter(0.0), sleep=lambda s: None, checkpoint_every=2)
        outs[side] = out.read_bytes()
        assert not os.path.exists(str(out) + ".interim")
    assert outs["torch"] == outs["jax"]
    assert sorted(calls["torch"]) == sorted(calls["jax"]) and len(calls["torch"]) == 3
    assert {r["sequence_id"] for r in json.loads(outs["torch"])} == {"0001-0002", "0003-0004", "12-345"}


@pytest.mark.parametrize("mode, word", [("emotion", "abend"), ("environment", "dabei"), ("emotion", "ä-ö")])
def test_prompts_are_the_jax_prompts(mode, word):
    assert pcue.build_prompt(mode, word) == jcue.build_prompt(mode, word)


def test_frames_group_by_sequence_as_in_jax(tmp_path):
    frames = _frames(tmp_path / "f", ["a_0001-0002", "a_7-8", "x"], per_stem=2)
    with open(os.path.join(frames, "notes.txt"), "w") as f:
        f.write("not a frame")
    assert pcue.group_frames_by_sequence(frames) == jcue.group_frames_by_sequence(frames)
    assert set(pcue.group_frames_by_sequence(frames)) == {"a_0001-0002", "a_7-8"}
    assert pcue.group_frames_by_sequence(str(tmp_path / "missing")) == {}


def test_retries_on_a_rate_limit_then_gives_up(tmp_path):
    frames = _frames(tmp_path / "f", ["w_0001-0002"], per_stem=2)
    attempts, sleeps = [], []

    def flaky(prompt, paths):
        attempts.append(1)
        if len(attempts) < 3:
            raise RuntimeError("429 rate limit")
        return "ok"

    got = pcue.generate_cues_for_word(frames, str(tmp_path / "o.json"), "w", client=flaky,
                                      rate_limiter=pcue.RateLimiter(0.0), sleep=sleeps.append)
    assert len(got) == 1 and len(attempts) == 3 and sleeps.count(25.0) == 2

    def always_limited(prompt, paths):
        raise RuntimeError("Rate limit reached")

    sleeps.clear()
    got = pcue.generate_cues_for_word(frames, str(tmp_path / "p.json"), "w", client=always_limited,
                                      rate_limiter=pcue.RateLimiter(0.0), sleep=sleeps.append)
    assert got == [] and sleeps.count(25.0) == 6  # 6 attempts, then the sequence is dropped
    assert json.loads((tmp_path / "p.json").read_text()) == []


def test_other_errors_drop_the_sequence_without_retry(tmp_path, capsys):
    frames = _frames(tmp_path / "f", ["w_0001-0002"])
    attempts = []

    def broken(prompt, paths):
        attempts.append(1)
        raise ValueError("bad image")

    assert pcue.generate_cues_for_word(frames, str(tmp_path / "o.json"), "w", client=broken,
                                       rate_limiter=pcue.RateLimiter(0.0), sleep=lambda s: None) == []
    assert attempts == [1] and "cue generation failed" in capsys.readouterr().out


def test_rate_limiter_spaces_requests_by_its_interval():
    limiter, slept = pcue.RateLimiter(min_interval=22.0), []
    limiter.wait(slept.append)
    limiter.wait(slept.append)
    assert slept and 21.0 < slept[-1] <= 22.0


def test_interim_checkpoint_every_n_results(tmp_path, monkeypatch):
    frames = _frames(tmp_path / "f", [f"w_{i:04d}-0001" for i in range(5)], per_stem=1)
    out = str(tmp_path / "o.json")
    writes = []
    write = pcue._write_json
    monkeypatch.setattr(pcue, "_write_json", lambda path, data: (writes.append((path, len(data))), write(path, data)))
    pcue.generate_cues_for_word(frames, out, "w", client=lambda prompt, paths: "desc",
                                rate_limiter=pcue.RateLimiter(0.0), sleep=lambda s: None, checkpoint_every=2)
    assert writes == [(out + ".interim", 2), (out + ".interim", 4), (out, 5)]
    assert not os.path.exists(out + ".interim")


def test_generate_all_cues_writes_the_jax_tree(tmp_path):
    data = tmp_path / "cue_data"
    for split in ("train", "val"):
        _frames(data / split / "abend", [f"abend_{split}_0001-0002"], per_stem=2)
    for side, mod in (("jax", jcue), ("torch", pcue)):
        mod.generate_all_cues(str(data), str(tmp_path / side), ["abend"], splits=("train", "val"),
                              client=_client([]), rate_limiter=mod.RateLimiter(0.0), sleep=lambda s: None)
    walk = {side: sorted(os.path.relpath(os.path.join(d, f), tmp_path / side)
                         for d, _, files in os.walk(tmp_path / side) for f in files) for side in ("jax", "torch")}
    assert walk["torch"] == walk["jax"] and len(walk["torch"]) == 4
    for rel in walk["torch"]:
        assert (tmp_path / "torch" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


# --- fetch_weights -------------------------------------------------------------


def test_weight_urls_equal_the_jax_table_and_cover_every_converter():
    from multimodal_lipread_torch.pipelines.common import _pretrained_converters

    assert pfetch.WEIGHT_URLS == jfetch.WEIGHT_URLS
    assert set(pfetch.WEIGHT_URLS) == set(_pretrained_converters())
    for url in pfetch.WEIGHT_URLS.values():
        assert pfetch.expected_hash_prefix(url) == jfetch.expected_hash_prefix(url)
    with pytest.raises(ValueError, match="no hash fragment"):
        pfetch.expected_hash_prefix("https://example.com/model.pth")


def test_verify_file_checks_the_sha256_prefix(tmp_path):
    payload = b"fake checkpoint bytes"
    digest = hashlib.sha256(payload).hexdigest()
    path = tmp_path / f"model-{digest[:8]}.pth"
    path.write_bytes(payload)
    for url, ok in ((f"https://example.com/model-{digest[:8]}.pth", True),
                    ("https://example.com/model-00000000.pth", False)):
        assert pfetch.verify_file(str(path), url) is ok is jfetch.verify_file(str(path), url)


def _refuse_network(monkeypatch):
    import urllib.error
    import urllib.request

    def refuse(*args, **kwargs):
        raise urllib.error.URLError("no egress")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def test_fetch_reuses_a_verified_file_and_refuses_a_corrupt_one(tmp_path, monkeypatch):
    _refuse_network(monkeypatch)
    payload = b"fake checkpoint bytes"
    digest = hashlib.sha256(payload).hexdigest()
    monkeypatch.setitem(pfetch.WEIGHT_URLS, "_ok", f"https://download.invalid/model-{digest[:8]}.pth")
    monkeypatch.setitem(pfetch.WEIGHT_URLS, "_bad", "https://download.invalid/other-deadbeef.pth")
    (tmp_path / f"model-{digest[:8]}.pth").write_bytes(payload)
    (tmp_path / "other-deadbeef.pth").write_bytes(payload)
    assert pfetch.fetch("_ok", str(tmp_path)) == str(tmp_path / f"model-{digest[:8]}.pth")
    with pytest.raises(RuntimeError, match="fails its sha256 check"):
        pfetch.fetch("_bad", str(tmp_path))


def test_fetch_without_egress_raises_the_runbook_message(tmp_path, monkeypatch):
    _refuse_network(monkeypatch)
    monkeypatch.setitem(pfetch.WEIGHT_URLS, "_missing", "https://download.invalid/model-deadbeef.pth")
    with pytest.raises(RuntimeError, match="no egress — run this tool on a machine with internet access"):
        pfetch.fetch("_missing", str(tmp_path / "w"))
    assert os.listdir(tmp_path / "w") == []  # no partial download is left
    assert pfetch.main(["--out", str(tmp_path / "w"), "--arch", "resnet18"]) == 1
