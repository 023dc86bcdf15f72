"""Entry functions of the port's command-line tools (counterpart of the JAX
package's ``cli.py``). Each reads ``sys.argv`` as its module's own CLI
does:

    python -m multimodal_lipread_torch.cli <pipeline> --config <yaml> [--set k=v ...] [--resume] [--device cpu]

with ``<pipeline>`` one of the seven (``audio`` ... ``audio_cues_video``);
the tools are ``lip_extract``, ``frame_extract``, ``cue_generate`` (a
vision LLM behind a remote API writes the cue descriptions),
``data_clean``, ``transcode``, ``serve`` and ``plot``.
"""

from __future__ import annotations

import importlib
import sys

from multimodal_lipread_torch.serving import PIPELINES


def _pipeline_main(name: str) -> int:
    """Run a training pipeline with the current ``sys.argv``."""
    if name not in PIPELINES:
        raise SystemExit(f"unknown pipeline {name!r} (one of {', '.join(PIPELINES)})")
    mod = importlib.import_module(f"multimodal_lipread_torch.pipelines.{name}")
    from multimodal_lipread_torch.pipelines.common import parse_cli

    cfg = parse_cli()
    mod.main(cfg, resume=bool(cfg.get("_cli.resume", False)), device=cfg.get("_cli.device", "cuda"))
    return 0


def audio() -> int:
    return _pipeline_main("audio")


def video() -> int:
    return _pipeline_main("video")


def audio_video() -> int:
    return _pipeline_main("audio_video")


def cues() -> int:
    return _pipeline_main("cues")


def audio_cues() -> int:
    return _pipeline_main("audio_cues")


def cues_video() -> int:
    return _pipeline_main("cues_video")


def audio_cues_video() -> int:
    return _pipeline_main("audio_cues_video")


def _module_main(dotted: str) -> int:
    """Run a module's own ``main`` with the current ``sys.argv``."""
    importlib.import_module(dotted).main()
    return 0


def lip_extract() -> int:
    return _module_main("multimodal_lipread_torch.data.lip_extraction")


def frame_extract() -> int:
    return _module_main("multimodal_lipread_torch.data.frame_extraction")


def data_clean() -> int:
    return _module_main("multimodal_lipread_torch.tools.data_clean")


def cue_generate() -> int:
    return _module_main("multimodal_lipread_torch.tools.cue_generation")


def transcode() -> int:
    return _module_main("multimodal_lipread_torch.tools.transcode")


def serve() -> int:
    return _module_main("multimodal_lipread_torch.serving")


def plot() -> int:
    return _module_main("multimodal_lipread_torch.utils.visualize")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit("usage: python -m multimodal_lipread_torch.cli <pipeline> --config <yaml> [...]")
    sys.exit(_pipeline_main(sys.argv.pop(1)))
