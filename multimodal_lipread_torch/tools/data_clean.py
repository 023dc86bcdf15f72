"""Cue-description sanitizer against label leakage through generated text
(counterpart of the JAX package's ``tools/data_clean.py``).

Replaces every occurrence of the target word in a cue description (whole
word, any case, quoted forms included) with the placeholder
``"target word"``, and writes sanitized copies of the JSON files.

    python -m multimodal_lipread_torch.tools.data_clean --input <json or Descriptions_* dir> --output <path>
"""

from __future__ import annotations

import json
import os
import re
from typing import Tuple


def sanitize_text(word: str, description: str) -> Tuple[str, int]:
    """Replace the target word (and its 'quoted' or "quoted" forms) with
    '"target word"' → ``(new text, replacements)``."""
    pattern = re.compile(rf'(["\']?)\b{re.escape(word)}\b(["\']?)', flags=re.IGNORECASE)
    return pattern.subn('"target word"', description)


def sanitize_descriptions(input_json_path: str, output_json_path: str) -> int:
    """Sanitize one cue JSON file; returns the number of entries changed."""
    with open(input_json_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    updated, modified = [], 0
    for entry in data:
        new_desc, n = sanitize_text(entry["word"], entry["description"])
        modified += n > 0
        updated.append({"word": entry["word"], "sequence_id": entry["sequence_id"], "description": new_desc})
    os.makedirs(os.path.dirname(os.path.abspath(output_json_path)), exist_ok=True)
    with open(output_json_path, "w", encoding="utf-8") as f:
        json.dump(updated, f, indent=2, ensure_ascii=False)
    return modified


def sanitize_tree(input_dir: str, output_dir: str) -> int:
    """Sanitize every cue JSON of a ``Descriptions_*`` directory."""
    return sum(sanitize_descriptions(os.path.join(input_dir, name), os.path.join(output_dir, name))
               for name in sorted(os.listdir(input_dir)) if name.endswith(".json"))


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Sanitize cue descriptions (label-leak guard)")
    parser.add_argument("--input", required=True, help="JSON file or Descriptions_* directory")
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)
    if os.path.isdir(args.input):
        n = sanitize_tree(args.input, args.output)
    else:
        n = sanitize_descriptions(args.input, args.output)
    print(f"Sanitized entries modified: {n}")


if __name__ == "__main__":
    main()
