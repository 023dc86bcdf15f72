"""Fetch and verify torchvision ImageNet checkpoints for pretrained
grafting (counterpart of the JAX package's ``tools/fetch_weights.py``; the
same table, checks and messages).

The reference initializes every CNN backbone from torchvision ImageNet
weights (reference: video/models/resnet_lstm.py:80-86,
audio/models/resnet_model.py:10-12); accuracy parity depends on that init.
A machine without egress cannot download them, so this tool is the
runbook: run it on any machine WITH egress, copy the ``.pth`` files over,
then point ``model.pretrained`` at them (see
``pipelines/common.py:load_pretrained_backbones``).

    # on a machine with internet:
    python -m multimodal_lipread_torch.tools.fetch_weights --out /weights --all
    # or one arch:
    python -m multimodal_lipread_torch.tools.fetch_weights --out /weights --arch resnet18

    # then in any pipeline YAML:
    model:
      pretrained:
        - {arch: resnet18, path: /weights/resnet18-f37072fd.pth,
           submodule: [resnet], adapt_1ch: true}

Each torchvision filename embeds the first 8 hex chars of the file's sha256
(the same check ``torch.hub.load_state_dict_from_url`` performs); downloads
are verified against it before being kept.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import sys
from typing import Dict

# torchvision IMAGENET1K_V1 checkpoint URLs for every backbone family this
# framework's converters support (utils/torch_import.py)
WEIGHT_URLS: Dict[str, str] = {
    "resnet18": "https://download.pytorch.org/models/resnet18-f37072fd.pth",
    "resnet34": "https://download.pytorch.org/models/resnet34-b627a593.pth",
    "resnet50": "https://download.pytorch.org/models/resnet50-0676ba61.pth",
    "vgg11": "https://download.pytorch.org/models/vgg11_bn-6002323d.pth",
    "vgg13": "https://download.pytorch.org/models/vgg13_bn-abd245e5.pth",
    "vgg16": "https://download.pytorch.org/models/vgg16_bn-6c64b313.pth",
    "vgg19": "https://download.pytorch.org/models/vgg19_bn-c79401a0.pth",
    "mobilenet_v2": "https://download.pytorch.org/models/mobilenet_v2-b0353104.pth",
    "mobilenet_v3_small": "https://download.pytorch.org/models/mobilenet_v3_small-047dcff4.pth",
    "shufflenet_v2_x0_5": "https://download.pytorch.org/models/shufflenetv2_x0.5-f707e7126e.pth",
    "shufflenet_v2_x1_0": "https://download.pytorch.org/models/shufflenetv2_x1-5666bf0f80.pth",
}


def expected_hash_prefix(url: str) -> str:
    """The sha256 prefix torchvision embeds in the checkpoint filename."""
    m = re.search(r"-([0-9a-f]{8,64})\.pth$", url)
    if not m:
        raise ValueError(f"no hash fragment in {url}")
    return m.group(1)


def verify_file(path: str, url: str) -> bool:
    """sha256(path) must start with the filename's embedded hash prefix."""
    prefix = expected_hash_prefix(url)
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest().startswith(prefix)


def fetch(arch: str, out_dir: str, timeout: float = 120.0) -> str:
    """Download + verify one checkpoint; returns the local path.

    Raises RuntimeError with an actionable message when the environment has
    no egress or the hash check fails.
    """
    url = WEIGHT_URLS[arch]
    os.makedirs(out_dir, exist_ok=True)
    dest = os.path.join(out_dir, os.path.basename(url))
    if os.path.exists(dest):
        if verify_file(dest, url):
            print(f"{arch}: already present and verified ({dest})")
            return dest
        raise RuntimeError(f"{dest} exists but fails its sha256 check — delete and re-run")

    import urllib.error
    import urllib.request

    tmp = dest + ".part"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    except (urllib.error.URLError, OSError) as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"could not download {url} ({e}). This environment may have no "
            f"egress — run this tool on a machine with internet access and "
            f"copy the .pth files into {out_dir}."
        ) from e
    if not verify_file(tmp, url):
        os.remove(tmp)
        raise RuntimeError(f"downloaded {url} but sha256 does not match its filename prefix")
    os.replace(tmp, dest)
    print(f"{arch}: fetched and verified → {dest}")
    return dest


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True, help="directory to store .pth files")
    p.add_argument("--arch", action="append", default=[], choices=sorted(WEIGHT_URLS),
                   help="backbone(s) to fetch (repeatable)")
    p.add_argument("--all", action="store_true", help="fetch every supported backbone")
    args = p.parse_args(argv)
    archs = sorted(WEIGHT_URLS) if args.all else args.arch
    if not archs:
        p.error("pass --arch <name> (repeatable) or --all")
    failures = []
    for arch in archs:
        try:
            fetch(arch, args.out)
        except RuntimeError as e:
            print(f"{arch}: FAILED — {e}", file=sys.stderr)
            failures.append(arch)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
