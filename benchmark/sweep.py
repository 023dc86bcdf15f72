"""Find a serve cell's knee: one set-up, then one open-loop window per rate.

    python3 benchmark/sweep.py --workload <serve cell> --seed 5 --seconds 10 --rates 50 100 150 200

For each rate it prints the latency percentiles, the queue's p95 and
whether the backlog grew over the window: the median latency of the last
third of the requests over that of the first third, and how long after
the window's close the last answer came. The knee is the highest rate
whose backlog does not grow; a cell's mix fixes its rate below it. The
benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.drivers import serve as serve_driver  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    spec = harness.load_spec(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ctx = harness.Context(spec, harness.find_cell(spec, args.workload), args.seed, args.seconds, False,
                          torch.device(args.device), time.perf_counter())
    try:
        mix = ctx.mix
        _corpus, _predictor, request = serve_driver.setup(ctx)
        for rate in args.rates:
            due, ids = serve_driver.schedule(dict(mix, rate_per_s=rate), args.seed, args.seconds)
            out = serve_driver.serve_window(request, due, ids, mix["workers"], args.seconds)
            lat = (out["done"] - due) * 1e3
            third = max(1, len(lat) // 3)
            print(json.dumps({
                "rate_per_s": rate, "requests": len(due), "failed": int(np.isnan(out["done"]).sum()),
                "p50_ms": float(np.nanpercentile(lat, 50)), "p95_ms": float(np.nanpercentile(lat, 95)),
                "queue_p95_ms": float(np.nanpercentile((out["start"] - due) * 1e3, 95)),
                "growth": float(np.nanmedian(lat[-third:]) / np.nanmedian(lat[:third])),
                "last_answer_after_close_s": float(np.nanmax(out["done"]) - args.seconds),
                "clips_per_s": float(sum(len(i) for i in ids) / args.seconds)}), flush=True)
    finally:
        ctx.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
