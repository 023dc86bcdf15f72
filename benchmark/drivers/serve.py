"""The serve driver: open-loop requests at a fixed rate to a resident
predictor. Mix parameters: ``pool`` (clips on disk), ``rate_per_s``,
``clips_min`` / ``clips_max`` (a request asks for k clips with
P(k) ∝ 1/k), ``workers`` (server threads), ``batch_size`` (the
predictor's fixed batch) and ``check_requests`` (answers compared with the
reference, the largest request among them).

Every seed gets the same work in another order: ``rate × seconds``
requests whose gaps are the exponential distribution's quantiles (scaled
to fill the window) and whose sizes are the 1/k law's quantiles, each list
shuffled by the seed, and the clips of each request drawn by the seed. A
dispatcher thread puts each request on the queue at its due time; a
request's latency runs from its due time to its logits on the host, so a
stall is charged to every request queued behind it. Every request due in
the window is waited for, up to a minute past its close."""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from benchmark import checks, tracing

DRAIN_S = 60.0


def schedule(mix: dict, seed: int, seconds: float) -> tuple:
    """(due seconds (n,), clip ids per request) for one window."""
    rate = float(mix["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps *= seconds / gaps.sum()
    ks = np.arange(mix["clips_min"], mix["clips_max"] + 1)
    cdf = np.cumsum(1.0 / ks) / np.sum(1.0 / ks)
    sizes = ks[np.minimum(np.searchsorted(cdf, q), len(ks) - 1)]
    rng = np.random.default_rng(seed)
    gaps, sizes = rng.permutation(gaps), rng.permutation(sizes)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    ids = [rng.choice(mix["pool"], size=int(k), replace=False) for k in sizes]
    return due, ids


def _union_s(intervals) -> float:
    total, end = 0.0, -np.inf
    for s, t in sorted(intervals):
        if t > end:
            total += t - max(s, end)
            end = t
    return total


def serve_window(request, due, ids, workers: int, seconds: float) -> dict:
    """Offer the requests at their due times; returns per request its
    start and end of service (host seconds from the window's start, NaN
    where it never ended), its logits or error, and the dispatcher's
    lateness."""
    n = len(due)
    start, done, sent = np.full(n, np.nan), np.full(n, np.nan), np.full(n, np.nan)
    logits, errors = [None] * n, {}
    work: "queue.Queue" = queue.Queue()
    t0 = time.perf_counter()

    def serve():
        while True:
            i = work.get()
            if i is None:
                return
            start[i] = time.perf_counter() - t0
            try:
                logits[i] = request(ids[i])
            except Exception as e:  # noqa: BLE001 — counted as failed
                errors[i] = repr(e)
            done[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=serve, name=f"bench-serve-{w}", daemon=True) for w in range(workers)]
    for t in threads:
        t.start()
    for i in range(n):
        delay = due[i] - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        sent[i] = time.perf_counter() - t0
        work.put(i)
    rest = seconds - (time.perf_counter() - t0)
    if rest > 0:
        time.sleep(rest)
    for _ in threads:
        work.put(None)
    deadline = time.perf_counter() + DRAIN_S
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    return {"start": start, "done": done, "sent": sent, "logits": logits, "errors": errors,
            "hung": any(t.is_alive() for t in threads)}


def setup(ctx) -> tuple:
    """The pool on disk, the resident predictor and its request, warmed on
    the largest, the smallest and again the largest request."""
    mix = ctx.mix
    corpus = ctx.adapter.make_corpus(ctx, mix["pool"])
    ctx.phase("corpus")
    predictor, request = ctx.adapter.build_serve(ctx, corpus, mix["batch_size"])
    ctx.phase("predictor")
    pool = np.arange(mix["pool"])
    for k in (mix["clips_max"], mix["clips_min"], mix["clips_max"]):
        request(pool[:k])
    ctx.sync()
    ctx.phase("warm-up")
    return corpus, predictor, request


def run(ctx) -> dict:
    mix, adapter = ctx.mix, ctx.adapter
    corpus, predictor, request = setup(ctx)
    due, ids = schedule(mix, ctx.seed, ctx.seconds)
    with tracing.window(ctx.trace) as win:
        ctx.mark_setup_done()
        out = serve_window(request, due, ids, mix["workers"], ctx.seconds)
        ctx.sync()
    if out["hung"]:
        raise RuntimeError(f"requests still in service {DRAIN_S:.0f} s after the window closed")
    ctx.read_memory_peak()
    del predictor, request
    ctx.free()

    answered = [i for i in range(len(due)) if out["logits"][i] is not None]
    latency_ms = (out["done"] - due)[answered] * 1e3
    queue_ms = (out["start"] - due)[answered] * 1e3
    late_ms = (out["sent"] - due) * 1e3
    ctx.note(f"requests {len(due)}, answered {len(answered)}, latency p95 "
             f"{np.percentile(latency_ms, 95) if answered else float('nan'):.3f} ms (not judged), dispatcher late "
             f"p50 {np.median(late_ms):.3f} ms, max {np.max(late_ms):.3f} ms; errors {list(out['errors'].values())[:3]}")

    # the reference on a sample of answered requests drawn from the seed, the largest among them
    rng = np.random.default_rng(ctx.seed + 1)
    sample = set(rng.choice(answered, size=min(mix["check_requests"], len(answered)), replace=False).tolist())
    if answered:
        sample.add(max(answered, key=lambda i: len(ids[i])))
    sample = sorted(sample)
    program = [out["logits"][i] for i in sample]
    reference = []
    with ctx.reference_precision(), torch.no_grad():
        for i in sample:
            inputs = adapter.reference_inputs(corpus, ids[i], ctx.device)
            reference.append(ctx.reference.forward(ctx.weights, ctx.config, inputs, False).float().cpu().numpy())
    numbers = checks.serve_numbers(program, reference)
    clips = int(sum(len(ids[i]) for i in answered))
    service = _union_s(zip(out["start"][answered], out["done"][answered]))
    return {
        "e2e": {"serve_p50_ms": float(np.percentile(latency_ms, 50)) if answered else float("nan")},
        "attempted": len(due), "failed": len(due) - len(answered), "numbers": numbers,
        "view": {"trace": win.trace, "queue_ms": queue_ms, "clips": clips, "service_s": service,
                 "flops_per_clip": lambda: ctx.reference_flops(1, train=False)},
    }
