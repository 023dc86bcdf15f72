"""Spans and the device trace of a measured window.

The benchmark's spans are named ``bench.*`` and placed in its own files
around each call into a layer of the program. While a traced window is
open they are kept in memory, each with its start and end on the host's
wall clock in ns (the clock of the profiler's events); otherwise they
cost a check of one flag. A traced window runs under ``torch.profiler``
with the CUDA activity alone: recording every CPU operator as well slowed
a vgg_lstm train step by a third on the card. :func:`reduce` reads the
raw Kineto events once: the device activities (kernels, copies, memsets)
that start in the window, their union (the busy time), the idle gaps
labelled by the spans the host was in, the time by device operation, the
log-mel kernel's launches with their batch, and the spans' durations.

A launch's batch is that of the spans open over the whole kernel, where
they all name one batch (a serving request's span ends on a copy back,
so its launch runs inside it; every train step names the same batch); a
launch that no span places is left out and counted."""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

LOGMEL_KERNEL = "logmel_kernel"

# (start ns, end ns, name, log-mel clips) kept while a traced window is open
_spans: Optional[List[tuple]] = None
_lock = threading.Lock()


@contextlib.contextmanager
def span(name: str, logmel_clips: Optional[int] = None):
    """A span around one call into the program; ``logmel_clips`` is the
    batch of the log-mel launch the call makes, where it makes one."""
    if _spans is None:
        yield
        return
    start = time.time_ns()
    try:
        yield
    finally:
        end = time.time_ns()
        with _lock:
            if _spans is not None:
                _spans.append((start, end, name, logmel_clips))


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: int
    op_seconds: Dict[str, float]
    idle_seconds: Dict[str, float]
    spans: Dict[str, List[float]]
    logmel_launches: List[Tuple[int, float]]  # (clips, seconds)
    logmel_unread: int = 0  # launches that no span placed

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle_seconds.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}


@contextlib.contextmanager
def window(trace: bool):
    """The measured window; with ``trace`` under the profiler. Yields a
    holder whose ``trace`` is set (a :class:`Trace`) once it closes."""
    global _spans
    holder = type("WindowTrace", (), {"trace": None})()
    if not trace:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        _spans = []
        w0 = time.time_ns()
        try:
            yield holder
        finally:
            w1 = time.time_ns()
            with _lock:
                spans, _spans = _spans, None
    holder.trace = reduce(prof.profiler.kineto_results.events(), w0, w1, spans)


def _launch_batches(logmel, spans) -> List[Optional[int]]:
    """The batch of each log-mel kernel (start, end), or None."""
    clipped = [sp for sp in spans if sp[3] is not None]
    out = []
    for start, end in logmel:
        batches = {sp[3] for sp in clipped if sp[0] <= start and end <= sp[1]}
        out.append(batches.pop() if len(batches) == 1 else None)
    return out


def reduce(events, w0: int, w1: int, spans: List[tuple]) -> Trace:
    """The window [w0, w1) (wall-clock ns) of the profiler's raw events."""
    cuda = torch.autograd.DeviceType.CUDA
    device: List[Tuple[int, int, str]] = []
    logmel: List[Tuple[int, int]] = []
    for e in events:
        if e.device_type() != cuda:
            continue
        name, start = e.name(), e.start_ns()
        device.append((start, start + e.duration_ns(), name))
        if LOGMEL_KERNEL in name and w0 <= start < w1:
            logmel.append((start, start + e.duration_ns()))
    batches = _launch_batches(logmel, spans)
    inside = sorted((max(s, w0), min(t, w1), n) for s, t, n in device if w0 <= s < w1)
    op_seconds: Dict[str, float] = collections.defaultdict(float)
    busy, gaps, cursor = 0, [], w0
    for s, t, n in inside:
        op_seconds[n] += (t - s) / 1e9
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if cursor < w1:
        gaps.append((cursor, w1))
    return Trace(
        window_s=(w1 - w0) / 1e9,
        busy_s=busy / 1e9,
        device_ops=len(inside),
        op_seconds=dict(op_seconds),
        idle_seconds=_label_gaps(gaps, spans),
        spans={n: [(sp[1] - sp[0]) / 1e9 for sp in spans if sp[2] == n] for n in {sp[2] for sp in spans}},
        logmel_launches=[(b, (t - s) / 1e9) for (s, t), b in zip(logmel, batches) if b is not None],
        logmel_unread=sum(1 for b in batches if b is None),
    )


def _label_gaps(gaps, spans) -> Dict[str, float]:
    """Idle seconds by the benchmark spans open at each gap's midpoint
    (joined with '+'; 'none' where the host was in none)."""
    marks = sorted([(sp[0], 1, sp[2]) for sp in spans] + [(sp[1], -1, sp[2]) for sp in spans])
    times = [m[0] for m in marks]
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    open_count: Dict[str, int] = collections.Counter()
    out: Dict[str, float] = collections.defaultdict(float)
    i = 0
    for mid, length in mids:
        j = bisect.bisect_right(times, mid)
        for _t, delta, n in marks[i:j]:
            open_count[n] += delta
        i = max(i, j)
        label = "+".join(sorted(n for n, c in open_count.items() if c > 0)) or "none"
        out[label] += length / 1e9
    return dict(out)
