"""The port's spans and counters.

``span(name, new_request=False, **attrs)`` times a block of the program and
``count(name, n)`` adds to a counter. Both record only while a
``torch.profiler`` session is active, whatever its activities: the
benchmark's traced window (``--trace 1``), the epoch that
``training.profile_dir`` traces, or any profiler a caller opens. With the
profiler off, a span or a count reads the flag torch keeps for such checks
(``torch.autograd.profiler._is_profiler_enabled``) and returns: no lock, no
``record_function`` and no storage.

While recording, a span keeps its name, its start and end in ns on
``time.time_ns()`` (the clock of the profiler's events, so a span lies over
the device activity it launched), its thread, its id and its parent's (a
stack per thread), a request id and its attrs. A span opened with
``new_request=True`` starts a request, whose id every span opened inside it
on its thread carries. A span also enters
``torch.profiler.record_function(name)``, so it shows beside its kernels in
a Chrome trace the profiler writes.

A session begins at the first span or count that finds the profiler on
after one that found it off (or after a :func:`last_session` call made
with it off), so :func:`last_session` gives the spans and counts of the
newest traced window only. It keeps at most ``MAX_SPANS`` spans and counts
the ones left out under the counter ``trace.spans_dropped``. Safe to use
from several threads."""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 20
SPAN_FIELDS = ("name", "start_ns", "end_ns", "thread", "id", "parent", "request", "attrs")


class _Session:
    __slots__ = ("spans", "counters")

    def __init__(self):
        self.spans: List[tuple] = []
        self.counters: Dict[str, int] = {}


_lock = threading.Lock()
_session: Optional[_Session] = None
_off_seen = True  # a span, count or read found the profiler off since the session began
_local = threading.local()
_ids = itertools.count(1)


def _current() -> _Session:
    """The session a recording span or count adds to: a new one after the
    profiler was seen off."""
    global _session, _off_seen
    if _off_seen:
        with _lock:
            if _off_seen:
                _session, _off_seen = _Session(), False
    return _session


_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "new_request", "attrs", "session", "start", "id", "parent", "request", "_rf")

    def __init__(self, name: str, new_request: bool, attrs: Dict[str, Any], session: _Session):
        self.name, self.new_request, self.attrs, self.session = name, new_request, attrs, session

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.request = self.id if self.new_request else (parent.request if parent is not None else None)
        stack.append(self)
        self.start = time.time_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        try:
            self._rf.__exit__(*exc)
        finally:
            end = time.time_ns()
            _local.stack.pop()
            record = (self.name, self.start, end, threading.get_ident(), self.id, self.parent, self.request,
                      self.attrs)
            with _lock:
                if len(self.session.spans) < MAX_SPANS:
                    self.session.spans.append(record)
                else:
                    self.session.counters["trace.spans_dropped"] = self.session.counters.get(
                        "trace.spans_dropped", 0) + 1
        return False


def span(name: str, new_request: bool = False, **attrs):
    """A context manager that records the block as the span ``name`` while
    a profiler session is active (see the module's docstring)."""
    global _off_seen
    if not _profiler._is_profiler_enabled:
        _off_seen = True
        return _OFF
    return _Span(name, new_request, attrs, _current())


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session is active."""
    global _off_seen
    if not _profiler._is_profiler_enabled:
        _off_seen = True
        return
    session = _current()
    with _lock:
        session.counters[name] = session.counters.get(name, 0) + n


def last_session() -> Optional[Dict[str, Any]]:
    """The newest session's ``{"spans": [...], "counters": {...}}``, each
    span a dict of ``SPAN_FIELDS``, in the order the spans ended; ``None``
    where no session was recorded."""
    global _off_seen
    with _lock:
        if not _profiler._is_profiler_enabled:
            _off_seen = True
        if _session is None:
            return None
        spans, counters = list(_session.spans), dict(_session.counters)
    return {"spans": [dict(zip(SPAN_FIELDS, s)) for s in spans], "counters": counters}
