"""The host's time in the program's span ``trainer.group`` per dispatch of
the traced window, in ms: one group of K train steps (a graph replay, the
copy of its indices and weights in, and the step count)."""


def _session():
    """The program's newest traced session (``utils/trace.py``), or None
    where the program has no such module or recorded nothing."""
    try:
        from multimodal_lipread_torch.utils import trace
    except ImportError:
        return None
    return trace.last_session()


def read(view):
    session = _session() if view.trace else None
    if not session:
        return None
    spans = [s["end_ns"] - s["start_ns"] for s in session["spans"] if s["name"] == "trainer.group"]
    return sum(spans) / len(spans) / 1e6 if spans else None
