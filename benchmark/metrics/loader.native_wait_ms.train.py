"""Mean host time of the program's span ``loader.native_next`` in the traced
window, in ms: the loader thread's wait on the native prefetcher's ring
for each batch (decode and disk behind it)."""


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
    spans = [s["end_ns"] - s["start_ns"] for s in session["spans"] if s["name"] == "loader.native_next"]
    return sum(spans) / len(spans) / 1e6 if spans else None
