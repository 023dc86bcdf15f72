"""The host's time in the program's span ``serve.d2h`` per served request of
the traced window, in ms: the copy of the logits back, which waits for
the card to finish the request's forward and the work queued before it."""


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
    spans = [s["end_ns"] - s["start_ns"] for s in session["spans"] if s["name"] == "serve.d2h"]
    per = sum(1 for s in session["spans"] if s["name"] == "serve.request")
    return sum(spans) / per / 1e6 if spans and per else None
