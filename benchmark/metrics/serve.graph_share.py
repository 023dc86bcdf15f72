"""The share of the predictor's forwards in the traced window that a CUDA
graph's replay served, in %: the program's counter ``serve.replays`` over
its spans ``serve.forward`` (one a replica a batch, replayed or eager)."""


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
    replays = session["counters"].get("serve.replays") if session else None
    if replays is None:
        return None
    forwards = sum(1 for s in session["spans"] if s["name"] == "serve.forward")
    return 100.0 * replays / forwards if forwards else None
