"""The share of the batches the trainer took in the traced window that its
host prefetch queue did not hold when asked for, in %: the program's
counters ``loader.batches_waited`` over ``loader.batches``."""


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
    batches = session["counters"].get("loader.batches") if session else None
    if not batches:
        return None
    return 100.0 * session["counters"].get("loader.batches_waited", 0) / batches
