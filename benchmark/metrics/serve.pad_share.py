"""The share of the rows the predictor sent to the card in the traced
window that were padding, in %: the program's counters
``serve.rows_padded`` over ``serve.rows`` + ``serve.rows_padded``."""


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
    rows = session["counters"].get("serve.rows") if session else None
    if not rows:
        return None
    padded = session["counters"].get("serve.rows_padded", 0)
    return 100.0 * padded / (rows + padded)
