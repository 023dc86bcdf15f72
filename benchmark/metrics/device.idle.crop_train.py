"""The share of the traced window in which no device activity ran, in %."""


def read(view):
    if not view.trace or view.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)
