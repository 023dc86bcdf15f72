"""The log-mel kernel's share of its roofline, in %: over its launches in
the traced window, the least time the card could take for each launch's
clips (``counts.logmel_bound_s``) over the kernel's device time."""

from benchmark import counts


def read(view):
    launches = view.trace.logmel_launches if view.trace else []
    if not launches or not view.peaks:
        return None
    bound = sum(counts.logmel_bound_s(clips, view.peaks) for clips, _s in launches)
    return 100.0 * bound / sum(s for _c, s in launches)
