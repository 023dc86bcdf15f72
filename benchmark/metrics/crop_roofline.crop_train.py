"""The crop kernel's share of its roofline, in %: over the steps of the
traced window (one crop launch a step), the least time the card could take
for each launch's frames and boxes (``crop_counts``: its bytes at the
memory bandwidth) over the kernel's device time."""

KERNEL = "crop_resize_pad_kernel"


def read(view):
    bound = getattr(view, "crop_bound_s", None)
    if not view.trace or not view.peaks or bound is None:
        return None
    seconds = sum(s for name, s in view.trace.op_seconds.items() if KERNEL in name)
    return 100.0 * bound(view.peaks) / seconds if seconds > 0 else None
