"""Device activities (kernels, copies, memsets) that started in the traced
window, per train step taken in it."""


def read(view):
    if not view.trace or not view.steps:
        return None
    return view.trace.device_ops / view.steps
