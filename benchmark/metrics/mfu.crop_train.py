"""The whole train step's share of the card's float32 peak, in %: the
reference's forward and backward FLOPs at the cell's batch (the crop
counts none) times the steps of the traced window, over the window's
length and the peak."""


def read(view):
    if not view.trace or not view.steps or not view.peaks:
        return None
    flops = view.flops_per_step() * view.steps
    return 100.0 * flops / view.window_s / view.peaks["fp32_flops"]
