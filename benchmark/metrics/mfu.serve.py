"""The served forward's share of the card's float32 peak, in %: the
reference's forward FLOPs for the clips requested (padding not counted)
over the time at least one request was in service and the peak."""


def read(view):
    if not view.trace or not view.clips or not view.service_s or not view.peaks:
        return None
    return 100.0 * view.flops_per_clip() * view.clips / view.service_s / view.peaks["fp32_flops"]
