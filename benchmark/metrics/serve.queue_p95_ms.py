"""The 95th percentile of the time from a request's due time to the start
of its service (waiting for a server thread), in ms."""

import numpy as np


def read(view):
    if view.queue_ms is None or not len(view.queue_ms):
        return None
    return float(np.percentile(view.queue_ms, 95))
