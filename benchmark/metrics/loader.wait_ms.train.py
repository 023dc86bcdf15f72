"""Mean time the trainer waited for each batch from its loader (the span
``bench.loader.wait`` around each fetch), in ms."""


def read(view):
    waits = view.trace.spans.get("bench.loader.wait") if view.trace else None
    return 1e3 * sum(waits) / len(waits) if waits else None
