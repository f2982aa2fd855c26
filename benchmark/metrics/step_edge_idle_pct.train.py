"""The card's idle at the edges of the window's steps, untouched by any
profiler: 100 x the sum over the steps of (the ``train.step`` span's host
time - its device time from ``train.forward``'s start event to
``train.optimizer``'s end event) over the sum of the host times, in %.
None on the CPU, where the spans carry no device time."""

from benchmark.measure import spans


def read(measured):
    traces = spans.train_window(measured)
    if traces is None:
        return None
    steps = spans.named(traces, "train.step")
    if len(steps) != len(traces) or any("device_ms" not in s["attributes"] for s in steps):
        return None
    host_ms = sum(s["duration_s"] for s in steps) * 1e3
    device_ms = sum(s["attributes"]["device_ms"] for s in steps)
    return 100.0 * (host_ms - device_ms) / host_ms
