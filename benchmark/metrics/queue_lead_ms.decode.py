"""How long a decode step's work waits in the launch queue: the median over
the window's ``decode.step`` spans of (the time the card reached the
step's start event - the time the host recorded it), both on the host's
clock, in ms.  Near 0 the host paces the card.  None on the CPU, where the
spans carry no device time."""

import statistics

from benchmark.measure import spans


def read(measured):
    traces = spans.decode_window(measured)
    if traces is None:
        return None
    steps = spans.named(traces, "decode.step")
    if not steps or any("device_start_ns" not in s["attributes"] for s in steps):
        return None
    return statistics.median((s["attributes"]["device_start_ns"] - s["attributes"]["recorded_ns"]) / 1e6
                             for s in steps)
