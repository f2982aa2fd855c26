"""The mean device time of the program's ``train.optimizer`` span (AdamW's
``step``, its start event to its end event on the card) a window step, in
ms.  None on the CPU, where the spans carry no device time."""

from benchmark.measure import spans


def read(measured):
    traces = spans.train_window(measured)
    if traces is None:
        return None
    steps = spans.named(traces, "train.optimizer")
    if len(steps) != len(traces) or any("device_ms" not in s["attributes"] for s in steps):
        return None
    return sum(s["attributes"]["device_ms"] for s in steps) / len(steps)
