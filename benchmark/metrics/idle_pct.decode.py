"""The device's idle share of the traced window: 1 - (the union of its
kernels' intervals) / (first kernel's start to last kernel's end), in %."""


def read(measured):
    summary = measured["trace"]
    if summary is None or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
