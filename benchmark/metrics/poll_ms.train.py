"""The mean host time of the program's ``train.poll`` span (the drain
watcher's ``check_and_acknowledge``) a window step, in ms: the inside
twin of ``drain_poll_ms.train``."""

from benchmark.measure import spans


def read(measured):
    traces = spans.train_window(measured)
    if traces is None:
        return None
    polls = spans.named(traces, "train.poll")
    if len(polls) != len(traces):
        return None
    return sum(s["duration_s"] for s in polls) / len(polls) * 1e3
