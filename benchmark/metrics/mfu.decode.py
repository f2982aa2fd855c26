"""The whole decode step's roofline share: over every step of every call
of the window, the least time the card could take
(``measure.roofline.decode_step_bound_s`` at the step's filled cache
positions) over the window's seconds, in %."""

from benchmark.measure import roofline


def read(measured):
    w, t = measured["window"], measured["traffic"]
    if "call_s" not in w:
        return None
    per_call = sum(roofline.decode_step_bound_s(measured["model"], t["batch"], i + 1)
                   for i in range(t["total_len"] - 1))
    return 100.0 * per_call * w["calls"] / w["elapsed_s"]
