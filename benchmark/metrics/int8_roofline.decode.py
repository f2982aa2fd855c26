"""The int8 kernel's share of its roofline in the traced decode steps: the
frozen count (``measure.roofline.int8_bound_s``) of every launch of a
step at M = batch, over ``int8_linear_tc_kernel``'s device time in the
trace, in %."""

from benchmark.measure import roofline, trace


def read(measured):
    summary, t = measured["trace"], measured["traffic"]
    if summary is None:
        return None
    seconds = trace.kernel_total(summary, roofline.INT8_KERNEL)
    if seconds <= 0:
        return None
    per_step = sum(n * roofline.int8_bound_s(t["batch"], k, nn)
                   for k, nn, n in roofline.int8_step_shapes(measured["model"]))
    return 100.0 * per_step * summary["steps"] / seconds
