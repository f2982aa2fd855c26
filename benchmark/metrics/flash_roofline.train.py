"""The flash kernels' share of their roofline in the traced steps: the
frozen count (``measure.roofline.flash_work``) at the cell's shapes, each
kernel n_layers times a step, over the device time of
``flash_fwd_tc_kernel``, ``flash_bwd_dq_tc_kernel`` and
``flash_bwd_dkv_tc_kernel`` in the trace, in %."""

from benchmark.measure import roofline, trace


def read(measured):
    summary, m, t = measured["trace"], measured["model"], measured["traffic"]
    if summary is None:
        return None
    seconds = sum(trace.kernel_total(summary, k) for k in roofline.FLASH_KERNELS)
    if seconds <= 0:
        return None
    h, d = m["n_heads"], m["d_model"] // m["n_heads"]
    shape = (t["batch"], t["seq_len"] - 1, h, h, d)
    bound = sum(roofline.bound_s(*roofline.flash_work(k, *shape)) for k in roofline.FLASH_KERNELS)
    return 100.0 * bound * m["n_layers"] * summary["steps"] / seconds
