"""The whole training step's share of the bf16 peak: the FLOPs of every
step of the window (``measure.roofline.train_flops_per_step``) over the
window's seconds times 989 TFLOP/s, in %."""

from benchmark.measure import roofline


def read(measured):
    w, t = measured["window"], measured["traffic"]
    if "step_s" not in w:
        return None
    flops = roofline.train_flops_per_step(measured["model"], t["batch"], t["seq_len"]) * w["attempted"]
    return 100.0 * flops / (w["elapsed_s"] * roofline.PEAK_BF16_FLOPS)
