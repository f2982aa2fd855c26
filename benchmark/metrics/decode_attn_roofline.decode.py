"""The decode attention kernel's share of its roofline in the traced
decode steps: what the algorithm moves over those steps, over the device
time of the kernels named ``decode_attention`` in the trace, in %.

Traced step ``i`` (from the traffic's ``trace_first_step``, for
``trace_steps`` steps) attends once a layer over the ``i + 1`` positions
written so far: each launch reads K and V over them, reads q and writes
the output, once each, in bf16; its operations (QK^T and PV, 4 a cached
element) are far under the bf16 peak, so bytes bound it.  Where the trace
holds no such kernel (a program that attends otherwise) there is nothing
to read: None."""

from benchmark.measure import roofline, trace

KERNEL = "decode_attention"
ELEM = 2  # bf16, the served compute dtype


def launch_bound_s(model, batch: int, filled: int) -> float:
    """The least time of one launch over *filled* cached positions of
    *batch* rows."""
    d = model["d_model"]
    nbytes = ELEM * (2 * batch * filled * d + 2 * batch * d)
    return roofline.bound_s(nbytes, 4 * batch * filled * d)


def read(measured):
    summary, t, model = measured["trace"], measured["traffic"], measured["model"]
    if summary is None:
        return None
    seconds = trace.kernel_total(summary, KERNEL)
    if seconds <= 0:
        return None
    first = t["trace_first_step"]
    bound = sum(model["n_layers"] * launch_bound_s(model, t["batch"], i + 1)
                for i in range(first, first + summary["steps"]))
    return 100.0 * bound / seconds
