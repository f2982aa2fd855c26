"""Reading the program's own spans: the traces that the port records of
its hot path (``obs.tracing.workload_tracer``: one ``train.step`` trace a
training step, one ``decode.generate`` trace a decode call).  A run's
window is picked by order from the end, so that the set-up's steps and
earlier runs in the same process never mix in: a traced run's window is
followed by the profiled stretch, ``trace_steps`` more train steps or one
more decode call."""

from __future__ import annotations

from typing import Dict, List, Optional


def _traces(name: str) -> Optional[List[Dict]]:
    """Every complete trace named *name*, oldest first, or None where the
    program records no hot-path traces."""
    from k8s_operator_libs_tpu_torch.obs import tracing

    tracer = getattr(tracing, "workload_tracer", None)
    return None if tracer is None else [t for t in tracer().traces() if t["name"] == name]


def last(name: str, count: int, skip: int) -> Optional[List[Dict]]:
    """The last *count* + *skip* traces named *name*, less the last *skip*;
    None where fewer are found or any of them dropped a span."""
    traces = _traces(name)
    if traces is None or count < 1 or len(traces) < count + skip:
        return None
    picked = traces[len(traces) - count - skip:len(traces) - skip]
    return None if any(t["dropped_spans"] for t in picked) else picked


def train_window(measured: Dict) -> Optional[List[Dict]]:
    """The ``train.step`` traces of the window's steps."""
    w = measured["window"]
    if "step_s" not in w:
        return None
    return last("train.step", w["attempted"], measured["traffic"]["trace_steps"])


def decode_window(measured: Dict) -> Optional[List[Dict]]:
    """The ``decode.generate`` traces of the window's calls."""
    w = measured["window"]
    if "call_s" not in w:
        return None
    return last("decode.generate", w["calls"], 1)


def named(traces: List[Dict], name: str) -> List[Dict]:
    """The spans named *name* in *traces*, in order."""
    return [s for t in traces for s in t["spans"] if s["name"] == name]
