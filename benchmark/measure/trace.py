"""Reading a ``torch.profiler`` trace of the card: the device's busy time
(the union of its kernels' intervals, as the port's ``smoke.device_busy``
takes it), the traced window, each kernel's time and count, and the
breakdown the result line carries: the device operations that took most
time, and the longest idle gaps, each named by the host operation that
was running in it."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

import torch


#: Kernel names in the breakdown are cut to this many characters.
NAME_CHARS = 160


def profiler():
    """A profiler of the host and the card, not yet started."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True)


def _merged(spans) -> List[List[float]]:
    """The union of sorted (start, end) intervals, as disjoint intervals."""
    out: List[List[float]] = []
    for start, end in spans:
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _host_op_at(host, starts, t: float) -> str:
    """The innermost host operation running at time *t* (microseconds)."""
    best, best_len = None, None
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        e = host[i]
        if e.time_range.end >= t and (best_len is None or e.time_range.elapsed_us() < best_len):
            best, best_len = e, e.time_range.elapsed_us()
        if t - e.time_range.start > 10e6:  # no host op outlasts ten seconds here
            break
    return f"host: {best.name}" if best is not None else "host: no traced op (Python)"


def summarize(prof, top: int = 10) -> Optional[Dict]:
    """What a stopped profiler recorded on the card, or None where it
    recorded no device event: ``busy_s``, ``window_s`` (first device event
    start to last end), ``kernel_s`` (device seconds by name), and
    ``device_ops`` / ``idle_gaps`` ([name, seconds], at most *top* each)."""
    events = prof.events()
    device = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    if not device:
        return None
    merged = _merged(sorted((e.time_range.start, e.time_range.end) for e in device))
    busy_us = sum(end - start for start, end in merged)
    kernel_s: Dict[str, float] = {}
    for e in device:
        kernel_s[e.name] = kernel_s.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    host = sorted(
        (e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
        key=lambda e: e.time_range.start,
    )
    starts = [e.time_range.start for e in host]
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])), reverse=True)[:top]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (merged[-1][1] - merged[0][0]) / 1e6,
        "kernel_s": kernel_s,
        "device_ops": [[n[:NAME_CHARS], s] for n, s in sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[_host_op_at(host, starts, at + length / 2), length / 1e6] for length, at in gaps],
    }


def kernel_total(summary: Dict, name: str) -> float:
    """The device seconds of the kernels whose name contains *name*
    (templated kernels carry their arguments)."""
    return sum(v for k, v in summary["kernel_s"].items() if name in k)
