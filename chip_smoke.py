#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card (written for an H100), ``nvcc`` and the repository's
``k8s_operator_libs_tpu_torch`` package beside this file.  It imports
nothing of JAX or of the JAX package.  Phases, each of which raises on
failure (the exit code is then non-zero and no result line is printed):

1. device: the card's name and power limit; build the CUDA kernels from
   ``k8s_operator_libs_tpu_torch/csrc``, with each kernel's registers,
   shared memory and spills (``ptxas -v``) and its tensor-core
   instructions (HGMMA/HMMA in the SASS): each bf16 kernel must have
   them, at every head dim, with no spill and no ptxas note that its
   wgmma were serialized;
2. kernels: each flash kernel against its plain PyTorch version on the
   card, at the trainer's shape and at GQA, MQA, non-causal, ragged and
   long shapes in fp32 and bf16, then timed beside its plain version and
   SDPA: at the trainer's shape by replaying a CUDA graph of captured
   calls (free of each call's host work; the old back-to-back event
   figure is logged beside it), at the long shape by events.  SDPA's
   backward alone (its fwd+bwd less its forward) stands beside dQ +
   dK/dV;
3. main path: the drain-aware trainer (``run_smoke``) at the repo's chip
   configuration with ``flash_attention=True`` in bf16, with the kernels'
   launch counts read around it (the forward, dQ and dK/dV launches must
   all go to the tensor-core kernels), and flash against the dense
   ("gather") path on identical weights;
4. drain: request, checkpoint, acknowledgement with the echoed token,
   restore and a 2-step resume (inside ``run_smoke``);
5. a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

#: Tolerances.  The kernels accumulate in fp32 like their plain versions,
#: so in fp32 they differ only by summation order: max-abs error at most
#: FP32_TOL times max(1, max |reference|).  In bf16 the kernel rounds its
#: outputs to 8 bits of mantissa, a relative error of up to 2^-9 each;
#: through autograd the rounded O and dO feed the bf16 backward, and the
#: two roundings compound to about 2^-8 of max |ref|.  So bf16 is held to
#: BF16_TOL = 2^-7 times max(1, max |ref|) against the fp32 plain version
#: on the same bf16 inputs: twice that, far below a wrong kernel's error.
#: The fp32 cases at the same shapes run the same kernel bodies and hold
#: them to FP32_TOL.
FP32_TOL = 1e-4
BF16_TOL = 2.0**-7
#: flash vs gather loss on identical weights and batch: fp32 to the JAX
#: suite's 1e-4; bf16 rounds scores, softmax and activations differently
#: on the two paths, so 2e-2 (0.3% of a loss of ~7.6).
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_PEAK_FLOPS = 67e12  # H100 SXM fp32 FMA; the bf16 peak is smoke's table

SOURCE = "k8s_operator_libs_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "k8s_operator_libs_tpu/tpu/flash_attention.py:64",
    "flash_bwd_dq": "k8s_operator_libs_tpu/tpu/flash_attention.py:225",
    "flash_bwd_dkv": "k8s_operator_libs_tpu/tpu/flash_attention.py:277",
}


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of *fn* over *iters* back-to-back calls, by
    events: where a call's host work outlasts its kernels, this measures
    the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Mean device milliseconds of one *fn* call: *calls* calls captured
    in a CUDA graph, replayed *replays* times between events, so no
    call's host work (checks, allocation, the ctypes call) is timed."""
    import torch

    side = torch.cuda.Stream()  # warm up off the default stream, as capture wants
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def work(kernel: str, b, s, h, hk, d, causal: bool, dtype: str):
    """(bytes, flops) the function must move and do: each input read
    once, each output written once; products over the unmasked
    (query, key) pairs only."""
    e = 2 if dtype == "bfloat16" else 4
    q, kv, rows = b * h * s * d * e, b * hk * s * d * e, b * h * s * 4
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    if kernel == "flash_fwd":  # q, k, v -> O, lse; QK^T and PV
        return 2 * q + 2 * kv + rows, 4 * pairs * d
    if kernel == "flash_bwd_dq":  # q, k, v, dO, lse, dvec -> dQ
        return 3 * q + 2 * kv + 2 * rows, 6 * pairs * d
    # q, k, v, dO, lse, dvec -> per-query-head dK, dV
    return 4 * q + 2 * kv + 2 * rows, 8 * pairs * d


def peak_flops(dtype: str) -> float:
    from k8s_operator_libs_tpu_torch.tpu import smoke

    if dtype == "bfloat16":
        return smoke.peak_bf16_tflops("H100") * 1e12
    return FP32_PEAK_FLOPS


def bound_ms(kernel: str, dtype: str, *shape):
    nbytes, flops = work(kernel, *shape, dtype)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops(dtype) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, ref) -> float:
    return float((got.detach().float() - ref.detach().float()).abs().max())


#: per dtype, the largest err / max(1, max |ref|) seen and the check that
#: saw it, to read against the tolerance
worst_rel: dict = {}


def check_close(what: str, got, ref, dtype: str) -> float:
    """Max-abs error of *got* against *ref*, raising past the tolerance."""
    import torch

    if not torch.isfinite(got.detach().float()).all():
        raise RuntimeError(f"{what}: non-finite values")
    err = max_err(got, ref)
    scale = max(1.0, float(ref.detach().float().abs().max()))
    tol = (BF16_TOL if dtype == "bfloat16" else FP32_TOL) * scale
    if err > tol:
        raise RuntimeError(f"{what}: max abs err {err:.3e} > {tol:.3e}")
    worst_rel[dtype] = max(worst_rel.get(dtype, (0.0, "")), (err / scale, what))
    return err


# ------------------------------------------------------------ phase 2


def make_inputs(b, s, h, hk, d, dtype, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda heads: torch.randn(  # noqa: E731
        b, s, heads, d, device="cuda", generator=gen
    ).to(getattr(torch, dtype))
    return mk(h), mk(hk), mk(hk), mk(h)  # q, k, v, dO


def plain_attention(q, k, v, causal):
    """Autograd-differentiable plain version on [b, s, h, d] (fp32)."""
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa

    g = fa._group_size(q, k)
    out, _ = fa.flash_forward_plain(fa._fold(q), fa._fold(k), fa._fold(v), g, causal)
    return fa._unfold(out, q.shape[0])


def check_case(name, b, s, h, hk, d, causal, dtype, block=128, seed=0):
    """Hold each kernel, called directly, against its plain version, and
    the autograd Function against autograd of the plain version.
    Returns the kernels' max-abs errors."""
    import torch

    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa

    q, k, v, do = make_inputs(b, s, h, hk, d, dtype, seed)
    g = h // hk
    qf, kf, vf, dof = (fa._fold(x) for x in (q, k, v, do))
    f32 = lambda x: x.float()  # noqa: E731 — the plain side sees the same values
    errs = {}
    # forward kernel vs plain
    o, lse = fa.flash_forward(qf, kf, vf, g, causal)
    o_ref, lse_ref = fa.flash_forward_plain(f32(qf), f32(kf), f32(vf), g, causal)
    errs["flash_fwd"] = check_close(f"{name} O", o, o_ref, dtype)
    # lse is fp32 from the same input values on both sides
    check_close(f"{name} lse", lse, lse_ref, "float32")
    # backward kernels vs plain on the same (q, k, v, dO, lse, dvec)
    dvec = (o_ref * f32(dof)).sum(-1)
    dq = fa.flash_bwd_dq(qf, kf, vf, dof, lse_ref, dvec, g, causal)
    dk, dv = fa.flash_bwd_dkv(qf, kf, vf, dof, lse_ref, dvec, g, causal)
    args = (f32(qf), f32(kf), f32(vf), f32(dof), lse_ref, dvec, g, causal)
    dq_ref = fa.flash_bwd_dq_plain(*args)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*args)
    errs["flash_bwd_dq"] = check_close(f"{name} dQ kernel", dq, dq_ref, dtype)
    errs["flash_bwd_dkv"] = max(
        check_close(f"{name} dK kernel", dk, dk_ref, dtype),
        check_close(f"{name} dV kernel", dv, dv_ref, dtype),
    )
    # the autograd Function against autograd of the plain version
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal, block, block)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref_out = plain_attention(*ref_leaves, causal)
    ref_grads = torch.autograd.grad(ref_out, ref_leaves, do.float())
    check_close(f"{name} out (autograd)", out, ref_out, dtype)
    for what, a, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        check_close(f"{name} {what} (autograd)", a, r, dtype)
    log(f"kernels {name}: b{b} s{s} h{h} hk{hk} d{d} causal={causal} {dtype} "
        + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items()))
    return errs


def check_lse_cotangent():
    """flash_attention_lse with a non-zero lse cotangent (fp32)."""
    import torch

    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa

    q, k, v, do = make_inputs(2, 256, 4, 4, 64, "float32", seed=5)
    glse = torch.randn(8, 256, device="cuda", generator=torch.Generator("cuda").manual_seed(6))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out, lse = fa.flash_attention_lse(*leaves, True)
    grads = torch.autograd.grad((out, lse), leaves, (do, glse))
    ref_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    o_ref, lse_ref = fa.flash_forward_plain(*(fa._fold(x) for x in ref_leaves), 1, True)
    ref_grads = torch.autograd.grad(
        (fa._unfold(o_ref, 2), lse_ref), ref_leaves, (do, glse)
    )
    for what, a, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        check_close(f"lse-cotangent {what}", a, r, "float32")
    log("kernels lse-cotangent: ok")


def time_shape(b, s, h, d, dtype, iters, plain_iters, graphs: bool):
    """Device ms of each kernel, its plain version and SDPA, forward and
    forward+backward, causal, on one set of inputs.  With *graphs* the
    kernels, plain versions and SDPA are timed by :func:`graph_ms` and
    each kernel's back-to-back event figure is kept as ``event_ms``."""
    import torch
    import torch.nn.functional as F

    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa

    q, k, v, do = make_inputs(b, s, h, h, d, dtype, seed=11)
    qf, kf, vf, dof = (fa._fold(x) for x in (q, k, v, do))
    o, lse = fa.flash_forward(qf, kf, vf, 1, True)
    dvec = (o.float() * dof.float()).sum(-1)
    bwd = (qf, kf, vf, dof, lse, dvec, 1, True)
    row = {"shape": f"b{b} s{s} h{h} d{d} causal {dtype}",
           "timed_by": "cuda graph replay" if graphs else "events, back to back"}
    calls = {
        "flash_fwd": (lambda: fa.flash_forward(qf, kf, vf, 1, True),
                      lambda: fa.flash_forward_plain(qf, kf, vf, 1, True)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd), lambda: fa.flash_bwd_dq_plain(*bwd)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd), lambda: fa.flash_bwd_dkv_plain(*bwd)),
    }
    timed = {}
    for name, (kernel, plain) in calls.items():
        event = cuda_ms(kernel, iters)
        if graphs:
            timed[name] = {"ms": graph_ms(kernel), "plain_ms": graph_ms(plain), "event_ms": event}
        else:
            timed[name] = {"ms": event, "plain_ms": cuda_ms(plain, plain_iters)}
    # SDPA wants [b, h, s, d]: the folded layout, viewed
    qh, kh, vh = (x.view(b, h, s, d) for x in (qf, kf, vf))
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)  # noqa: E731
    row["sdpa_fwd_ms"] = graph_ms(sdpa) if graphs else cuda_ms(sdpa, iters)
    if graphs:
        row["sdpa_fwd_event_ms"] = cuda_ms(sdpa, iters)

    def fwd_bwd(attn, tensors, grad):
        leaves = [x.detach().requires_grad_() for x in tensors]
        return lambda: torch.autograd.grad(attn(*leaves), leaves, grad)

    row["fwd_bwd_ms"] = {
        "kernels": cuda_ms(
            fwd_bwd(lambda *t: fa.flash_attention(*t, True), (q, k, v), do), iters
        ),
        "plain": cuda_ms(
            fwd_bwd(lambda *t: plain_attention(*t, True), (q, k, v), do), plain_iters
        ),
        "sdpa": cuda_ms(
            fwd_bwd(
                lambda *t: F.scaled_dot_product_attention(*t, is_causal=True),
                (qh, kh, vh), do.transpose(1, 2).contiguous(),
            ),
            iters,
        ),
    }
    # No one call computes dQ or dK/dV alone; SDPA's backward alone (its
    # fwd+bwd less its forward, both by events) is their yardstick.
    sdpa_fwd_event = row["sdpa_fwd_event_ms"] if graphs else row["sdpa_fwd_ms"]
    row["sdpa_bwd_ms"] = row["fwd_bwd_ms"]["sdpa"] - sdpa_fwd_event
    row["dq_plus_dkv_ms"] = timed["flash_bwd_dq"]["ms"] + timed["flash_bwd_dkv"]["ms"]
    for name in calls:
        bound, by = bound_ms(name, dtype, b, s, h, h, d, True)
        row[name] = {**timed[name], "bound_ms": bound, "bound_by": by,
                     "bound_share": bound / timed[name]["ms"]}
    log("timing", json.dumps(row))
    del q, k, v, do, qf, kf, vf, dof, o, lse, dvec, bwd, qh, kh, vh, calls, sdpa
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------ phase 3


def flash_vs_gather(config, dtype_name: str):
    """Two train steps' losses of the flash and gather paths on the same
    weights and batches."""
    import dataclasses

    import torch

    from k8s_operator_libs_tpu_torch.tpu import workload as wl

    cfg = dataclasses.replace(config, dtype=getattr(torch, dtype_name))
    losses = {}
    for flash in (True, False):
        model, opt = wl.create_train_state(
            dataclasses.replace(cfg, flash_attention=flash), "cuda", seed=3
        )
        step = wl.make_train_step(model, opt)
        losses[flash] = [
            float(step(wl.make_batch(cfg, 8, seed=i, device="cuda"))) for i in range(2)
        ]
    diffs = [abs(a - b) for a, b in zip(losses[True], losses[False])]
    if not all(math.isfinite(x) for x in losses[True] + losses[False]):
        raise RuntimeError(f"non-finite loss: {losses}")
    if max(diffs) > LOSS_TOL[dtype_name]:
        raise RuntimeError(
            f"flash vs gather ({dtype_name}): losses {losses}, diff {max(diffs):.3e} "
            f"> {LOSS_TOL[dtype_name]}"
        )
    log(f"main flash-vs-gather {dtype_name}: flash {losses[True]} gather "
        f"{losses[False]} max diff {max(diffs):.3e} (tol {LOSS_TOL[dtype_name]})")
    return max(diffs)


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total + cur_end - cur_start


def step_breakdown(config, steps: int = 5):
    """Where a train step's time goes, flash and gather paths in one call:
    host-clock ms per step, and from a torch.profiler trace the device's
    busy ms per step (the union of its kernels' intervals), the idle share
    of the traced window, and the kernels that take most device time."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from k8s_operator_libs_tpu_torch.tpu import workload as wl

    out = {}
    batch = wl.make_batch(config, 8, seed=0, device="cuda")
    for flash in (True, False):
        model, opt = wl.create_train_state(
            dataclasses.replace(config, flash_attention=flash), "cuda", seed=3
        )
        step = wl.make_train_step(model, opt)
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        row = {"wall_ms_per_step": (time.perf_counter() - t0) / steps * 1e3}
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True
        ) as prof:
            for _ in range(steps):
                step(batch)
            torch.cuda.synchronize()
        # device work only: a user annotation's device range spans the gaps
        # between the kernels it encloses
        device = [
            e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
        ]
        if device:
            spans = sorted((e.time_range.start, e.time_range.end) for e in device)
            busy = _union_us(spans)
            by_name = {}
            for e in device:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            row.update(
                device_busy_ms_per_step=busy / 1e3 / steps,
                device_ops_per_step=len(device) / steps,
                idle_pct_of_traced_window=100.0 * (1 - busy / (spans[-1][1] - spans[0][0])),
                top_device_ms_per_step={n[:70]: t / 1e3 / steps for n, t in top},
            )
        else:
            row["device_trace"] = "not measured: the profiler recorded no CUDA events"
        out["flash" if flash else "gather"] = row
    log("step breakdown:", json.dumps(out))
    return out


def compiled_report():
    """Per kernel instantiation, ``ptxas -v``'s registers, shared memory,
    spills and notes and the HGMMA/HMMA count of its SASS.  Raises unless
    each tensor-core kernel is built at every head dim with tensor-core
    instructions, no spill and no ptxas note that its wgmma were
    serialized (C7515 for a call, C7512 for want of registers)."""
    from k8s_operator_libs_tpu_torch import _build
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa

    ptxas = _build.ptxas_report("flash_attention")
    sass = _build.sass_counts("flash_attention")
    report = {name: {**ptxas.get(name, {}), **sass.get(name, {})} for name in sorted(sass)}
    for name, row in report.items():
        log("compiled", name, json.dumps(row))
    tensor_core = {k for kernels in fa.DEVICE_KERNELS.values() for k in kernels.values()
                   if "_tc_" in k}
    for kernel in sorted(tensor_core):
        rows = [report.get(f"{kernel}<{d}>") for d in fa.HEAD_DIMS]
        bad = [
            r for r in rows
            if r is None or r["HGMMA"] + r["HMMA"] == 0
            or r.get("spill_stores", 1) or r.get("spill_loads", 1)
            or any("serialized" in n for n in r.get("notes", ()))
        ]
        if bad:
            raise RuntimeError(
                f"{kernel}: a head dim missing, without tensor-core instructions, spilling "
                f"or with serialized wgmma ({rows})"
            )
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import dataclasses

    from k8s_operator_libs_tpu_torch import _build
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. device and build ----
    card = nvidia_smi_line()
    log("device:", card, "| torch", torch.__version__, "cuda", torch.version.cuda,
        "| gpu", json.dumps(smoke.detect_gpu()))
    t0 = time.perf_counter()
    _build.load("flash_attention")
    log(f"build: flash_attention.cu {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds['flash_attention']:.1f} s)")
    compiled = compiled_report()

    # ---- 2. kernels against their plain versions ----
    errs = check_case("main-bf16", 8, 256, 8, 8, 64, True, "bfloat16")
    check_case("main-fp32", 8, 256, 8, 8, 64, True, "float32")
    check_case("gqa", 2, 256, 8, 2, 16, True, "float32", seed=1)
    check_case("mqa", 2, 256, 8, 1, 16, True, "float32", seed=2)
    check_case("gqa-bf16", 2, 256, 8, 2, 16, True, "bfloat16", seed=1)
    check_case("non-causal", 4, 256, 8, 8, 64, False, "float32", seed=3)
    check_case("non-causal-bf16", 4, 256, 8, 8, 64, False, "bfloat16", seed=3)
    check_case("ragged-d32", 2, 200, 4, 4, 32, True, "float32", block=40, seed=4)
    check_case("d128", 2, 256, 4, 4, 128, True, "float32", seed=7)
    check_case("bench-s2048", 4, 2048, 8, 8, 64, True, "bfloat16", seed=8)
    # the tensor-core kernels' ragged edge, widest head, non-causal GQA, MQA
    check_case("ragged-d32-bf16", 2, 200, 4, 4, 32, True, "bfloat16", block=40, seed=4)
    check_case("d128-bf16", 2, 256, 4, 4, 128, True, "bfloat16", seed=7)
    check_case("non-causal-gqa-bf16", 2, 256, 8, 2, 16, False, "bfloat16", seed=10)
    check_case("mqa-bf16", 2, 256, 8, 1, 16, True, "bfloat16", seed=2)
    # s % 4 != 0: a row of lse or dvec starts only 4-byte aligned
    check_case("ragged-s203-gqa-bf16", 2, 203, 8, 2, 64, True, "bfloat16", block=203, seed=12)
    check_lse_cotangent()
    log("kernels worst err / max(1, max|ref|):", json.dumps(worst_rel),
        f"(tol fp32 {FP32_TOL}, bf16 {BF16_TOL})")
    main_timing = time_shape(8, 256, 8, 64, "bfloat16", iters=100, plain_iters=20, graphs=True)
    long_timing = time_shape(4, 8192, 8, 64, "bfloat16", iters=10, plain_iters=2, graphs=False)
    log("phase 2 done", f"{time.perf_counter() - t_start:.1f} s")

    # ---- 3 and 4. main path: train, time, drain, restore, resume ----
    config = dataclasses.replace(
        smoke.smoke_config(torch.device("cuda")), flash_attention=True
    )
    warmup, steps = 2, 10
    fa.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as ckpt:
        result = smoke.run_smoke(ckpt, steps=steps, warmup=warmup, config=config)
    launches = dict(fa.launch_counts)
    device_launches = dict(fa.device_launch_counts)
    drain = result["drain_handshake"]
    train_steps = warmup + steps + drain["resumed_steps"]
    want = config.n_layers * train_steps
    if any(n != want for n in launches.values()):
        raise RuntimeError(
            f"launch counts {launches} != {want} ({config.n_layers} layers x "
            f"{train_steps} steps) for every kernel"
        )
    # bf16: every forward, dQ and dK/dV launch went to the tensor-core kernels
    routed = {name: fa.DEVICE_KERNELS[name][config.dtype] for name in launches}
    if any("_tc_" not in k for k in routed.values()) or {
        k: n for k, n in device_launches.items() if n
    } != {routed[e]: want for e in launches}:
        raise RuntimeError(f"device kernel launches {device_launches}, want {want} of {routed}")
    if not math.isfinite(result["final_loss"]):
        raise RuntimeError(f"non-finite loss {result['final_loss']}")
    if drain != {**drain, "checkpoint_step": steps, "ack": "done:smoke-1", "resumed_steps": 2}:
        raise RuntimeError(f"drain handshake: {drain}")
    log("main path:", json.dumps({
        "step_time_ms": result["step_time_ms"],
        "tokens_per_s": result["tokens_per_s"],
        "achieved_tflops": result["achieved_tflops"],
        "mfu_pct": result["mfu_pct"],
        "final_loss": result["final_loss"],
        "model": result["model"],
        "launches": launches,
        "launches_per_step": {k: n / train_steps for k, n in launches.items()},
        "device_kernel_launches_per_step": {
            k: n / train_steps for k, n in device_launches.items() if n
        },
    }))
    log("drain:", json.dumps(drain))
    flash_vs_gather(config, "float32")
    flash_vs_gather(config, "bfloat16")
    step_breakdown(config)

    # ---- 5. the result lines ----
    kernels = []
    head_dim = config.d_model // config.n_heads
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        t = main_timing[name]
        # the instantiation the main path runs (a tc kernel: the head dim)
        built = compiled.get(f"{routed[name]}<{head_dim}>", {})
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            # the device kernel each dtype runs, with its launches above
            "device_kernels": {
                str(dt).removeprefix("torch."): k for dt, k in fa.DEVICE_KERNELS[name].items()
            },
            "main_path_device_kernel": routed[name],
            "max_abs_err": errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "event_ms": t["event_ms"],
            "registers": built.get("registers"),
            "spill_bytes": built.get("spill_stores"),
            # SDPA computes the forward; no one PyTorch call computes dQ
            # alone or dK/dV alone (time_shape logs SDPA's whole backward,
            # sdpa_bwd_ms, beside dq_plus_dkv_ms instead)
            "library_ms": main_timing["sdpa_fwd_ms"] if name == "flash_fwd" else None,
        })
    log("long-context:", json.dumps(long_timing))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
