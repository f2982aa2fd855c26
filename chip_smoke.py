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
   instructions (HGMMA/HMMA in the SASS): each bf16 flash kernel must
   have them, at every head dim, with no spill and no ptxas note that its
   wgmma were serialized, and the bf16 int8 kernel HMMA, no spill and no
   ptxas note;
2. kernels: each flash kernel against its plain PyTorch version on the
   card, at the trainer's shape and at GQA, MQA, non-causal, ragged and
   long shapes in fp32 and bf16, at head dims the kernels are not
   compiled for (8 and 48, zero-padded to 16 and 64 by the wrappers;
   causal and not, fp32 and bf16, and GQA at 8), and at phase 8's ring pairs (bf16, 128
   and 64 positions, causal and unmasked, and two pairs merged forward
   and run backward with the final lse), then timed beside its plain version and
   SDPA: at the trainer's shape by replaying a CUDA graph of captured
   calls (free of each call's host work; the old back-to-back event
   figure is logged beside it), at the long shape by events.  SDPA's
   backward alone (its fwd+bwd less its forward) stands beside dQ +
   dK/dV;
3. main path: the drain-aware trainer (``run_smoke`` without its benches)
   at the repo's chip configuration with ``flash_attention=True`` in bf16,
   with the kernels' launch counts read around it (the forward, dQ and
   dK/dV launches must all go to the tensor-core kernels), and flash
   against the dense ("gather") path on identical weights;
4. drain: request, checkpoint, acknowledgement (``run_smoke`` checks the
   echoed token and records ``"done"``, as the JAX package does), restore
   and a 2-step resume (inside ``run_smoke``);
5. serving: the int8 matmul kernel against its plain version at every
   decode shape of the smoke configuration (M 8), at M 1, 13, 16 and 17,
   at ragged K and N, at a K its plan splits unevenly and under a cluster
   of 8, in bf16 and fp32, two launches bit-equal and a CUDA-graph replay
   equal to the eager call, every bf16 launch on the tensor-core kernel;
   timed beside its bytes bound and ``F.linear`` on the dequantized
   weight, by graph replay (the kernel's events figure beside).  Then, at
   the smoke width from seed-0 weights: fp32 cached greedy decode equals
   full-prefix recompute; a ragged batch equals each row's solo run; bf16
   cached logits match the full prefix, and the int8 kernel route matches
   the plain route computed exactly (each Dense summed in float64 and
   rounded once; cuBLAS's route is logged beside it); ``generate``
   launches the int8 kernel (6 * n_layers + 1) times per step, all on the
   bf16 tensor-core kernel, and no flash kernel, with no host
   synchronisation in the loop (``set_sync_debug_mode("error")``);
   sampling is seeded and top_k 1 is greedy; a profiled window of decode
   steps;
6. stages: every stage of ``smoke.STAGES`` in order, in process, each
   gated: ``touch`` (checksum 512), ``matmul`` (n 4096, bf16; its TFLOP/s
   logged with the card line), ``train`` (MFU, no bench sections),
   ``attention`` (flash against the dense reference at s 1024 and 2048,
   fwd+bwd at s 8192; every flash launch on the tensor-core kernels),
   ``decode`` (the decode bench from seed-0 weights, float and int8;
   every int8 launch on the tensor-core kernel) and ``drain`` (ack
   ``"done"``, checkpoint at step 2, 2 steps resumed).  Then the drain
   trace: the script plays the orchestrator's gate with the port's
   tracer (a ``drain-handshake`` span whose traceparent it writes beside
   the request), the trainer drains in another thread, and its
   ``checkpoint-drain`` span must be a child of that span, in its trace;
7. the multi-process path (``k8s_operator_libs_tpu_torch.tpu.distributed``,
   ``multihost_trainer`` and ``ring_attention``): 7a, one NCCL rank in this
   process (``host_allreduce_max`` and the barrier, then
   ``MultihostDrainLoop`` over the data-parallel trainer at the main
   path's configuration, drained by a gate thread after step 3: saved,
   past the barrier, acknowledged ``done:<token>``, restored; 4 flash
   launches of each kind per step, all on the tensor-core kernels).  7b,
   two worker ranks on the one card (``hack.dist_worker``): NCCL is first
   expected to refuse them as a duplicate GPU, and gloo then carries
   them (its all-reduce takes CUDA tensors; the rings stage each block
   through pinned host memory); the data-parallel drain, with both ranks
   stopped at one step, identical losses within ``LOSS_TOL["bfloat16"]``
   of 7a's, the ack and every rank's checkpoint; then the causal and
   non-causal contiguous flash rings and the zigzag ring at b 4, global
   s 8192, h 8, d 64, bf16, output and gradients within ``BF16_TOL`` of
   single-device flash, each rank's launches equal to the pairs it
   computes, timed by events beside single-device flash;
8. the sharded train step (``workload.make_train_step`` on a mesh):
   four worker ranks on the one card, over the transport 7b chose, on a
   dp 1 x sp 2 x tp 2 mesh at the smoke width with 257 tokens (128
   positions a seq rank), bf16, 2 steps each of gather SP with dense
   attention, the contiguous and zigzag flash rings, and the flash ring
   under remat, then a drain after one step on the flash ring.  Losses
   identical across ranks and within ``LOSS_TOL["bfloat16"]`` of one
   device's flash step on the same weights and batches, the gathered
   first-step gradients within ``SPMD_GRAD_TOL`` of its; each rank's
   flash launches ``n_layers`` x its ring pairs per step for each
   kernel, the forward doubled under remat, none on the gather path, all
   on the tensor-core kernels; the drain stops every rank at one step,
   acknowledges after the barrier, and its checkpoint, the full state,
   restored into a one-device trainer takes the mesh's next step within
   ``LOSS_TOL["bfloat16"]``;
9. the MoE, expert parallelism, the pipeline and the dryrun, at the
   smoke width with 4 experts where an MoE runs: 9a, one-device MoE train
   steps (the loss falls; each flash kernel ``n_layers`` times a step on
   its tensor-core kernel; where a step's time goes); 9b, the int8
   kernel at the router's shape (N = E = 4) against its plain version,
   then MoE decode, float and int8, each cached within ``BF16_TOL`` of its
   full-prefix recompute, the int8 kernel launched ((5 + 2E) x n_layers +
   1) times a step on its tensor-core kernel, no flash, no host sync;
   9c, phase 8's job on dp 1 x tp 2 x ep 2 (the MoE's experts split over
   ``expert``, their hidden dimension over ``model``) with phase 8's
   gates; 9d, the GPipe pipeline over four stages of one block, 4
   microbatches of 2 rows, its losses within ``LOSS_TOL["bfloat16"]`` of
   the sequential steps, its first-step gradients (the rest equal on every
   stage) within ``SPMD_GRAD_TOL`` of theirs, and each stage's flash
   launches one a microbatch;
   9e, ``graft_entry.dryrun_multichip(4)`` (the reference's 4-head model,
   head dim 8, on the padded tensor-core kernels), every check held.  9c-9e run
   four worker ranks on the one card over phase 7b's transport; phase 8
   and 9c-9d trace one step more a rank for where its time goes;
10. the drain through the port's full control-plane cluster at fleet
   size (``cluster.inmem``, ``cache``, ``writepipeline``, the API types
   and the GPU-fleet vocabulary), on the card's host: 10a, an
   ``InMemoryCluster`` of 1,024 Nodes of 8 H100 each
   (``nvidia.com/gpu.product``, ``nvidia.com/gpu.count`` and one
   ``nvidia.com/slice-id`` a 16-node rack), the driver DaemonSet with a
   pod a node, and the NodeMaintenance and GpuUpgradePolicy kinds (CRDs
   with structural schemas, a CR each, and a policy the schema refuses);
   10b, every node's ``nvidia.com/gpu-driver-upgrade-state`` set to
   ``upgrade-required`` (and its admission stamped) through one
   ``WriteDispatcher`` over the batch transport, then ``flush``: every
   acknowledged write reads back from the cluster and, once the journal's
   deltas are applied, from an informer cache that was stale until then;
   fan-out ms, writes/s, batches, writes coalesced and the cache's
   refresh ms are logged (host clock); 10c, the main path's trainer on
   the card drained through ``DrainSignalWatcher`` on one of the 1,024
   nodes, the request sent through the dispatcher: the acknowledgement
   echoes its token, the checkpoint restores, and each flash kernel
   launches ``n_layers`` times a step on its tensor-core kernel; then the
   same cluster served over HTTP by ``cluster.apiserver.ApiServerFacade``
   on a local port: 10e, 10b's 2,048 merge patches again through one
   ``WriteDispatcher(KubeApiClient(...), use_batch=True)`` (each batch one
   POST to the batch endpoint); every acknowledged write reads back
   through a paginated client list (limit 500) and through an informer
   cache fed by a second client's held watch stream, and
   ``tpu.topology`` finds exactly the 64 NVLink domains of 16 in the
   nodes listed over HTTP; writes/s, batches, writes per batch, writes
   coalesced, HTTP requests and the informer's refresh ms are logged
   beside 10b's (host clock); 10f, 10c's drain with the watcher and the
   dispatcher on ``KubeApiClient``s, the request sent under a
   ``drain-handshake`` span whose traceparent rides beside it: the ack
   echoes the token, the checkpoint restores, each flash kernel launches
   on its tensor-core kernel, and the tracer's Chrome export holds the
   trainer's ``checkpoint-drain`` span under the request's trace id;
   10g, a whole upgrade wave through the port's node managers in
   process: every node's state cleared and given a Job's pod, the driver
   DaemonSet's ``rev2`` published, then pass after pass of the state
   machine's BuildState and ApplyState (the SLO, remediation and
   analysis engines, done/unknown, the in-place scheduler, cordon,
   wait-for-jobs, pod deletion, drain with the ``CheckpointDrainGate``,
   pod restart, failed, validation, uncordon) through the port's
   ``ClusterUpgradeStateManager`` (``tests/test_torch_rollout_parity.py``
   holds it to the JAX package's pass by pass), the script playing the
   DaemonSet controller, until the admitted wave is ``upgrade-done``.  The first admission takes 16 racks of 16 (slots
   count racks under the slice-aware policy), every other node waiting
   and schedulable; every wave node passes cordon, wait-for-jobs, drain,
   pod-restart and uncordon in its flight-recorder timeline, ends done
   and schedulable with its Job's pod evicted (one pod a drain) and its
   driver at ``rev2``; the main path's trainer on one wave node drains
   on the gate's request, its checkpoint restores, each flash kernel
   launches ``n_layers`` times a step on its tensor-core kernel, and its
   ``checkpoint-drain`` span is a child of the gate's ``drain-handshake``
   span in the Chrome export; ``RolloutStatus`` accounts for all 1,024
   nodes every pass; the remediation breaker stays closed.  The trainer's
   step times under the wave are logged beside the gate's.  10h, the
   next wave over HTTP: the managers, the gate and the trainer's watcher
   on a ``KubeApiClient`` to the facade, with the same gates and the HTTP
   requests, batch POSTs and writes per batch logged beside 10g's.  10i,
   the rest of the fleet in process: ``plan_rollout`` over a dump of the
   fleet as 10g-10h leave it must converge, its next admission 16 racks
   of 16 that neither earlier wave took; then, under ``runtime.tuned_gc``,
   the two remaining waves as 10g's (trainer, gate, rack workloads and
   every gate) through ``ClusterUpgradeStateManager(...,
   use_state_index=True)``, the first admission the plan's, each pass's
   indexed snapshot holding the same buckets as a full one built beside
   it (both BuildState ms logged); at the end ``RolloutStatus`` counts all
   1,024 nodes ``upgrade-done``, every node schedulable, every driver pod
   at ``rev2``, and the remediation breaker closed.  10d, after 10e-10i,
   no key or value of ``cluster.to_dict()`` names the TPU fleet
   (``tpu.google.com``, ``gke-tpu``): the whole rollout wrote none.  Phases 4, 6, 7 and 8 keep
   their drain nodes in an ``InMemoryCluster`` served by the same facade
   class;
11. a ``{"kernels": [...]}`` line (each flash row with phases 10c's,
   10f's, 10g's, 10h's and 10i's launches beside its other paths'), the card
   line, and last ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --int8-turns TREE [TREE ...]

times the int8 kernel of each checkout TREE (a directory holding its own
``chip_smoke.py`` and package, e.g. an unpacked ``git archive``) at the
smoke configuration's decode shapes and the long shape, in turns: each
tree once in the order given, then once in reverse, one process per turn,
each calling its own tree's ``time_int8``.  It prints one ``turn`` line
per turn and the card line.

    python3 chip_smoke.py --ranks N

runs phase 7's multi-process path over N NCCL ranks, one card each: the
data-parallel drain (losses identical across ranks and within
``LOSS_TOL["bfloat16"]`` of one rank's plain step on the same batches)
and every flash ring at s 8192 against single-device flash, with the
same gates and timings; then, N a multiple of 4, phase 8 on a dp N/4 x
sp 2 x tp 2 mesh and 9c on dp N/4 x tp 2 x ep 2; 9d where N is the smoke
config's 4 layers; 9e; then the card line.

    python3 chip_smoke.py --int8-plans

times the bf16 int8 kernel at the same shapes under every launch plan
(cluster and warps per block, each 1, 2, 4 or 8, no more slices than K
has chunks) beside the one ``int8_plan`` chooses, one ``plans`` line per
shape, then the card line.
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

_FLASH_SOURCE = "k8s_operator_libs_tpu_torch/csrc/flash_attention.cu"
SOURCE = {
    "flash_fwd": _FLASH_SOURCE,
    "flash_bwd_dq": _FLASH_SOURCE,
    "flash_bwd_dkv": _FLASH_SOURCE,
    "int8_linear": "k8s_operator_libs_tpu_torch/csrc/int8_matmul.cu",
}
REPLACES = {
    "flash_fwd": "k8s_operator_libs_tpu/tpu/flash_attention.py:64",
    "flash_bwd_dq": "k8s_operator_libs_tpu/tpu/flash_attention.py:225",
    "flash_bwd_dkv": "k8s_operator_libs_tpu/tpu/flash_attention.py:277",
    "int8_linear": "XLA's fusion of k8s_operator_libs_tpu/tpu/quantize.py:74-84 into "
                   "the consuming matmul; no Pallas kernel",
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


def capture(fn, calls: int = 1):
    """A CUDA graph of *calls* calls of *fn*, and what the last returned."""
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
            out = fn()
    return graph, out


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Mean device milliseconds of one *fn* call: *calls* calls captured
    in a CUDA graph, replayed *replays* times between events, so no
    call's host work (checks, allocation, the ctypes call) is timed."""
    import torch

    graph, _ = capture(fn, calls)
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


def check_ring_pairs(name, b, s, h, d, seed):
    """A flash ring's two pairs of one query chunk of *s* positions, as
    phase 8 runs them (bf16): the unmasked pair of the chunk below and
    the causal diagonal pair, each through the forward kernel, merged in
    the logsumexp frame (``ring_attention._merge``); then both backward
    kernels of each pair with the FINAL lse and ``dvec = rowsum(dO * O)``
    of the merged output, the dQ partials summed, as ``_RingFlash`` does.
    Held against autograd of the plain attention of the chunk's queries
    over both chunks' keys (causal), within ``BF16_TOL``."""
    import torch

    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import ring_attention as ra

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n: torch.randn(b, n, h, d, device="cuda", generator=gen).to(torch.bfloat16)  # noqa: E731
    q, k, v, do = mk(s), mk(2 * s), mk(2 * s), mk(s)
    qf, kf, vf, dof = (fa._fold(x) for x in (q, k, v, do))
    pairs = [(kf[:, :s].contiguous(), vf[:, :s].contiguous(), False),  # the chunk below
             (kf[:, s:].contiguous(), vf[:, s:].contiguous(), True)]  # the diagonal
    o = torch.zeros(qf.shape, dtype=torch.float32, device="cuda")
    lse = torch.full(qf.shape[:2], -1e30, dtype=torch.float32, device="cuda")
    for kp, vp, causal in pairs:
        o, lse = ra._merge(o, lse, *fa.flash_forward(qf, kp, vp, 1, causal))
    out = o.to(torch.bfloat16)
    dvec = (out.float() * dof.float()).sum(-1)
    dq = sum(fa.flash_bwd_dq(qf, kp, vp, dof, lse, dvec, 1, causal).float() for kp, vp, causal in pairs)
    dkv = [fa.flash_bwd_dkv(qf, kp, vp, dof, lse, dvec, 1, causal) for kp, vp, causal in pairs]
    dk, dv = (torch.cat([x[i] for x in dkv], 1) for i in (0, 1))
    # the plain side: queries at s..2s-1 over keys 0..2s-1
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    scores = torch.einsum("bqhd,bkhd->bhqk", leaves[0], leaves[1]) / math.sqrt(d)
    visible = (torch.arange(s, 2 * s, device="cuda")[:, None] >= torch.arange(2 * s, device="cuda"))
    ref = torch.einsum("bhqk,bkhd->bqhd", scores.masked_fill(~visible, -1e30).softmax(-1), leaves[2])
    ref_grads = torch.autograd.grad(ref, leaves, do.float())
    errs = {"O": check_close(f"{name} merged O", fa._unfold(out, b), ref, "bfloat16")}
    for what, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_grads):
        errs[what] = check_close(f"{name} {what} (final lse)", fa._unfold(a, b), r, "bfloat16")
    log(f"kernels {name}: b{b} chunk s{s} h{h} d{d} bf16, two pairs merged "
        + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items()))


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


def device_window(run, steps: int):
    """Host-clock ms per step of *run* (which runs *steps* steps and
    returns), then from a torch.profiler trace of another call the
    device's busy ms per step, its ops per step, the idle share of the
    traced window, and the kernels that take most device time
    (``smoke.device_busy``)."""
    import torch

    from k8s_operator_libs_tpu_torch.tpu import smoke

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return {"wall_ms_per_step": (time.perf_counter() - t0) / steps * 1e3, **smoke.device_busy(run, steps)}


def step_breakdown(config, steps: int = 5):
    """Where a train step's time goes, flash and gather paths in one call
    (:func:`device_window` over *steps* steps)."""
    import dataclasses

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

        def run():
            for _ in range(steps):
                step(batch)

        out["flash" if flash else "gather"] = device_window(run, steps)
    log("step breakdown:", json.dumps(out))
    return out


# ------------------------------------------------------------ phase 5


def int8_decode_shapes(config):
    """(name, K, N, launches per decode step) of every int8 matmul one
    decode step runs at *config*."""
    d, ff, layers = config.d_model, config.d_ff, config.n_layers
    return [
        ("qkv/out", d, d, 4 * layers),
        ("mlp_up", d, ff, layers),
        ("mlp_down", ff, d, layers),
        ("lm_head", d, config.vocab_size, 1),
    ]


def int8_inputs(m, k, n, dtype: str, seed: int):
    """x [m, k], a per-row int8 weight q [n, k] with its fp32 scale s, and
    a bias, on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(n, k, device="cuda", generator=gen) / math.sqrt(k)
    amax = w.abs().amax(1)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(w / s[:, None]).clamp(-127, 127).to(torch.int8)
    dt = getattr(torch, dtype)
    x = torch.randn(m, k, device="cuda", generator=gen).to(dt)
    bias = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dt)
    return x, q, s, bias


def int8_bound_ms(m, k, n, dtype: str):
    """Bytes: q once, its scales, x, y and the bias; operations: 2MNK."""
    e = 2 if dtype == "bfloat16" else 4
    nbytes = k * n + 4 * n + e * (m * k + m * n + n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / peak_flops(dtype) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_int8(name, m, k, n, dtype: str, seed: int = 0) -> float:
    """The kernel against its plain version on the same inputs, two
    launches and a graph replay bit-equal, and the launch on the dtype's
    device kernel."""
    import torch

    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    x, q, s, bias = int8_inputs(m, k, n, dtype, seed)
    before = dict(qz.device_launch_counts)
    got = qz.int8_linear(x, q, s, bias)
    kernel = qz.DEVICE_KERNELS["int8_linear"][getattr(torch, dtype)]
    launched = {k_: v - before[k_] for k_, v in qz.device_launch_counts.items() if v != before[k_]}
    if launched != {kernel: 1}:
        raise RuntimeError(f"int8 {name}: device launches {launched}, want one of {kernel}")
    if not torch.equal(got, qz.int8_linear(x, q, s, bias)):
        raise RuntimeError(f"int8 {name}: two launches differ")
    graph, replayed = capture(lambda: qz.int8_linear(x, q, s, bias))
    replayed.zero_()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(got, replayed):
        raise RuntimeError(f"int8 {name}: a CUDA-graph replay differs from the eager call")
    err = check_close(f"int8 {name}", got, qz.int8_linear_plain(x, q, s, bias), dtype)
    log(f"kernels int8 {name}: M{m} K{k} N{n} {dtype} err={err:.3e}")
    return err


def time_int8(m, k, n, dtype: str, graphs: bool, iters: int = 50) -> dict:
    """Device ms of the kernel, its plain version, and ``F.linear`` on the
    already-dequantized weight: the cuBLAS call the kernel replaces, which
    reads twice the bytes (a yardstick, not the same function).  With
    *graphs* they are timed by :func:`graph_ms` and the kernel's
    back-to-back event figure is kept as ``event_ms``."""
    import torch.nn.functional as F

    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    x, q, s, bias = int8_inputs(m, k, n, dtype, seed=1)
    w = (q.float() * s[:, None]).to(x.dtype)
    timer = graph_ms if graphs else (lambda fn: cuda_ms(fn, iters))
    kernel = lambda: qz.int8_linear(x, q, s, bias)  # noqa: E731
    row = {
        "ms": timer(kernel),
        "plain_ms": timer(lambda: qz.int8_linear_plain(x, q, s, bias)),
        "linear_ms": timer(lambda: F.linear(x, w, bias)),
    }
    if graphs:
        row["event_ms"] = cuda_ms(kernel, iters)
    bound, by = int8_bound_ms(m, k, n, dtype)
    row.update(bound_ms=bound, bound_by=by, bound_share=bound / row["ms"])
    return row


def int8_kernel_phase(config):
    """Hold the kernel to its plain version at every decode shape of
    *config* (M 8), at M 1, 13, 16 and 17, at ragged K and N, at a K the
    bf16 plan splits unevenly, under a cluster of 8, and at the long
    shape; time them all by graph replay: at the long shape too a call's
    host work is as long as the kernel (``event_ms``).  Returns (worst err
    at the decode shapes, timings)."""
    errs = []
    for dtype in ("bfloat16", "float32"):
        for name, k, n, _ in int8_decode_shapes(config):
            errs.append(check_int8(f"{name}-{dtype}", 8, k, n, dtype, seed=k + n))
        check_int8(f"m1-{dtype}", 1, 512, 2048, dtype, seed=3)
        check_int8(f"m13-{dtype}", 13, 2048, 512, dtype, seed=4)
        check_int8(f"m16-{dtype}", 16, 512, 512, dtype, seed=8)
        check_int8(f"m17-{dtype}", 17, 2048, 2048, dtype, seed=9)
        check_int8(f"ragged-k80-n33-{dtype}", 8, 80, 33, dtype, seed=5)
        check_int8(f"ragged-k77-n40-{dtype}", 13, 77, 40, dtype, seed=6)  # byte loads of q
        check_int8(f"ragged-n2047-{dtype}", 8, 512, 2047, dtype, seed=10)
        check_int8(f"uneven-k1040-{dtype}", 8, 1040, 512, dtype, seed=11)  # 17 chunks, 16 slices
        check_int8(f"cluster8-k8192-n512-{dtype}", 8, 8192, 512, dtype, seed=12)
    check_int8("long-bfloat16", 8, 8192, 8192, "bfloat16", seed=7)
    shapes = {}
    for name, k, n, per_step in int8_decode_shapes(config):
        shapes[name] = {"M": 8, "K": k, "N": n, "launches_per_step": per_step,
                        **time_int8(8, k, n, "bfloat16", graphs=True)}
    step = {key: sum(r[key] * r["launches_per_step"] for r in shapes.values())
            for key in ("ms", "plain_ms", "linear_ms", "bound_ms")}
    step["launches"] = sum(r["launches_per_step"] for r in shapes.values())
    step["bound_by"] = "/".join(sorted({r["bound_by"] for r in shapes.values()}))
    long = {"M": 8, "K": 8192, "N": 8192, **time_int8(8, 8192, 8192, "bfloat16", graphs=True)}
    timing = {"per_shape": shapes, "per_decode_step": step, "long": long}
    log("timing int8:", json.dumps(timing))
    return max(errs), timing


def decode_logits(cfg, model, tokens):
    """Teacher-forced cached decode over *tokens* [b, t]: each step's fp32
    last logits, [b, t, vocab]."""
    import torch

    from k8s_operator_libs_tpu_torch.tpu import workload as wl

    b, t = tokens.shape
    cache = wl.KVCache(cfg, b, t, "cuda")
    steps = []
    with torch.inference_mode():
        for i in range(t):
            pos = torch.full((b, 1), i, dtype=torch.long, device="cuda")
            steps.append(model(tokens[:, i:i + 1], pos, cache=cache)[:, -1].float())
    return torch.stack(steps, 1)


def exact_dense(self, x):
    """A Dense's forward, x . w^T + b on its compute-dtype operands, summed
    in float64 and rounded to the compute dtype once."""
    import torch.nn.functional as F

    dt = self.compute_dtype
    return F.linear(x.to(dt).double(), self.weight.to(dt).double(), self.bias.to(dt).double()).to(dt)


def no_host_sync(fn):
    """*fn*() with every synchronising CUDA call raising."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def serving_gates(config, prompt_len: int = 16, new_tokens: int = 32) -> dict:
    """The serving path at the smoke width from seed-0 weights; every
    gate raises.  Returns the int8 launches of the gated ``generate`` and
    what was measured."""
    import dataclasses

    import numpy as np
    import torch

    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz
    from k8s_operator_libs_tpu_torch.tpu import workload as wl

    out = {}
    b, total = 8, prompt_len + new_tokens
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, config.vocab_size, (b, prompt_len))).cuda()

    # fp32: cached greedy decode == full-prefix recompute, token for token
    f32 = dataclasses.replace(config, dtype=torch.float32, flash_attention=False)
    model = wl.TinyLM(f32, "cuda", seed=0)
    greedy = wl.greedy_generate(f32, model, prompt, new_tokens)
    buf = prompt
    with torch.inference_mode():
        for _ in range(new_tokens):
            buf = torch.cat([buf, model(buf)[:, -1].float().argmax(-1)[:, None]], 1)
    if not torch.equal(greedy, buf):
        raise RuntimeError(f"fp32 decode != recompute in {int((greedy != buf).sum())} tokens")

    # ragged prompts: each row equals its own solo generation (fp32)
    lens = [min(n, prompt_len) for n in (3, prompt_len, 7, 12, 1, prompt_len, 9, 5)]
    ragged = wl.generate(f32, model, prompt, new_tokens, prompt_lens=lens)
    for r, plen in enumerate(lens):
        solo = wl.generate(f32, model, prompt[r:r + 1, :plen], new_tokens + prompt_len - plen)
        if not torch.equal(ragged[r], solo[0]):
            raise RuntimeError(f"ragged row {r} (prompt {plen}) != its solo generation")

    # sampling, through the fp32 int8 route (bf16 logits tie at the top
    # often enough that top_k 1 may keep two tokens where argmax takes the
    # first): one seed reproduces, another differs, top_k 1 is greedy
    int8_f32 = wl.quantize_model(model)
    del model

    def sample(seed, top_k=8, temperature=1.0):
        return no_host_sync(lambda: wl.generate(
            f32, int8_f32, prompt, new_tokens, temperature=temperature, top_k=top_k, seed=seed
        ))

    a, again, other = sample(7), sample(7), sample(8)
    if not torch.equal(a, again) or torch.equal(a, other):
        raise RuntimeError("sampling: seed 7 not reproduced, or seed 8 gave the same tokens")
    if not torch.equal(sample(3, top_k=1, temperature=5.0), wl.greedy_generate(f32, int8_f32, prompt, new_tokens)):
        raise RuntimeError("sampling: top_k=1 differs from greedy")
    del int8_f32
    log(f"serving fp32: greedy == recompute over {new_tokens} tokens; ragged {lens} == solo rows; "
        "int8 sampling seeded, top_k=1 == greedy, no host sync")

    # bf16: the cache against the full prefix; int8: the kernel route
    # against the plain route (the dequantized weights through F.linear)
    # computed exactly, each Dense in float64 and rounded to bf16 once, as
    # the kernel's contract states. cuBLAS's bf16 F.linear strays from
    # that by more than the tolerance itself (PERF.md §6), so its route
    # is logged beside, not gated.
    bf16 = dataclasses.replace(config, flash_attention=False)
    model = wl.TinyLM(bf16, "cuda", seed=0)
    qstate = qz.quantize_params_int8(model)
    int8 = wl.quantized_model(bf16, qstate, "cuda")
    plain = wl.TinyLM(bf16, "cuda")
    plain.load_state_dict(qz.dequantize_params(qstate))
    tokens = wl.greedy_generate(bf16, int8, prompt, new_tokens)
    with torch.inference_mode():
        full = model(tokens).float()
    out["bf16_cache_err"] = check_close("bf16 decode vs full prefix", decode_logits(bf16, model, tokens), full, "bfloat16")
    kernel_logits = decode_logits(bf16, int8, tokens)
    cublas_logits = decode_logits(bf16, plain, tokens)
    for dense in plain.modules():
        if isinstance(dense, wl.Dense):
            dense.forward = exact_dense.__get__(dense)
    exact_logits = decode_logits(bf16, plain, tokens)
    out["int8_route_err"] = check_close(
        "int8 kernel route vs exact plain route", kernel_logits, exact_logits, "bfloat16"
    )
    out["int8_vs_cublas_route_err"] = max_err(kernel_logits, cublas_logits)
    out["cublas_vs_exact_route_err"] = max_err(cublas_logits, exact_logits)

    # the int8 route's launches, with no host synchronisation in the loop
    qz.reset_launch_counts()
    fa.reset_launch_counts()
    gated = no_host_sync(lambda: wl.generate(bf16, int8, prompt, new_tokens))
    launches = qz.launch_counts["int8_linear"]
    device_launches = {k: n for k, n in qz.device_launch_counts.items() if n}
    want = (6 * config.n_layers + 1) * (total - 1)
    routed = qz.DEVICE_KERNELS["int8_linear"][config.dtype]
    if launches != want or device_launches != {routed: want} or any(fa.launch_counts.values()):
        raise RuntimeError(
            f"int8 launches {launches} by device kernel {device_launches} (want {want}, all "
            f"{routed}), flash launches {fa.launch_counts} (want 0)"
        )
    if not torch.equal(gated, tokens):
        raise RuntimeError("two greedy int8 generations differ")
    log(f"serving bf16/int8: errs {json.dumps(out)} (tol {BF16_TOL}); int8 launches {launches} "
        f"= (6*{config.n_layers}+1)*{total - 1}, all {routed}; flash 0; no host sync in the loop")

    # where a decode step's time goes, float and int8 (8 new tokens)
    out["decode_breakdown"] = {
        name: device_window(lambda m=m: wl.generate(bf16, m, prompt, 8), prompt_len + 7)
        for name, m in (("float", model), ("int8", int8))
    }
    log("decode breakdown (per decode step):", json.dumps(out["decode_breakdown"]))
    out["launches"] = launches
    out["device_kernel"] = routed
    return out


# ------------------------------------------------------------ phase 6


#: The attention stage's flash launches: a warm and 30 timed forwards at
#: each of s 1024 and 2048, then a warm and 5 timed fwd+bwd at s 8192.
ATTENTION_STAGE_LAUNCHES = {"flash_fwd": 2 * 31 + 6, "flash_bwd_dq": 6, "flash_bwd_dkv": 6}


def stage_phase(card: str) -> dict:
    """Run every stage of ``smoke.STAGES`` in order, in this process,
    each gated (every gate raises), with the flash and int8 launch counts
    set to 0 before each stage and read after it.  Returns the records
    by stage."""
    import torch

    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz
    from k8s_operator_libs_tpu_torch.tpu import smoke

    stamp = {"platform": "gpu", "device_kind": torch.cuda.get_device_name(0)}
    records = {}
    for stage in smoke.STAGES:
        fa.reset_launch_counts()
        qz.reset_launch_counts()
        t0 = time.perf_counter()
        rec = records[stage] = smoke.run_stage(stage)
        seconds = time.perf_counter() - t0
        flash = dict(fa.launch_counts)
        flash_devices = {k: n for k, n in fa.device_launch_counts.items() if n}
        int8 = qz.launch_counts["int8_linear"]
        int8_devices = {k: n for k, n in qz.device_launch_counts.items() if n}
        if {k: rec.get(k) for k in stamp} != stamp:
            raise RuntimeError(f"stage {stage}: stamped {rec}, want {stamp}")
        if stage == "touch" and rec["touch"]["checksum"] != 512.0:
            raise RuntimeError(f"touch: {rec['touch']}")
        if stage == "matmul":
            mm = rec["matmul"]
            if (mm["n"], mm["dtype"]) != (4096, "bfloat16") or not mm["tflops"] > 0:
                raise RuntimeError(f"matmul: {mm}")
            log("stage matmul:", json.dumps(mm), "|", card)
        if stage == "train":
            if ("mfu_pct" not in rec or {"attention_kernel", "decode"} & set(rec)
                    or not math.isfinite(rec["final_loss"])):
                raise RuntimeError(f"train: {rec}")
            log("stage train:", json.dumps({k: rec[k] for k in (
                "step_time_ms", "tokens_per_s", "achieved_tflops", "mfu_pct", "final_loss"
            )}), "|", card)
        if stage == "attention":
            want_devices = {
                fa.DEVICE_KERNELS[e][torch.bfloat16]: n for e, n in ATTENTION_STAGE_LAUNCHES.items()
            }
            if flash != ATTENTION_STAGE_LAUNCHES or flash_devices != want_devices:
                raise RuntimeError(
                    f"attention: flash launches {flash} by device kernel {flash_devices}, "
                    f"want {ATTENTION_STAGE_LAUNCHES}, all on {want_devices}"
                )
            for row, timing in rec["attention_kernel"].items():
                log(f"stage attention {row}:", json.dumps(timing), "|", card)
        if stage == "decode":
            dec = rec["decode"]
            cfg = smoke.smoke_config(torch.device("cuda"))
            # a warm and a timed generation over 16 + new_tokens positions
            want = (6 * cfg.n_layers + 1) * (16 + dec["new_tokens"] - 1) * 2
            routed = qz.DEVICE_KERNELS["int8_linear"][torch.bfloat16]
            if int8 != want or int8_devices != {routed: want} or any(flash.values()):
                raise RuntimeError(
                    f"decode: int8 launches {int8} by device kernel {int8_devices}, want "
                    f"{want} on {routed}; flash launches {flash}, want 0"
                )
            log("decode bench:", json.dumps(dec), "|", card)
        if stage == "drain":
            hs = rec["drain_handshake"]
            if hs != {**hs, "checkpoint_step": 2, "ack": "done", "resumed_steps": 2}:
                raise RuntimeError(f"drain: {hs}")
            log("stage drain:", json.dumps(hs))
        log(f"stage {stage}: ok in {seconds:.1f} s; flash launches {flash_devices}, "
            f"int8 launches {int8_devices}")
    return records


def drain_trace_phase(config) -> dict:
    """Play the orchestrator's gate with the port's own tracer: open a
    ``drain-handshake`` span, write ``requested:<token>`` and the span's
    traceparent to the node, and wait for the acknowledgement while the
    trainer runs in another thread until it drains.  The trainer's
    ``checkpoint-drain`` span must carry the gate span's trace id and
    have that span as its parent.  Returns both spans."""
    import uuid
    from concurrent.futures import ThreadPoolExecutor

    from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster
    from k8s_operator_libs_tpu_torch.cluster.objects import make_node
    from k8s_operator_libs_tpu_torch.obs import tracing
    from k8s_operator_libs_tpu_torch.tpu import workload as wl
    from k8s_operator_libs_tpu_torch.tpu.drain_handshake import DrainSignalWatcher
    from k8s_operator_libs_tpu_torch.upgrade import consts, util

    tracer = tracing.Tracer()
    previous = tracing.set_default_tracer(tracer)
    try:
        nodes = InMemoryCluster()
        nodes.create(make_node("gpu-host"))
        key = util.get_pre_drain_checkpoint_annotation_key()
        token = uuid.uuid4().hex[:12]
        ack = f"{consts.PRE_DRAIN_CHECKPOINT_DONE}:{token}"
        with tempfile.TemporaryDirectory(prefix="chip-smoke-trace-") as ckpt, \
                ThreadPoolExecutor(1) as pool:
            trainer = wl.CheckpointingTrainer(
                config, ckpt, watcher=DrainSignalWatcher(nodes, "gpu-host"), device="cuda"
            )
            trainer.run(2)
            run = pool.submit(trainer.run, 1000)  # a thread: no span context is inherited
            with tracing.start_span("drain-handshake", attributes={"node": "gpu-host"}) as gate:
                nodes.patch("Node", "gpu-host", {"metadata": {"annotations": {
                    key: f"{consts.PRE_DRAIN_CHECKPOINT_REQUESTED}:{token}",
                    util.get_pre_drain_traceparent_annotation_key(): gate.traceparent,
                }}})
                deadline = time.monotonic() + 120
                while nodes.get("Node", "gpu-host")["metadata"]["annotations"][key] != ack:
                    if run.done() or time.monotonic() > deadline:
                        raise RuntimeError(f"drain trace: no acknowledgement ({run})")
                    time.sleep(0.01)
            step = run.result(timeout=120)
            if not trainer.drained or wl.restore_checkpoint(ckpt, step)["step"] != step:
                raise RuntimeError(f"drain trace: drained {trainer.drained} at step {step}")
        spans = {s["name"]: s for t in tracer.traces(complete_only=False) for s in t["spans"]}
        gate_span, drain_span = spans["drain-handshake"], spans["checkpoint-drain"]
        if (drain_span["trace_id"], drain_span["parent_id"], drain_span["status"]) != (
            gate_span["trace_id"], gate_span["span_id"], "ok"
        ):
            raise RuntimeError(f"drain trace: gate span {gate_span}, drain span {drain_span}")
        log("drain trace:", json.dumps({
            "trace_id": gate_span["trace_id"],
            "drain-handshake": {k: gate_span[k] for k in ("span_id", "duration_s")},
            "checkpoint-drain": {k: drain_span[k] for k in ("parent_id", "duration_s", "status")},
            "drained_at_step": step,
        }))
        return {"drain-handshake": gate_span, "checkpoint-drain": drain_span}
    finally:
        tracing.set_default_tracer(previous)


# ------------------------------------------------------------ phase 7


#: The rings of 7b, at the attention bench's width: (case, function, causal).
RING_SHAPE = (4, 8192, 8, 64)  # b, global s, h, d; bf16
RING_CASES = (
    ("ring-causal", "ring_flash_attention", True),
    ("ring", "ring_flash_attention", False),
    ("zigzag", "zigzag_ring_flash_attention", True),
)
#: seconds a group of worker ranks may take, start to exit
RANKS_DEADLINE = 180


def _drain_request(nodes, token: str) -> None:
    from k8s_operator_libs_tpu_torch.upgrade import consts, util

    nodes.patch("Node", "gpu-host", {"metadata": {"annotations": {
        util.get_pre_drain_checkpoint_annotation_key():
            f"{consts.PRE_DRAIN_CHECKPOINT_REQUESTED}:{token}",
    }}})


def _check_drained(what: str, nodes, token: str, ckpt: str, results) -> int:
    """Every rank drained at one step, the node carries ``done:<token>``,
    and the checkpoint of every rank restores at that step.  Returns the
    step."""
    from k8s_operator_libs_tpu_torch.tpu import workload as wl
    from k8s_operator_libs_tpu_torch.tpu.multihost_trainer import shadow_dir
    from k8s_operator_libs_tpu_torch.upgrade import consts, util

    steps = {r["stopped_at_step"] for r in results}
    ack = nodes.get("Node", "gpu-host")["metadata"]["annotations"].get(
        util.get_pre_drain_checkpoint_annotation_key())
    if not all(r["drained"] for r in results) or len(steps) != 1:
        raise RuntimeError(f"{what}: not one drained step: {results}")
    step = steps.pop()
    if ack != f"{consts.PRE_DRAIN_CHECKPOINT_DONE}:{token}":
        raise RuntimeError(f"{what}: ack {ack!r}, want done:{token}")
    for rank in range(len(results)):
        if wl.restore_checkpoint(shadow_dir(ckpt, rank), step)["step"] != step:
            raise RuntimeError(f"{what}: rank {rank}'s checkpoint does not restore at step {step}")
    return step


def _check_flash_launches(what: str, counts: dict, want: dict) -> None:
    """*counts* by device kernel must be *want* by entry point, each on
    its bf16 tensor-core kernel."""
    import torch

    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa

    expect = {fa.DEVICE_KERNELS[e][torch.bfloat16]: n for e, n in want.items() if n}
    if counts != expect or any("_tc_" not in k for k in expect):
        raise RuntimeError(f"{what}: flash launches {counts}, want {expect}")


def one_rank_drain(config, card: str) -> dict:
    """7a: one NCCL rank in this process.  Its collectives, then
    ``MultihostDrainLoop`` over the data-parallel trainer at *config*,
    drained by a gate thread after step 3.  Returns the loop's record."""
    import threading
    import uuid

    import torch
    import torch.distributed as dist

    from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster
    from k8s_operator_libs_tpu_torch.cluster.objects import make_node
    from k8s_operator_libs_tpu_torch.hack import dist_worker
    from k8s_operator_libs_tpu_torch.tpu import distributed
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu.drain_handshake import DrainSignalWatcher

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(dist_worker.free_port()),
           "WORLD_SIZE": "1", "RANK": "0"}
    identity = distributed.initialize_from_env(env)
    try:
        if (*identity, dist.get_backend()) != (0, 1, "nccl"):
            raise RuntimeError(f"7a: rank, world, backend {identity}, {dist.get_backend()}")
        if distributed.host_allreduce_max(2.0) != 2.0:
            raise RuntimeError("7a: host_allreduce_max(2.0) != 2.0")
        distributed.sync_global_devices("chip-smoke-7a")
        nodes = InMemoryCluster()
        nodes.create(make_node("gpu-host"))
        token = uuid.uuid4().hex[:12]
        reached = threading.Event()

        def gate():
            if reached.wait(timeout=RANKS_DEADLINE):
                _drain_request(nodes, token)

        with tempfile.TemporaryDirectory(prefix="chip-smoke-7a-") as ckpt:
            thread = threading.Thread(target=gate, daemon=True)
            thread.start()
            fa.reset_launch_counts()
            rec = dist_worker.drain_job(
                config, distributed.global_mesh(), 0, torch.device("cuda", torch.cuda.current_device()),
                DrainSignalWatcher(nodes, "gpu-host"), ckpt, max_steps=200, max_seconds=120,
                on_step=lambda step, loss: step >= 3 and reached.set(),
            )
            thread.join(timeout=10)
            if thread.is_alive():
                raise RuntimeError("7a: the gate thread did not finish")
            step = _check_drained("7a", nodes, token, ckpt, [rec])
        n = config.n_layers * step
        rec["flash_launches"] = dist_worker.flash_device_launches()
        _check_flash_launches("7a", rec["flash_launches"], dict.fromkeys(fa.launch_counts, n))
        if not all(math.isfinite(x) for x in rec["losses"]):
            raise RuntimeError(f"7a: losses {rec['losses']}")
        log("phase 7a one NCCL rank:", json.dumps(rec), "|", card)
        return rec
    finally:
        dist.destroy_process_group()


def start_nccl_probe():
    """Two NCCL ranks on the one card, started (they run beside 7a; as a
    context manager, leaving it kills them)."""
    from k8s_operator_libs_tpu_torch.hack.dist_worker import Ranks

    args = ["train", "--device", "cuda", "--backend", "nccl", "--steps", "1"]
    return Ranks(2, args, env={"NCCL_DEBUG": "WARN"})


def nccl_probe(probe) -> str:
    """NCCL is expected to refuse two ranks on one card (a duplicate
    GPU).  Returns the backend 7b uses: gloo after that refusal, NCCL had
    it accepted them; anything else raises."""
    with probe as ranks:
        try:
            ranks_out = ranks.finish(60)
        except TimeoutError as err:  # a refusal by hanging: killed, and said so
            log("phase 7b NCCL probe: two ranks on one card hung for 60 s; killed |",
                str(err)[-300:])
            return "gloo"
    codes = [code for code, _, _ in ranks_out]
    lines = [ln for _, _, err in ranks_out for ln in err]
    duplicate = [ln for ln in lines if "duplicate gpu" in ln.lower()]
    if codes == [0, 0]:
        log("phase 7b NCCL probe: two ranks on one card accepted; 7b runs NCCL")
        return "nccl"
    if all(codes) and duplicate:
        log("phase 7b NCCL probe: refused, exit codes", codes, "|", duplicate[0].strip()[:300])
        return "gloo"
    raise RuntimeError(f"7b NCCL probe: exit codes {codes}, no duplicate-GPU refusal:\n"
                       + "\n".join(lines[-40:]))


def ranks_drain(config, backend: str, reference: list, card: str, n: int = 2,
                what: str = "7b") -> dict:
    """The data-parallel drain of *n* worker ranks (7b: two on the one
    card).  Rank 0 watches the node over HTTP (the port's client and node
    server); the losses must be identical across ranks and within
    ``LOSS_TOL["bfloat16"]`` of the *reference* losses of one rank on the
    same global batches."""
    import uuid

    from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster
    from k8s_operator_libs_tpu_torch.cluster.apiserver import ApiServerFacade
    from k8s_operator_libs_tpu_torch.cluster.objects import make_node
    from k8s_operator_libs_tpu_torch.hack.dist_worker import Ranks
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa

    nodes = InMemoryCluster()
    nodes.create(make_node("gpu-host"))
    token = uuid.uuid4().hex[:12]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-7b-") as ckpt, ApiServerFacade(nodes) as server:
        env = {"FACADE_URL": server.url, "DRAIN_NODE_NAME": "gpu-host", "DRAIN_CKPT_DIR": ckpt,
               "DRAIN_MAX_STEPS": "200", "DRAIN_MAX_SECONDS": "120"}
        args = ["drain", "--device", "cuda", "--backend", backend, "--config", "smoke"]
        with Ranks(n, args, env) as ranks:
            ranks.wait_for(0, "] step 3 ", RANKS_DEADLINE)
            _drain_request(nodes, token)
            results = ranks.results(RANKS_DEADLINE)
        step = _check_drained(what, nodes, token, ckpt, results)
    losses = [r["losses"] for r in results]
    if any(x != losses[0] for x in losses) or len(losses[0]) != step:
        raise RuntimeError(f"{what}: loss sequences differ across ranks: {losses}")
    common = min(step, len(reference))
    diff = max(abs(a - b) for a, b in zip(losses[0][:common], reference[:common]))
    if diff > LOSS_TOL["bfloat16"]:
        raise RuntimeError(f"{what}: losses {losses[0]} vs one rank's {reference}: {diff:.3e}")
    launches = config.n_layers * step
    for r in results:
        _check_flash_launches(f"{what} rank {r['rank']}", r["flash_launches"],
                              dict.fromkeys(fa.launch_counts, launches))
    rec = {"backend": backend, "stopped_at_step": step, "losses": losses[0],
           "max_diff_vs_one_rank": diff, "steps_compared": common,
           "step_ms": [r["step_ms"] for r in results],
           "loop_ms_per_step": [r["loop_ms_per_step"] for r in results],
           "worker_seconds": [r["seconds"] for r in results]}
    log(f"phase {what}, {n} ranks, drain:", json.dumps(rec), "|", card)
    return rec


def ranks_rings(backend: str, card: str, n: int = 2, what: str = "7b") -> dict:
    """Every flash ring over *n* worker ranks (7b: two on the one card),
    at b 4, global s 8192, h 8, d 64, bf16; output and gradients against
    single-device ``flash_attention`` on the whole sequence with the same
    dO, at ``BF16_TOL``; each rank's launches equal its pairs
    (``ring_schedule``), all on the tensor-core kernels.  Returns the
    per-case launches and timings."""
    import torch

    from k8s_operator_libs_tpu_torch.hack.dist_worker import Ranks
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import ring_attention as ra

    b, s, h, d = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ring-") as tmp:
        host = {"q": q.cpu(), "k": k.cpu(), "v": v.cpu(), "do": do.cpu()}
        torch.save({"cases": [{"name": name, "fn": fn, "causal": causal, "block": 128, **host}
                              for name, fn, causal in RING_CASES]}, f"{tmp}/inputs.pt")
        args = ["ring", "--device", "cuda", "--backend", backend,
                "--inputs", f"{tmp}/inputs.pt", "--out", f"{tmp}/rank{{rank}}.pt"]
        with Ranks(n, args) as ranks:
            lines = ranks.results(RANKS_DEADLINE)
        shards = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(n)]
    report = {"backend": backend, "transport": lines[0]["transport"], "cases": {},
              "worker_seconds": [line["seconds"] for line in lines]}
    for name, fn, causal in RING_CASES:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves, causal)
        ref = (out, *torch.autograd.grad(out, leaves, do))
        layout = "zigzag" if fn.startswith("zigzag") else "contiguous"
        errs, rel = {}, {}
        for i, key in enumerate(("out", "dq", "dk", "dv")):
            got = torch.cat([sh[name][key] for sh in shards], dim=1).cuda()
            got = ra.from_zigzag(got, n) if layout == "zigzag" else got
            errs[key] = check_close(f"{what} {name} {key}", got, ref[i], "bfloat16")
            # the error as check_close holds it: against max(1, max |ref|)
            rel[key] = errs[key] / max(1.0, float(ref[i].detach().float().abs().max()))
        pairs = [len(ra.ring_schedule(n, r, causal, layout)) for r in range(n)]
        for r, line in enumerate(lines):
            row = line["cases"][name]
            if row["pairs"] != pairs[r] or row["launches"] != dict.fromkeys(fa.launch_counts, pairs[r]):
                raise RuntimeError(f"{what} {name} rank {r}: launches {row['launches']}, want {pairs[r]} each")
            _check_flash_launches(f"{what} {name} rank {r}", row["device_launches"],
                                  dict.fromkeys(fa.launch_counts, pairs[r]))
        report["cases"][name] = {
            "pairs": pairs, "max_abs_err": errs, "err_over_scale": rel,
            "fwd_ms": [line["cases"][name]["fwd_ms"] for line in lines],
            "bwd_ms": [line["cases"][name]["bwd_ms"] for line in lines],
        }
    # contiguous causal: rank r computes the r + 1 blocks at or below it
    if report["cases"]["ring-causal"]["pairs"] != list(range(1, n + 1)):
        raise RuntimeError(f"{what}: causal ring pairs {report['cases']['ring-causal']['pairs']}")
    # single-device flash at the same global shape, by events
    for causal in (True, False):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        fwd = [cuda_ms(lambda: fa.flash_attention(*leaves, causal), 1, warmup=1) for _ in range(3)]
        bwd = []
        for _ in range(3):
            out = fa.flash_attention(*leaves, causal)
            bwd.append(cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 1, warmup=0))
        report["single_device_causal" if causal else "single_device"] = {"fwd_ms": fwd, "bwd_ms": bwd}
    log(f"phase {what}, {n} ranks, rings:", json.dumps(report), "|", card)
    del q, k, v, do
    torch.cuda.empty_cache()
    return report


# ------------------------------------------------------------ phase 8


#: The sharded train step at the smoke width on dp 1 x sp 2 x tp 2: 257
#: tokens, so the 256 positions after the shift split 128 a seq rank.
SPMD_MESH = (1, 2, 2)
SPMD_SEQ = 257
SPMD_STEPS = 2
#: Phase 8's first-step gradients, gathered to the full state, against one
#: device's on the same weights and batch: per layer (the leaves of one
#: module, so a key bias, whose exact gradient is zero since softmax
#: ignores a constant added to a query's scores, is read on its weight's
#: scale), max |mesh - one device| / max |one device|, held below
#: SPMD_GRAD_TOL: twice the worst reading on an H100 (0.0276, a key
#: projection, in every run, gather SP's too: bf16 rounding at other
#: points), far below the error of a wrong merge or a wrong collective.
SPMD_GRAD_TOL = 0.055


def layer_rel_err(got: dict, ref: dict):
    """(the largest per-layer relative error of *got* against *ref*, its
    layer): max |got - ref| / max |ref| over the leaves of each module."""
    layers: dict = {}
    for name, r in ref.items():
        err, scale = layers.get(name.rsplit(".", 1)[0], (0.0, 0.0))
        layers[name.rsplit(".", 1)[0]] = (max(err, float((got[name].float() - r).abs().max())),
                                          max(scale, float(r.abs().max())))
    return max((err / scale, layer) for layer, (err, scale) in layers.items())
_RING_FLASH = {"seq_axis": "seq", "ring_attention": True, "ring_flash": True}
SPMD_RUNS = (
    ("gather-sp", {"seq_axis": "seq", "flash_attention": False}),
    ("ring-flash", _RING_FLASH),
    ("zigzag", {**_RING_FLASH, "ring_layout": "zigzag"}),
    ("remat-ring-flash", {**_RING_FLASH, "remat": True}),
)
#: A job of the sharded step: the mesh's (sp, tp, ep) beside dp = ranks /
#: 4, the config's fields over the smoke config with flash, the runs (2
#: steps each, the first step's gradients gathered, one step more traced),
#: and the fields of the drain's run.  Phase 8: dp 1 x sp 2 x tp 2 at 257
#: tokens (128 positions a seq rank).
SPMD_JOB = {"name": "sharded step", "mesh": SPMD_MESH[1:] + (1,), "config": {"max_seq_len": SPMD_SEQ},
            "runs": SPMD_RUNS, "drain": _RING_FLASH}


def _spmd_launches(config, row, remat: bool) -> dict:
    """The flash launches by entry point a rank of an SPMD run must make:
    per step and layer, each of its ring pairs (one where attention is
    per-device flash) once forward and once in each backward kernel, the
    forward again under remat's recompute; none on the gather path."""
    pairs = 1 if row["plan"]["tier"] == "flash" else row["pairs"]
    per = config.n_layers * pairs * row["steps"]
    return {"flash_fwd": per * (2 if remat else 1), "flash_bwd_dq": per, "flash_bwd_dkv": per}


def spmd_phase(backend: str, card: str, n: int = 4, what: str = "8", job=SPMD_JOB) -> dict:
    """The sharded train step (``dist_worker spmd``) of *job* over *n*
    ranks at the smoke width, bf16, 2 steps per run, then a drain after
    one step (phase 8: dp (n/4) x sp 2 x tp 2; gather SP with dense
    attention, the contiguous and zigzag flash rings, the flash ring under
    remat, the drain on the flash ring).  Gates: losses identical across
    ranks and within ``LOSS_TOL["bfloat16"]`` of one device's flash step on
    the same weights and batches; each rank's flash launches as
    :func:`_spmd_launches` says, all on the tensor-core kernels; the drain
    stopped every rank at one step and acknowledged, and its checkpoint,
    the full state, restored into a one-device trainer on the card takes
    the mesh's next step within ``LOSS_TOL["bfloat16"]``; each run's
    first-step gradients, gathered to the full state, within
    ``SPMD_GRAD_TOL`` of one device's.  Returns the per-run record, with
    each rank's device busy time of one traced step."""
    import dataclasses
    import uuid

    import torch

    from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster
    from k8s_operator_libs_tpu_torch.cluster.apiserver import ApiServerFacade
    from k8s_operator_libs_tpu_torch.cluster.objects import make_node
    from k8s_operator_libs_tpu_torch.hack.dist_worker import Ranks
    from k8s_operator_libs_tpu_torch.tpu import smoke
    from k8s_operator_libs_tpu_torch.tpu import workload as wl

    mesh = [n // 4, *job["mesh"]]
    config = dataclasses.replace(smoke.smoke_config(torch.device("cuda")), flash_attention=True,
                                 **job["config"])
    model, optimizer = wl.create_train_state(config, "cuda", seed=0)
    step = wl.make_train_step(model, optimizer)
    reference = [float(step(wl.make_batch(config, 8, seed=0, device="cuda")))]
    ref_grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    reference += [float(step(wl.make_batch(config, 8, seed=i, device="cuda"))) for i in range(1, SPMD_STEPS)]
    del model, optimizer, step
    runs = [{"name": name, "mesh": mesh, "config": {**job["config"], **fields},
             "steps": SPMD_STEPS, "grads": True} for name, fields in job["runs"]]
    runs.append({"name": "drain", "mesh": mesh, "config": {**job["config"], **job["drain"]},
                 "steps": 5, "drain": True})
    nodes = InMemoryCluster()
    nodes.create(make_node("gpu-host"))
    token = uuid.uuid4().hex[:12]
    _drain_request(nodes, token)  # standing: the drain stops the job at its first poll
    with tempfile.TemporaryDirectory(prefix="chip-smoke-8-") as tmp, ApiServerFacade(nodes) as server:
        with open(f"{tmp}/runs.json", "w") as f:
            json.dump({"runs": runs}, f)
        env = {"FACADE_URL": server.url, "DRAIN_NODE_NAME": "gpu-host", "DRAIN_CKPT_DIR": f"{tmp}/ckpt"}
        args = ["spmd", "--device", "cuda", "--backend", backend, "--config", "smoke",
                "--inputs", f"{tmp}/runs.json", "--out", f"{tmp}/rank{{rank}}.pt"]
        with Ranks(n, args, env) as ranks:
            lines = ranks.results(RANKS_DEADLINE)
        grads = torch.load(f"{tmp}/rank0.pt", weights_only=True)
        drained = [line["runs"]["drain"] for line in lines]
        step = _check_drained(f"{what} drain", nodes, token, f"{tmp}/ckpt/drain", drained)
        state = wl.restore_checkpoint(f"{tmp}/ckpt/drain", step)
        trainer = wl.CheckpointingTrainer(dataclasses.replace(config, seq_axis=None), f"{tmp}/one",
                                          device="cuda")
        trainer.load(state)
        trainer.run(1)
    report = {"backend": backend, "mesh": mesh, "transport": lines[0]["runs"][job["runs"][0][0]]["transport"],
              "reference_losses": reference, "runs": {},
              "worker_seconds": [line["seconds"] for line in lines]}
    for name, fields in job["runs"] + (("drain", job["drain"]),):
        rows = [line["runs"][name] for line in lines]
        losses = rows[0]["losses"]  # the drain's: its one step before the stop
        if any(r["losses"] != losses for r in rows):
            raise RuntimeError(f"{what} {name}: losses differ across ranks: {[r['losses'] for r in rows]}")
        diff = max(abs(a - b) for a, b in zip(losses, reference))
        if diff > LOSS_TOL["bfloat16"] or not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"{what} {name}: losses {losses} vs one device's {reference}: {diff:.3e}")
        if any(r["warnings"] for r in rows):
            raise RuntimeError(f"{what} {name}: the workload warned: {rows[0]['warnings']}")
        grad_err = None
        if name in grads:
            got = grads[name]
            if set(got) != set(ref_grads):
                raise RuntimeError(f"{what} {name}: gradients of {sorted(got)}")
            grad_err = layer_rel_err(got, ref_grads)
            if not grad_err[0] <= SPMD_GRAD_TOL:
                raise RuntimeError(f"{what} {name}: first-step gradient of {grad_err[1]} off one "
                                   f"device's by {grad_err[0]:.3e} of its max > {SPMD_GRAD_TOL}")
        for r, row in enumerate(rows):
            want = _spmd_launches(config, row, bool(fields.get("remat")))
            if row["launches"] != want:
                raise RuntimeError(f"{what} {name} rank {r}: launches {row['launches']}, want {want}")
            _check_flash_launches(f"{what} {name} rank {r}", row["device_launches"], want)
        report["runs"][name] = {
            "plan": rows[0]["plan"], "losses": losses, "max_diff_vs_one_device": diff,
            "grad_rel_err_vs_one_device": grad_err,
            "pairs": [row["pairs"] for row in rows],
            "launches": [row["launches"] for row in rows],
            "step_ms": [row["step_ms"] for row in rows],
            "device": [row.get("device") for row in rows],
        }
    next_diff = abs(trainer.losses[0] - drained[0]["next_loss"])
    if len({r["next_loss"] for r in drained}) != 1 or next_diff > LOSS_TOL["bfloat16"]:
        raise RuntimeError(f"{what} drain: restored one-device step {trainer.losses} vs the mesh's "
                           f"next {[r['next_loss'] for r in drained]}")
    report["runs"]["drain"].update(stopped_at_step=step, next_loss=drained[0]["next_loss"],
                                   restored_next_loss=trainer.losses[0], next_diff=next_diff)
    log(f"phase {what}, {n} ranks, {job['name']}:", json.dumps(report), "|", card)
    del trainer
    torch.cuda.empty_cache()
    return report


# ------------------------------------------------------------ phase 9


#: Phase 9's MoE: the smoke width with 4 experts, the E of the JAX tests
#: and dryrun.
N_EXPERTS = 4
#: 9a: one-device MoE steps on a fixed batch (the loss must fall).
MOE_STEPS = 6
#: 9c: the MoE on dp (n/4) x tp 2 x ep 2, 2 steps and a drain after one.
EP_JOB = {"name": "EP step", "mesh": (1, 2, 2), "config": {"n_experts": N_EXPERTS},
          "runs": (("ep", {}),), "drain": {}}
#: 9d: GPipe over 4 stages (the smoke config's 4 layers), 4 microbatches
#: of 2 rows of the batch of 8.
PIPE_MICROBATCHES = 4
PIPE_STEPS = 3


def moe_config():
    """The smoke config with ``N_EXPERTS`` experts and flash attention."""
    import dataclasses

    import torch

    from k8s_operator_libs_tpu_torch.tpu import smoke

    return dataclasses.replace(smoke.smoke_config(torch.device("cuda")), flash_attention=True,
                               n_experts=N_EXPERTS)


def moe_train_phase(config, card: str) -> dict:
    """9a: ``MOE_STEPS`` one-device MoE train steps on a fixed batch, the
    launch counts read around them.  Gates: the loss falls and is finite;
    each flash kernel launched ``n_layers`` times a step, all on the
    tensor-core kernels.  Then where a step's time goes
    (:func:`device_window`)."""
    import torch

    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import workload as wl

    model, optimizer = wl.create_train_state(config, "cuda", seed=0)
    step = wl.make_train_step(model, optimizer)
    batch = wl.make_batch(config, 8, seed=0, device="cuda")
    fa.reset_launch_counts()
    losses = [float(step(batch)) for _ in range(MOE_STEPS)]
    launches = dict(fa.launch_counts)
    device_launches = {k: n for k, n in fa.device_launch_counts.items() if n}
    want = dict.fromkeys(launches, config.n_layers * MOE_STEPS)
    if launches != want:
        raise RuntimeError(f"9a MoE step: flash launches {launches}, want {want}")
    _check_flash_launches("9a MoE step", device_launches, want)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"9a MoE step: losses {losses} do not fall")

    def run():
        for _ in range(5):
            step(batch)

    rec = {"n_experts": config.n_experts, "losses": losses,
           "launches_per_step": {k: n / MOE_STEPS for k, n in launches.items()},
           "device_kernel_launches_per_step": {k: n / MOE_STEPS for k, n in device_launches.items()},
           "timing": device_window(run, 5)}
    log("phase 9a MoE train step (one device):", json.dumps(rec), "|", card)
    del model, optimizer, step
    torch.cuda.empty_cache()
    return rec


def moe_decode_phase(config, card: str, prompt_len: int = 16, new_tokens: int = 32) -> dict:
    """9b: the MoE serving path from seed-0 weights, float and int8.  The
    int8 kernel first at the router's shape (M 8, K d_model, N = E = 4:
    fewer weight rows than the kernel's 16-row tile, which no earlier phase
    ran) against its plain version; then gates: each model's cached decode
    logits within ``BF16_TOL`` of its full-prefix recompute; the int8
    model's ``generate`` launches the int8 kernel ``(5 + 2E) n_layers + 1``
    times a step, all on the bf16 tensor-core kernel, no flash kernel, no
    host synchronisation in the loop.  Then where a decode step's time
    goes, float and int8."""
    import dataclasses

    import numpy as np
    import torch

    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz
    from k8s_operator_libs_tpu_torch.tpu import workload as wl

    e, layers = config.n_experts, config.n_layers
    out = {"router_err": check_int8(f"router-n{e}-bfloat16", 8, config.d_model, e, "bfloat16", seed=21)}
    check_int8(f"router-n{e}-float32", 8, config.d_model, e, "float32", seed=21)
    bf16 = dataclasses.replace(config, flash_attention=False)
    b, total = 8, prompt_len + new_tokens
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, config.vocab_size, (b, prompt_len))).cuda()
    model = wl.TinyLM(bf16, "cuda", seed=0)
    int8 = wl.quantize_model(model)
    tokens = wl.greedy_generate(bf16, int8, prompt, new_tokens)
    for name, m in (("float", model), ("int8", int8)):
        with torch.inference_mode():
            full = m(tokens).float()
        out[f"{name}_cache_err"] = check_close(f"9b MoE {name} decode vs full prefix",
                                               decode_logits(bf16, m, tokens), full, "bfloat16")
    qz.reset_launch_counts()
    fa.reset_launch_counts()
    gated = no_host_sync(lambda: wl.generate(bf16, int8, prompt, new_tokens))
    launches = qz.launch_counts["int8_linear"]
    device_launches = {k: n for k, n in qz.device_launch_counts.items() if n}
    per_step = (5 + 2 * e) * layers + 1
    want = per_step * (total - 1)
    routed = qz.DEVICE_KERNELS["int8_linear"][config.dtype]
    if launches != want or device_launches != {routed: want} or any(fa.launch_counts.values()):
        raise RuntimeError(
            f"9b int8 MoE launches {launches} by device kernel {device_launches} (want {want}, "
            f"all {routed}), flash launches {fa.launch_counts} (want 0)"
        )
    if not torch.equal(gated, tokens):
        raise RuntimeError("9b: two greedy int8 MoE generations differ")
    out.update(launches=launches, launches_per_step=launches // (total - 1), device_kernel=routed)
    out["decode_breakdown"] = {
        name: device_window(lambda m=m: wl.generate(bf16, m, prompt, 8), prompt_len + 7)
        for name, m in (("float", model), ("int8", int8))
    }
    log(f"phase 9b MoE decode: int8 launches {launches} = ((5+2*{e})*{layers}+1)*{total - 1}, all "
        f"{routed}; flash 0; no host sync; {json.dumps(out)}", "|", card)
    del model, int8
    torch.cuda.empty_cache()
    return out


def stage_gradients(stage_grads: list, what: str) -> dict:
    """The whole model's gradients from each stage's (``dist_worker
    pipeline``'s ``--out``, by stage): stage r's ``block.<key>`` as
    ``block_r.<key>``, the rest from stage 0 after checking that every
    stage holds the same rest gradients, bit for bit."""
    import torch

    grads, rest = {}, {k: g for k, g in stage_grads[0].items() if not k.startswith("block.")}
    for r, g in enumerate(stage_grads):
        own = {k: v for k, v in g.items() if not k.startswith("block.")}
        if own.keys() != rest.keys() or not all(torch.equal(v, rest[k]) for k, v in own.items()):
            raise RuntimeError(f"{what} stage {r}: rest gradients differ from stage 0's")
        grads.update({f"block_{r}.{k[len('block.'):]}": v for k, v in g.items() if k.startswith("block.")})
    return {**grads, **rest}


def pipeline_phase(backend: str, card: str, n: int = 4, what: str = "9d") -> dict:
    """9d: the GPipe pipeline (``dist_worker pipeline``) over *n* stages of
    one block each at the smoke width (4 layers), bf16, flash, the batch of
    8 in ``PIPE_MICROBATCHES`` microbatches, ``PIPE_STEPS`` AdamW steps on
    a fixed batch.  Gates: losses identical on every stage and within
    ``LOSS_TOL["bfloat16"]`` of the sequential one-device steps on the
    same weights and batch; the first step's gradients (each stage's
    block as that layer's, the rest equal on every stage) within
    ``SPMD_GRAD_TOL`` of the sequential step's; each stage's flash
    launches one a microbatch per step for each kernel, all on the
    tensor-core kernels."""
    import dataclasses

    import torch

    from k8s_operator_libs_tpu_torch.hack.dist_worker import Ranks
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import smoke
    from k8s_operator_libs_tpu_torch.tpu import workload as wl

    config = dataclasses.replace(smoke.smoke_config(torch.device("cuda")), flash_attention=True)
    model, optimizer = wl.create_train_state(config, "cuda", seed=0)
    step = wl.make_train_step(model, optimizer)
    batch = wl.make_batch(config, 8, seed=0, device="cuda")
    reference = [float(step(batch))]
    ref_grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    reference += [float(step(batch)) for _ in range(1, PIPE_STEPS)]
    del model, optimizer, step
    with tempfile.TemporaryDirectory(prefix="chip-smoke-9d-") as tmp:
        args = ["pipeline", "--device", "cuda", "--backend", backend, "--config", "smoke",
                "--steps", str(PIPE_STEPS), "--batch", "8", "--microbatches", str(PIPE_MICROBATCHES),
                "--out", f"{tmp}/rank{{rank}}.pt"]
        with Ranks(n, args) as ranks:
            lines = ranks.results(RANKS_DEADLINE)
        stage_grads = [torch.load(f"{tmp}/rank{r}.pt", weights_only=True) for r in range(n)]
    grads = stage_gradients(stage_grads, what)
    if set(grads) != set(ref_grads):
        raise RuntimeError(f"{what}: gradients of {sorted(grads)}")
    grad_err = layer_rel_err(grads, ref_grads)
    if not grad_err[0] <= SPMD_GRAD_TOL:
        raise RuntimeError(f"{what}: first-step gradient of {grad_err[1]} off the sequential step's by "
                           f"{grad_err[0]:.3e} of its max > {SPMD_GRAD_TOL}")
    losses = lines[0]["losses"]
    if [line["stage"] for line in lines] != list(range(n)) or any(line["losses"] != losses for line in lines):
        raise RuntimeError(f"{what}: stages {[line['stage'] for line in lines]}, losses "
                           f"{[line['losses'] for line in lines]}")
    diff = max(abs(a - b) for a, b in zip(losses, reference))
    if diff > LOSS_TOL["bfloat16"] or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{what}: pipelined losses {losses} vs sequential {reference}: {diff:.3e}")
    want = dict.fromkeys(fa.launch_counts, PIPE_MICROBATCHES * PIPE_STEPS)
    for line in lines:
        if line["launches"] != want:
            raise RuntimeError(f"{what} stage {line['stage']}: launches {line['launches']}, want {want}")
        _check_flash_launches(f"{what} stage {line['stage']}", line["device_launches"], want)
    rec = {"backend": backend, "stages": n, "microbatches": PIPE_MICROBATCHES, "losses": losses,
           "sequential_losses": reference, "max_diff_vs_sequential": diff,
           "grad_rel_err_vs_sequential": grad_err,
           "launches": [line["launches"] for line in lines],
           "step_ms": [line["step_ms"] for line in lines],
           "device": [line.get("device") for line in lines],
           "worker_seconds": [line["seconds"] for line in lines]}
    log(f"phase {what}, {n} stages, GPipe:", json.dumps(rec), "|", card)
    return rec


def dryrun_phase(backend: str, card: str, n: int = 4, what: str = "9e") -> dict:
    """9e: ``graft_entry.dryrun_multichip`` over *n* ranks and *backend*
    on the card: it raises unless every check holds."""
    from k8s_operator_libs_tpu_torch import graft_entry

    t0 = time.perf_counter()
    losses = graft_entry.dryrun_multichip(n, "cuda", backend=backend, timeout=RANKS_DEADLINE)
    rec = {"backend": backend, "ranks": n, "losses": losses, "seconds": time.perf_counter() - t0}
    log(f"phase {what} dryrun_multichip, every check held:", json.dumps(rec), "|", card)
    return rec


# ------------------------------------------------------------ phase 10


#: A large GPU fleet: 1,024 nodes of 8 H100 each, 16 to a rack (one
#: ``nvidia.com/slice-id`` value a rack), within upstream Kubernetes'
#: documented 5,000-node limit ("Considerations for large clusters").
FLEET_NODES = 1024
FLEET_RACK = 16
FLEET_GPU_PRODUCT = "NVIDIA-H100-80GB-HBM3"
FLEET_NAMESPACE = "gpu-operator"
FLEET_DRIVER_LABELS = {"app": "gpu-driver"}
#: the TPU fleet's domain and GKE's TPU label prefix: no object may hold them
TPU_MARKERS = ("tpu.google.com", "gke-tpu")


def _fleet_node(i: int) -> str:
    return f"gpu-node-{i:04d}"


def _crd(kind: str, spec_schema: dict) -> dict:
    """A CustomResourceDefinition of a registered kind, with *spec_schema*
    as its structural schema's ``spec``."""
    from k8s_operator_libs_tpu_torch.cluster.client import kind_info

    info = kind_info(kind)
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{info.plural}.{info.group}"},
        "spec": {
            "group": info.group,
            "names": {"kind": kind, "listKind": f"{kind}List", "plural": info.plural,
                      "singular": info.plural[:-1]},
            "scope": "Namespaced",
            "versions": [{"name": info.version, "served": True, "storage": True, "schema": {
                "openAPIV3Schema": {"type": "object", "properties": {"spec": spec_schema}},
            }}],
        },
    }


def build_fleet():
    """10a: the fleet in a fresh ``InMemoryCluster``: its Nodes with GPU
    Feature Discovery's labels, the driver DaemonSet with one pod a node,
    and the NodeMaintenance and GpuUpgradePolicy kinds (CRDs with
    structural schemas, then one CR each, and a policy the schema
    refuses).  Returns (cluster, seconds)."""
    from k8s_operator_libs_tpu_torch.api import (
        DrainSpec, IntOrString, PreDrainCheckpointSpec, UpgradePolicySpec,
    )
    from k8s_operator_libs_tpu_torch.cluster.errors import InvalidError
    from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster
    from k8s_operator_libs_tpu_torch.cluster.objects import (
        make_controller_revision, make_daemonset, make_node, make_node_maintenance, make_pod,
    )
    from k8s_operator_libs_tpu_torch.upgrade import consts

    t0 = time.perf_counter()
    cluster = InMemoryCluster()
    cluster.create(_crd("NodeMaintenance", {
        "type": "object", "required": ["requestorID", "nodeName"],
        "properties": {"requestorID": {"type": "string"}, "nodeName": {"type": "string"}},
    }))
    cluster.create(_crd("GpuUpgradePolicy", {"type": "object", "properties": {
        "autoUpgrade": {"type": "boolean"},
        "maxParallelUpgrades": {"type": "integer", "minimum": 0},
        "maxUnavailable": {"x-kubernetes-int-or-string": True},
        "sliceAware": {"type": "boolean"},
        "preDrainCheckpoint": {"type": "object", "properties": {
            "enable": {"type": "boolean"},
            "timeoutSeconds": {"type": "integer", "minimum": 0, "default": 300},
        }},
    }}))
    policy = UpgradePolicySpec(
        auto_upgrade=True, max_parallel_upgrades=FLEET_RACK, max_unavailable=IntOrString("25%"),
        drain_spec=DrainSpec(enable=True), slice_aware=True,
        pre_drain_checkpoint=PreDrainCheckpointSpec(enable=True),
    )
    policy.validate()
    cluster.create({"kind": "GpuUpgradePolicy", "metadata": {"name": "fleet", "namespace": FLEET_NAMESPACE},
                    "spec": policy.to_dict()})
    try:
        cluster.create({"kind": "GpuUpgradePolicy", "metadata": {"name": "bad", "namespace": FLEET_NAMESPACE},
                        "spec": {"maxParallelUpgrades": -1}})
        raise RuntimeError("10a: the GpuUpgradePolicy schema admitted maxParallelUpgrades -1")
    except InvalidError:
        pass
    ds = cluster.create(make_daemonset("gpu-driver", FLEET_NAMESPACE, dict(FLEET_DRIVER_LABELS),
                                       desired_number_scheduled=FLEET_NODES))
    cluster.create(make_controller_revision(ds, 1, "rev1"))
    for i in range(FLEET_NODES):
        cluster.create(make_node(_fleet_node(i), labels={
            "nvidia.com/gpu.product": FLEET_GPU_PRODUCT,
            "nvidia.com/gpu.count": "8",
            consts.SLICE_ID_LABEL_KEYS[0]: f"rack-{i // FLEET_RACK:02d}",
        }))
        cluster.create(make_pod(f"gpu-driver-{i:04d}", FLEET_NAMESPACE, _fleet_node(i),
                                labels=dict(FLEET_DRIVER_LABELS), owner=ds, revision_hash="rev1"))
    cluster.create(make_node_maintenance("gpu-node-0000-maintenance", FLEET_NAMESPACE, "gpu-operator",
                                         _fleet_node(0)))
    counts = {kind: len(cluster.list(kind)) for kind in ("Node", "Pod", "GpuUpgradePolicy", "NodeMaintenance")}
    racks = {n["metadata"]["labels"][consts.SLICE_ID_LABEL_KEYS[0]] for n in cluster.list("Node")}
    want = {"Node": FLEET_NODES, "Pod": FLEET_NODES, "GpuUpgradePolicy": 1, "NodeMaintenance": 1}
    if counts != want or len(racks) != FLEET_NODES // FLEET_RACK:
        raise RuntimeError(f"10a: fleet {counts}, {len(racks)} racks; want {want}")
    policy_back = cluster.get("GpuUpgradePolicy", "fleet", FLEET_NAMESPACE)["spec"]
    if UpgradePolicySpec.from_dict(policy_back).to_dict() != policy.to_dict():
        raise RuntimeError(f"10a: the policy does not round-trip: {policy_back}")
    return cluster, time.perf_counter() - t0


def fan_out(cluster) -> dict:
    """10b: through one ``WriteDispatcher`` over the cluster's batch
    transport, set every node's state label to ``upgrade-required`` and
    stamp its admission annotation (two merge patches a node, which the
    dispatcher may coalesce), then ``flush``.  Every acknowledged write
    must read back from the cluster, and from an informer cache that held
    the fleet before the writes, once the journal's deltas since are
    applied to it.  Returns the host-clock figures."""
    import threading

    from k8s_operator_libs_tpu_torch import metrics
    from k8s_operator_libs_tpu_torch.cluster.cache import InformerCache
    from k8s_operator_libs_tpu_torch.cluster.writepipeline import WriteDispatcher, WriteOp
    from k8s_operator_libs_tpu_torch.upgrade import consts, util

    registry = metrics.MetricsRegistry()
    previous = metrics.set_default_registry(registry)
    state_key, admitted_key = util.get_upgrade_state_label_key(), util.get_admitted_at_annotation_key()
    try:
        # seeded here; from now on it sees only what is ingested into it
        cache = InformerCache(cluster, lag_seconds=3600.0, kinds=("Node",), externally_fed=True)
        seq = cluster.journal_seq()
        acks, lock = {}, threading.Lock()

        def ack(name):
            def done(obj, err):
                with lock:
                    acks.setdefault(name, []).append((obj, err))
            return done

        dispatcher = WriteDispatcher(cluster, use_batch=True)
        try:
            t0 = time.perf_counter()
            for i in range(FLEET_NODES):
                name = _fleet_node(i)
                dispatcher.submit(WriteOp(op="patch", kind="Node", name=name, body={"metadata": {
                    "labels": {state_key: consts.UPGRADE_STATE_UPGRADE_REQUIRED}}}), ack(name))
                dispatcher.submit(WriteOp(op="patch", kind="Node", name=name, body={"metadata": {
                    "annotations": {admitted_key: f"{i}"}}}), ack(name))
            dispatcher.flush(timeout=120.0)
            fan_out_s = time.perf_counter() - t0
            coalesced = dispatcher.coalesced
        finally:
            dispatcher.close()
        batches = metrics.write_batch_size_histogram().count()
        failed = {n: errs for n, a in acks.items() if (errs := [e for _, e in a if e is not None])}
        if len(acks) != FLEET_NODES or failed or sum(len(a) for a in acks.values()) != 2 * FLEET_NODES:
            raise RuntimeError(f"10b: {len(acks)} nodes acknowledged, failures {list(failed.items())[:3]}")
        stale = [n for n in cache.list("Node") if n["metadata"]["labels"].get(state_key)]
        if stale:
            raise RuntimeError(f"10b: the lagged cache saw {len(stale)} writes before its refresh")
        t1 = time.perf_counter()
        cache.ingest(cluster.events_since(seq))
        refresh_s = time.perf_counter() - t1
        for source, nodes in (("cluster", cluster.list("Node")), ("cache", cache.list("Node"))):
            wrong = [n["metadata"]["name"] for n in nodes
                     if n["metadata"]["labels"].get(state_key) != consts.UPGRADE_STATE_UPGRADE_REQUIRED
                     or admitted_key not in n["metadata"]["annotations"]]
            if len(nodes) != FLEET_NODES or wrong:
                raise RuntimeError(f"10b: {len(wrong)} of {len(nodes)} nodes in the {source} lack "
                                   f"an acknowledged write: {wrong[:5]}")
    finally:
        metrics.set_default_registry(previous)
    writes = 2 * FLEET_NODES
    return {
        "nodes": FLEET_NODES,
        "writes": writes,
        "fan_out_ms": fan_out_s * 1e3,
        "writes_per_s": writes / fan_out_s,
        "batches": batches,
        "writes_coalesced": coalesced,
        "cache_refresh_ms": refresh_s * 1e3,
        "journal_events": cluster.journal_seq() - seq,
    }


def fleet_drain(cluster, config, node: str, what: str = "10c", tracer=None) -> dict:
    """10c (and 10f over HTTP): the smoke-config trainer drains on the
    card through ``DrainSignalWatcher(cluster, node)``: the request goes
    through a ``WriteDispatcher`` over *cluster* after two steps; the
    acknowledgement must echo its token, the checkpoint must restore, and
    each flash kernel must launch ``n_layers`` times a step, on its
    tensor-core kernel.  With *tracer* the request is sent under a
    ``drain-handshake`` span whose traceparent rides beside it, and the
    trainer's ``checkpoint-drain`` span must be its child in the
    tracer's Chrome export."""
    import contextlib
    import uuid
    from concurrent.futures import ThreadPoolExecutor

    from k8s_operator_libs_tpu_torch.cluster.writepipeline import WriteDispatcher, WriteOp
    from k8s_operator_libs_tpu_torch.obs import tracing
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import workload as wl
    from k8s_operator_libs_tpu_torch.tpu.drain_handshake import DrainSignalWatcher
    from k8s_operator_libs_tpu_torch.upgrade import consts, util

    key = util.get_pre_drain_checkpoint_annotation_key()
    token = uuid.uuid4().hex[:12]
    ack = f"{consts.PRE_DRAIN_CHECKPOINT_DONE}:{token}"
    previous = None if tracer is None else tracing.set_default_tracer(tracer)
    fa.reset_launch_counts()
    try:
        with tempfile.TemporaryDirectory(prefix=f"chip-smoke-{what}-") as ckpt, ThreadPoolExecutor(1) as pool:
            trainer = wl.CheckpointingTrainer(config, ckpt, watcher=DrainSignalWatcher(cluster, node),
                                              device="cuda")
            trainer.run(2)
            run = pool.submit(trainer.run, 1000)  # a thread: no span context is inherited
            gate = (contextlib.nullcontext() if tracer is None
                    else tracing.start_span("drain-handshake", attributes={"node": node}))
            with gate as span:
                annotations = {key: f"{consts.PRE_DRAIN_CHECKPOINT_REQUESTED}:{token}"}
                if span is not None:
                    annotations[util.get_pre_drain_traceparent_annotation_key()] = span.traceparent
                dispatcher = WriteDispatcher(cluster, use_batch=True)
                try:
                    sent = []
                    t0 = time.perf_counter()
                    dispatcher.submit(WriteOp(op="patch", kind="Node", name=node, body={"metadata": {
                        "annotations": annotations}}), lambda obj, err: sent.append(err))
                    dispatcher.flush(timeout=30.0)
                finally:
                    dispatcher.close()
                if sent != [None]:
                    raise RuntimeError(f"{what}: the drain request was not acknowledged by the cluster: {sent}")
                step = run.result(timeout=300)
                ack_s = time.perf_counter() - t0
            got = cluster.get("Node", node)["metadata"]["annotations"].get(key)
            if not trainer.drained or got != ack:
                raise RuntimeError(f"{what}: drained {trainer.drained}, ack {got!r}, want {ack!r}")
            if wl.restore_checkpoint(ckpt, step)["step"] != step:
                raise RuntimeError(f"{what}: the checkpoint does not restore at step {step}")
    finally:
        if tracer is not None:
            tracing.set_default_tracer(previous)
    launches = dict(fa.launch_counts)
    _check_flash_launches(what, {k: n for k, n in fa.device_launch_counts.items() if n},
                          dict.fromkeys(launches, config.n_layers * step))
    if not all(math.isfinite(x) for x in trainer.losses):
        raise RuntimeError(f"{what}: losses {trainer.losses}")
    rec = {"node": node, "drained_at_step": step, "ack": got.split(":")[0],
           "request_to_ack_ms": ack_s * 1e3, "flash_launches": launches}
    if tracer is not None:
        chrome = json.loads(json.dumps(tracing.to_chrome(tracer.traces(complete_only=False))))
        drains = [e for e in chrome["traceEvents"] if e["name"] == "checkpoint-drain"
                  and e["args"]["trace_id"] == span.trace_id and e["args"]["parent_id"] == span.span_id]
        if len(drains) != 1 or drains[0]["args"]["status"] != "ok":
            raise RuntimeError(f"{what}: the Chrome export holds no checkpoint-drain span under trace "
                               f"{span.trace_id}: {chrome['traceEvents']}")
        rec["trace"] = {"trace_id": span.trace_id, "checkpoint_drain_ms": drains[0]["dur"] / 1e3,
                        "chrome_events": len(chrome["traceEvents"])}
    return rec


def http_fan_out(facade) -> dict:
    """10e: 10b's 2,048 merge patches again, now over HTTP: one
    ``WriteDispatcher(KubeApiClient(...), use_batch=True)`` sends each
    batch as one POST to the facade's batch endpoint.  Every acknowledged
    write must read back through a paginated client ``list`` (limit 500)
    and through an ``InformerCache`` fed by another client's held watch
    stream.  Then ``tpu.topology`` groups the nodes listed over HTTP into
    NVLink domains: exactly 10a's racks.  Returns the host-clock figures."""
    import threading

    from k8s_operator_libs_tpu_torch import metrics
    from k8s_operator_libs_tpu_torch.cluster.cache import InformerCache
    from k8s_operator_libs_tpu_torch.cluster.kubeclient import KubeApiClient, KubeConfig
    from k8s_operator_libs_tpu_torch.cluster.writepipeline import WriteDispatcher, WriteOp
    from k8s_operator_libs_tpu_torch.tpu import topology
    from k8s_operator_libs_tpu_torch.upgrade import consts, util

    registry = metrics.MetricsRegistry()
    previous = metrics.set_default_registry(registry)
    state_key, admitted_key = util.get_upgrade_state_label_key(), util.get_admitted_at_annotation_key()
    want_state = consts.UPGRADE_STATE_CORDON_REQUIRED
    writer = KubeApiClient(KubeConfig(server=facade.url), timeout=30.0)
    watcher = KubeApiClient(KubeConfig(server=facade.url), timeout=30.0)
    reader = KubeApiClient(KubeConfig(server=facade.url), timeout=30.0)
    try:
        cache = InformerCache(watcher, lag_seconds=3600.0, kinds=("Node",), externally_fed=True)
        cache.sync()  # seeded by a list over HTTP; from now on only the stream feeds it
        seq = watcher.journal_seq()
        watcher.start_held_watches(("Node",))
        acks, lock = {}, threading.Lock()

        def ack(name):
            def done(obj, err):
                with lock:
                    acks.setdefault(name, []).append((obj, err))
            return done

        served0 = facade.requests_served
        dispatcher = WriteDispatcher(writer, use_batch=True)
        try:
            t0 = time.perf_counter()
            for i in range(FLEET_NODES):
                name = _fleet_node(i)
                dispatcher.submit(WriteOp(op="patch", kind="Node", name=name, body={"metadata": {
                    "labels": {state_key: want_state}}}), ack(name))
                dispatcher.submit(WriteOp(op="patch", kind="Node", name=name, body={"metadata": {
                    "annotations": {admitted_key: f"http-{name}"}}}), ack(name))
            dispatcher.flush(timeout=300.0)
            fan_out_s = time.perf_counter() - t0
            coalesced = dispatcher.coalesced
        finally:
            dispatcher.close()
        requests = facade.requests_served - served0
        batches = metrics.write_batch_size_histogram().count()
        if writer._batch_supported is not True:
            raise RuntimeError(f"10e: the client did not write through the batch endpoint "
                               f"({writer._batch_supported})")
        failed = {n: errs for n, a in acks.items() if (errs := [e for _, e in a if e is not None])}
        if len(acks) != FLEET_NODES or failed or sum(len(a) for a in acks.values()) != 2 * FLEET_NODES:
            raise RuntimeError(f"10e: {len(acks)} nodes acknowledged, failures {list(failed.items())[:3]}")

        def wrong(nodes):
            return [n["metadata"]["name"] for n in nodes
                    if n["metadata"]["labels"].get(state_key) != want_state
                    or n["metadata"].get("annotations", {}).get(admitted_key) != f"http-{n['metadata']['name']}"]

        def versions(nodes):
            return {n["metadata"]["name"]: n["metadata"]["resourceVersion"] for n in nodes}

        # the informer: fed by the held stream until it shows every write
        t1 = time.perf_counter()
        deadline = t1 + 120.0
        streamed = 0
        while True:
            watcher.wait_for_held_event(seq, timeout=0.5)
            events = watcher.events_since(seq, kind=("Node",))
            streamed += len(events)
            cache.ingest(events)
            if not wrong(cache.list("Node")):
                break
            if time.perf_counter() > deadline:
                raise RuntimeError(f"10e: the informer lacks {len(wrong(cache.list('Node')))} writes "
                                   f"after {streamed} streamed events")
        refresh_s = time.perf_counter() - t1
        # the paginated list
        reader.list_page_size = 500
        t2 = time.perf_counter()
        listed = reader.list("Node")
        list_s = time.perf_counter() - t2
        missing = wrong(listed)
        if len(listed) != FLEET_NODES or missing:
            raise RuntimeError(f"10e: {len(missing)} of {len(listed)} listed nodes lack an "
                               f"acknowledged write: {missing[:5]}")
        if versions(cache.list("Node")) != versions(listed):
            raise RuntimeError("10e: the informer and the paginated list disagree")
        domains = topology.group_by_domain(listed)
        sizes = sorted({len(members) for members in domains.values()})
        racks = {f"rack-{r:02d}" for r in range(FLEET_NODES // FLEET_RACK)}
        if set(domains) != racks or sizes != [FLEET_RACK]:
            raise RuntimeError(f"10e: {len(domains)} NVLink domains of sizes {sizes}, want "
                               f"{len(racks)} of {FLEET_RACK}")
    finally:
        watcher.close()
        writer.close()
        reader.close()
        metrics.set_default_registry(previous)
    writes = 2 * FLEET_NODES
    return {
        "nodes": FLEET_NODES,
        "writes": writes,
        "fan_out_ms": fan_out_s * 1e3,
        "writes_per_s": writes / fan_out_s,
        "batches": batches,
        "writes_per_batch": (writes - coalesced) / batches if batches else None,
        "writes_coalesced": coalesced,
        "http_requests": requests,
        "informer_refresh_ms": refresh_s * 1e3,
        "streamed_events": streamed,
        "paginated_list_ms": list_s * 1e3,
        "nvlink_domains": len(domains),
    }


#: 10g-10h: the job pod each node runs (a drain evicts it) and the wave's
#: targets: an slos block and a remediation block beside the fleet's policy
FLEET_JOB_NAMESPACE = "ml"
WAVE_SLOS = {"maxNodePhaseSeconds": 600, "drainP99Seconds": 300, "fleetCompletionDeadlineSeconds": 3600}
WAVE_REMEDIATION = {"failureThreshold": 0.5, "minAttempted": 4, "autoRollback": False}
#: passes a wave may take before the phase fails (it needs about 8)
WAVE_MAX_PASSES = 40


def wave_policy(cluster):
    """The fleet's GpuUpgradePolicy (10a) with the wave's SLO and
    remediation blocks: slice-aware, 16 parallel upgrades, 25 % of the
    racks unavailable, drain with the pre-drain checkpoint."""
    from k8s_operator_libs_tpu_torch.api import UpgradePolicySpec

    spec = dict(cluster.get("GpuUpgradePolicy", "fleet", FLEET_NAMESPACE)["spec"])
    policy = UpgradePolicySpec.from_dict({**spec, "slos": WAVE_SLOS, "remediation": WAVE_REMEDIATION})
    policy.validate()
    return policy


def prepare_upgrade(cluster) -> dict:
    """Before 10g: clear what 10b and 10e wrote (every node's state label
    and admission stamp), give each node a workload pod owned by a Job,
    and publish the driver DaemonSet's ``rev2``, so that every driver pod
    is out of sync."""
    from k8s_operator_libs_tpu_torch.cluster.objects import make_controller_revision, make_pod
    from k8s_operator_libs_tpu_torch.upgrade import util

    t0 = time.perf_counter()
    for i in range(FLEET_NODES):
        cluster.patch("Node", _fleet_node(i), {"metadata": {
            "labels": {util.get_upgrade_state_label_key(): None},
            "annotations": {util.get_admitted_at_annotation_key(): None}}})
        job = {"kind": "Job", "metadata": {"name": f"train-{i:04d}", "namespace": FLEET_JOB_NAMESPACE}}
        cluster.create(make_pod(f"train-{i:04d}", FLEET_JOB_NAMESPACE, _fleet_node(i),
                                labels={"job-name": f"train-{i:04d}"}, owner=job))
    ds = cluster.get("DaemonSet", "gpu-driver", FLEET_NAMESPACE)
    cluster.create(make_controller_revision(ds, 2, "rev2"))
    return {"prepare_ms": (time.perf_counter() - t0) * 1e3}


def play_daemonset(store) -> int:
    """The DaemonSet controller: recreate each deleted driver pod at the
    newest revision, Ready.  Returns how many it created."""
    from k8s_operator_libs_tpu_torch.cluster.objects import make_pod

    ds = store.get("DaemonSet", "gpu-driver", FLEET_NAMESPACE)
    have = {p["spec"]["nodeName"] for p in store.list("Pod", namespace=FLEET_NAMESPACE)}
    made = 0
    for i in range(FLEET_NODES):
        if _fleet_node(i) not in have:
            store.create(make_pod(f"gpu-driver-{i:04d}", FLEET_NAMESPACE, _fleet_node(i),
                                  labels=dict(FLEET_DRIVER_LABELS), owner=ds, revision_hash="rev2"))
            made += 1
    return made


class _RackWorkloads:
    """The workloads of the wave's other nodes: each answers its node's
    checkpoint request at once (its job is not on the card).  Polls the
    store every 5 ms in a thread until closed, through *watcher_cls*
    (the port's ``DrainSignalWatcher`` unless another is given)."""

    def __init__(self, store, watcher_cls=None):
        import threading

        self._store = store
        self._watcher_cls = watcher_cls
        self._watchers = []
        self.acks = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="rack-workloads", daemon=True)
        self._thread.start()

    def watch(self, nodes) -> None:
        from k8s_operator_libs_tpu_torch.tpu.drain_handshake import DrainSignalWatcher

        watcher_cls = self._watcher_cls or DrainSignalWatcher
        self._watchers = [watcher_cls(self._store, name) for name in nodes]

    def _run(self) -> None:
        while not self._stop.wait(0.005):
            for watcher in self._watchers:
                if watcher.checkpoint_requested():
                    watcher.acknowledge()
                    self.acks += 1

    def close(self) -> None:
        self._stop.set()
        self._thread.join(10)
        if self._thread.is_alive():
            raise RuntimeError("the rack workloads' thread did not stop")


def _step_ms(polls) -> dict:
    """The trainer's steps under the wave, from its watcher's poll times
    (host clock): their count, p50, p95 and longest ms, and the last one,
    the step in flight when the gate's request came."""
    steps = sorted(b - a for a, b in zip(polls, polls[1:]))
    if not steps:
        return {"n": 0}
    return {"n": len(steps), "p50": steps[len(steps) // 2] * 1e3,
            "p95": steps[min(len(steps) - 1, int(0.95 * len(steps)))] * 1e3, "max": steps[-1] * 1e3,
            "last": (polls[-1] - polls[-2]) * 1e3}


def _buckets(state) -> dict:
    """A snapshot's buckets: state -> sorted node names."""
    return {bucket: sorted(ns.node["metadata"]["name"] for ns in entries)
            for bucket, entries in state.node_states.items() if entries}


def upgrade_wave(client, store, config, what: str = "10g", facade=None, use_state_index: bool = False,
                 expect_wave=None) -> dict:
    """10g (and 10h over HTTP, *facade* serving *store* to *client*; 10i's
    waves through the state index): the port's ``ClusterUpgradeStateManager``
    on *client* takes the next wave of the fleet (*store* is the cluster
    behind it) through a whole upgrade, pass by pass, with the
    smoke-config trainer on the card on one node of the wave; see the
    module docstring for the gates.  With *use_state_index*, each pass
    also builds a full snapshot, whose buckets must equal the indexed
    one's; *expect_wave*, a set of node names, must be the first
    admission.  Returns the host-clock figures."""
    from concurrent.futures import ThreadPoolExecutor

    from k8s_operator_libs_tpu_torch import metrics
    from k8s_operator_libs_tpu_torch.cluster.cache import InformerCache
    from k8s_operator_libs_tpu_torch.obs import events, tracing
    from k8s_operator_libs_tpu_torch.obs.slo import SloEngine
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import workload as wl
    from k8s_operator_libs_tpu_torch.tpu.drain_handshake import CheckpointDrainGate, DrainSignalWatcher
    from k8s_operator_libs_tpu_torch.upgrade import consts, timeline, util
    from k8s_operator_libs_tpu_torch.upgrade.remediation import remediation_report
    from k8s_operator_libs_tpu_torch.upgrade.rollout_status import RolloutStatus
    from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

    class TokenWatcher(DrainSignalWatcher):
        """The trainer's watcher, keeping the request it answered and the
        host clock at each poll: the trainer polls once a step, so the
        differences are its steps' host ms (the poll's read included)."""

        answered = None

        def __init__(self, *args):
            super().__init__(*args)
            self.polls = []

        def check_and_acknowledge(self, on_checkpoint):
            self.polls.append(time.perf_counter())
            return super().check_and_acknowledge(on_checkpoint)

        def acknowledge(self):
            self.answered = self._read()
            super().acknowledge()

    policy = wave_policy(store)
    state_key = util.get_upgrade_state_label_key()
    registry, tracer, log_, flight = (metrics.MetricsRegistry(), tracing.Tracer(capacity=4096),
                                      events.DecisionEventLog(capacity=8192), timeline.FlightRecorder())
    previous = (metrics.set_default_registry(registry), tracing.set_default_tracer(tracer),
                events.set_default_log(log_))
    served0 = None if facade is None else facade.requests_served
    manager = ClusterUpgradeStateManager(
        client, cache=InformerCache(client, lag_seconds=0.0), recorder=util.EventRecorder(),
        pre_drain_gate=CheckpointDrainGate(client, policy.pre_drain_checkpoint), write_pipeline_workers=16,
        cache_sync_timeout_seconds=30.0, cache_sync_poll_seconds=0.01, flight_recorder=flight,
        use_state_index=use_state_index)
    # the full snapshot the indexed one is held to, from a manager that
    # only builds
    full = ClusterUpgradeStateManager(client, cache=InformerCache(client, lag_seconds=0.0),
                                      flight_recorder=timeline.FlightRecorder()) if use_state_index else None
    workloads = _RackWorkloads(store)
    passes, wave, trainer, run, host = [], [], None, None, None
    t_admit = t_done = None
    try:
        with tempfile.TemporaryDirectory(prefix=f"chip-smoke-{what}-") as ckpt, ThreadPoolExecutor(1) as pool:
            for n in range(WAVE_MAX_PASSES):
                t0 = time.perf_counter()
                state = manager.build_state(FLEET_NAMESPACE, FLEET_DRIVER_LABELS)
                built = {"build_ms": (time.perf_counter() - t0) * 1e3}
                if full is not None:
                    if not state.built_from_index:
                        raise RuntimeError(f"{what}: pass {n}'s snapshot was not built from the state index")
                    t1 = time.perf_counter()
                    full_state = full.build_state(FLEET_NAMESPACE, FLEET_DRIVER_LABELS)
                    built["full_build_ms"] = (time.perf_counter() - t1) * 1e3
                    if _buckets(full_state) != _buckets(state):
                        raise RuntimeError(f"{what}: pass {n}'s indexed snapshot differs from the full one: "
                                           f"{ {k: len(v) for k, v in _buckets(state).items()} } against "
                                           f"{ {k: len(v) for k, v in _buckets(full_state).items()} }")
                status = RolloutStatus.from_cluster_state(state, policy)
                if (status.total_nodes != FLEET_NODES
                        or status.done + status.in_progress + status.pending + status.unknown != FLEET_NODES):
                    raise RuntimeError(f"{what}: pass {n}'s status does not account for the fleet: "
                                       f"{status.by_state}")
                pending_before = {ns.node["metadata"]["name"] for ns in state.nodes_in(
                    consts.UPGRADE_STATE_UPGRADE_REQUIRED)}
                manager.apply_state(state, policy)
                if not (manager.drain_manager.wait_idle(120.0) and manager.pod_manager.wait_idle(120.0)):
                    raise RuntimeError(f"{what}: drains or pod restarts still in flight after 120 s")
                if not wave:
                    admitted = sorted(n_ for n_ in pending_before if store.get("Node", n_)["metadata"]["labels"].get(
                        state_key) == consts.UPGRADE_STATE_CORDON_REQUIRED)
                    if admitted and expect_wave is not None and set(admitted) != set(expect_wave):
                        raise RuntimeError(f"{what}: the first admission ({len(admitted)} nodes) is not the plan's "
                                           f"({len(expect_wave)}): {sorted(set(admitted) ^ set(expect_wave))[:5]}")
                    if admitted:
                        t_admit, wave = t0, admitted
                        host = wave[len(wave) // 2]
                        workloads.watch([n_ for n_ in wave if n_ != host])
                        fa.reset_launch_counts()
                        trainer = wl.CheckpointingTrainer(config, ckpt, watcher=TokenWatcher(client, host),
                                                          device="cuda")
                        trainer.run(2)
                        trainer.watcher.polls.clear()  # time the steps under the wave only
                        run = pool.submit(trainer.run, 3000)  # a thread: it drains on its node's request
                made = play_daemonset(store)
                passes.append({"ms": (time.perf_counter() - t0) * 1e3, "driver_pods_recreated": made, **built})
                if wave and all(store.get("Node", n_)["metadata"]["labels"].get(state_key)
                                == consts.UPGRADE_STATE_DONE for n_ in wave):
                    t_done = time.perf_counter()
                    break
            else:
                raise RuntimeError(f"{what}: the wave is not done after {WAVE_MAX_PASSES} passes")
            step = run.result(timeout=300)
            if not trainer.drained:
                raise RuntimeError(f"{what}: the trainer on {host} ran {step} steps and was never drained")
            if wl.restore_checkpoint(ckpt, step)["step"] != step:
                raise RuntimeError(f"{what}: the checkpoint does not restore at step {step}")
            answered = trainer.watcher.answered or ""
            polls = trainer.watcher.polls
        final = manager.build_state(FLEET_NAMESPACE, FLEET_DRIVER_LABELS)
        status = RolloutStatus.from_cluster_state(final, policy)
        if (status.total_nodes != FLEET_NODES or status.in_progress
                or status.done + status.pending + status.unknown != FLEET_NODES):
            raise RuntimeError(f"{what}: the status after the wave does not account for the fleet: "
                               f"{status.by_state}")
        final_slo = SloEngine(flight).evaluate(final, policy)
        remediation = remediation_report(final, policy)
        batches, writes = metrics.write_batch_size_histogram().count(), metrics.write_batch_size_histogram().sum()
        requests = None if facade is None else facade.requests_served - served0
    finally:
        workloads.close()
        manager.shutdown()
        if full is not None:
            full.shutdown()
        metrics.set_default_registry(previous[0])
        tracing.set_default_tracer(previous[1])
        events.set_default_log(previous[2])
    launches = dict(fa.launch_counts)
    _check_flash_launches(what, {k: n for k, n in fa.device_launch_counts.items() if n},
                          dict.fromkeys(launches, config.n_layers * step))
    if not all(math.isfinite(x) for x in trainer.losses):
        raise RuntimeError(f"{what}: losses {trainer.losses}")
    # the wave: one admission of 16 racks (slots count racks under a
    # slice-aware policy; tests/test_torch_rollout_parity.py pins it)
    racks = {store.get("Node", n_)["metadata"]["labels"][consts.SLICE_ID_LABEL_KEYS[0]] for n_ in wave}
    if len(wave) != FLEET_RACK * FLEET_RACK or len(racks) != FLEET_RACK:
        raise RuntimeError(f"{what}: the first admission took {len(wave)} nodes in {len(racks)} racks, "
                           f"want {FLEET_RACK} racks of {FLEET_RACK}")
    decisions = log_.events()
    admitted_events = sum(e["count"] for e in decisions if e["type"] == "NodeAdmitted")
    deferred = {e["target"] for e in decisions if e["type"] == "NodeDeferred"}
    if admitted_events != len(wave) or deferred & set(wave):
        raise RuntimeError(f"{what}: {admitted_events} NodeAdmitted decisions for a wave of {len(wave)}; "
                           f"deferred wave nodes {sorted(deferred & set(wave))[:5]}")
    # every wave node done, schedulable, its Job pod evicted, its driver at
    # rev2; every other node schedulable and either waiting untouched or
    # done by an earlier wave
    nodes = {n_["metadata"]["name"]: n_ for n_ in store.list("Node")}
    drivers = {p["spec"]["nodeName"]: p for p in store.list("Pod", namespace=FLEET_NAMESPACE)}
    jobs = {p["spec"]["nodeName"] for p in store.list("Pod", namespace=FLEET_JOB_NAMESPACE)}
    in_wave = set(wave)
    upgraded = (consts.UPGRADE_STATE_DONE, "rev2", False)
    for name, node in nodes.items():
        label = node["metadata"]["labels"].get(state_key)
        rev = drivers[name]["metadata"]["labels"].get("controller-revision-hash")
        ends = (label, rev, name in jobs)
        ok = ends == upgraded if name in in_wave else ends in (
            upgraded, (consts.UPGRADE_STATE_UPGRADE_REQUIRED, "rev1", True))
        if not ok or node["spec"].get("unschedulable"):
            raise RuntimeError(f"{what}: {name} ({'wave' if name in in_wave else 'outside the wave'}) ends "
                               f"{label!r}, schedulable {not node['spec'].get('unschedulable')}, driver {rev}, "
                               f"job pod {'present' if name in jobs else 'gone'}")
    # each node: cordon, wait-for-jobs, drain, pod-restart, uncordon, done
    lifecycle = [consts.UPGRADE_STATE_UPGRADE_REQUIRED, consts.UPGRADE_STATE_CORDON_REQUIRED,
                 consts.UPGRADE_STATE_WAIT_FOR_JOBS_REQUIRED, consts.UPGRADE_STATE_DRAIN_REQUIRED,
                 consts.UPGRADE_STATE_POD_RESTART_REQUIRED, consts.UPGRADE_STATE_UNCORDON_REQUIRED]
    timelines = {tl["node"]: tl for tl in flight.timelines()}
    broken = [n_ for n_ in wave if [p for p, _, _ in timelines[n_]["intervals"]][-len(lifecycle):] != lifecycle
              or timelines[n_]["current"] != consts.UPGRADE_STATE_DONE]
    if broken:
        raise RuntimeError(f"{what}: {len(broken)} wave nodes lack a complete timeline, e.g. "
                           f"{timelines.get(broken[0])}")
    # the drain: one pod evicted a node (its Job's; never the driver), and
    # the trainer's checkpoint-drain span under the gate's drain-handshake
    spans = [s for t in tracer.traces(complete_only=False) for s in t["spans"]]
    drains = {s["attributes"]["node"]: s for s in spans if s["name"] == "drain"}
    evicted = {drains[n_]["attributes"].get("pods_evicted") for n_ in wave if n_ in drains}
    if len(drains) != len(wave) or evicted != {1}:
        raise RuntimeError(f"{what}: {len(drains)} drain spans for {len(wave)} nodes, pods evicted {evicted}")
    [gate] = [s for s in spans if s["name"] == "drain-handshake" and s["attributes"]["node"] == host]
    chrome = json.loads(json.dumps(tracing.to_chrome(tracer.traces(complete_only=False))))
    cds = [e for e in chrome["traceEvents"] if e["name"] == "checkpoint-drain"
           and e["args"]["trace_id"] == gate["trace_id"] and e["args"]["parent_id"] == gate["span_id"]]
    gate_events = [e for e in chrome["traceEvents"] if e["name"] == "drain-handshake"
                   and e["args"]["span_id"] == gate["span_id"]]
    if (gate["attributes"].get("result") != "acknowledged" or len(cds) != 1 or cds[0]["args"]["status"] != "ok"
            or not answered.startswith(f"{consts.PRE_DRAIN_CHECKPOINT_REQUESTED}:") or len(gate_events) != 1):
        raise RuntimeError(f"{what}: the gate on {host} ended {gate['attributes']}, answered {answered!r}, "
                           f"{len(cds)} checkpoint-drain spans under it in the Chrome export")
    if workloads.acks != len(wave) - 1:
        raise RuntimeError(f"{what}: the rack workloads answered {workloads.acks} requests, want {len(wave) - 1}")
    if remediation["blocking"] or (remediation["breaker"] or {}).get("state") == "open" or remediation["nodes"]:
        raise RuntimeError(f"{what}: remediation {remediation}")
    gate_ev, cd = gate_events[0], cds[0]
    rec = {
        "nodes": len(wave), "racks": len(racks), "rack_ids": sorted(racks), "passes": len(passes),
        "wave_ms": (t_done - t_admit) * 1e3, "pass_ms": [round(p["ms"], 1) for p in passes],
        "build_ms": [round(p["build_ms"], 1) for p in passes],
        "driver_pods_recreated": sum(p["driver_pods_recreated"] for p in passes),
        "admitted": admitted_events, "deferred_nodes": len(deferred),
        "phase_seconds": {p: {"p50": s["p50"], "p95": s["p95"], "count": s["count"]}
                          for p, s in final_slo["phases"].items()},
        "host": host, "drained_at_step": step, "flash_launches": launches,
        "trainer_step_ms": _step_ms(polls),
        "drain_handshake_ms": gate_ev["dur"] / 1e3, "checkpoint_drain_ms": cd["dur"] / 1e3,
        "request_to_ack_ms": (cd["ts"] + cd["dur"] - gate_ev["ts"]) / 1e3,
        "provider_writes": writes, "provider_batches": batches,
        "writes_per_batch": writes / batches if batches else None,
        "remediation": {"breaker": remediation["breaker"], "blocking": remediation["blocking"]},
    }
    if requests is not None:
        rec["http_requests"] = requests
    if full is not None:
        rec["full_build_ms"] = [round(p["full_build_ms"], 1) for p in passes]
    return rec


def fleet_rest(store, config, taken) -> dict:
    """10i: the rest of the fleet after 10g and 10h, in process.
    ``plan_rollout`` projects the rollout over a dump of the fleet as it
    stands; then the remaining waves go through the port's
    ``ClusterUpgradeStateManager`` with the state index, each as 10g's
    (trainer, gate and rack workloads), under ``runtime.tuned_gc``, the
    first admission the plan's.  *taken* holds the racks of the earlier
    waves.  Returns the host-clock figures."""
    from k8s_operator_libs_tpu_torch import runtime
    from k8s_operator_libs_tpu_torch.cluster.cache import InformerCache
    from k8s_operator_libs_tpu_torch.upgrade import consts, util
    from k8s_operator_libs_tpu_torch.upgrade.plan import plan_rollout
    from k8s_operator_libs_tpu_torch.upgrade.remediation import remediation_report
    from k8s_operator_libs_tpu_torch.upgrade.rollout_status import RolloutStatus
    from k8s_operator_libs_tpu_torch.upgrade.upgrade_state import ClusterUpgradeStateManager

    policy, taken = wave_policy(store), set(taken)
    slice_key = consts.SLICE_ID_LABEL_KEYS[0]
    t0 = time.perf_counter()
    plan = plan_rollout(store.to_dict(), FLEET_NAMESPACE, FLEET_DRIVER_LABELS, policy)
    plan_ms = (time.perf_counter() - t0) * 1e3
    first = set(plan.next_admissions)
    racks = {store.get("Node", n)["metadata"]["labels"][slice_key] for n in first}
    if not plan.converged or len(first) != FLEET_RACK * FLEET_RACK or len(racks) != FLEET_RACK or racks & taken:
        raise RuntimeError(f"10i: the plan converged {plan.converged}; its next admissions are {len(first)} nodes "
                           f"in {len(racks)} racks, {len(racks & taken)} of them taken by 10g-10h")
    rec = {"plan_cycles": plan.cycles_simulated, "plan_ms": plan_ms,
           "plan_projected_states": plan.projected_states, "waves": []}
    remaining = FLEET_NODES // (FLEET_RACK * FLEET_RACK) - len(taken) // FLEET_RACK
    with runtime.tuned_gc():
        for k in range(remaining):
            wave = upgrade_wave(store, store, config, f"10i wave {k + 1}", use_state_index=True,
                                expect_wave=first if k == 0 else None)
            if set(wave["rack_ids"]) & taken:
                raise RuntimeError(f"10i wave {k + 1}: took racks of an earlier wave: {wave['rack_ids']}")
            taken |= set(wave["rack_ids"])
            rec["waves"].append(wave)
    manager = ClusterUpgradeStateManager(store, cache=InformerCache(store, lag_seconds=0.0))
    try:
        final = manager.build_state(FLEET_NAMESPACE, FLEET_DRIVER_LABELS)
    finally:
        manager.shutdown()
    status = RolloutStatus.from_cluster_state(final, policy)
    remediation = remediation_report(final, policy)
    state_key = util.get_upgrade_state_label_key()
    nodes = store.list("Node")
    revisions = {p["metadata"]["labels"].get("controller-revision-hash")
                 for p in store.list("Pod", namespace=FLEET_NAMESPACE)}
    labels = {n["metadata"]["labels"].get(state_key) for n in nodes}
    if (status.total_nodes != FLEET_NODES or status.done != FLEET_NODES or labels != {consts.UPGRADE_STATE_DONE}
            or any(n["spec"].get("unschedulable") for n in nodes) or revisions != {"rev2"} or len(taken)
            != FLEET_NODES // FLEET_RACK):
        raise RuntimeError(f"10i: the fleet ends {status.by_state}, labels {labels}, driver revisions {revisions}, "
                           f"{len(taken)} racks upgraded")
    if (remediation["breaker"] or {}).get("state") == "open" or remediation["blocking"]:
        raise RuntimeError(f"10i: remediation {remediation}")
    rec["status"] = {"done": status.done, "total": status.total_nodes,
                     "breaker": (remediation["breaker"] or {}).get("state", "closed")}
    return rec


def fleet_phase(config, card: str) -> dict:
    """Phase 10: the drain through the full in-memory cluster, at the size
    of a large fleet, then through its HTTP facade, then the whole fleet
    upgraded by the port's state machine: a wave in process, a wave over
    HTTP, and the rest through the state index (10a-10i; see the module
    docstring)."""
    from k8s_operator_libs_tpu_torch.cluster.apiserver import ApiServerFacade
    from k8s_operator_libs_tpu_torch.cluster.kubeclient import KubeApiClient, KubeConfig
    from k8s_operator_libs_tpu_torch.obs import tracing

    cluster, build_s = build_fleet()
    log(f"phase 10a fleet: {FLEET_NODES} nodes of 8 x {FLEET_GPU_PRODUCT}, "
        f"{FLEET_NODES // FLEET_RACK} racks, {FLEET_NODES} driver pods, built in {build_s * 1e3:.1f} ms "
        f"(host clock) | {card}")
    fan = fan_out(cluster)
    log("phase 10b fan-out (host clock):", json.dumps(fan), "|", card)
    drain = fleet_drain(cluster, config, _fleet_node(FLEET_NODES // 2 + 5))
    log("phase 10c fleet drain:", json.dumps(drain), "|", card)
    with ApiServerFacade(cluster) as facade:
        http_fan = http_fan_out(facade)
        log("phase 10e fan-out over HTTP (host clock; 10b's in-process figures beside):",
            json.dumps({"http": http_fan, "in_process": fan}), "|", card)
        with KubeApiClient(KubeConfig(server=facade.url), timeout=30.0) as client:
            http_drain = fleet_drain(client, config, _fleet_node(FLEET_NODES // 4 + 3), "10f",
                                     tracer=tracing.Tracer())
        log("phase 10f fleet drain over HTTP:", json.dumps(http_drain), "|", card)
        prepared = prepare_upgrade(cluster)
        t0 = time.perf_counter()
        wave = upgrade_wave(cluster, cluster, config, "10g")
        log("phase 10g rack wave (host clock):", json.dumps({**prepared, **wave,
            "phase_s": time.perf_counter() - t0}), "|", card)
        t0 = time.perf_counter()
        with KubeApiClient(KubeConfig(server=facade.url), timeout=30.0) as client:
            http_wave = upgrade_wave(client, cluster, config, "10h", facade=facade)
        log("phase 10h rack wave over HTTP (host clock; 10g's in-process figures beside):", json.dumps({
            "http": {**http_wave, "phase_s": time.perf_counter() - t0}, "in_process": wave}), "|", card)
    if set(wave["rack_ids"]) & set(http_wave["rack_ids"]):
        raise RuntimeError(f"10h: the second wave took racks of the first: {http_wave['rack_ids']}")
    t0 = time.perf_counter()
    rest = fleet_rest(cluster, config, set(wave["rack_ids"]) | set(http_wave["rack_ids"]))
    log("phase 10i the rest of the fleet through the state index (host clock):",
        json.dumps({**rest, "phase_s": time.perf_counter() - t0}), "|", card)
    dump = json.dumps(cluster.to_dict())
    found = [m for m in TPU_MARKERS if m in dump]
    if found:
        raise RuntimeError(f"10d: the cluster holds {found}")
    log(f"phase 10d: no key or value of the cluster's {len(dump)} bytes names {list(TPU_MARKERS)}"
        f" (after 10e-10i, all {FLEET_NODES} nodes upgraded)")
    return {"build_ms": build_s * 1e3, "fan_out": fan, "drain": drain, "http_fan_out": http_fan,
            "http_drain": http_drain, "wave": wave, "http_wave": http_wave, "rest": rest}


def compiled_report():
    """Per kernel instantiation of every library, ``ptxas -v``'s
    registers, shared memory, spills and notes and the HGMMA/HMMA count of
    its SASS.  Raises unless each flash tensor-core kernel is built at
    every head dim with tensor-core instructions, no spill and no ptxas
    note that its wgmma were serialized (C7515 for a call, C7512 for want
    of registers), and unless each int8 device kernel is built, the bf16
    one with HMMA, no spill and no ptxas note."""
    import torch

    from k8s_operator_libs_tpu_torch import _build
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    report = {}
    for lib in _build.SIGNATURES:
        ptxas = _build.ptxas_report(lib)
        sass = _build.sass_counts(lib)
        report.update({name: {**ptxas.get(name, {}), **sass.get(name, {})} for name in sorted(sass)})
    for name, row in report.items():
        log("compiled", name, json.dumps(row))
    int8 = qz.DEVICE_KERNELS["int8_linear"]
    if any(name not in report for name in int8.values()):
        raise RuntimeError(f"int8_matmul: {sorted(int8.values())} not all built ({sorted(report)})")
    tc = report[int8[torch.bfloat16]]
    if tc["HMMA"] == 0 or tc.get("spill_stores", 1) or tc.get("spill_loads", 1) or tc.get("notes"):
        raise RuntimeError(f"{int8[torch.bfloat16]}: no HMMA, a spill or a ptxas note ({tc})")
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


#: What one turn of ``--int8-turns`` runs inside a tree: only functions
#: every tree since the int8 kernel's first version has.
_TURN = """
import json, torch
import chip_smoke as c
from k8s_operator_libs_tpu_torch.tpu import smoke
cfg = smoke.smoke_config(torch.device("cuda"))
row = {name: {"launches_per_step": per, **c.time_int8(8, k, n, "bfloat16", graphs=True)}
       for name, k, n, per in c.int8_decode_shapes(cfg)}
row["per_decode_step_ms"] = sum(r["ms"] * r["launches_per_step"] for r in row.values())
row["long"] = c.time_int8(8, 8192, 8192, "bfloat16", graphs=True)
print("TURN", json.dumps(row), flush=True)
"""


def int8_plans() -> None:
    """Time the bf16 kernel under every plan at the decode shapes and the
    long shape (graph replay); print a ``plans`` line each."""
    import torch

    from k8s_operator_libs_tpu_torch import _build
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz
    from k8s_operator_libs_tpu_torch.tpu import smoke

    lib = _build.load("int8_matmul")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(k, n) for _, k, n, _ in int8_decode_shapes(smoke.smoke_config(torch.device("cuda")))]
    for k, n in dict.fromkeys(shapes + [(8192, 8192)]):
        x, q, s, bias = int8_inputs(8, k, n, "bfloat16", seed=1)
        y = torch.empty(8, n, dtype=x.dtype, device="cuda")

        def launch(k_warps, cluster):
            _build.check(lib.int8_linear(
                x.data_ptr(), q.data_ptr(), s.data_ptr(), bias.data_ptr(), y.data_ptr(), 8, k, n,
                1, k_warps, cluster, torch.cuda.current_stream().cuda_stream,
            ), "int8_linear")

        chunks = -(-k // qz.INT8_K_CHUNK)
        us = {
            f"cluster {c}, {w} warps": 1e3 * graph_ms(lambda w=w, c=c: launch(w, c))
            for c in (1, 2, 4, 8) for w in (1, 2, 4, 8) if c * w <= chunks
        }
        plan = qz.int8_plan(8, k, n, n_sms)
        log("plans", json.dumps({
            "M": 8, "K": k, "N": n, "chosen": f"cluster {plan.cluster}, {plan.k_warps} warps",
            "us": dict(sorted(us.items(), key=lambda kv: kv[1])),
        }))


def int8_turns(trees) -> None:
    """Time each tree's int8 kernel in turns (the trees in order, then in
    reverse), one process per turn; print a ``turn`` line for each."""
    import os

    order = list(trees) + list(reversed(trees))
    for i, tree in enumerate(order):
        proc = subprocess.run(
            [sys.executable, "-c", _TURN], cwd=os.path.abspath(tree),
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"turn {i} in {tree} failed:\n{proc.stderr[-4000:]}")
        row = json.loads(proc.stdout.split("TURN ", 1)[1].splitlines()[0])
        log("turn", json.dumps({"turn": i, "tree": tree, **row}))


def nccl_ranks(n: int) -> None:
    """The multi-process path over *n* NCCL ranks, one card each: the
    data-parallel drain, held to one rank's plain step on the same global
    batches, and every flash ring at s 8192, held to single-device flash
    on the first card."""
    import dataclasses

    import torch

    from k8s_operator_libs_tpu_torch import _build
    from k8s_operator_libs_tpu_torch.tpu import smoke
    from k8s_operator_libs_tpu_torch.tpu import workload as wl

    if torch.cuda.device_count() < n:
        raise RuntimeError(f"--ranks {n} needs {n} cards, torch sees {torch.cuda.device_count()}")
    card = nvidia_smi_line()
    log("device:", card, "x", torch.cuda.device_count(), "| torch", torch.__version__)
    _build.build_all()  # before the ranks start, which then load it
    config = dataclasses.replace(smoke.smoke_config(torch.device("cuda")), flash_attention=True)
    model, optimizer = wl.create_train_state(config, "cuda", seed=0)
    step = wl.make_train_step(model, optimizer)
    reference = [float(step(wl.make_batch(config, 8, seed=i, device="cuda"))) for i in range(8)]
    del model, optimizer, step
    t0 = time.perf_counter()
    ranks_drain(config, "nccl", reference, card, n, what=f"{n} cards")
    t1 = time.perf_counter()
    ranks_rings("nccl", card, n, what=f"{n} cards")
    t2 = time.perf_counter()
    if n % 4 == 0:
        spmd_phase("nccl", card, n, what=f"{n} cards")
    t3 = time.perf_counter()
    if n % 4 == 0:
        spmd_phase("nccl", card, n, what=f"{n} cards 9c", job=EP_JOB)
    if n == config.n_layers:  # one block a stage
        pipeline_phase("nccl", card, n, what=f"{n} cards 9d")
    dryrun_phase("nccl", card, n, what=f"{n} cards 9e")
    log(f"{n} cards: drain {t1 - t0:.1f} s, rings {t2 - t1:.1f} s, sharded step "
        f"{t3 - t2:.1f} s, phase 9 {time.perf_counter() - t3:.1f} s")


def main(argv=None) -> int:
    import argparse

    import torch

    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--int8-turns", nargs="+", metavar="TREE",
                      help="time each checkout's int8 kernel in turns instead")
    args.add_argument("--int8-plans", action="store_true",
                      help="time the bf16 int8 kernel under every launch plan instead")
    args.add_argument("--ranks", type=int, metavar="N",
                      help="run the multi-process path over N NCCL ranks, a card each, instead")
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.int8_turns or args.int8_plans or args.ranks:
        if args.int8_turns:
            int8_turns(args.int8_turns)
        elif args.ranks:
            nccl_ranks(args.ranks)
        else:
            int8_plans()
        print(nvidia_smi_line())
        return 0
    import dataclasses

    from k8s_operator_libs_tpu_torch import _build
    from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz
    from k8s_operator_libs_tpu_torch.tpu import smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. device and build ----
    card = nvidia_smi_line()
    log("device:", card, "| torch", torch.__version__, "cuda", torch.version.cuda,
        "| gpu", json.dumps(smoke.detect_gpu()))
    t0 = time.perf_counter()
    _build.build_all()  # one nvcc per source, side by side
    nvcc = dict(_build.build_seconds)  # before load() finds them built
    for lib in _build.SIGNATURES:
        _build.load(lib)
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, in parallel: "
        + ", ".join(f"{lib}.cu {t:.1f} s" for lib, t in nvcc.items()) + ")")
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
    # phase 8's ring pairs: b 8, 4 heads a model rank, the 128 positions a
    # seq rank (the contiguous ring) and their 64-long zigzag halves
    for span in (128, 64):
        check_case(f"ring-pair-s{span}-bf16", 8, span, 4, 4, 64, True, "bfloat16", block=span, seed=13)
        check_case(f"ring-pair-s{span}-unmasked-bf16", 8, span, 4, 4, 64, False, "bfloat16",
                   block=span, seed=14)
        check_ring_pairs(f"ring-pairs-s{span}", 8, span, 4, 64, seed=15)
    # head dims the kernels are not compiled for: zero-padded to the next
    # compiled width (8 -> 16, 48 -> 64) at the true width's scale
    for d, seed in ((8, 20), (48, 21)):
        for dtype in ("float32", "bfloat16"):
            for causal in (True, False):
                tag = f"pad-d{d}-{'causal' if causal else 'full'}-{dtype}"
                check_case(tag, 2, 256, 4, 4, d, causal, dtype, seed=seed)
    check_case("pad-d8-gqa-bf16", 2, 256, 8, 2, 8, True, "bfloat16", seed=22)
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
        # without the benches: the attention bench's flash launches would
        # land inside this path's launch counts (phase 6 runs them)
        result = smoke.run_smoke(
            ckpt, steps=steps, warmup=warmup, config=config, kernel_sections=False
        )
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
    if drain != {**drain, "checkpoint_step": steps, "ack": "done", "resumed_steps": 2}:
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
    log("phase 3-4 done", f"{time.perf_counter() - t_start:.1f} s")

    # ---- 5. serving: the int8 kernel, then the decode path's gates ----
    int8_err, int8_timing = int8_kernel_phase(config)
    serving = serving_gates(config)
    log("phase 5 done", f"{time.perf_counter() - t_start:.1f} s")

    # ---- 6. every stage, then the drain trace ----
    stage_phase(card)
    drain_trace_phase(config)
    log("phase 6 done", f"{time.perf_counter() - t_start:.1f} s")

    # ---- 7. the multi-process path: one NCCL rank, then two ranks ----
    t7 = [time.perf_counter()]
    with start_nccl_probe() as probe:
        one_rank = one_rank_drain(config, card)
        t7.append(time.perf_counter())
        backend = nccl_probe(probe)
    t7.append(time.perf_counter())
    ranks_drain(config, backend, one_rank["losses"], card)
    t7.append(time.perf_counter())
    rings = ranks_rings(backend, card)
    t7.append(time.perf_counter())
    log(f"phase 7 done {t7[-1] - t_start:.1f} s (phase 7 {t7[-1] - t7[0]:.1f} s: 7a "
        f"{t7[1] - t7[0]:.1f}, probe after it {t7[2] - t7[1]:.1f}, 7b drain "
        f"{t7[3] - t7[2]:.1f}, 7b rings {t7[4] - t7[3]:.1f})")

    # ---- 8. the sharded train step: four ranks on the one card ----
    t8 = time.perf_counter()
    spmd = spmd_phase(backend, card)
    log(f"phase 8 done {time.perf_counter() - t_start:.1f} s (phase 8 {time.perf_counter() - t8:.1f} s)")

    # ---- 9. the MoE, expert parallelism, the pipeline and the dryrun ----
    t9 = [time.perf_counter()]
    moe = moe_config()
    moe_train = moe_train_phase(moe, card)
    t9.append(time.perf_counter())
    moe_decode = moe_decode_phase(moe, card)
    t9.append(time.perf_counter())
    ep = spmd_phase(backend, card, what="9c", job=EP_JOB)
    t9.append(time.perf_counter())
    pipe = pipeline_phase(backend, card)
    t9.append(time.perf_counter())
    dryrun_phase(backend, card)
    t9.append(time.perf_counter())
    log(f"phase 9 done {t9[-1] - t_start:.1f} s (phase 9 {t9[-1] - t9[0]:.1f} s: "
        + ", ".join(f"9{part} {b - a:.1f}" for part, a, b in zip("abcde", t9, t9[1:])) + ")")

    # ---- 10. the drain through the full cluster, at fleet size ----
    t10 = time.perf_counter()
    fleet = fleet_phase(config, card)
    log(f"phase 10 done {time.perf_counter() - t_start:.1f} s (phase 10 {time.perf_counter() - t10:.1f} s)")

    # ---- 11. the result lines ----
    kernels = []
    head_dim = config.d_model // config.n_heads
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        t = main_timing[name]
        # the instantiation the main path runs (a tc kernel: the head dim)
        built = compiled.get(f"{routed[name]}<{head_dim}>", {})
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
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
            # phase 7's paths: the one-rank drain loop, and per rank of
            # each two-rank ring (fwd: forward; dq, dkv: backward)
            "ring_path_launches": {
                "7a drain loop (1 rank)": one_rank["flash_launches"][routed[name]],
                **{f"7b {case} (per rank)": row["pairs"] for case, row in rings["cases"].items()},
            },
            # phase 8's sharded step, per rank over each run (2 steps; the
            # drain's 1 and the step after it)
            "spmd_path_launches": {
                f"8 {run} (per rank)": [counts[name] for counts in row["launches"]]
                for run, row in spmd["runs"].items()
            },
            # phase 9's paths: the one-device MoE step, the EP step per
            # rank over its run (2 steps) and the drain's step, and the
            # pipeline per stage per step (a launch a microbatch)
            "moe_path_launches": {
                "9a MoE step (one device, per step)": moe_train["launches_per_step"][name],
                **{f"9c {run} (per rank)": [counts[name] for counts in row["launches"]]
                   for run, row in ep["runs"].items()},
                "9d GPipe (per stage, per step)": [counts[name] / PIPE_STEPS for counts in pipe["launches"]],
            },
            # phase 10c: the smoke trainer drained through the fleet's
            # cluster, counted from 0 around it
            "fleet_path_launches": {
                f"10c fleet drain ({fleet['drain']['drained_at_step']} steps)":
                    fleet["drain"]["flash_launches"][name],
                f"10f fleet drain over HTTP ({fleet['http_drain']['drained_at_step']} steps)":
                    fleet["http_drain"]["flash_launches"][name],
                f"10g rack wave ({fleet['wave']['drained_at_step']} steps)":
                    fleet["wave"]["flash_launches"][name],
                f"10h rack wave over HTTP ({fleet['http_wave']['drained_at_step']} steps)":
                    fleet["http_wave"]["flash_launches"][name],
                **{f"10i wave {k + 1} ({w['drained_at_step']} steps)": w["flash_launches"][name]
                   for k, w in enumerate(fleet["rest"]["waves"])},
            },
        })
    step = int8_timing["per_decode_step"]
    built = compiled.get(serving["device_kernel"], {})
    kernels.append({
        "name": "int8_linear",
        "route": "cuda",
        "source": SOURCE["int8_linear"],
        "replaces": REPLACES["int8_linear"],
        "launches": serving["launches"],
        "device_kernels": {
            str(dt).removeprefix("torch."): k for dt, k in qz.DEVICE_KERNELS["int8_linear"].items()
        },
        "main_path_device_kernel": serving["device_kernel"],
        "max_abs_err": int8_err,
        # one decode step's int8 matmuls at the smoke config (M 8, bf16),
        # each by graph replay, summed over its launches_per_step
        "unit": f"ms per decode step ({step['launches']} launches; per_shape in the "
                "int8 timing line)",
        "ms": step["ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"],
        "registers": built.get("registers"),
        "spill_bytes": built.get("spill_stores"),
        # F.linear on the already-dequantized bf16 weight: the cuBLAS call
        # the kernel replaces (it reads twice the weight bytes)
        "library_ms": step["linear_ms"],
        "long_shape": int8_timing["long"],
        # phase 9b: the int8 MoE decode's launches a step ((5 + 2E) layers
        # + 1, all on the tensor-core kernel) and the router's N = E shape
        # against the plain version
        "moe_decode_launches_per_step": moe_decode["launches_per_step"],
        "moe_router_max_abs_err": moe_decode["router_err"],
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
