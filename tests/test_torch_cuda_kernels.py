"""The port's CUDA kernels on the card (marked ``cuda``; they skip where
torch sees no CUDA device).  No jax import: this file runs on the machine
with the card, where the JAX package's dependencies may be absent.

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

chip_smoke.py holds the kernels to their plain versions at the full set of
shapes; these tests are the quick check.
"""

import pytest
import torch

from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
from k8s_operator_libs_tpu_torch.tpu import workload as wl


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


#: bf16 against the fp32 plain version on the same bf16 inputs: the
#: chip_smoke.py bound (the kernels round their outputs, P and dS to bf16).
BF16_TOL = 2.0**-7


def _close(got, want, tol: float = 1e-4) -> bool:
    err = float((got.float() - want.float()).abs().max())
    return err <= tol * max(1.0, float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("hk,causal", [(4, True), (2, True), (1, True), (4, False)])
def test_kernels_match_their_plain_versions(cuda, hk, causal):
    """fp32, s 200 (a ragged edge for every tile), GQA/MQA and not."""
    gen = torch.Generator(device=cuda).manual_seed(hk)
    g = 4 // hk
    qf = torch.randn(8, 200, 64, device=cuda, generator=gen)
    kf, vf = (torch.randn(8 // g, 200, 64, device=cuda, generator=gen) for _ in range(2))
    dof = torch.randn(qf.shape, device=cuda, generator=gen)
    o, lse = fa.flash_forward(qf, kf, vf, g, causal)
    o_ref, lse_ref = fa.flash_forward_plain(qf, kf, vf, g, causal)
    assert _close(o, o_ref) and _close(lse, lse_ref)
    dvec = (o_ref * dof).sum(-1)
    args = (qf, kf, vf, dof, lse_ref, dvec, g, causal)
    assert _close(fa.flash_bwd_dq(*args), fa.flash_bwd_dq_plain(*args))
    for got, want in zip(fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv_plain(*args)):
        assert _close(got, want)


@pytest.mark.cuda
def test_a_flash_train_step_launches_each_kernel_once_per_layer(cuda):
    cfg = wl.ModelConfig(
        d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=33,
        dtype=torch.bfloat16, flash_attention=True,
    )
    model, optimizer = wl.create_train_state(cfg, cuda)
    step = wl.make_train_step(model, optimizer)
    fa.reset_launch_counts()
    losses = [float(step(wl.make_batch(cfg, 4, seed=i, device=cuda))) for i in range(3)]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert fa.flash_launch_counts() == {name: 2 * 3 for name in fa.FLASH_ENTRIES}
    assert fa.launch_counts["decode_attention"] == 0


def _bf16_inputs(cuda, d, s, hk, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    g = 4 // hk

    def mk(rows):
        return torch.randn(rows, s, d, device=cuda, generator=gen).bfloat16()

    qf, kf, vf, dof = mk(8), mk(8 // g), mk(8 // g), mk(8)
    return qf, kf, vf, dof, g


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hk", [4, 2, 1], ids=lambda hk: f"hk{hk}")
@pytest.mark.parametrize("s", [1, 63, 200, 203, 256], ids=lambda s: f"s{s}")
@pytest.mark.parametrize("d", fa.HEAD_DIMS, ids=lambda d: f"d{d}")
def test_bf16_tensor_core_kernels_match_their_plain_versions(cuda, d, s, hk, causal):
    """The wgmma forward, dQ and dK/dV at every head dim, MHA/GQA/MQA,
    causal or not: one row, one short tile, ragged and whole 64-row tiles,
    and s 203, where a row of lse or dvec starts only 4-byte aligned
    (dK/dV copies them 4 bytes at a time)."""
    qf, kf, vf, dof, g = _bf16_inputs(cuda, d, s, hk, seed=d * 1000 + s + hk)
    fp32 = [t.float() for t in (qf, kf, vf, dof)]
    before = dict(fa.device_launch_counts)
    o, lse = fa.flash_forward(qf, kf, vf, g, causal)
    o_ref, lse_ref = fa.flash_forward_plain(*fp32[:3], g, causal)
    assert _close(o, o_ref, BF16_TOL)
    assert _close(lse, lse_ref)  # fp32 on both sides, from the same values
    dvec = (o_ref * fp32[3]).sum(-1)
    dq = fa.flash_bwd_dq(qf, kf, vf, dof, lse_ref, dvec, g, causal)
    assert _close(dq, fa.flash_bwd_dq_plain(*fp32, lse_ref, dvec, g, causal), BF16_TOL)
    dk, dv = fa.flash_bwd_dkv(qf, kf, vf, dof, lse_ref, dvec, g, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*fp32, lse_ref, dvec, g, causal)
    assert _close(dk, dk_ref, BF16_TOL) and _close(dv, dv_ref, BF16_TOL)
    launched = {
        name: n - before[name] for name, n in fa.device_launch_counts.items() if n != before[name]
    }
    assert launched == {
        "flash_fwd_tc_kernel": 1, "flash_bwd_dq_tc_kernel": 1, "flash_bwd_dkv_tc_kernel": 1,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hk", [4, 2], ids=lambda hk: f"hk{hk}")
@pytest.mark.parametrize("d", [8, 24, 48, 100, 192], ids=lambda d: f"d{d}")
def test_head_dims_between_the_compiled_ones_run_padded(cuda, d, hk, causal, dtype):
    """A head dim the kernels are not compiled for runs zero-padded to the
    next compiled one, at its own scale, on that width's kernels."""
    qf, kf, vf, dof, g = _bf16_inputs(cuda, d, 200, hk, seed=d + hk)
    qf, kf, vf, dof = (t.to(dtype) for t in (qf, kf, vf, dof))
    fp32 = [t.float() for t in (qf, kf, vf, dof)]
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-4
    before = dict(fa.device_launch_counts)
    o, lse = fa.flash_forward(qf, kf, vf, g, causal)
    o_ref, lse_ref = fa.flash_forward_plain(*fp32[:3], g, causal)
    assert o.shape == qf.shape and _close(o, o_ref, tol) and _close(lse, lse_ref)
    dvec = (o_ref * fp32[3]).sum(-1)
    dq = fa.flash_bwd_dq(qf, kf, vf, dof, lse_ref, dvec, g, causal)
    assert dq.shape == qf.shape
    assert _close(dq, fa.flash_bwd_dq_plain(*fp32, lse_ref, dvec, g, causal), tol)
    dk, dv = fa.flash_bwd_dkv(qf, kf, vf, dof, lse_ref, dvec, g, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*fp32, lse_ref, dvec, g, causal)
    assert _close(dk, dk_ref, tol) and _close(dv, dv_ref, tol)
    launched = {
        name: n - before[name] for name, n in fa.device_launch_counts.items() if n != before[name]
    }
    assert launched == {fa.DEVICE_KERNELS[e][dtype]: 1 for e in fa.FLASH_ENTRIES}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_the_widest_head_dim_runs_on_its_own_kernels(cuda, causal, dtype):
    """Head dim 256, GQA, s 200: each kernel against its plain version,
    unpadded, on the 256 instantiations."""
    qf, kf, vf, dof, g = _bf16_inputs(cuda, 256, 200, 2, seed=256)
    qf, kf, vf, dof = (t.to(dtype) for t in (qf, kf, vf, dof))
    fp32 = [t.float() for t in (qf, kf, vf, dof)]
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-4
    before = dict(fa.device_launch_counts)
    o, lse = fa.flash_forward(qf, kf, vf, g, causal)
    o_ref, lse_ref = fa.flash_forward_plain(*fp32[:3], g, causal)
    assert _close(o, o_ref, tol) and _close(lse, lse_ref)
    dvec = (o_ref * fp32[3]).sum(-1)
    dq = fa.flash_bwd_dq(qf, kf, vf, dof, lse_ref, dvec, g, causal)
    assert _close(dq, fa.flash_bwd_dq_plain(*fp32, lse_ref, dvec, g, causal), tol)
    dk, dv = fa.flash_bwd_dkv(qf, kf, vf, dof, lse_ref, dvec, g, causal)
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*fp32, lse_ref, dvec, g, causal)
    assert _close(dk, dk_ref, tol) and _close(dv, dv_ref, tol)
    launched = {
        name: n - before[name] for name, n in fa.device_launch_counts.items() if n != before[name]
    }
    assert launched == {fa.DEVICE_KERNELS[e][dtype]: 1 for e in fa.FLASH_ENTRIES}


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4], ids=lambda g: f"g{g}")
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [65, 129, 200, 256], ids=lambda s: f"s{s}")
@pytest.mark.parametrize("d", fa.HEAD_DIMS, ids=lambda d: f"d{d}")
def test_bf16_dkv_matches_its_plain_version_on_every_key_tile(cuda, d, s, causal, g):
    """The warp-specialised dK/dV (two consumer warpgroups of 64 keys on
    each 128-key tile) at every head dim: s 65, one key for the second
    consumer of the only tile; s 129, a second tile whose second consumer
    has no key; s 200, a ragged tile; s 256, whole tiles. s 65 and 129
    have s % 4 != 0, so the lse and dvec rows come by 4-byte copies; 200
    and 256 by bulk copies."""
    qf, kf, vf, dof, _ = _bf16_inputs(cuda, d, s, 4 // g, seed=7000 + d * 10 + s + g)
    fp32 = [t.float() for t in (qf, kf, vf, dof)]
    o_ref, lse_ref = fa.flash_forward_plain(*fp32[:3], g, causal)
    dvec = (o_ref * fp32[3]).sum(-1)
    before = fa.device_launch_counts["flash_bwd_dkv_tc_kernel"]
    dk, dv = fa.flash_bwd_dkv(qf, kf, vf, dof, lse_ref, dvec, g, causal)
    assert fa.device_launch_counts["flash_bwd_dkv_tc_kernel"] == before + 1
    dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*fp32, lse_ref, dvec, g, causal)
    assert _close(dk, dk_ref, BF16_TOL) and _close(dv, dv_ref, BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256], ids=lambda d: f"d{d}")
def test_bf16_dkv_takes_lse_rows_that_start_only_4_byte_aligned(cuda, d):
    """s % 4 == 0, but lse and dvec start 4 bytes past a 16-byte boundary
    (contiguous views into a larger buffer): the rows come by 4-byte
    copies, and the result is bit-equal to the aligned call's."""
    qf, kf, vf, dof, g = _bf16_inputs(cuda, d, 256, 2, seed=d)
    fp32 = [t.float() for t in (qf, kf, vf, dof)]
    o_ref, lse_ref = fa.flash_forward_plain(*fp32[:3], g, True)
    dvec = (o_ref * fp32[3]).sum(-1)

    def shifted(rows):
        flat = torch.empty(rows.numel() + 1, device=cuda)
        out = flat[1:].view(rows.shape)
        out.copy_(rows)
        return out

    lse_4, dvec_4 = shifted(lse_ref), shifted(dvec)
    assert lse_4.is_contiguous() and lse_4.data_ptr() % 16 == 4
    aligned = fa.flash_bwd_dkv(qf, kf, vf, dof, lse_ref, dvec, g, True)
    unaligned = fa.flash_bwd_dkv(qf, kf, vf, dof, lse_4, dvec_4, g, True)
    assert torch.equal(aligned[0], unaligned[0]) and torch.equal(aligned[1], unaligned[1])


def _bf16_backward_inputs(cuda):
    qf, kf, vf, dof, g = _bf16_inputs(cuda, 64, 1000, 2, seed=9)
    o, lse = fa.flash_forward(qf, kf, vf, g, True)
    dvec = (o.float() * dof.float()).sum(-1)
    return qf, kf, vf, dof, lse, dvec, g, True


@pytest.mark.cuda
def test_bf16_dq_is_deterministic(cuda):
    """dQ accumulates in registers with no atomics: two launches on the
    same inputs agree bit for bit."""
    args = _bf16_backward_inputs(cuda)
    assert torch.equal(fa.flash_bwd_dq(*args), fa.flash_bwd_dq(*args))


@pytest.mark.cuda
def test_bf16_dkv_is_deterministic(cuda):
    """dK and dV accumulate in registers and are written once, with no
    atomics: two launches on the same inputs agree bit for bit."""
    args = _bf16_backward_inputs(cuda)
    first, second = fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv(*args)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_a_bf16_train_step_runs_the_tensor_core_kernels(cuda):
    cfg = wl.ModelConfig(
        d_model=128, n_heads=2, n_layers=2, d_ff=256, max_seq_len=65,
        dtype=torch.bfloat16, flash_attention=True,
    )
    model, optimizer = wl.create_train_state(cfg, cuda)
    step = wl.make_train_step(model, optimizer)
    fa.reset_launch_counts()
    loss = float(step(wl.make_batch(cfg, 4, seed=0, device=cuda)))
    assert torch.isfinite(torch.tensor(loss))
    launched = {name: n for name, n in fa.device_launch_counts.items() if n}
    assert launched == {
        "flash_fwd_tc_kernel": 2, "flash_bwd_dq_tc_kernel": 2, "flash_bwd_dkv_tc_kernel": 2,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4], ids=lambda g: f"g{g}")
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [1, 63, 65, 129, 200, 203, 256, 1000], ids=lambda s: f"s{s}")
@pytest.mark.parametrize("d", fa.HEAD_DIMS, ids=lambda d: f"d{d}")
def test_bf16_forward_and_dq_match_their_plain_versions_around_the_ring(cuda, d, s, causal, g):
    """The forward and dQ, whose K/V tiles stream through a ring of TMA
    stages: one row; a short tile; one key past a tile, or past two; a
    ragged tile; whole tiles; and s 1000, 16 tiles, where the ring wraps
    more often than it has stages."""
    qf, kf, vf, dof, _ = _bf16_inputs(cuda, d, s, 4 // g, seed=9000 + d * 10 + s + g)
    fp32 = [t.float() for t in (qf, kf, vf, dof)]
    before = dict(fa.device_launch_counts)
    o, lse = fa.flash_forward(qf, kf, vf, g, causal)
    o_ref, lse_ref = fa.flash_forward_plain(*fp32[:3], g, causal)
    assert _close(o, o_ref, BF16_TOL)
    assert _close(lse, lse_ref)  # fp32 on both sides, from the same values
    dvec = (o_ref * fp32[3]).sum(-1)
    dq = fa.flash_bwd_dq(qf, kf, vf, dof, lse_ref, dvec, g, causal)
    assert _close(dq, fa.flash_bwd_dq_plain(*fp32, lse_ref, dvec, g, causal), BF16_TOL)
    launched = {
        name: n - before[name] for name, n in fa.device_launch_counts.items() if n != before[name]
    }
    assert launched == {"flash_fwd_tc_kernel": 1, "flash_bwd_dq_tc_kernel": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [16, 32, 64], ids=lambda d: f"d{d}")
def test_bf16_dq_on_a_grid_wider_than_two_blocks_an_sm(cuda, d, causal):
    """Up to head dim 64, dQ runs 64-key units at two blocks an SM where
    two blocks an SM hold its grid (the shapes above), and 32-key units
    at three otherwise: here b*h is chosen so that the grid passes that,
    and the second plan is held to the plain version too."""
    s, g = 1000, 2
    bh = 2 * (2 * torch.cuda.get_device_properties(0).multi_processor_count // 16 + 1)
    assert bh * -(-s // 64) > 2 * torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=cuda).manual_seed(d)
    qf, dof = (torch.randn(bh, s, d, device=cuda, generator=gen).bfloat16() for _ in range(2))
    kf, vf = (torch.randn(bh // g, s, d, device=cuda, generator=gen).bfloat16() for _ in range(2))
    fp32 = [t.float() for t in (qf, kf, vf, dof)]
    o_ref, lse_ref = fa.flash_forward_plain(*fp32[:3], g, causal)
    dvec = (o_ref * fp32[3]).sum(-1)
    dq = fa.flash_bwd_dq(qf, kf, vf, dof, lse_ref, dvec, g, causal)
    assert _close(dq, fa.flash_bwd_dq_plain(*fp32, lse_ref, dvec, g, causal), BF16_TOL)


@pytest.mark.cuda
def test_bf16_forward_is_deterministic(cuda):
    """O and lse are written once from registers, with no atomics: two
    launches on the same inputs agree bit for bit."""
    qf, kf, vf, _, g = _bf16_inputs(cuda, 64, 1000, 2, seed=10)
    (o1, lse1), (o2, lse2) = (fa.flash_forward(qf, kf, vf, g, True) for _ in range(2))
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 256], ids=lambda d: f"d{d}")
def test_bf16_forward_and_dq_replayed_in_a_cuda_graph_equal_eager(cuda, d, causal):
    """The tensor maps are encoded on the host at each call and passed by
    value, so a captured launch keeps them: replayed, the forward and dQ
    are bit-equal to the eager calls."""
    qf, kf, vf, dof, g = _bf16_inputs(cuda, d, 1000, 2, seed=11 + d)

    def calls():
        o, lse = fa.flash_forward(qf, kf, vf, g, causal)
        dvec = (o.float() * dof.float()).sum(-1)
        return o, lse, fa.flash_bwd_dq(qf, kf, vf, dof, lse, dvec, g, causal)

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for _ in range(2):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(c, e) for c, e in zip(captured, eager))


@pytest.mark.cuda
def test_bf16_forward_and_dq_read_inputs_written_just_before_them(cuda):
    """q, k, v and dO written by a kernel right before each launch, 60
    times, into the block the allocator hands back after junk was written
    there: a load that ran ahead of the write would see the junk. Every
    result is bit-equal to the launch on the inputs at rest."""
    qf, kf, vf, dof, g = _bf16_inputs(cuda, 64, 1000, 2, seed=12)
    o_want, lse_want = fa.flash_forward(qf, kf, vf, g, True)
    dvec = (o_want.float() * dof.float()).sum(-1)
    dq_want = fa.flash_bwd_dq(qf, kf, vf, dof, lse_want, dvec, g, True)
    torch.cuda.synchronize()

    def fresh(src):
        junk = torch.full_like(src, float("nan"))
        del junk
        return src.float().bfloat16()  # a kernel's write, just ahead of the launch

    order = ("q", "k", "v", "do")
    ok = True
    for i in range(60):
        t = {name: fresh(src) for name, src in zip(order, (qf, kf, vf, dof))}
        if i % 2:
            o, lse = fa.flash_forward(t["q"], t["k"], t["v"], g, True)
            ok &= torch.equal(o, o_want) and torch.equal(lse, lse_want)
        else:
            dq = fa.flash_bwd_dq(t["q"], t["k"], t["v"], t["do"], lse_want, dvec, g, True)
            ok &= torch.equal(dq, dq_want)
    assert ok


# ------------------------------------------------ the int8 decode matmul

#: (M, K, N): every decode shape of the smoke config at M 8 (q/k/v/out,
#: mlp_up and lm_head, mlp_down), M 1 and 13, ragged K and N (K 77 takes
#: byte loads of q); then every branch of the bf16 plan (int8_plan): the
#: long shape (no cluster, 4 warps, 2048 of K each), clusters of 4 and 8
#: (K 4096 and 8192 at N 512), K 1040 (17 chunks in 16 slices), N 2047 (a
#: ragged last tile), M 16 and M 17 (two and three tiles of x rows)
INT8_SHAPES = [(8, 512, 512), (8, 512, 2048), (8, 2048, 512), (1, 512, 2048), (13, 2048, 512),
               (8, 80, 33), (13, 77, 40), (8, 8192, 8192), (8, 4096, 512), (8, 8192, 512),
               (8, 1040, 512), (8, 512, 2047), (16, 512, 512), (17, 2048, 2048)]


def _int8_inputs(cuda, m, k, n, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randint(-127, 128, (n, k), device=cuda, generator=gen, dtype=torch.int8)
    s = torch.rand(n, device=cuda, generator=gen) * 0.01 + 1e-4
    x = torch.randn(m, k, device=cuda, generator=gen).to(dtype)
    bias = torch.randn(n, device=cuda, generator=gen).to(dtype)
    return x, q, s, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("m,k,n", INT8_SHAPES, ids=lambda v: str(v))
def test_int8_linear_matches_its_plain_version(cuda, m, k, n, dtype):
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    x, q, s, bias = _int8_inputs(cuda, m, k, n, dtype, seed=m + k + n)
    before = qz.launch_counts["int8_linear"]
    devices_before = dict(qz.device_launch_counts)
    got = qz.int8_linear(x, q, s, bias)
    assert qz.launch_counts["int8_linear"] == before + 1
    launched = {
        name: c - devices_before[name]
        for name, c in qz.device_launch_counts.items() if c != devices_before[name]
    }
    # bf16 on the tensor-core kernel, fp32 on the CUDA-core one
    assert launched == {
        torch.bfloat16: {"int8_linear_tc_kernel": 1},
        torch.float32: {"int8_linear_kernel<float>": 1},
    }[dtype]
    want = qz.int8_linear_plain(x, q, s, bias)
    assert got.dtype == dtype and got.shape == (m, n)
    assert _close(got, want, BF16_TOL if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
def test_int8_linear_is_deterministic(cuda):
    """Each output is written once after a warp-shuffle reduction, with no
    atomics: two launches agree bit for bit."""
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    x, q, s, bias = _int8_inputs(cuda, 8, 8192, 4096, torch.bfloat16, seed=1)
    assert torch.equal(qz.int8_linear(x, q, s, bias), qz.int8_linear(x, q, s, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 512, 512), (8, 2048, 512), (8, 8192, 512)], ids=str)
def test_int8_linear_replayed_in_a_cuda_graph_equals_eager(cuda, m, k, n):
    """The bf16 kernel with no cluster, a cluster of 2 and one of 8: it
    allocates nothing and does not synchronise, so a graph may hold it, and
    its fixed summation order makes the replay bit-equal."""
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    x, q, s, bias = _int8_inputs(cuda, m, k, n, torch.bfloat16, seed=2)
    eager = qz.int8_linear(x, q, s, bias)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qz.int8_linear(x, q, s, bias)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = qz.int8_linear(x, q, s, bias)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_int8_linear_refuses_a_misaligned_x(cuda):
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    _, q, s, bias = _int8_inputs(cuda, 4, 64, 16, torch.bfloat16)
    flat = torch.zeros(4 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    before = qz.launch_counts["int8_linear"]
    with pytest.raises(ValueError, match="16-byte"):
        qz.int8_linear(flat[1:].view(4, 64), q, s, bias)
    assert qz.launch_counts["int8_linear"] == before


@pytest.mark.cuda
def test_int8_generate_launches_the_kernel_for_every_quantized_dense(cuda):
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    cfg = wl.ModelConfig(d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=32,
                         dtype=torch.bfloat16, flash_attention=True)
    model = wl.quantize_model(wl.TinyLM(cfg, cuda))
    prompt = torch.randint(0, cfg.vocab_size, (3, 5), device=cuda)
    qz.reset_launch_counts()
    fa.reset_launch_counts()
    out = wl.generate(cfg, model, prompt, 7)
    assert out.shape == (3, 12) and torch.equal(out[:, :5], prompt)
    assert qz.launch_counts["int8_linear"] == (6 * 2 + 1) * 11
    assert set(fa.flash_launch_counts().values()) == {0}  # decode runs no flash kernel
    assert fa.launch_counts["decode_attention"] == 2 * 11  # but its own, a layer a step


def _int8_layer(cuda, k, n, seed):
    """A weight quantized per row as ``quantize_model`` quantizes it (scale
    amax / 127), its bias, in the magnitudes of a trained layer: the
    output of one layer stays O(1) as the input of the next."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn(n, k, device=cuda, generator=gen) / k**0.5
    s = w.abs().amax(1) / 127.0
    q = torch.round(w / s[:, None]).clamp(-127, 127).to(torch.int8)
    bias = (0.1 * torch.randn(n, device=cuda, generator=gen)).bfloat16()
    return q, s, bias


@pytest.mark.cuda
def test_a_dependent_int8_chain_in_a_cuda_graph_equals_eager(cuda):
    """y of one launch is x of the next, three times (K = N = 512, M 8),
    each launch allowed to start before the one ahead has ended. Captured
    in one CUDA graph and replayed, the chain is bit-equal to eager, and
    both are within 2^-7 of the plain chain: no launch read its x before
    the one ahead wrote it."""
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    layers = [_int8_layer(cuda, 512, 512, seed=20 + i) for i in range(3)]
    x = torch.randn(8, 512, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    x = x.bfloat16()

    def chain(linear):
        y = x
        for q, s, bias in layers:
            y = linear(y, q, s, bias)
        return y

    eager = chain(qz.int8_linear)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain(qz.int8_linear)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = chain(qz.int8_linear)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    assert _close(eager, chain(qz.int8_linear_plain), BF16_TOL)


@pytest.mark.cuda
def test_int8_linear_reads_weights_written_just_before_it(cuda):
    """q, s and the bias written by the kernels right before the launch,
    200 times, the last of the three writes rotating: each copy lands
    where junk was just written (the allocator hands the junk's block
    back), so a launch that read any of them into registers before the
    kernel ahead ended would see junk. Every result is bit-equal to the
    launch on the weights at rest."""
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    x, q, s, bias = _int8_inputs(cuda, 8, 512, 512, torch.bfloat16, seed=4)
    want = qz.int8_linear(x, q, s, bias)
    torch.cuda.synchronize()

    def fresh(src, junk, write):
        scratch = torch.full_like(src, junk)
        del scratch
        return write(src)

    writes = {
        "q": lambda: fresh(q, 99, torch.clone),
        "s": lambda: fresh(s, float("nan"), lambda t: t.double().float()),
        "bias": lambda: fresh(bias, float("nan"), lambda t: t.float().bfloat16()),
    }
    order = list(writes)
    got = []
    for i in range(200):
        last = order[i % 3]  # written right before the launch
        inputs = {name: write() for name, write in writes.items() if name != last}
        inputs[last] = writes[last]()
        got.append(qz.int8_linear(x, inputs["q"], inputs["s"], inputs["bias"]))
    torch.cuda.synchronize()
    assert all(torch.equal(y, want) for y in got)


# ------------------------------------------------------------ decode attention


def _decode_inputs(cuda, b, total, h, hd, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, keys, values = (
        torch.randn(shape, device=cuda, generator=gen).to(dtype)
        for shape in ((b, 1, h, hd), (b, total, h, hd), (b, total, h, hd))
    )
    return q, keys, values


#: (b, h, total): 384 rows of 16 heads are 384 blocks or more, past twice
#: the SMs, so each block takes a row's whole prefix; 2 rows of 4 heads
#: split the prefix over blocks and merge (past the first few positions).
DECODE_SHAPES = {"whole": (384, 16, 300), "split": (2, 4, 300)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("index", [0, 150, 299], ids=lambda i: f"i{i}")
@pytest.mark.parametrize("hd", [16, 64, 80, 256], ids=lambda d: f"d{d}")
@pytest.mark.parametrize("plan", sorted(DECODE_SHAPES))
def test_decode_attention_matches_its_plain_version(cuda, plan, hd, index, dtype):
    b, h, total = DECODE_SHAPES[plan]
    q, keys, values = _decode_inputs(cuda, b, total, h, hd, dtype, seed=hd + index)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = fa.decode_plan(b, h, hd, q.element_size(), index + 1, n_sms).splits
    if plan == "whole" or index == 0:
        assert splits == 1
    elif index == total - 1:
        assert splits > 1
    before = dict(fa.device_launch_counts)
    got = fa.decode_attention(q, keys, values, index)
    want = fa.decode_attention_plain(q.float(), keys.float(), values.float(), index)
    assert got.shape == q.shape and got.dtype == dtype
    assert _close(got, want, BF16_TOL if dtype == torch.bfloat16 else 1e-4)
    launched = {
        name: n - before[name] for name, n in fa.device_launch_counts.items() if n != before[name]
    }
    assert launched == {"decode_attention_kernel": 1, **({fa.DECODE_MERGE_KERNEL: 1} if splits > 1 else {})}


@pytest.mark.cuda
@pytest.mark.parametrize("plan", sorted(DECODE_SHAPES))
def test_decode_attention_reads_only_the_written_prefix(cuda, plan):
    """NaN in every position after the index changes no bit of the
    output: the kernel never loads the masked tail."""
    b, h, total = DECODE_SHAPES[plan]
    q, keys, values = _decode_inputs(cuda, b, total, h, 64, torch.bfloat16, seed=7)
    want = fa.decode_attention(q, keys, values, 200)
    keys[:, 201:] = float("nan")
    values[:, 201:] = float("nan")
    got = fa.decode_attention(q, keys, values, 200)
    assert torch.isfinite(got.float()).all() and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", sorted(DECODE_SHAPES))
def test_decode_attention_is_deterministic(cuda, plan):
    b, h, total = DECODE_SHAPES[plan]
    q, keys, values = _decode_inputs(cuda, b, total, h, 64, torch.bfloat16, seed=3)
    first = fa.decode_attention(q, keys, values, 250)
    assert all(torch.equal(fa.decode_attention(q, keys, values, 250), first) for _ in range(3))


@pytest.mark.cuda
def test_decode_attention_refuses_a_cache_it_cannot_read_in_place(cuda):
    q, keys, values = _decode_inputs(cuda, 2, 16, 4, 64, torch.bfloat16, seed=1)
    before = fa.launch_counts["decode_attention"]
    with pytest.raises(ValueError, match="contiguous"):
        fa.decode_attention(q, keys.transpose(1, 2).contiguous().transpose(1, 2), values, 3)
    assert fa.launch_counts["decode_attention"] == before


@pytest.mark.cuda
def test_int8_generate_runs_decode_attention_a_layer_a_step_and_matches_the_cpu(cuda):
    """fp32 int8 serving of a 2-layer model on the card (the fp32 int8 and
    decode kernels) and on the CPU (their plain versions), from the same
    float weights: the same greedy tokens, and one decode_attention launch
    a layer a step."""
    from k8s_operator_libs_tpu_torch.tpu import quantize as qz

    cfg = wl.ModelConfig(d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=40)
    float_cpu = wl.TinyLM(cfg, "cpu", seed=5)
    float_card = wl.TinyLM(cfg, cuda)
    float_card.load_state_dict(float_cpu.state_dict())
    prompt = torch.randint(0, cfg.vocab_size, (3, 6), generator=torch.Generator().manual_seed(5))
    want = wl.generate(cfg, wl.quantize_model(float_cpu), prompt, 30, device="cpu")
    served = wl.quantize_model(float_card)
    fa.reset_launch_counts()
    qz.reset_launch_counts()
    got = wl.generate(cfg, served, prompt.to(cuda), 30, device=cuda)
    assert fa.launch_counts["decode_attention"] == cfg.n_layers * 35
    assert fa.device_launch_counts["decode_attention_kernel"] == cfg.n_layers * 35
    assert set(fa.flash_launch_counts().values()) == {0}
    assert torch.equal(got.cpu(), want)
