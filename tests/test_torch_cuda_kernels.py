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
    assert fa.launch_counts == {name: 2 * 3 for name in fa.launch_counts}


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
    assert set(fa.launch_counts.values()) == {0}  # decode runs no flash kernel
