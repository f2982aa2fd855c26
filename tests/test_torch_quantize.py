"""Weight-only int8 (k8s_operator_libs_tpu_torch/tpu/quantize.py) against
the JAX package's tpu/quantize.py, and the int8 matmul's wrapper on the
CPU.

The flax params of the TinyLM of TestInt8WeightOnlyServing (vocab 128,
d 64, 4 heads, 2 layers, d_ff 128, seq 32) are perturbed by a seeded
numpy draw, so that every leaf, the q/k/v biases included, is non-zero;
the same tree goes through both packages.  ``q`` must match exactly,
``s`` to 1e-7 relative, the error observable to 1e-6, the byte count
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.tpu import quantize as jq
from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu_torch.convert import params_from_jax, params_to_jax
from k8s_operator_libs_tpu_torch.tpu import quantize as qz
from k8s_operator_libs_tpu_torch.tpu import workload as wl

CFG = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=32)
HD = CFG["d_model"] // CFG["n_heads"]


@pytest.fixture(scope="module")
def trees():
    """(flax params as numpy, JAX's quantized tree as numpy)."""
    _, params, _, _ = jwl.create_train_state(jwl.ModelConfig(**CFG))
    rng = np.random.default_rng(0)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape)).astype(np.float32), params
    )
    jax_q = jq.quantize_params_int8(jax.tree.map(jnp.asarray, np_params))
    return np_params, jax.tree.map(np.asarray, jax_q)


def _nodes(tree, prefix=""):
    """path -> leaf or quant node of a nested tree."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict) and not jq._is_quant_node(value):
            out.update(_nodes(value, path + "/"))
        else:
            out[path] = value
    return out


def _port_q(np_params):
    return qz.quantize_params_int8(params_from_jax(np_params), n_heads=CFG["n_heads"])


def test_every_q_equals_jax_and_every_scale_is_within_1e_7(trees):
    np_params, jax_q = trees
    got = _nodes(params_to_jax(_port_q(np_params), CFG["n_heads"]))
    want = _nodes(jax_q)
    assert set(got) == set(want)
    n_quantized = 0
    for path, ref in want.items():
        if jq._is_quant_node(ref):
            n_quantized += 1
            assert jq._is_quant_node(got[path]), path
            assert got[path]["q"].dtype == np.int8 and np.array_equal(got[path]["q"], ref["q"]), path
            assert got[path]["s"].shape == ref["s"].shape, path
            np.testing.assert_allclose(got[path]["s"], ref["s"], rtol=1e-7, atol=0, err_msg=path)
        else:
            assert np.array_equal(got[path], ref), path
    assert n_quantized == 2 + 1 + CFG["n_layers"] * 9  # embeds, lm_head, 4 kernels + 3 biases + 2 mlp


def test_trap_qkv_scales_are_shared_across_heads(trees):
    """flax's q/k/v kernel is [d, h, hd] and its bias [h, hd]: the scale
    reduces over d and h (and h for the bias), so it is per hd column,
    shared by every head, not one per row of the torch [h*hd, d] weight."""
    np_params, _ = trees
    qs = _port_q(np_params)
    for name in ("query", "key", "value"):
        w, b = qs[f"block_0.attn.{name}.weight"], qs[f"block_0.attn.{name}.bias"]
        assert tuple(w["s"].shape) == (1, 1, HD) and tuple(w["q"].shape) == (CFG["d_model"],) * 2
        assert qz.is_quant_node(b), "the [h, hd] bias is 2-D in flax: JAX quantizes it"
        assert tuple(b["s"].shape) == (1, HD) and tuple(b["q"].shape) == (CFG["d_model"],)
        q3 = w["q"].float().abs().view(CFG["n_heads"], HD, CFG["d_model"])
        assert (q3.amax(dim=(0, 2)) == 127).all()  # each hd column, over all heads
        assert not (w["q"].float().abs().amax(1) == 127).all()  # not each torch row
    assert tuple(qs["block_0.attn.out.weight"]["s"].shape) == (1, 1, CFG["d_model"])


def test_trap_embedding_scales_per_feature_column(trees):
    np_params, _ = trees
    qs = _port_q(np_params)
    for key, rows in (("embed.embedding", CFG["vocab_size"]), ("pos_embed.embedding", CFG["max_seq_len"])):
        node = qs[key]
        assert tuple(node["q"].shape) == (rows, CFG["d_model"])
        assert tuple(node["s"].shape) == (1, CFG["d_model"])
        assert (node["q"].abs().amax(0) == 127).all()  # every column reaches the clip
    assert tuple(qs["lm_head.weight"]["s"].shape) == (1, CFG["vocab_size"])
    assert (qs["lm_head.weight"]["q"].abs().amax(1) == 127).all()  # per row of [out, in]


def test_one_dimensional_leaves_stay_float(trees):
    np_params, _ = trees
    qs = _port_q(np_params)
    for key in ("ln_f.scale", "ln_f.bias", "block_0.attn.out.bias", "block_1.mlp_up.bias", "lm_head.bias"):
        assert not qz.is_quant_node(qs[key]) and qs[key].dtype == torch.float32, key


def test_error_and_bytes_equal_jax(trees):
    np_params, jax_q = trees
    state = params_from_jax(np_params)
    qs = _port_q(np_params)
    want = jq.quantization_error(jax.tree.map(jnp.asarray, np_params), jax_q)
    assert 0.0 < want < 0.02
    assert abs(qz.quantization_error(state, qs) - want) < 1e-6
    assert qz.quantized_bytes(qs) == jq.quantized_bytes(jax_q)
    fp_bytes = sum(t.numel() * t.element_size() for t in state.values())
    assert qz.quantized_bytes(qs) < 0.4 * fp_bytes


def test_a_numpy_state_and_a_model_quantize_like_the_state(trees):
    """A state dict with numpy leaves (as from a checkpoint read without
    torch) must quantize, not serve float with error 0; a TinyLM carries
    its own head count."""
    np_params, _ = trees
    state = params_from_jax(np_params)
    np_state = {k: v.numpy() for k, v in state.items()}
    from_np = qz.quantize_params_int8(np_state, n_heads=CFG["n_heads"])
    assert any(qz.is_quant_node(v) for v in from_np.values())
    assert 0.0 < qz.quantization_error(np_state, from_np) < 0.02
    model = wl.TinyLM(wl.ModelConfig(**CFG), device="cpu")
    model.load_state_dict(state)
    from_model = qz.quantize_params_int8(model)
    tensors = lambda v: list(v.values()) if qz.is_quant_node(v) else [v]  # noqa: E731
    for key, node in _port_q(np_params).items():
        for other in (from_np[key], from_model[key]):
            assert all(torch.equal(a, b) for a, b in zip(tensors(node), tensors(other))), key
    with pytest.raises(ValueError, match="n_heads"):
        qz.quantize_params_int8(state)


def test_a_jax_quantized_tree_round_trips_through_the_port_exactly(trees):
    _, jax_q = trees
    state = params_from_jax(jax_q)
    assert state["block_0.attn.query.weight"]["q"].dtype == torch.int8
    back, want = _nodes(params_to_jax(state, CFG["n_heads"])), _nodes(jax_q)
    assert set(back) == set(want)
    for path, ref in want.items():
        pairs = zip(back[path].values(), ref.values()) if jq._is_quant_node(ref) else [(back[path], ref)]
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_dequantize_equals_jax(trees, dtype):
    _, jax_q = trees
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jq.dequantize_params(jax.tree.map(jnp.asarray, jax_q), jdt)
    ))
    got = qz.dequantize_params(params_from_jax(jax_q), dtype)
    for key, ref in want.items():
        assert torch.equal(got[key].float(), ref), key


def test_scale_like_broadcasts_per_row_per_head_and_per_column():
    s = torch.tensor([[[1.0, 2.0]]])  # [1, 1, hd=2], 3 heads
    q = torch.zeros(6, 4, dtype=torch.int8)
    assert qz.scale_like("b.attn.query.weight", q, s).flatten().tolist() == [1, 2] * 3
    assert tuple(qz.scale_like("embed.embedding", q[:, :2], s).shape) == (1, 2)
    with pytest.raises(ValueError, match="tile"):
        qz.scale_like("x.weight", torch.zeros(5, 4, dtype=torch.int8), s)


def test_int8_linear_on_the_cpu_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.integers(-127, 128, (33, 80)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 1e-2, 33).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 5, 80)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(33).astype(np.float32))
    qz.reset_launch_counts()
    y = qz.int8_linear(x, q, s, bias)
    assert y.shape == (3, 5, 33) and qz.launch_counts == {"int8_linear": 0}
    assert set(qz.device_launch_counts.values()) == {0}
    want = x.double() @ (q.double() * s.double()[:, None]).T + bias.double()
    assert float((y.double() - want).abs().max()) < 1e-5
    yb = qz.int8_linear(x.bfloat16(), q, s, bias.bfloat16())  # the weight rounds to bf16
    wb = (q.float() * s[:, None]).bfloat16().float()
    ref = x.bfloat16().float() @ wb.T + bias.bfloat16().float()
    assert yb.dtype == torch.bfloat16
    assert float((yb.float() - ref).abs().max()) <= 2.0**-7 * float(ref.abs().max())
    assert qz.launch_counts == {"int8_linear": 0} and set(qz.device_launch_counts.values()) == {0}


def test_int8_kernel_input_checks_reject_what_the_kernel_does_not_take():
    q = torch.zeros(16, 32, dtype=torch.int8)
    s = torch.ones(16)
    x = torch.zeros(4, 32)
    qz._check_kernel_inputs(x, q, s, torch.zeros(16))
    with pytest.raises(ValueError, match="dtype"):
        qz._check_kernel_inputs(x.half(), q, s, None)
    with pytest.raises(ValueError, match="int8"):
        qz._check_kernel_inputs(x, q.float(), s, None)
    with pytest.raises(ValueError, match="int8"):
        qz._check_kernel_inputs(torch.zeros(4, 31), q, s, None)
    with pytest.raises(ValueError, match="fp32"):
        qz._check_kernel_inputs(x, q, s.double(), None)
    with pytest.raises(ValueError, match="bias"):
        qz._check_kernel_inputs(x, q, s, torch.zeros(16).bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        qz._check_kernel_inputs(torch.zeros(32, 4).T, q, s, None)
    # x starting 4 bytes into its storage: refused, never read past a row
    flat = torch.zeros(4 * 32 + 1)
    with pytest.raises(ValueError, match="16-byte"):
        qz._check_kernel_inputs(flat[1:].view(4, 32), q, s, None)


# ------------------------------------------------ the bf16 kernel's plan

#: (M, K, N) of every int8 matmul of a decode step at the smoke config
#: (q/k/v/out, mlp_up and lm_head, mlp_down), at batch 8
_SMOKE = dict(d=512, ff=2048, vocab=2048)
DECODE_SHAPES = [(8, 512, 512), (8, 512, 2048), (8, 2048, 512), (8, 512, 2048)]
#: M 1 and 13, M 16 and 17, ragged K (K 77 takes byte loads) and N, a K
#: that 16 slices cut unevenly, the long shape, clusters of 4 and 8, and
#: the smallest shape
PLAN_SHAPES = DECODE_SHAPES + [
    (1, 512, 2048), (13, 2048, 512), (16, 512, 512), (17, 2048, 2048), (8, 80, 33),
    (13, 77, 40), (8, 512, 2047), (8, 1040, 512), (8, 8192, 8192), (8, 4096, 512),
    (8, 8192, 512), (1, 1, 1),
]
#: H100 SXM, H100 PCIe, and a small card
SM_COUNTS = [132, 114, 16]


def test_the_decode_shapes_are_the_smoke_config_s():
    from k8s_operator_libs_tpu_torch.tpu import smoke

    cfg = smoke.smoke_config(torch.device("cpu"))
    assert (cfg.d_model, cfg.d_ff, cfg.vocab_size) == tuple(_SMOKE.values())
    d, ff, vocab = _SMOKE.values()
    assert DECODE_SHAPES == [(8, d, d), (8, d, ff), (8, ff, d), (8, d, vocab)]


@pytest.mark.parametrize("n_sms", SM_COUNTS)
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES, ids=str)
def test_int8_plan_k_slices_cover_k_exactly_once_in_order(m, k, n, n_sms):
    plan = qz.int8_plan(m, k, n, n_sms)
    assert len(plan.k_slices) == plan.cluster * plan.k_warps
    assert plan.k_slices[0][0] == 0 and plan.k_slices[-1][1] == k
    for (_, end), (begin, _) in zip(plan.k_slices, plan.k_slices[1:]):
        assert end == begin
    for begin, end in plan.k_slices:
        assert begin < end  # every warp has work
        assert begin % qz.INT8_K_CHUNK == 0  # whole chunks but the last
    assert sorted(kk for b, e in plan.k_slices for kk in range(b, e)) == list(range(k))


@pytest.mark.parametrize("n_sms", SM_COUNTS)
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES, ids=str)
def test_int8_plan_clusters_divide_the_grid_and_tile_every_row(m, k, n, n_sms):
    plan = qz.int8_plan(m, k, n, n_sms)
    assert plan.cluster in (1, 2, 4, 8) and 1 <= plan.k_warps <= 8
    gx, gy = plan.grid
    assert gx % plan.cluster == 0
    assert (gx // plan.cluster) * plan.rows_per_block >= n > (gx // plan.cluster - 1) * 16
    assert gy * qz.INT8_TILE_M >= m > (gy - 1) * qz.INT8_TILE_M
    assert plan.rows_per_block == qz.INT8_TILE_ROWS == 16


@pytest.mark.parametrize("n_sms", [132, 114])
@pytest.mark.parametrize("m,k,n", DECODE_SHAPES + [(1, 512, 2048), (13, 2048, 512)], ids=str)
def test_int8_plan_puts_all_of_q_in_flight_at_every_decode_shape(m, k, n, n_sms):
    """Each warp's slice fits in its ring, so every byte of q is requested
    as the kernel starts."""
    plan = qz.int8_plan(m, k, n, n_sms)
    assert max(e - b for b, e in plan.k_slices) <= qz.INT8_RING_CHUNKS * qz.INT8_K_CHUNK


def test_int8_plan_at_the_smoke_decode_shapes():
    """The plans the main path launches on an H100 SXM (132 SMs): no
    cluster where 8 warps of one block hold all of K; a cluster of 2 at
    K 2048, where they would each walk 4 chunks."""
    got = {(k, n): qz.int8_plan(8, k, n, 132) for _, k, n in DECODE_SHAPES}
    assert {kn: (p.cluster, p.k_warps, p.grid) for kn, p in got.items()} == {
        (512, 512): (1, 8, (32, 1)),
        (512, 2048): (1, 8, (128, 1)),
        (2048, 512): (2, 8, (64, 1)),
    }


@pytest.mark.parametrize("n_sms", SM_COUNTS)
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES, ids=str)
def test_int8_plan_clusters_only_small_grids_whose_slices_overflow_the_ring(m, k, n, n_sms):
    plan = qz.int8_plan(m, k, n, n_sms)
    blocks_per_cluster_grid = plan.blocks // plan.cluster
    if plan.cluster > 1:
        half = plan.cluster // 2  # the cluster before the last doubling
        assert blocks_per_cluster_grid * half < n_sms
        assert -(-k // qz.INT8_K_CHUNK) > qz.INT8_RING_CHUNKS * plan.k_warps * half
    assert plan.k_warps == min(8 if blocks_per_cluster_grid < n_sms else 4, -(-k // 64))


def test_int8_plan_forms_every_cluster_size():
    got = {(k, n): qz.int8_plan(8, k, n, 132) for k, n in
           [(512, 512), (2048, 512), (4096, 512), (8192, 512), (8192, 8192)]}
    assert {kn: (p.cluster, p.k_warps) for kn, p in got.items()} == {
        (512, 512): (1, 8), (2048, 512): (2, 8), (4096, 512): (4, 8), (8192, 512): (8, 8),
        (8192, 8192): (1, 4),
    }


def test_int8_plan_splits_unevenly_when_the_chunks_do_not_divide():
    plan = qz.int8_plan(8, 1040, 512, 132)  # 17 chunks of 64 (the last 16 wide)
    assert (plan.cluster, plan.k_warps) == (2, 8)
    assert [e - b for b, e in plan.k_slices] == [64] * 15 + [64 + 16]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES, ids=str)
def test_int8_plan_is_a_pure_function_of_the_shape_and_the_sm_count(m, k, n):
    plan = qz.int8_plan(m, k, n, 132)
    qz.int8_plan(m + 1, k, n, 114)  # another plan in between changes nothing
    assert plan == qz.int8_plan.__wrapped__(m, k, n, 132) == qz.int8_plan(m, k, n, 132)


def test_int8_plan_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="n_sms"):
        qz.int8_plan(8, 512, 512, 0)
    with pytest.raises(ValueError, match=">= 1"):
        qz.int8_plan(0, 512, 512, 132)
