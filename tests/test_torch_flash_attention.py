"""The port's flash attention (k8s_operator_libs_tpu_torch/tpu/
flash_attention.py) against the JAX package's.

The same numpy inputs go through the JAX function (the Pallas kernels in
interpret mode, as tests/test_tpu_integration.py::TestFlashAttention runs
them on the CPU) and through the port, whose wrappers run the kernels'
plain PyTorch versions for CPU tensors.  Tolerances are the JAX suite's:
1e-5 on outputs, 1e-4 on fused-backward gradients, 1e-3 on GQA/MQA
gradients.  The CUDA kernels themselves are compared with their plain
versions on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_operator_libs_tpu.tpu import flash_attention as jfa
from k8s_operator_libs_tpu.tpu.ring_attention import dense_reference as jax_dense
from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
from k8s_operator_libs_tpu_torch.tpu.ring_attention import _NEG, dense_reference


def _arrays(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _torch(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _max_err(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max())


def _jax_grads(fn, arrays):
    """Gradients of sum(fn(q, k, v) ** 2) in JAX."""
    return jax.grad(
        lambda a, b, c: (fn(a, b, c) ** 2).sum(), argnums=(0, 1, 2)
    )(*(jnp.asarray(x) for x in arrays))


def _torch_grads(fn, arrays):
    leaves = _torch(arrays, grad=True)
    (fn(*leaves) ** 2).sum().backward()
    return [x.grad for x in leaves]


@pytest.fixture(scope="module")
def qkv256():
    """b 2, s 256, h 4, d 64 — TestFlashAttention._qkv()."""
    return _arrays((2, 256, 4, 64), seed=0)


@pytest.fixture(scope="module")
def jax_dense_256(qkv256):
    return {
        causal: np.asarray(jax_dense(*(jnp.asarray(x) for x in qkv256), causal))
        for causal in (True, False)
    }


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_jax_flash_and_dense(causal, qkv256, jax_dense_256):
    out_jax = jfa.flash_attention(
        *(jnp.asarray(x) for x in qkv256), causal, 128, 128, True
    )
    out = fa.flash_attention(*_torch(qkv256), causal, 128, 128)
    assert _max_err(out, out_jax) < 1e-5
    assert _max_err(out, jax_dense_256[causal]) < 1e-5
    assert _max_err(dense_reference(*_torch(qkv256), causal), jax_dense_256[causal]) < 1e-5


@pytest.mark.parametrize("bq,bk", [(64, 128), (128, 64)])
def test_uneven_q_k_blocks(bq, bk, qkv256, jax_dense_256):
    out = fa.flash_attention(*_torch(qkv256), True, bq, bk)
    assert _max_err(out, jax_dense_256[True]) < 1e-5


@pytest.fixture(scope="module")
def qkv128():
    return _arrays((2, 128, 4, 64), seed=2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", [(64, 64), (32, 64), (64, 32)])
def test_fused_backward_matches_jax_fused(causal, bq, bk, qkv128):
    """The fused backward (dQ and dK/dV kernels' plain versions) against
    JAX's fused Pallas backward in interpret mode."""
    gj = _jax_grads(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal, bq, bk, True), qkv128
    )
    gt = _torch_grads(lambda a, b, c: fa.flash_attention(a, b, c, causal, bq, bk), qkv128)
    for a, b in zip(gt, gj):
        assert _max_err(a, b) < 1e-4, (causal, bq, bk)


@pytest.mark.parametrize("hk", [2, 1], ids=["gqa", "mqa"])
def test_gqa_and_mqa_match_jax(hk):
    """k/v carry fewer heads than q: the kernels index K/V row bh // g and
    the backward group-sums the per-query-head dK/dV partials."""
    b, s, h, d = 2, 128, 8, 16
    rng = np.random.default_rng(7 + hk)
    arrays = [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))
    ]
    jargs = [jnp.asarray(x) for x in arrays]
    out_jax = jfa.flash_attention(*jargs, True, 64, 64, True)
    rep = lambda x: jnp.repeat(x, h // hk, axis=2)  # noqa: E731
    ref = jax_dense(jargs[0], rep(jargs[1]), rep(jargs[2]), True)
    out = fa.flash_attention(*_torch(arrays), True, 64, 64)
    assert _max_err(out, out_jax) < 1e-5
    assert _max_err(out, ref) < 1e-5
    gj = _jax_grads(lambda a, b_, c: jfa.flash_attention(a, b_, c, True, 64, 64, True), arrays)
    gt = _torch_grads(lambda a, b_, c: fa.flash_attention(a, b_, c, True, 64, 64), arrays)
    for a, b_ in zip(gt, gj):
        assert a.shape == b_.shape
        assert _max_err(a, b_) < 1e-3, hk


def test_indivisible_heads_rejected():
    q, k = _torch(_arrays((2, 128, 8, 16), seed=1, n=1) + _arrays((2, 128, 3, 16), seed=2, n=1))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k, True, 64, 64)


def test_recompute_backward_matches_fused_and_jax(qkv128):
    """backward="recompute" differentiates dense attention and agrees
    with the fused default and with JAX's recompute."""
    fused = _torch_grads(lambda a, b, c: fa.flash_attention(a, b, c, True, 64, 64), qkv128)
    recompute = _torch_grads(
        lambda a, b, c: fa.flash_attention(a, b, c, True, 64, 64, "recompute"), qkv128
    )
    gj = _jax_grads(
        lambda a, b, c: jfa.flash_attention(a, b, c, True, 64, 64, True, "recompute"),
        qkv128,
    )
    for f, r, j in zip(fused, recompute, gj):
        assert _max_err(f, r) < 1e-4
        assert _max_err(r, j) < 1e-4


def test_recompute_backward_rejects_gqa():
    q, k, v = _torch(
        _arrays((1, 64, 4, 16), seed=3, n=1) + _arrays((1, 64, 2, 16), seed=4, n=2),
        grad=True,
    )
    out = fa.flash_attention(q, k, v, True, 64, 64, "recompute")
    with pytest.raises(ValueError):
        out.sum().backward()


def test_unknown_backward_mode_rejected(qkv128):
    with pytest.raises(ValueError):
        fa.flash_attention(*_torch(qkv128), True, 64, 64, "dense")


def test_indivisible_seq_rejected():
    q, k, v = _torch(_arrays((2, 200, 4, 64), seed=0))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, True, 128, 128)


@pytest.mark.parametrize("s", [127, 255])
def test_attention_fn_pads_indivisible_seq_to_full_block(s):
    """The attention seam pads to a whole block and slices back: exact
    against dense, and equal to the JAX seam."""
    arrays = _arrays((2, s, 4, 64), seed=s)
    jargs = [jnp.asarray(x) for x in arrays]
    out = fa.make_flash_attention_fn(block=128)(*_torch(arrays))
    out_jax = jfa.make_flash_attention_fn(interpret=True, block=128)(*jargs)
    assert out.shape == (2, s, 4, 64)
    assert _max_err(out, jax_dense(*jargs, True)) < 1e-5
    assert _max_err(out, out_jax) < 1e-5


def test_attention_fn_gradient_through_padding_matches_jax():
    """Padding at s 255 (the trainer's teacher-forced length) is exact in
    the backward too: padded query rows get a zero cotangent."""
    arrays = _arrays((1, 255, 2, 32), seed=9)
    gj = _jax_grads(jfa.make_flash_attention_fn(interpret=True, block=128), arrays)
    gt = _torch_grads(fa.make_flash_attention_fn(block=128), arrays)
    for a, b in zip(gt, gj):
        assert _max_err(a, b) < 1e-4


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_lse_with_lse_cotangent_matches_jax(causal):
    """(out, lse) and a non-zero lse cotangent: dvec = rowsum(dO*O) - g_lse."""
    b, s, h, d = 2, 128, 2, 32
    arrays = _arrays((b, s, h, d), seed=11)
    rng = np.random.default_rng(12)
    g_out = rng.standard_normal((b, s, h, d)).astype(np.float32)
    g_lse = rng.standard_normal((b * h, s)).astype(np.float32)
    jargs = [jnp.asarray(x) for x in arrays]
    (out_j, lse_j), vjp = jax.vjp(
        lambda a, b_, c: jfa.flash_attention_lse(a, b_, c, causal, 64, 64, True), *jargs
    )
    gj = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    leaves = _torch(arrays, grad=True)
    out, lse = fa.flash_attention_lse(*leaves, causal, 64, 64)
    assert lse.dtype == torch.float32 and lse.shape == (b * h, s)
    assert _max_err(out, out_j) < 1e-5
    assert _max_err(lse, lse_j) < 1e-5
    gt = torch.autograd.grad((out, lse), leaves, (torch.from_numpy(g_out), torch.from_numpy(g_lse)))
    for a, b_ in zip(gt, gj):
        assert _max_err(a, b_) < 1e-4


def test_plain_versions_match_the_jax_kernels_on_folded_inputs(qkv128):
    """Each kernel's plain version against the JAX forward and fused
    backward at the fold layout [b*h, s, d]: O, lse, dQ, dK, dV."""
    q, k, v = qkv128
    jargs = [jnp.asarray(x) for x in qkv128]
    out_j, lse_j = jfa._flash_forward(*jargs, True, 64, 64, True)
    g = np.random.default_rng(13).standard_normal(q.shape).astype(np.float32)
    dq_j, dk_j, dv_j = jfa._flash_backward(
        *jargs, out_j, lse_j, jnp.asarray(g), True, 64, 64, True
    )
    qf, kf, vf, gf = (fa._fold(torch.from_numpy(x)) for x in (q, k, v, g))
    o, lse = fa.flash_forward_plain(qf, kf, vf, 1, True)
    assert _max_err(fa._unfold(o, 2), out_j) < 1e-5
    assert _max_err(lse, lse_j) < 1e-5
    dvec = (o * gf).sum(-1)
    dq = fa.flash_bwd_dq_plain(qf, kf, vf, gf, lse, dvec, 1, True)
    dk, dv = fa.flash_bwd_dkv_plain(qf, kf, vf, gf, lse, dvec, 1, True)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert _max_err(fa._unfold(got, 2), want) < 1e-4


def _dkv_rounded_as_the_bf16_kernel(qf, kf, vf, dof, lse, dvec, g, causal):
    """dK/dV rounded where flash_bwd_dkv_tc_kernel rounds: bf16 inputs,
    P^T and dS^T to bf16 before their products, fp32 sums, bf16 outputs."""
    probs, ds = fa._probs_and_dscores(
        qf.float(), kf.float(), vf.float(), dof.float(), lse, dvec, g, causal
    )
    bf16 = lambda x: x.bfloat16().float()  # noqa: E731
    dv = torch.bmm(bf16(probs).transpose(1, 2), dof.float())
    dk = torch.bmm(bf16(ds).transpose(1, 2), qf.float())
    return dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hk", [8, 2], ids=["mha", "gqa"])
def test_bf16_dkv_rounding_stays_within_the_card_bound(hk, causal):
    """At the trainer's shape (b 8, s 256, h 8, d 64) the bf16 dK/dV
    kernel's roundings keep it within chip_smoke.py's 2^-7 * max(1, |ref|)
    of the fp32 plain version (itself held to the JAX kernel by
    test_plain_versions_match_the_jax_kernels_on_folded_inputs)."""
    b, s, h, d = 8, 256, 8, 64
    rng = np.random.default_rng(17 + hk)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, hk, d)).astype(np.float32) for _ in range(2))
    qf, kf, vf, dof = (fa._fold(torch.from_numpy(x).bfloat16()) for x in (q, k, v, do))
    fp32 = [t.float() for t in (qf, kf, vf, dof)]
    g = h // hk
    o, lse = fa.flash_forward_plain(*fp32[:3], g, causal)
    dvec = (o * fp32[3]).sum(-1)
    got = _dkv_rounded_as_the_bf16_kernel(qf, kf, vf, dof, lse, dvec, g, causal)
    want = fa.flash_bwd_dkv_plain(*fp32, lse, dvec, g, causal)
    for a, ref in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == (b * h, s, d)
        assert _max_err(a.float(), ref) <= 2.0**-7 * max(1.0, float(ref.abs().max()))
    # the roundings do show: the bf16 result is not the fp32 one
    assert _max_err(got[1].float(), want[1]) > 0


@pytest.mark.parametrize("bq,bk", [(64, 64), (32, 64), (64, 32), (128, 16)])
def test_causal_predicates_match_jax(bq, bk):
    """_causal_needed is the kernels' loop bound: k-tile kj is needed by
    q-tile qi iff its first key is below the tile's end (kv_end in
    csrc/flash_attention.cu); _causal_mask is the JAX mask."""
    for qi in range(4):
        for kj in range(8):
            needed = fa._causal_needed(qi, kj, bq, bk)
            assert needed == jfa._causal_needed(qi, kj, bq, bk)
            assert needed == (kj * bk < qi * bq + bq)
            mask = fa._causal_mask(qi, kj, bq, bk)
            assert np.array_equal(mask.numpy(), np.asarray(jfa._causal_mask(qi, kj, bq, bk)))
            assert needed == bool(mask.any())


def test_mask_value_and_group_size_match_jax():
    from k8s_operator_libs_tpu.tpu.ring_attention import _NEG as jax_neg

    assert _NEG == jax_neg
    q, k = torch.zeros(1, 4, 8, 16), torch.zeros(1, 4, 2, 16)
    assert fa._group_size(q, k) == jfa._group_size(np.zeros(q.shape), np.zeros(k.shape)) == 4
    assert fa._check_blocks(100, 128, 128) == jfa._check_blocks(100, 128, 128)
