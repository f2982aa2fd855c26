"""The port's ring attention (k8s_operator_libs_tpu_torch/tpu/ring_attention.py)
against the JAX package's ``ring_attention_sharded`` on its (data 2, seq 4)
mesh, on the same global numpy inputs.

The port runs over four gloo ranks, real processes started once for the
file by the port's worker (``dist_worker ring``); every case runs in that
one group.  Each rank returns its local output and gradients for a fixed
random cotangent, which the JAX side gets too (``jax.vjp``).  Tolerances
are the JAX suite's: the einsum ring 1e-5 forward and 1e-4 gradients
(``tests/test_tpu_integration.py:530-569``), the flash rings 1e-4 forward
and 1e-2 gradients (``:1044-1079``, ``:1113-1162``); the flash pairs run
the kernels' plain versions here and Pallas in interpret mode there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from k8s_operator_libs_tpu.tpu import ring_attention as jra
from k8s_operator_libs_tpu_torch.hack.dist_worker import Ranks
from k8s_operator_libs_tpu_torch.tpu import ring_attention as ra

N = 4  # ranks on the seq axis
DEADLINE = 240

#: name -> (port function, causal, block, (b, s, h, d), seed, fwd tol, grad tol,
#: JAX keyword arguments of ring_attention_sharded)
CASES = {
    "einsum-causal": ("ring_attention", True, 0, (4, 32, 4, 16), 0, 1e-5, 1e-4, {}),
    "einsum": ("ring_attention", False, 0, (4, 32, 4, 16), 3, 1e-5, 1e-4, {}),
    "flash-causal": ("ring_flash_attention", True, 32, (2, 128, 4, 16), 0, 1e-4, 1e-2,
                     {"use_flash": True, "flash_block": 32}),
    "flash": ("ring_flash_attention", False, 32, (2, 128, 4, 16), 1, 1e-4, 1e-2,
              {"use_flash": True, "flash_block": 32}),
    "zigzag": ("zigzag_ring_flash_attention", True, 16, (2, 128, 4, 16), 5, 1e-4, 1e-2,
               {"use_flash": True, "flash_block": 16, "layout": "zigzag"}),
}


#: grouped-query attention through both flash rings: 4 query heads on 2
#: K/V heads, held to the plain oracle (no JAX ring takes fewer K/V heads)
GQA = {"gqa-causal": ("ring_flash_attention", 32), "gqa-zigzag": ("zigzag_ring_flash_attention", 16)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]  # q, k, v, dO


def _gqa_inputs():
    rng = np.random.default_rng(9)
    mk = lambda heads: rng.standard_normal((2, 128, heads, 16)).astype(np.float32)  # noqa: E731
    return mk(4), mk(2), mk(2), mk(4)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case over one group of four gloo ranks: by case, the global
    output and gradients (the ranks' shards put back in natural order),
    and each rank's JSON line."""
    tmp = tmp_path_factory.mktemp("ring")
    cases = []
    for name, (fn, causal, block, shape, seed, *_) in CASES.items():
        q, k, v, do = (torch.from_numpy(x) for x in _inputs(shape, seed))
        cases.append({"name": name, "fn": fn, "causal": causal, "block": block,
                      "q": q, "k": k, "v": v, "do": do})
    q, k, v, do = (torch.from_numpy(x) for x in _gqa_inputs())
    for name, (fn, block) in GQA.items():
        cases.append({"name": name, "fn": fn, "causal": True, "block": block,
                      "q": q, "k": k, "v": v, "do": do})
    torch.save({"cases": cases}, tmp / "inputs.pt")
    args = ["ring", "--device", "cpu", "--inputs", str(tmp / "inputs.pt"),
            "--out", str(tmp / "rank{rank}.pt")]
    with Ranks(N, args) as ranks:
        lines = ranks.results(DEADLINE)
    shards = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(N)]
    out = {}
    for name, fn in [(name, case[0]) for name, case in CASES.items()] + [
            (name, fn) for name, (fn, _) in GQA.items()]:
        whole = {}
        for key in ("out", "dq", "dk", "dv"):
            x = torch.cat([s[name][key] for s in shards], dim=1)
            whole[key] = (ra.from_zigzag(x, N) if fn.startswith("zigzag") else x).numpy()
        out[name] = whole
    return out, lines


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:8]).reshape(2, N), axis_names=("data", "seq"))


def _jax_ref(mesh, name):
    """(out, dq, dk, dv) of the JAX ring on the case's inputs and cotangent."""
    _, causal, _, shape, seed, _, _, kwargs = CASES[name]
    q, k, v, do = _inputs(shape, seed)
    sh = NamedSharding(mesh, P("data", "seq", None, None))

    def out_and_grads(*args):
        out, vjp = jax.vjp(
            lambda a, b, c: jra.ring_attention_sharded(a, b, c, mesh, "seq", causal=causal, **kwargs),
            *args[:3],
        )
        return (out, *vjp(args[3]))

    # one compiled program: op-by-op dispatch of the ring takes ~10x longer
    return jax.jit(out_and_grads)(*(jax.device_put(jnp.asarray(x), sh) for x in (q, k, v, do)))


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_gradients_match_the_jax_ring(port, mesh, name):
    tensors, _ = port
    *_, fwd_tol, grad_tol, _ = CASES[name]
    ref = dict(zip(("out", "dq", "dk", "dv"), _jax_ref(mesh, name)))
    for key, want in ref.items():
        err = float(np.abs(tensors[name][key] - np.asarray(want)).max())
        assert err < (fwd_tol if key == "out" else grad_tol), (name, key, err)


@pytest.mark.parametrize("name", ["einsum-causal", "flash-causal", "zigzag"])
def test_causal_rings_equal_dense_attention(port, name):
    """Beside the JAX ring, the plain oracle on the whole sequence."""
    tensors, _ = port
    _, causal, _, shape, seed, fwd_tol, grad_tol, _ = CASES[name]
    leaves = [torch.from_numpy(x).requires_grad_() for x in _inputs(shape, seed)[:3]]
    out = ra.dense_reference(*leaves, causal)
    out.backward(torch.from_numpy(_inputs(shape, seed)[3]))
    for key, want in zip(("out", "dq", "dk", "dv"), (out, *(x.grad for x in leaves))):
        err = float(np.abs(tensors[name][key] - want.detach().numpy()).max())
        assert err < (fwd_tol if key == "out" else grad_tol), (name, key, err)


@pytest.mark.parametrize("name", list(GQA))
def test_gqa_flash_rings_equal_dense_attention(port, name):
    """Fewer K/V heads than query heads: the rings' dK/dV are the group
    sums.  Against the plain oracle on the expanded heads, both fp32 on
    the CPU, at 1e-4 forward and gradients."""
    tensors, _ = port
    q, k, v, do = (torch.from_numpy(x) for x in _gqa_inputs())
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ra.dense_reference(leaves[0], *(x.repeat_interleave(2, dim=2) for x in leaves[1:]), True)
    out.backward(do)
    for key, want in zip(("out", "dq", "dk", "dv"), (out, *(x.grad for x in leaves))):
        err = float(np.abs(tensors[name][key] - want.detach().numpy()).max())
        assert err < 1e-4, (name, key, err)


def test_every_rank_reports_gloo_and_the_schedules_pairs(port):
    _, lines = port
    assert [line["rank"] for line in lines] == list(range(N))
    for line in lines:
        assert line["backend"] == "gloo" and line["transport"] == "gloo"
        for name, (fn, causal, *_) in CASES.items():
            row = line["cases"][name]
            # the CPU runs the plain versions: no kernel launch counts
            assert set(row["launches"].values()) == {0} and row["device_launches"] == {}
            if fn != "ring_attention":
                layout = "zigzag" if fn.startswith("zigzag") else "contiguous"
                assert row["pairs"] == len(ra.ring_schedule(N, line["rank"], causal, layout))
    contiguous = [line["cases"]["flash-causal"]["pairs"] for line in lines]
    assert contiguous == [1, 2, 3, 4]  # rank r computes the r+1 blocks at or below it
    assert {line["cases"]["zigzag"]["pairs"] for line in lines} == {2 * N + 1}
    assert {line["cases"]["flash"]["pairs"] for line in lines} == {N}


# -------------------------------------------- TestZigzagRingFlash, ported


def test_permutation_round_trip():
    x = np.arange(2 * 48 * 2 * 3, dtype=np.float32).reshape(2, 48, 2, 3)
    for n in (2, 4):
        z = ra.to_zigzag(torch.from_numpy(x), n)
        assert np.array_equal(z.numpy(), np.asarray(jra.to_zigzag(jnp.asarray(x), n)))
        assert not np.array_equal(z.numpy(), x)
        assert np.array_equal(ra.from_zigzag(z, n).numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        ra.to_zigzag(torch.zeros(1, 6, 1, 1), 2)


def test_schedule_is_balanced():
    """Per ring step every rank computes the same number of zigzag
    sub-pairs (checked against the JAX test's classification, q-chunk >=
    k-chunk computes); contiguous chunks are maximally unbalanced."""
    for n in (2, 4, 8):
        per_rank, contiguous = [], []
        for my in range(n):
            pairs = ra.ring_schedule(n, my, True, "zigzag")
            steps = [sum(1 for p in pairs if p[0] == i) for i in range(n)]
            # the JAX test's count, by chunk ids
            q_ids = (my, 2 * n - 1 - my)
            want = [sum(1 for qc in q_ids for kc in ((my - i) % n, 2 * n - 1 - (my - i) % n) if qc >= kc)
                    for i in range(n)]
            assert steps == want, (n, my)
            per_rank.append(len(pairs))
            contiguous.append(len(ra.ring_schedule(n, my, True)))
        assert len(set(per_rank)) == 1, (n, per_rank)
        assert contiguous == list(range(1, n + 1))  # rank 0 computes 1 pair, rank n-1 n
        assert all(len(ra.ring_schedule(n, my, False)) == n for my in range(n))


def test_schedule_kinds_follow_the_diagonal():
    # contiguous: below the diagonal unmasked, on it causal
    assert ra.ring_schedule(2, 0, True) == [(0, 0, 0, True)]
    assert ra.ring_schedule(2, 1, True) == [(0, 0, 0, True), (1, 0, 0, False)]
    # zigzag, rank 0 of 2 holds chunks (0, 3): step 0 its own (0, 3), step 1 rank 1's (1, 2)
    assert ra.ring_schedule(2, 0, True, "zigzag") == [
        (0, 0, 0, True), (0, 1, 0, False), (0, 1, 1, True), (1, 1, 0, False), (1, 1, 1, False),
    ]
    with pytest.raises(ValueError, match="layout"):
        ra.ring_schedule(2, 0, True, "striped")


def test_block_checks_are_the_jax_functions():
    """Raised before the ring is built: no process group is needed."""
    q = torch.zeros(1, 96, 2, 16)
    with pytest.raises(ValueError, match="divide the local sequence"):
        ra.ring_flash_attention(q, q, q, None, True, 64)
    ra_odd = torch.zeros(1, 7, 2, 16)
    with pytest.raises(ValueError, match="even local sequence"):
        ra.zigzag_ring_flash_attention(ra_odd, ra_odd, ra_odd)
    with pytest.raises(ValueError, match="half-chunk"):
        ra.zigzag_ring_flash_attention(q, q, q, block=32)
