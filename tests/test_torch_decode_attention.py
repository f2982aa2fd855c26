"""Decode attention on the CPU: the plain version of the decode kernel
against the dense attention it replaces, the wrapper's refusals, the
launch plan the wrapper hands the kernel, and the decode loop's use of it.
The kernel itself runs only on the card (tests/test_torch_cuda_kernels.py).
"""

import itertools

import pytest
import torch

from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa
from k8s_operator_libs_tpu_torch.tpu import workload as wl

#: SMs of an H100 SXM.
H100_SMS = 132


def _cache(b=3, total=9, h=4, hd=16, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, keys, values = (
        torch.randn(shape, generator=gen).to(dtype)
        for shape in ((b, 1, h, hd), (b, total, h, hd), (b, total, h, hd))
    )
    return q, keys, values


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_plain_version_is_the_masked_dense_attention_at_every_index(dtype):
    """Bit for bit what the decode step computed before the kernel:
    ``_attend`` over the whole cache, the positions after the index masked."""
    q, keys, values = _cache(dtype=dtype)
    for index in range(keys.shape[1]):
        visible = torch.arange(keys.shape[1]) <= index
        want = wl._attend(q, keys, values, visible)
        assert torch.equal(fa.decode_attention_plain(q, keys, values, index), want)
        assert torch.equal(fa.decode_attention(q, keys, values, index), want)


def test_the_masked_tail_weighs_exactly_nothing():
    """What lets the kernel read only positions 0..index: junk after the
    index changes no bit, and attention over the prefix alone, unmasked,
    is the same function up to the order of its sums."""
    q, keys, values = _cache(total=12, seed=1)
    for index in range(keys.shape[1]):
        want = fa.decode_attention_plain(q, keys, values, index)
        junk_k, junk_v = keys.clone(), values.clone()
        junk_k[:, index + 1:] = 1e4
        junk_v[:, index + 1:] = -3e4
        assert torch.equal(fa.decode_attention_plain(q, junk_k, junk_v, index), want)
        prefix = wl._attend(q, keys[:, :index + 1], values[:, :index + 1],
                            torch.ones(index + 1, dtype=torch.bool))
        torch.testing.assert_close(prefix, want, rtol=1e-6, atol=1e-6)


def _refuse(monkeypatch, match, q, keys, values, index):
    """The wrapper raises ValueError before it routes to a kernel or to
    the plain version."""
    def never(*args):
        raise AssertionError("routed past the checks")

    monkeypatch.setattr(fa, "_decode_attention_cuda", never)
    monkeypatch.setattr(fa, "decode_attention_plain", never)
    with pytest.raises(ValueError, match=match):
        fa.decode_attention(q, keys, values, index)


@pytest.mark.parametrize("index", [-1, 9, 100], ids=lambda i: f"i{i}")
def test_the_wrapper_refuses_an_index_outside_the_cache(monkeypatch, index):
    _refuse(monkeypatch, "index", *_cache(total=9), index)


@pytest.mark.parametrize("hd", [264, 512], ids=lambda d: f"d{d}")
def test_the_wrapper_refuses_a_head_dim_over_256(monkeypatch, hd):
    _refuse(monkeypatch, "head_dim", *_cache(h=1, hd=hd), 0)


@pytest.mark.parametrize("hd,dtype", [(6, torch.float32), (12, torch.bfloat16)], ids=str)
def test_the_wrapper_refuses_a_head_row_of_partial_16_byte_chunks(monkeypatch, hd, dtype):
    _refuse(monkeypatch, "16-byte", *_cache(hd=hd, dtype=dtype), 0)


@pytest.mark.parametrize("case", ["q_heads", "q_positions", "q_batch", "values", "keys_3d"])
def test_the_wrapper_refuses_mismatched_shapes(monkeypatch, case):
    q, keys, values = _cache()
    bad = {
        "q_heads": (q[:, :, :2], keys, values),
        "q_positions": (torch.cat([q, q], 1), keys, values),
        "q_batch": (q[:2], keys, values),
        "values": (q, keys, values[:, :5]),
        "keys_3d": (q, keys[0], values[0]),
    }[case]
    _refuse(monkeypatch, "shape|!=", *bad, 0)


@pytest.mark.parametrize("case", ["keys", "values", "float16", "float64"])
def test_the_wrapper_refuses_mismatched_or_unsupported_dtypes(monkeypatch, case):
    q, keys, values = _cache()
    bad = {
        "keys": (q, keys.bfloat16(), values),
        "values": (q, keys, values.bfloat16()),
        "float16": (q.half(), keys.half(), values.half()),
        "float64": (q.double(), keys.double(), values.double()),
    }[case]
    _refuse(monkeypatch, "dtype", *bad, 0)


def test_the_plain_route_counts_no_launch():
    fa.reset_launch_counts()
    fa.decode_attention(*_cache(), 4)
    assert fa.launch_counts["decode_attention"] == 0
    assert set(fa.device_launch_counts.values()) == {0}


def test_the_serving_cell_takes_whole_prefixes_and_gpt2_xl_at_b8_splits():
    """GPT-2 medium at b 512 (the benchmark's decode cell): a block a row
    of all 16 heads, 128 threads, 4 positions a stage (48 KB in three),
    no split.  GPT-2 XL at b 8: 8 blocks of 25 heads, so the prefix of
    256 is split in 16 parts of 16."""
    cell = fa.decode_plan(512, 16, 64, 2, 256, H100_SMS)
    assert cell == fa.DecodePlan(width=64, heads=16, groups=1, threads=128, tile=4, splits=1,
                                 split_len=256)
    assert 3 * 2 * cell.tile * cell.heads * 64 * 2 == 48 * 1024
    xl = fa.decode_plan(8, 25, 64, 2, 256, H100_SMS)
    assert (xl.heads, xl.groups, xl.threads, xl.tile) == (25, 1, 224, 4)
    assert (xl.splits, xl.split_len) == (16, 16)
    assert fa.decode_plan(8, 25, 64, 2, 1, H100_SMS).splits == 1  # one position: one part


@pytest.mark.parametrize("b", [1, 2, 8, 64, 512], ids=lambda b: f"b{b}")
def test_every_plan_is_one_the_kernel_takes(b):
    """What ``decode_attention`` in csrc/decode_attention.cu checks, and
    what its blocks assume, over heads, head dims, dtypes and prefixes:
    every head in a group, threads whole warps of at most 256, whole
    groups of four positions a stage, shared memory within the SM's, no
    split empty, and a split only where the rows' blocks leave the card
    less than twice full."""
    for h, hd, elem, n in itertools.product(
        [1, 4, 16, 25, 48, 96], [8, 16, 64, 80, 128, 256], [2, 4], [1, 2, 5, 17, 100, 512]
    ):
        _check_plan(fa.decode_plan(b, h, hd, elem, n, H100_SMS), b, h, hd, elem, n)


def _check_plan(plan, b, h, hd, elem, n):
    assert plan.width == fa.padded_head_dim(hd)
    lanes = plan.width // max(plan.width // 32, 16 // elem)
    assert lanes in (2, 4, 8, 16, 32)
    assert plan.groups * plan.heads >= h > (plan.groups - 1) * plan.heads
    assert plan.threads % 32 == 0 and plan.heads * lanes <= plan.threads <= 256
    assert plan.tile % 4 == 0 and 4 <= plan.tile <= 32
    assert 3 * 2 * plan.tile * plan.heads * hd * elem <= 226 * 1024
    assert (plan.splits - 1) * plan.split_len < n <= plan.splits * plan.split_len
    assert plan.split_len % plan.tile == 0 or plan.splits == 1
    if b * plan.groups >= 2 * H100_SMS:
        assert plan.splits == 1
    assert plan.splits <= max(1, -(-2 * H100_SMS // (b * plan.groups)))


def test_decode_runs_the_decode_attention_a_layer_a_step(monkeypatch):
    """``generate`` attends through ``decode_attention`` once a layer a
    step, at the index the step wrote, over the layer's cache in place."""
    cfg = wl.ModelConfig(n_layers=3, d_model=32, n_heads=4, d_ff=64, max_seq_len=16)
    model = wl.TinyLM(cfg, device="cpu")
    calls = []

    def spy(q, keys, values, index):
        calls.append((index, keys.shape))
        return fa.decode_attention(q, keys, values, index)

    monkeypatch.setattr(wl, "decode_attention", spy)
    out = wl.greedy_generate(cfg, model, torch.zeros(2, 3, dtype=torch.long), 5, device="cpu")
    assert out.shape == (2, 8)
    assert [index for index, _ in calls] == [i for i in range(7) for _ in range(3)]
    assert {shape for _, shape in calls} == {(2, 8, 4, 8)}
