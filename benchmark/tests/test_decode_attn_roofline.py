"""The decode attention roofline's count against a shape worked by hand."""

import pytest

from benchmark import cells
from benchmark.measure import roofline as r

ROOT = cells.Path(__file__).resolve().parents[2]
MODEL = {"vocab_size": 10, "d_model": 4, "n_heads": 2, "n_layers": 3, "d_ff": 8, "max_seq_len": 8}
TRAFFIC = {"batch": 2, "total_len": 8, "trace_first_step": 5, "trace_steps": 2}
KERNEL = "void (anonymous namespace)::decode_attention_kernel<__nv_bfloat16, 64>(...)"


def _summary(kernel_s):
    return {"kernel_s": kernel_s, "steps": 2, "busy_s": 1.0, "window_s": 1.0}


def test_the_count_by_hand():
    # steps 5 and 6 attend over 6 and 7 positions, 3 launches each; a launch
    # reads K and V (2 rows x positions x d 4, bf16) and q, and writes o:
    # 2 * (2*2*6*4 + 2*2*4) = 224 and 2 * (2*2*7*4 + 2*2*4) = 256 bytes
    metric = cells.reader(ROOT, "decode_attn_roofline.decode")
    nbytes = 3 * 224 + 3 * 256
    assert metric.launch_bound_s(MODEL, 2, 6) == pytest.approx(224 / r.HBM_BYTES_PER_S)
    summary = _summary({KERNEL: 1e-6, "int8_linear_tc_kernel": 5.0})
    got = metric.read({"trace": summary, "traffic": TRAFFIC, "model": MODEL})
    assert got == pytest.approx(100 * nbytes / r.HBM_BYTES_PER_S / 1e-6)


def test_the_merge_pass_counts_as_the_kernel_s_time():
    metric = cells.reader(ROOT, "decode_attn_roofline.decode")
    whole = metric.read({"trace": _summary({KERNEL: 2e-6}), "traffic": TRAFFIC, "model": MODEL})
    split = metric.read({"trace": _summary({KERNEL: 1e-6, "decode_attention_merge_kernel<float>": 1e-6}),
                         "traffic": TRAFFIC, "model": MODEL})
    assert split == pytest.approx(whole)


@pytest.mark.parametrize("summary", [None, _summary({}), _summary({"int8_linear_tc_kernel": 1.0})],
                         ids=["no trace", "no kernels", "no decode kernel"])
def test_nothing_to_read_without_the_kernel(summary):
    metric = cells.reader(ROOT, "decode_attn_roofline.decode")
    assert metric.read({"trace": summary, "traffic": TRAFFIC, "model": MODEL}) is None
