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


def _close(got, want) -> bool:
    err = float((got.float() - want.float()).abs().max())
    return err <= 1e-4 * max(1.0, float(want.float().abs().max()))


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
