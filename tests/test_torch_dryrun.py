"""The port's multi-rank dryrun (k8s_operator_libs_tpu_torch/graft_entry.py::
dryrun_multichip), the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``, over four gloo ranks on the CPU.

One job for the file: the dense dp 1 x sp 2 x tp 2 step, the MoE dp 1 x
tp 2 x ep 2 step, gather SP against the ring and the flash ring, flash
against gather under pure data parallelism, and a 2-stage pipeline step.
Its own bounds are the JAX dryrun's (1e-4); here each of its steps is
also held to the JAX package's one-device loss, and to the port's, on the
same weights and batch (1e-4).
"""

import jax.numpy as jnp
import pytest
import torch

from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu_torch import graft_entry
from k8s_operator_libs_tpu_torch.convert import params_to_jax
from k8s_operator_libs_tpu_torch.tpu import workload as wl

N = 4


@pytest.fixture(scope="module")
def losses():
    return graft_entry.dryrun_multichip(N, device="cpu", backend="gloo", timeout=180)


def _one_device_losses(fields, batch: int):
    """(JAX's loss, the port's first-step loss) on the port's seed-0
    weights and the batch of *batch* rows."""
    fields = {**graft_entry.DRYRUN_BASE, **fields}
    cfg = wl.ModelConfig(**fields)
    model, optimizer = wl.create_train_state(cfg, "cpu", seed=0)
    tokens = wl.make_batch(cfg, batch)
    params = params_to_jax(model.state_dict(), cfg.n_heads)
    want = float(jwl.loss_fn(jwl.TinyLM(jwl.ModelConfig(**fields)), params, jnp.asarray(tokens.numpy())))
    return want, float(wl.make_train_step(model, optimizer)(tokens))


def test_dryrun_multichip_on_four_gloo_ranks_passes_every_check(losses):
    assert set(losses) == {"dense", "moe", "gather_sp", "ring", "ring_flash", "gather", "flash", "pipeline"}
    assert all(loss > 0 for loss in losses.values())
    for name in ("ring", "ring_flash"):
        assert abs(losses[name] - losses["gather_sp"]) < graft_entry.DRYRUN_TOL
    assert abs(losses["flash"] - losses["gather"]) < graft_entry.DRYRUN_TOL


@pytest.mark.parametrize("name,fields,batch", [
    ("dense", {}, 2),  # dp 1: 2 rows
    ("moe", {"n_experts": 4}, 2),
    ("gather", {}, 2 * N),  # dp 4
    ("pipeline", {}, 4),
    ("gather_sp", {"max_seq_len": 17}, 2),
])
def test_each_dryrun_step_takes_one_devices_loss(losses, name, fields, batch):
    jax_loss, port_loss = _one_device_losses(fields, batch)
    assert abs(losses[name] - jax_loss) < 1e-4, (name, losses[name], jax_loss)
    assert abs(losses[name] - port_loss) < 1e-4, name


def test_dryrun_multichip_defaults_to_the_card_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(N)


def _reference_dryrun_base() -> dict:
    """The ``base`` dict of the JAX package's ``__graft_entry__.
    dryrun_multichip``, read from its source (no jax runs)."""
    import ast
    from pathlib import Path

    source = Path(__file__).resolve().parent.parent / "__graft_entry__.py"
    for node in ast.walk(ast.parse(source.read_text())):
        if (
            isinstance(node, ast.Assign)
            and [getattr(t, "id", None) for t in node.targets] == ["base"]
            and isinstance(node.value, ast.Call)
            and getattr(node.value.func, "id", None) == "dict"
        ):
            return {kw.arg: ast.literal_eval(kw.value) for kw in node.value.keywords}
    raise AssertionError("no base = dict(...) in __graft_entry__.py")


def test_the_dryrun_model_is_the_references():
    assert graft_entry.DRYRUN_BASE == _reference_dryrun_base()
    assert graft_entry.DRYRUN_BASE["n_heads"] == 4
