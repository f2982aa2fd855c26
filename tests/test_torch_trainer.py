"""The port's drain-aware trainer (k8s_operator_libs_tpu_torch/tpu/
workload.py::CheckpointingTrainer, drain_handshake.py, smoke.py) on the
CPU.

The port of test_trainer_checkpoints_and_stops_on_drain
(tests/test_tpu_integration.py), run once against the port's own node
store and once against the JAX package's InMemoryCluster, which the test
passes in: the orchestrator side and the port's workload side meet on the
same annotation.
"""

import threading

import jax
import pytest
import torch

from k8s_operator_libs_tpu.api import PreDrainCheckpointSpec
from k8s_operator_libs_tpu.cluster import InMemoryCluster
from k8s_operator_libs_tpu.cluster.objects import make_node as jax_make_node
from k8s_operator_libs_tpu.tpu import smoke as jsmoke
from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu.tpu.drain_handshake import CheckpointDrainGate
from k8s_operator_libs_tpu.upgrade import consts as jconsts
from k8s_operator_libs_tpu.upgrade import util as jutil
from k8s_operator_libs_tpu_torch.cluster.inmem import (
    InMemoryNodeStore,
    NotFoundError,
    make_node,
    merge_patch,
)
from k8s_operator_libs_tpu_torch.tpu import smoke
from k8s_operator_libs_tpu_torch.tpu import workload as wl
from k8s_operator_libs_tpu_torch.tpu.drain_handshake import DrainSignalWatcher
from k8s_operator_libs_tpu_torch.upgrade import consts, util

CFG = wl.ModelConfig(n_layers=1, d_model=32, d_ff=64, max_seq_len=16)


def _port_store():
    store = InMemoryNodeStore()
    store.create(make_node("gpu-host"))
    return store


def _jax_cluster():
    cluster = InMemoryCluster()
    cluster.create(jax_make_node("gpu-host"))
    return cluster


@pytest.mark.parametrize("client", [_port_store, _jax_cluster], ids=["port-store", "jax-cluster"])
@pytest.mark.parametrize("request_value", ["requested", "requested:tok-7"])
def test_trainer_checkpoints_and_stops_on_drain(client, request_value, tmp_path):
    nodes = client()
    watcher = DrainSignalWatcher(nodes, "gpu-host")
    trainer = wl.CheckpointingTrainer(
        CFG, str(tmp_path), watcher=watcher, batch_size=4, device="cpu"
    )
    assert trainer.run(3) == 3  # no drain signal: all steps run
    key = util.get_pre_drain_checkpoint_annotation_key()
    nodes.patch("Node", "gpu-host", {"metadata": {"annotations": {key: request_value}}})
    completed = trainer.run(100)
    assert trainer.drained is True
    assert completed == 3  # stopped before running more steps
    ack = nodes.get("Node", "gpu-host")["metadata"]["annotations"][key]
    assert ack == request_value.replace("requested", "done")  # token echoed
    # the checkpoint exists at the acknowledged step, and a fresh trainer
    # resumes on it exactly as an uninterrupted run continues
    restored = wl.restore_checkpoint(str(tmp_path), 3)
    assert restored["step"] == 3
    resumed = wl.CheckpointingTrainer(CFG, str(tmp_path), batch_size=4, device="cpu", seed=5)
    resumed.load(restored)
    assert resumed.run(1) == 4
    straight = wl.CheckpointingTrainer(CFG, str(tmp_path / "straight"), batch_size=4, device="cpu")
    straight.run(4)
    assert resumed.losses[-1] == pytest.approx(straight.losses[3], abs=1e-6)
    assert trainer.losses == straight.losses[:3]


def test_port_watcher_answers_the_jax_orchestrator_gate(tmp_path):
    """The JAX package's CheckpointDrainGate (orchestrator side) requests
    a checkpoint with a fresh token and blocks; the port's trainer, in
    another thread, saves and acknowledges with that token."""
    cluster = _jax_cluster()
    gate = CheckpointDrainGate(
        cluster, PreDrainCheckpointSpec(enable=True, timeout_second=20), poll_seconds=0.01
    )
    trainer = wl.CheckpointingTrainer(
        CFG, str(tmp_path), watcher=DrainSignalWatcher(cluster, "gpu-host"),
        batch_size=2, device="cpu",
    )
    worker = threading.Thread(target=trainer.run, args=(2000,))
    worker.start()
    gate.wait_for_checkpoint(cluster.get("Node", "gpu-host"))  # blocks until the ack
    worker.join(timeout=20)
    assert not worker.is_alive()
    assert trainer.drained and trainer.step < 2000
    assert wl.restore_checkpoint(str(tmp_path), trainer.step)["step"] == trainer.step
    # the gate cleared the handshake after the acknowledgement
    annotations = cluster.get("Node", "gpu-host")["metadata"].get("annotations") or {}
    assert jutil.get_pre_drain_checkpoint_annotation_key() not in annotations


def test_handshake_constants_equal_the_orchestrators():
    assert consts.PRE_DRAIN_CHECKPOINT_ANNOTATION_KEY_FMT == (
        jconsts.PRE_DRAIN_CHECKPOINT_ANNOTATION_KEY_FMT
    )
    assert consts.PRE_DRAIN_CHECKPOINT_REQUESTED == jconsts.PRE_DRAIN_CHECKPOINT_REQUESTED
    assert consts.PRE_DRAIN_CHECKPOINT_DONE == jconsts.PRE_DRAIN_CHECKPOINT_DONE
    assert util.get_component_name() == "tpu-runtime"
    try:
        util.set_component_name("gpu")
        jutil.set_component_name("gpu")
        assert util.get_pre_drain_checkpoint_annotation_key() == (
            jutil.get_pre_drain_checkpoint_annotation_key()
        ) == "tpu.google.com/gpu-pre-drain-checkpoint"
    finally:
        util.set_component_name("tpu-runtime")
        jutil.set_component_name("tpu-runtime")
    with pytest.raises(ValueError):
        util.set_component_name("")


def test_watcher_treats_a_missing_node_as_no_request():
    for nodes in (InMemoryNodeStore(), InMemoryCluster()):
        watcher = DrainSignalWatcher(nodes, "absent")
        assert watcher.checkpoint_requested() is False
        assert watcher.check_and_acknowledge(lambda: pytest.fail("saved")) is False


def test_node_store_merge_patch_deletes_on_none():
    store = _port_store()
    store.patch("Node", "gpu-host", {"metadata": {"annotations": {"a": "1", "b": "2"}}})
    store.patch("Node", "gpu-host", {"metadata": {"annotations": {"a": None}}})
    assert store.get("Node", "gpu-host")["metadata"]["annotations"] == {"b": "2"}
    assert merge_patch({"x": {"y": 1}}, {"x": None, "z": {"w": None}}) == {"z": {}}
    with pytest.raises(NotFoundError):
        store.get("Node", "absent")
    with pytest.raises(ValueError):
        store.create(make_node("gpu-host"))


def test_run_smoke_drives_train_drain_restore_resume_on_cpu(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(CFG, flash_attention=True)
    result = smoke.run_smoke(str(tmp_path), steps=2, warmup=1, batch_size=2, config=cfg, device="cpu")
    assert result["platform"] == "cpu" and "mfu_pct" not in result
    assert result["drain_handshake"] == {
        **result["drain_handshake"],
        "checkpoint_step": 2,
        "ack": "done:smoke-1",
        "resumed_steps": 2,
    }
    assert torch.isfinite(torch.tensor(result["final_loss"]))


def test_train_flops_per_step_equals_the_jax_estimate():
    cfg = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=33)
    _, params, _, _ = jwl.create_train_state(jwl.ModelConfig(**cfg))
    model = wl.TinyLM(wl.ModelConfig(**cfg), device="cpu")
    assert smoke._train_flops_per_step(wl.ModelConfig(**cfg), model, 8) == (
        jsmoke._train_flops_per_step(jwl.ModelConfig(**cfg), params, 8)
    )
    assert smoke.peak_bf16_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert jax.devices()[0].platform == "cpu"


def test_detect_gpu_is_none_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert smoke.detect_gpu() is None
