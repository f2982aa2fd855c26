"""The port's drain-aware trainer (k8s_operator_libs_tpu_torch/tpu/
workload.py::CheckpointingTrainer, drain_handshake.py, smoke.py) on the
CPU.

The port of test_trainer_checkpoints_and_stops_on_drain
(tests/test_tpu_integration.py), run once against the port's own
InMemoryCluster and once against the JAX package's, which the test
passes in: the orchestrator side and the port's workload side meet on the
same annotation.  The port's keys are the GPU fleet's (``nvidia.com``,
component ``gpu-driver``).  Each orchestrator gate is answered by each
package's watcher but the JAX pair's: the port's gate by the port's
watcher, the JAX gate by the port's, and the port's gate by the JAX
package's; where the two sides speak different vocabularies, a test-only
client renames the annotation keys between them.
"""

import threading

import jax
import pytest
import torch

from k8s_operator_libs_tpu.api import PreDrainCheckpointSpec
from k8s_operator_libs_tpu.cluster import InMemoryCluster as JaxInMemoryCluster
from k8s_operator_libs_tpu.cluster.inmem import merge_patch as jax_merge_patch
from k8s_operator_libs_tpu.cluster.objects import make_node as jax_make_node
from k8s_operator_libs_tpu.obs import tracing as jtracing
from k8s_operator_libs_tpu.tpu import smoke as jsmoke
from k8s_operator_libs_tpu.tpu import workload as jwl
from k8s_operator_libs_tpu.tpu.drain_handshake import CheckpointDrainGate
from k8s_operator_libs_tpu.tpu.drain_handshake import DrainSignalWatcher as JaxDrainSignalWatcher
from k8s_operator_libs_tpu.upgrade import consts as jconsts
from k8s_operator_libs_tpu.upgrade import util as jutil
from k8s_operator_libs_tpu_torch.api import PreDrainCheckpointSpec as PortPreDrainCheckpointSpec
from k8s_operator_libs_tpu_torch.cluster import (
    AlreadyExistsError,
    InMemoryCluster,
    NotFoundError,
    merge_patch,
)
from k8s_operator_libs_tpu_torch.cluster.objects import make_node
from k8s_operator_libs_tpu_torch.obs import tracing
from k8s_operator_libs_tpu_torch.tpu import smoke
from k8s_operator_libs_tpu_torch.tpu import workload as wl
from k8s_operator_libs_tpu_torch.tpu.drain_handshake import CheckpointDrainGate as PortCheckpointDrainGate
from k8s_operator_libs_tpu_torch.tpu.drain_handshake import DrainSignalWatcher
from k8s_operator_libs_tpu_torch.upgrade import consts, util

from test_torch_vocab import from_port_vocab, to_port_vocab

CFG = wl.ModelConfig(n_layers=1, d_model=32, d_ff=64, max_seq_len=16)


def _port_cluster():
    cluster = InMemoryCluster()
    cluster.create(make_node("gpu-host"))
    return cluster


def _jax_cluster():
    cluster = JaxInMemoryCluster()
    cluster.create(jax_make_node("gpu-host"))
    return cluster


class _VocabBridge:
    """A test-only client over the JAX package's cluster that shows the
    port the annotation keys in the port's vocabulary: ``get`` rewrites
    them into it, ``patch`` back out of it."""

    def __init__(self, cluster):
        self.cluster = cluster

    def get(self, kind, name, namespace=""):
        obj = self.cluster.get(kind, name, namespace)
        meta = obj.get("metadata") or {}
        meta["annotations"] = to_port_vocab(meta.get("annotations") or {})
        return obj

    def patch(self, kind, name, body, namespace=""):
        return self.cluster.patch(kind, name, from_port_vocab(body), namespace)


@pytest.mark.parametrize("client", [_port_cluster, _jax_cluster], ids=["port-cluster", "jax-cluster"])
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


@pytest.fixture
def tracers():
    """Fresh default tracers for both packages: (JAX's, the port's)."""
    jax_tracer, port_tracer = jtracing.Tracer(), tracing.Tracer()
    previous = jtracing.set_default_tracer(jax_tracer), tracing.set_default_tracer(port_tracer)
    yield jax_tracer, port_tracer
    jtracing.set_default_tracer(previous[0])
    tracing.set_default_tracer(previous[1])


def _spans(tracer, name):
    return [s for t in tracer.traces(complete_only=False) for s in t["spans"] if s["name"] == name]


def _drain_through_gate(gate, gate_tracer, cluster, watcher, watcher_tracer, keys, tmp_path):
    """*gate* requests a checkpoint with a fresh token and blocks; the
    port's trainer, in another thread, polls *watcher*, saves and
    acknowledges with that token.  Its checkpoint-drain span (in
    *watcher_tracer*) joins the gate's trace (in *gate_tracer*) as a child
    of the gate's drain-handshake span, through the traceparent
    annotation, and the gate clears both *keys* on *cluster*."""
    trainer = wl.CheckpointingTrainer(CFG, str(tmp_path), watcher=watcher, batch_size=2, device="cpu")
    worker = threading.Thread(target=trainer.run, args=(2000,))
    worker.start()
    gate.wait_for_checkpoint(cluster.get("Node", "gpu-host"))  # blocks until the ack
    worker.join(timeout=20)
    assert not worker.is_alive()
    assert trainer.drained and trainer.step < 2000
    assert wl.restore_checkpoint(str(tmp_path), trainer.step)["step"] == trainer.step
    # the gate cleared the handshake after the acknowledgement
    annotations = cluster.get("Node", "gpu-host")["metadata"].get("annotations") or {}
    assert not set(keys) & set(annotations)
    # the cross-process leg of the trace
    [gate_span] = _spans(gate_tracer, "drain-handshake")
    [drain_span] = _spans(watcher_tracer, "checkpoint-drain")
    assert gate_span["attributes"]["result"] == "acknowledged"
    assert drain_span["trace_id"] == gate_span["trace_id"]
    assert drain_span["parent_id"] == gate_span["span_id"]
    assert drain_span["status"] == "ok"
    assert drain_span["attributes"] == {"node": "gpu-host"}


def test_port_watcher_answers_the_jax_orchestrator_gate(tmp_path, tracers):
    """The JAX package's CheckpointDrainGate (orchestrator side) requests
    a checkpoint and the port's trainer answers it (:func:`_drain_through_gate`).
    The gate writes the JAX package's keys; the watcher reads the port's
    through :class:`_VocabBridge`."""
    jax_tracer, port_tracer = tracers
    cluster = _jax_cluster()
    gate = CheckpointDrainGate(
        cluster, PreDrainCheckpointSpec(enable=True, timeout_second=20), poll_seconds=0.01
    )
    keys = (jutil.get_pre_drain_checkpoint_annotation_key(), jutil.get_pre_drain_traceparent_annotation_key())
    watcher = DrainSignalWatcher(_VocabBridge(cluster), "gpu-host")
    _drain_through_gate(gate, jax_tracer, cluster, watcher, port_tracer, keys, tmp_path)


class _JaxVocabBridge:
    """A test-only client over the port's cluster that shows the JAX
    package's watcher the annotation keys in the JAX package's vocabulary:
    the inverse of :class:`_VocabBridge`."""

    def __init__(self, cluster):
        self.cluster = cluster

    def get(self, kind, name, namespace=""):
        obj = self.cluster.get(kind, name, namespace)
        meta = obj.get("metadata") or {}
        meta["annotations"] = from_port_vocab(meta.get("annotations") or {})
        return obj

    def patch(self, kind, name, body, namespace=""):
        return self.cluster.patch(kind, name, to_port_vocab(body), namespace)


@pytest.mark.parametrize("watcher_side", ["port", "jax"])
def test_the_port_gate_is_answered_by_each_packages_watcher(watcher_side, tmp_path, tracers):
    """The port's CheckpointDrainGate, on the port's cluster, answered by
    the port's watcher (both spans in the port's tracer), and by the JAX
    package's watcher over :class:`_JaxVocabBridge` (its span in the JAX
    tracer, under the port gate's span)."""
    jax_tracer, port_tracer = tracers
    cluster = _port_cluster()
    gate = PortCheckpointDrainGate(
        cluster, PortPreDrainCheckpointSpec(enable=True, timeout_second=20), poll_seconds=0.01
    )
    keys = (util.get_pre_drain_checkpoint_annotation_key(), util.get_pre_drain_traceparent_annotation_key())
    if watcher_side == "port":
        watcher, watcher_tracer = DrainSignalWatcher(cluster, "gpu-host"), port_tracer
    else:
        watcher, watcher_tracer = JaxDrainSignalWatcher(_JaxVocabBridge(cluster), "gpu-host"), jax_tracer
    _drain_through_gate(gate, port_tracer, cluster, watcher, watcher_tracer, keys, tmp_path)


def test_the_port_gate_times_out_open_and_clears_the_request(tracers):
    """Nobody answers: the gate waits its timeout, records it on its span,
    and clears both annotations so that the drain proceeds."""
    _, port_tracer = tracers
    cluster = _port_cluster()
    gate = PortCheckpointDrainGate(
        cluster, PortPreDrainCheckpointSpec(enable=True, timeout_second=0.2), poll_seconds=0.01
    )
    gate.wait_for_checkpoint(cluster.get("Node", "gpu-host"))
    [span] = _spans(port_tracer, "drain-handshake")
    assert span["attributes"] == {"node": "gpu-host", "result": "timeout"}
    annotations = cluster.get("Node", "gpu-host")["metadata"].get("annotations") or {}
    assert util.get_pre_drain_checkpoint_annotation_key() not in annotations
    assert util.get_pre_drain_traceparent_annotation_key() not in annotations


@pytest.mark.parametrize("carrier", ["", "garbage", f"00-{'0' * 32}-{'1' * 16}-01"])
def test_a_missing_or_malformed_traceparent_starts_a_new_root(carrier, tracers):
    _, port_tracer = tracers
    nodes = _port_cluster()
    key = util.get_pre_drain_checkpoint_annotation_key()
    nodes.patch("Node", "gpu-host", {"metadata": {"annotations": {
        key: "requested:t", util.get_pre_drain_traceparent_annotation_key(): carrier,
    }}})
    saved = []
    assert DrainSignalWatcher(nodes, "gpu-host").check_and_acknowledge(lambda: saved.append(1))
    assert saved == [1]
    [trace] = port_tracer.traces()  # complete: the span is its own root
    spans = {s["name"]: s for s in trace["spans"]}
    assert set(spans) == {"checkpoint-drain", "checkpoint.save", "drain.ack"}
    span = spans["checkpoint-drain"]
    assert (span["name"], span["parent_id"], span["status"]) == ("checkpoint-drain", "", "ok")
    assert {spans[n]["parent_id"] for n in ("checkpoint.save", "drain.ack")} == {span["span_id"]}


def test_an_injected_traceparent_reader_parents_the_span(tracers):
    _, port_tracer = tracers
    carrier = tracing.format_traceparent("ab" * 16, "cd" * 8)
    nodes = _port_cluster()
    key = util.get_pre_drain_checkpoint_annotation_key()
    nodes.patch("Node", "gpu-host", {"metadata": {"annotations": {key: "requested"}}})
    watcher = DrainSignalWatcher(nodes, "gpu-host", read_traceparent=lambda: carrier)
    assert watcher.check_and_acknowledge(lambda: None)
    [span] = _spans(port_tracer, "checkpoint-drain")
    assert (span["trace_id"], span["parent_id"]) == ("ab" * 16, "cd" * 8)
    # a failing save ends the span in error and propagates: no acknowledgement
    nodes.patch("Node", "gpu-host", {"metadata": {"annotations": {key: "requested"}}})
    with pytest.raises(OSError):
        watcher.check_and_acknowledge(lambda: (_ for _ in ()).throw(OSError("disk full")))
    assert _spans(port_tracer, "checkpoint-drain")[-1]["status"] == "error"
    assert nodes.get("Node", "gpu-host")["metadata"]["annotations"][key] == "requested"


def test_handshake_constants_equal_the_orchestrators():
    """The port's handshake keys are the orchestrator's in the GPU-fleet
    vocabulary; the values are the same."""
    assert consts.PRE_DRAIN_CHECKPOINT_ANNOTATION_KEY_FMT == to_port_vocab(
        jconsts.PRE_DRAIN_CHECKPOINT_ANNOTATION_KEY_FMT
    )
    assert consts.PRE_DRAIN_CHECKPOINT_REQUESTED == jconsts.PRE_DRAIN_CHECKPOINT_REQUESTED
    assert consts.PRE_DRAIN_CHECKPOINT_DONE == jconsts.PRE_DRAIN_CHECKPOINT_DONE
    assert consts.PRE_DRAIN_TRACEPARENT_ANNOTATION_KEY_FMT == to_port_vocab(
        jconsts.PRE_DRAIN_TRACEPARENT_ANNOTATION_KEY_FMT
    )
    assert util.get_component_name() == "gpu-driver"
    assert util.get_pre_drain_traceparent_annotation_key() == to_port_vocab(
        jutil.get_pre_drain_traceparent_annotation_key()
    )
    try:
        util.set_component_name("gpu")
        jutil.set_component_name("gpu")
        assert util.get_pre_drain_checkpoint_annotation_key() == to_port_vocab(
            jutil.get_pre_drain_checkpoint_annotation_key()
        ) == "nvidia.com/gpu-pre-drain-checkpoint"
        assert util.get_pre_drain_traceparent_annotation_key() == to_port_vocab(
            jutil.get_pre_drain_traceparent_annotation_key()
        ) == "nvidia.com/gpu-pre-drain-traceparent"
    finally:
        util.set_component_name("gpu-driver")
        jutil.set_component_name("tpu-runtime")
    with pytest.raises(ValueError):
        util.set_component_name("")


def test_watcher_treats_a_missing_node_as_no_request():
    for nodes in (InMemoryCluster(), JaxInMemoryCluster()):
        watcher = DrainSignalWatcher(nodes, "absent")
        assert watcher.checkpoint_requested() is False
        assert watcher.check_and_acknowledge(lambda: pytest.fail("saved")) is False


def test_node_store_merge_patch_deletes_on_none():
    """The port's cluster patches as RFC 7386 says, and its merge_patch is
    the JAX package's."""
    store = _port_cluster()
    store.patch("Node", "gpu-host", {"metadata": {"annotations": {"a": "1", "b": "2"}}})
    store.patch("Node", "gpu-host", {"metadata": {"annotations": {"a": None}}})
    assert store.get("Node", "gpu-host")["metadata"]["annotations"] == {"b": "2"}
    target, patch = {"x": {"y": 1}, "k": [1]}, {"x": None, "z": {"w": None}, "k": {"v": 2}}
    assert merge_patch(target, patch) == jax_merge_patch(target, patch) == {"z": {}, "k": {"v": 2}}
    with pytest.raises(NotFoundError):
        store.get("Node", "absent")
    with pytest.raises(AlreadyExistsError):
        store.create(make_node("gpu-host"))


def test_run_smoke_drives_train_drain_restore_resume_on_cpu(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(CFG, flash_attention=True)
    result = smoke.run_smoke(str(tmp_path), steps=2, warmup=1, batch_size=2, config=cfg, device="cpu")
    assert result["platform"] == "cpu" and "mfu_pct" not in result
    assert result["drain_handshake"] == {
        **result["drain_handshake"],
        "checkpoint_step": 2,
        "ack": "done",  # the reference's record: the token is checked, not reported
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
