"""The spans of the port's hot path (k8s_operator_libs_tpu_torch/obs/
hotpath.py, recorded by tpu/workload.py and tpu/drain_handshake.py) on
the CPU.

A train step is one ``train.step`` trace of six phases, a decode call one
``decode.generate`` trace of a ``decode.step`` span a step, both in the
workload tracer; the drain's save and acknowledgement are children of the
watcher's ``checkpoint-drain`` span.  On the CPU no span carries a device
time; the card's arithmetic is checked here on stand-in events that keep
the host's clock.  While a profiler records, a span is also a profiler
annotation, and with none recording ``record_function`` is never called.
"""

import threading
import time

import pytest
import torch

from k8s_operator_libs_tpu_torch.api import PreDrainCheckpointSpec
from k8s_operator_libs_tpu_torch.cluster import InMemoryCluster
from k8s_operator_libs_tpu_torch.cluster.objects import make_node
from k8s_operator_libs_tpu_torch.obs import hotpath, tracing
from k8s_operator_libs_tpu_torch.tpu import workload as wl
from k8s_operator_libs_tpu_torch.tpu.drain_handshake import CheckpointDrainGate, DrainSignalWatcher

from test_torch_vocab import port_globals  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_globals")

CFG = wl.ModelConfig(n_layers=1, d_model=32, d_ff=64, max_seq_len=16)
TRAIN_PHASES = ["train.poll", "train.batch", "train.forward", "train.backward", "train.optimizer",
                "train.loss_read"]
DEVICE_KEYS = {"device_ms", "device_start_ns", "recorded_ns"}


@pytest.fixture()
def workload_tracer():
    tracer = tracing.Tracer(capacity=tracing.WORKLOAD_CAPACITY)
    previous = tracing.set_workload_tracer(tracer)
    yield tracer
    tracing.set_workload_tracer(previous)


def _node_cluster():
    cluster = InMemoryCluster()
    cluster.create(make_node("gpu-host"))
    return cluster


def _trainer(tmp_path, watcher=None, batch_size=3):
    return wl.CheckpointingTrainer(CFG, str(tmp_path), watcher=watcher, batch_size=batch_size, device="cpu")


def _children(trace):
    [root] = [s for s in trace["spans"] if not s["parent_id"]]
    return root, [s for s in trace["spans"] if s["parent_id"]]


def _check_train_step(trace, step, tokens):
    root, children = _children(trace)
    assert trace["complete"] and trace["dropped_spans"] == 0
    assert root["name"] == "train.step" and root["attributes"] == {"step": step, "tokens": tokens}
    assert [s["name"] for s in children] == TRAIN_PHASES
    assert {s["parent_id"] for s in children} == {root["span_id"]}
    assert [s["start_unix"] for s in children] == sorted(s["start_unix"] for s in children)
    assert sum(s["duration_s"] for s in children) <= root["duration_s"]
    return root, children


def test_each_train_step_is_one_trace_of_six_phases(tmp_path, workload_tracer):
    trainer = _trainer(tmp_path, DrainSignalWatcher(_node_cluster(), "gpu-host"))
    assert trainer.run(2) == 2
    traces = workload_tracer.traces()
    assert [t["name"] for t in traces] == ["train.step", "train.step"]
    for step, trace in enumerate(traces):
        _check_train_step(trace, step, 3 * (CFG.max_seq_len - 1))
        # on the CPU: no device time anywhere
        assert all(not DEVICE_KEYS & set(s["attributes"]) for s in trace["spans"])


def test_a_replaced_step_function_or_optimizer_still_leaves_a_whole_trace(tmp_path, workload_tracer):
    trainer = _trainer(tmp_path)
    step_fn = trainer.step_fn
    trainer.step_fn = lambda tokens: step_fn(tokens[:1])
    trainer.optimizer.step = lambda *a, **k: None
    trainer.run(1)
    [trace] = workload_tracer.traces()
    _check_train_step(trace, 0, 3 * (CFG.max_seq_len - 1))


def test_the_step_function_outside_a_trace_records_nothing(workload_tracer):
    model, optimizer = wl.create_train_state(CFG, "cpu")
    loss = wl.make_train_step(model, optimizer)(wl.make_batch(CFG, 2))
    assert torch.isfinite(loss) and workload_tracer.traces(complete_only=False) == []


def test_a_decode_call_is_one_trace_with_a_span_a_step(workload_tracer):
    model = wl.TinyLM(CFG, device="cpu")
    prompt, lens, new = torch.randint(0, CFG.vocab_size, (4, 6)), [6, 1, 3, 5], 7
    buf = wl.generate(CFG, model, prompt, new, prompt_lens=lens, device="cpu")
    total = 6 + new
    assert buf.shape == (4, total)
    [trace] = workload_tracer.traces()
    root, steps = _children(trace)
    assert trace["name"] == "decode.generate" and trace["dropped_spans"] == 0
    assert root["attributes"] == {"batch": 4, "total_len": total,
                                  "served_tokens": sum(total - n for n in lens)}
    assert [(s["name"], s["attributes"]) for s in steps] == [("decode.step", {"i": i}) for i in range(total - 1)]
    assert {s["parent_id"] for s in steps} == {root["span_id"]}
    # uniform prompts serve max_new_tokens a row
    wl.generate(CFG, model, prompt, new, device="cpu")
    assert workload_tracer.traces()[-1]["spans"][-1]["attributes"]["served_tokens"] == 4 * new


def test_the_bounds_drop_and_count(tmp_path):
    model = wl.TinyLM(CFG, device="cpu")
    small = tracing.Tracer(capacity=2, max_spans_per_trace=3)
    previous = tracing.set_workload_tracer(small)
    try:
        wl.generate(CFG, model, torch.zeros(2, 2, dtype=torch.long), 4, device="cpu")
        [trace] = small.traces()
        # 5 steps and the root: the first three recorded, the rest counted
        assert len(trace["spans"]) == 3 and trace["dropped_spans"] == 3
        _trainer(tmp_path).run(2)
        assert [t["name"] for t in small.traces()] == ["train.step", "train.step"]  # the decode call evicted
        # a trace evicted while it is open: its phases are orphans, counted
        with hotpath.StepTrace("train.step", "cpu") as trace:
            with trace.phase("train.poll"):
                for _ in range(2):  # new roots from another thread's empty context
                    worker = threading.Thread(target=small.record_span, args=("other", 0.0))
                    worker.start()
                    worker.join(timeout=10)
                    assert not worker.is_alive()
            with trace.phase("train.batch"):
                pass
        assert small.orphan_spans == 2
    finally:
        tracing.set_workload_tracer(previous)


def test_spans_are_profiler_annotations_only_while_it_records(tmp_path, monkeypatch, workload_tracer):
    from torch.profiler import ProfilerActivity, profile

    trainer = _trainer(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run(1)
    names = {e.name: e for e in prof.events() if getattr(e, "is_user_annotation", False)}
    assert {"train.step", *TRAIN_PHASES} <= set(names)
    assert names["train.step"].device_type == torch.autograd.DeviceType.CPU

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trainer.run(1)
    wl.generate(CFG, trainer.model, torch.zeros(1, 2, dtype=torch.long), 2, device="cpu")
    assert [t["name"] for t in workload_tracer.traces()] == ["train.step"] * 2 + ["decode.generate"]


def test_a_drain_records_the_save_and_the_ack_under_the_gates_trace(tmp_path, workload_tracer):
    cluster = _node_cluster()
    gate = CheckpointDrainGate(cluster, PreDrainCheckpointSpec(enable=True, timeout_second=20), poll_seconds=0.01)
    trainer = _trainer(tmp_path, DrainSignalWatcher(cluster, "gpu-host"))
    worker = threading.Thread(target=trainer.run, args=(2000,))
    worker.start()
    gate.wait_for_checkpoint(cluster.get("Node", "gpu-host"))
    worker.join(timeout=20)
    assert not worker.is_alive() and trainer.drained
    spans = {s["name"]: s for t in tracing.default_tracer().traces() for s in t["spans"]}
    handshake, drain = spans["drain-handshake"], spans["checkpoint-drain"]
    assert drain["parent_id"] == handshake["span_id"]
    for name in ("checkpoint.save", "drain.ack"):
        assert (spans[name]["trace_id"], spans[name]["parent_id"], spans[name]["status"]) == (
            handshake["trace_id"], drain["span_id"], "ok")
    assert spans["checkpoint.save"]["start_unix"] <= spans["drain.ack"]["start_unix"]
    # the drained step's trace: its poll alone, no tokens trained
    root, children = _children(workload_tracer.traces()[-1])
    assert root["attributes"] == {"step": trainer.step} and [s["name"] for s in children] == ["train.poll"]


class _Event:
    """A stand-in CUDA timing event whose device time is its host record
    time plus a fixed queue lead."""

    LEAD_S = 0.02
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1

    def record(self, stream=None):
        self.t = time.perf_counter() + self.LEAD_S

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3

    def synchronize(self):
        time.sleep(max(0.0, self.t - time.perf_counter()))


@pytest.fixture()
def card(monkeypatch):
    """The timed path on stand-in events, with CPU tensors."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index=None: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(hotpath, "_pool", {})
    monkeypatch.setattr(_Event, "made", 0)
    return monkeypatch


def _timed_train_step(step_fn):
    with hotpath.StepTrace("train.step", "cuda:0", {"step": 0}) as trace:
        loss = step_fn(wl.make_batch(CFG, 2))
        with trace.phase("train.loss_read"):
            float(loss)
            trace.anchor(wait=True)  # the stand-in events' lead waited out


def test_device_times_are_placed_on_the_host_clock(card, workload_tracer):
    model, optimizer = wl.create_train_state(CFG, "cpu")
    step_fn = wl.make_train_step(model, optimizer)
    for _ in range(2):
        _timed_train_step(step_fn)
    assert _Event.made == 4  # four a step, the second step's from the pool
    root, phases = _children(workload_tracer.traces()[-1])
    by_name = {s["name"]: s["attributes"] for s in phases}
    timed = ["train.forward", "train.backward", "train.optimizer"]
    assert all(DEVICE_KEYS <= set(by_name[n]) for n in timed)
    assert not DEVICE_KEYS & set(by_name["train.loss_read"])
    assert all(by_name[n]["device_ms"] >= 0 for n in timed)
    assert sum(by_name[n]["device_ms"] for n in timed) == pytest.approx(root["attributes"]["device_ms"])
    assert root["attributes"]["device_start_ns"] == by_name["train.forward"]["device_start_ns"]
    for n in timed:
        lead_ms = (by_name[n]["device_start_ns"] - by_name[n]["recorded_ns"]) / 1e6
        assert _Event.LEAD_S * 1e3 - 1 <= lead_ms <= _Event.LEAD_S * 1e3 + 500
        span = next(s for s in phases if s["name"] == n)
        assert abs(by_name[n]["recorded_ns"] / 1e9 - span["start_unix"]) < 0.5


def test_a_decode_call_waits_once_and_times_each_step(card, workload_tracer):
    waits = []
    card.setattr(_Event, "synchronize", lambda self: waits.append(self))
    init = hotpath.StepTrace.__init__
    card.setattr(hotpath.StepTrace, "__init__",
                 lambda self, name, device, *args: init(self, name, "cuda:0", *args))
    wl.generate(CFG, wl.TinyLM(CFG, device="cpu"), torch.zeros(2, 3, dtype=torch.long), 5, device="cpu")
    [trace] = workload_tracer.traces()
    root, steps = _children(trace)
    assert len(steps) == 7 and _Event.made == 8  # an event a step, one after the last
    assert len(waits) == 1
    assert all(DEVICE_KEYS <= set(s["attributes"]) for s in steps)
    assert sum(s["attributes"]["device_ms"] for s in steps) == pytest.approx(root["attributes"]["device_ms"])


def test_nothing_is_recorded_on_the_card_while_a_graph_is_captured(card, workload_tracer):
    card.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    model, optimizer = wl.create_train_state(CFG, "cpu")
    with hotpath.StepTrace("train.step", "cuda:0") as trace:
        float(wl.make_train_step(model, optimizer)(wl.make_batch(CFG, 2)))
        trace.anchor()
    assert _Event.made == 0
    [trace] = workload_tracer.traces()
    assert [s["name"] for s in trace["spans"]] == ["train.forward", "train.backward", "train.optimizer",
                                                    "train.step"]
    assert all(not DEVICE_KEYS & set(s["attributes"]) for s in trace["spans"])
