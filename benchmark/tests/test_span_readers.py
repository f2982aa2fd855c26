"""The readers of the program's own spans (``poll_ms.train``,
``step_edge_idle_pct.train``, ``optimizer_ms.train``,
``queue_lead_ms.decode``) over whole traced runs on the CPU: the host
reading comes out, the device readings are None where the spans carry no
device time, and each run reads its own window alone, however many runs
the process made before it."""

import time

import pytest

from benchmark import cells, run
from benchmark.measure import spans

SEED = 2**31 + 4242
DEVICE_METRICS = {"tiny.train": ["step_edge_idle_pct.train", "optimizer_ms.train"],
                  "tiny.decode": ["queue_lead_ms.decode"]}


def _measured(root, cell, seed, seconds=0.2):
    """One traced run of *cell* through its driver: what the readers read."""
    bench = cells.load_benchmark(root)
    entry = cells.workload(bench, cell)
    config, traffic = cells.config(root, bench, entry["config"]), cells.traffic(root, entry["traffic"])
    driven = cells.driver(traffic["driver"]).Run(config, traffic, seed, "cpu", True)
    window = driven.window(seconds)
    driven.traced()
    return {"window": window, "traffic": traffic, "config": config, "model": config["model"]}


def test_the_poll_reads_a_number_and_the_device_metrics_none(tiny_root):
    result, _ = run.run_cell(tiny_root, "tiny.train", SEED, 0.2, True, device="cpu", t0=time.perf_counter())
    assert result["metrics"]["poll_ms.train"]["value"] > 0
    assert not set(DEVICE_METRICS["tiny.train"]) & set(result["metrics"])
    result, _ = run.run_cell(tiny_root, "tiny.decode", SEED, 0.2, True, device="cpu", t0=time.perf_counter())
    assert not set(DEVICE_METRICS["tiny.decode"]) & set(result["metrics"])


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.decode"])
def test_a_second_run_reads_its_own_window(tiny_root, cell):
    _measured(tiny_root, cell, SEED)
    measured = _measured(tiny_root, cell, SEED + 1)
    w = measured["window"]
    if cell == "tiny.train":
        traces = spans.train_window(measured)
        first = measured["traffic"]["check_steps"] + SEED + 1  # the trainer's step after its checked steps
        assert [spans.named([t], "train.step")[0]["attributes"]["step"] for t in traces] == \
            list(range(first, first + w["attempted"]))
        assert cells.reader(tiny_root, "poll_ms.train").read(measured) > 0
    else:
        traces = spans.decode_window(measured)
        assert len(traces) == w["calls"]
        assert sum(spans.named([t], "decode.generate")[0]["attributes"]["served_tokens"] for t in traces) == \
            w["tokens"]
    for name in DEVICE_METRICS[cell]:
        assert cells.reader(tiny_root, name).read(measured) is None


def test_a_stretch_that_dropped_a_span_or_falls_short_reads_none(tiny_root, monkeypatch):
    from k8s_operator_libs_tpu_torch.obs import tracing

    measured = _measured(tiny_root, "tiny.train", SEED)
    assert spans.train_window(measured) is not None
    traces = tracing.workload_tracer().traces()
    monkeypatch.setattr(spans, "_traces", lambda name: [dict(t, dropped_spans=1) for t in traces])
    assert spans.train_window(measured) is None
    monkeypatch.setattr(spans, "_traces", lambda name: [t for t in traces if t["name"] == name][:2])
    assert spans.train_window(measured) is None
    assert cells.reader(tiny_root, "poll_ms.train").read(measured) is None
