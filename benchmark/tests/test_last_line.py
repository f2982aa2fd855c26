"""The result line: its keys, in the contract's order with the numbers
compared last, and the refusal, with no result, where there is no card."""

import json
import subprocess
import sys
import time

import pytest

from benchmark import run

from .conftest import ROOT


@pytest.mark.parametrize("cell,tracing", [("tiny.train", False), ("tiny.train", True),
                                          ("tiny.decode", False), ("tiny.decode", True)])
def test_result_line_keys(tiny_root, cell, tracing):
    result, numbers = run.run_cell(tiny_root, cell, 2**31 + 17, 0.2, tracing, device="cpu",
                                   t0=time.perf_counter())
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["checks"] == {k: {"value": v["value"], "limit": v["limit"]} for k, v in numbers.items()}
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"} and metric["value"] > 0
    kind = "per_layer" if tracing else "end_to_end"
    names = {m["name"] for m in json.loads((tiny_root / "BENCHMARK.json").read_text())[kind]
             if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= names
    if not tracing:  # the end-to-end metrics are all host-clock ones: every one is there
        assert set(line["metrics"]) == names


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", "gpt2-medium.train",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "refused" in proc.stderr


def test_jax_in_the_process_refuses(monkeypatch, tiny_root):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    with pytest.raises(run.BannedModules):
        run.run_cell(tiny_root, "tiny.train", 3, 0.1, False, device="cpu", t0=time.perf_counter())
