"""A new cell is data: a configuration, a traffic mix and a metric added
as files are found by name, with no file that is there edited."""

import json

from benchmark import cells


def _snapshot(root):
    return {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}


def test_new_files_are_found_without_editing_any(tiny_root):
    before = _snapshot(tiny_root)
    bench_text = (tiny_root / "BENCHMARK.json").read_text()
    (tiny_root / "benchmark" / "configs" / "dummy.json").write_text(json.dumps({"model": {"d_model": 8}}))
    (tiny_root / "benchmark" / "traffic" / "dummy-mix.json").write_text(json.dumps({"driver": "train"}))
    (tiny_root / "benchmark" / "limits" / "dummy.cell.json").write_text(json.dumps({"limits": {"x": 1}}))
    (tiny_root / "benchmark" / "metrics" / "dummy_metric.x.py").write_text("def read(m):\n    return 7.0\n")
    bench = json.loads(bench_text)
    bench["configs"].append({"name": "dummy", "source": "a test", "file": "benchmark/configs/dummy.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy-mix",
                               "chips": 1, "why": "tests"})
    bench["per_layer"].append({"name": "dummy_metric.x", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "setup_s",
                               "workloads": ["dummy.cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = cells.load_benchmark(tiny_root)
    cell = cells.workload(loaded, "dummy.cell")
    assert cells.config(tiny_root, loaded, cell["config"]) == {"model": {"d_model": 8}}
    assert cells.traffic(tiny_root, cell["traffic"])["driver"] == "train"
    assert cells.limits(tiny_root, "dummy.cell") == {"x": 1}
    assert cells.driver("train").Run is not None
    wanted = [m["name"] for m in cells.metrics_for(loaded, "dummy.cell", "per_layer")]
    assert wanted == ["dummy_metric.x"]
    assert cells.reader(tiny_root, "dummy_metric.x").read({}) == 7.0
    after = _snapshot(tiny_root)
    assert {p: b for p, b in after.items() if p in before} == before


def test_metrics_follow_their_workloads_key():
    bench = cells.load_benchmark(cells.Path(__file__).resolve().parents[2])
    for cell in bench["workloads"]:
        end_to_end = {m["name"] for m in cells.metrics_for(bench, cell["name"], "end_to_end")}
        per_layer = {m["name"] for m in cells.metrics_for(bench, cell["name"], "per_layer")}
        assert "setup_s" in end_to_end and len(end_to_end) >= 2
        assert per_layer
        moved = {m["moves"] for m in cells.metrics_for(bench, cell["name"], "per_layer")}
        assert moved <= end_to_end


def test_every_metric_has_a_reader():
    root = cells.Path(__file__).resolve().parents[2]
    bench = cells.load_benchmark(root)
    for kind in ("end_to_end", "per_layer"):
        for metric in bench[kind]:
            assert callable(cells.reader(root, metric["name"]).read)
