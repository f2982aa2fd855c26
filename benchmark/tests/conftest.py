"""A tiny benchmark beside the real one, for driving whole runs on the
CPU: a copy of ``benchmark/`` under a temporary root with a small GPT-2
configuration, its traffic, limits and cells."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = {"vocab_size": 128, "d_model": 64, "n_heads": 4, "n_layers": 2, "d_ff": 256, "max_seq_len": 64}
TINY_TRAFFIC = {
    "tiny-train": {"driver": "train", "batch": 4, "seq_len": 64, "watcher_node": "gpu-node-0000",
                   "check_steps": 3, "trace_steps": 2},
    "tiny-decode": {"driver": "decode", "batch": 8, "total_len": 32,
                    "prompt_len": {"min": 2, "max": 16, "median": 6, "sigma": 0.75},
                    "check_rows": 3, "trace_steps": 4, "trace_first_step": 5},
}
#: fp32 on the CPU agrees with the fp32 reference to rounding; these
#: limits sit far above that and far under what each fault reads.
TINY_LIMITS = {
    "tiny.train": {"loss_rel": 1e-5, "grad_rel": 1e-4, "change_rel": 1e-3},
    "tiny.decode": {"gap_max": 1e-3, "prompt_mismatch": 0, "out_of_vocab": 0},
}


def tiny_benchmark(root: Path) -> Path:
    """*root* holding a copy of ``benchmark/`` and a ``BENCHMARK.json`` of
    the real metrics over two tiny cells."""
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps({"model": TINY_MODEL}))
    for name, spec in TINY_TRAFFIC.items():
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(spec))
    for name, limits in TINY_LIMITS.items():
        (root / "benchmark" / "limits" / f"{name}.json").write_text(json.dumps({"limits": limits}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "a test", "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny-train", "chips": 1, "why": "tests"},
        {"name": "tiny.decode", "config": "tiny", "traffic": "tiny-decode", "chips": 1, "why": "tests"},
    ]
    real = {"gpt2-xl.train": "tiny.train", "gpt2-medium.train": "tiny.train",
            "gpt2-medium.decode-int8": "tiny.decode"}
    for kind in ("end_to_end", "per_layer"):
        for metric in bench[kind]:
            if "workloads" in metric:
                metric["workloads"] = sorted({real[w] for w in metric["workloads"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_benchmark(tmp_path)
