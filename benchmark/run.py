"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration's file, ``benchmark/traffic/<traffic>.json`` (whose
``driver`` names ``benchmark/drivers/<driver>.py``),
``benchmark/limits/<cell>.json`` and one reader a metric,
``benchmark/metrics/<metric>.py``.  With ``--trace 0`` the line carries
the cell's end-to-end metrics; with ``--trace 1`` its per-layer ones,
read from a profiler trace taken after the window.

The run refuses (exit 2, no result) where there is no card or fewer than
the cell asks for, and fails (exit 3, no result) where JAX or the JAX
package is loaded once the window has closed.  ``correct`` comes from
the comparison with the plain reference (``benchmark/reference/``); each
number compared is printed beside its limit, last on standard error and
last in the result line.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names that the port must not load, compared whole.
BANNED_MODULES = ("jax", "jaxlib", "flax", "k8s_operator_libs_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the port's nvcc
    builds already go to its own ``_build/`` there)."""
    base = root / "build" / "benchmark-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def banned_loaded() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED_MODULES)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: none"


def run_cell(root: Path, name: str, seed: int, seconds: float, tracing: bool, device: str = "cuda",
             fault: Optional[str] = None, t0: float = T0) -> Tuple[Dict, Dict]:
    """One run of cell *name* under *root*: (the result line, the numbers
    compared).  *device* and *fault* are for the harness's own tests,
    which drive a run on the CPU with the timed path broken underneath."""
    import torch

    from benchmark import cells
    from benchmark.reference import compare

    bench = cells.load_benchmark(root)
    cell = cells.workload(bench, name)
    config, traffic = cells.config(root, bench, cell["config"]), cells.traffic(root, cell["traffic"])
    limits = cells.limits(root, name)
    driver = cells.driver(traffic["driver"])
    on_card = torch.device(device).type == "cuda"

    run = driver.Run(config, traffic, seed, device, tracing, fault=fault)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log("setup:", json.dumps({"setup_s": setup_s, **run.phases}))
    window = run.window(seconds)
    summary = run.traced() if tracing else None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    times = window.get("step_s") or window.get("call_s")
    cut = statistics.quantiles(times, n=10) if len(times) > 1 else times
    log("window:", json.dumps({"elapsed_s": window["elapsed_s"], "n": len(times), "min_s": min(times),
                               "p10_s": cut[0], "p50_s": statistics.median(times), "p90_s": cut[-1],
                               "max_s": max(times), "first_s": times[:3], "last_s": times[-3:]}))
    log("path: launches in the window", json.dumps(window.pop("launches")),
        "| traced", json.dumps(summary and summary.get("launches")))
    measured = {"setup_s": setup_s, "window": window, "trace": summary,
                "polls": getattr(run, "polls", None) and run.polls.seconds,
                "config": config, "traffic": traffic, "model": config["model"]}
    metrics = {}
    for entry in cells.metrics_for(bench, name, "per_layer" if tracing else "end_to_end"):
        value = cells.reader(root, entry["name"]).read(measured)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    found = banned_loaded()
    if found:
        raise BannedModules(f"loaded once the window closed: {', '.join(found)}")

    run.free()
    numbers = run.check()
    correct = compare.judge(numbers, limits)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": device_info}
    if tracing and summary is not None:
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in numbers.items()}
    return result, numbers


class BannedModules(RuntimeError):
    """JAX, or the JAX package, was loaded in the process."""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    from benchmark import cells

    chips = cells.workload(cells.load_benchmark(ROOT), args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"refused: {args.workload} needs {chips} CUDA device(s); "
            f"available {torch.cuda.is_available()}, count {torch.cuda.device_count()}")
        return 2
    log("card:", card_line(), "| torch", torch.__version__, "cuda", torch.version.cuda)
    try:
        result, numbers = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    except BannedModules as err:
        log("refused:", err)
        return 3
    found = banned_loaded()
    if found:
        log("refused: loaded after the reference ran:", ", ".join(found))
        return 3
    for name, entry in numbers.items():
        log(f"check {name}: {entry['value']!r} limit {entry['limit']!r}"
            + (f" (leaf {entry['leaf']})" if entry.get("leaf") else ""))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
