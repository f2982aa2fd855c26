"""Read the numbers that decide ``correct`` for one cell over many seeds in
one process, for the program, the control or a planted fault: the
readings its limits are set from.  The benchmark's own runs never run
this.

    python benchmark/control.py --workload <cell> --mode <mode> --seeds <n> [<n> ...]

Modes: ``program`` (the timed path as it is); ``control`` (training: the
reference in the program's place with fp8 matmul operands; serving: at
each served position the token that int4 weights put first); ``both``
(the two from one run);
``half_batch`` and ``unchanged`` (training) or ``half_batch`` and
``token`` (serving): the faults of ``drivers/<driver>.py``'s
``plant_fault``.  Training needs no window; serving reads one call.  Each
seed's numbers are printed as a JSON line, and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, cell: str, mode: str, seed: int, device: str = "cuda") -> dict:
    """The numbers compared in one run of *cell*, by mode: *mode* alone,
    or ``both`` for ``program`` and ``control`` from one run."""
    from benchmark import cells
    from benchmark.reference import compare, gpt2

    bench = cells.load_benchmark(root)
    entry = cells.workload(bench, cell)
    config, traffic = cells.config(root, bench, entry["config"]), cells.traffic(root, entry["traffic"])
    driver = cells.driver(traffic["driver"])
    fault = None if mode in ("program", "control", "both") else mode
    out = {}
    if traffic["driver"] == "train":
        reference = driver.reference(config, traffic, seed, device)
        if device == "cuda":
            import torch

            torch.cuda.empty_cache()  # the program's run takes the card next
        if mode != "control":
            run = driver.Run(config, traffic, seed, device, False, fault=fault)
            run.free()
            out["program" if mode == "both" else mode] = compare.train_numbers(run.readings, reference)
        if mode in ("control", "both"):
            lower = driver.reference(config, traffic, seed, device, cast=gpt2.fp8)
            out["control"] = compare.train_numbers(lower, reference)
        return out
    run = driver.Run(config, traffic, seed, device, False, fault=fault)
    run.window(0)
    run.free()
    if mode != "control":
        out["program" if mode == "both" else mode] = run.check()
    if mode in ("control", "both"):
        out["control"] = run.check(control=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        by_mode = readings(ROOT, args.workload, args.mode, seed)
        line = json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0,
                           **{mode: {k: v["value"] for k, v in numbers.items()}
                              for mode, numbers in by_mode.items()},
                           "leaves": {f"{mode}.{k}": v["leaf"] for mode, numbers in by_mode.items()
                                      for k, v in numbers.items() if "leaf" in v}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
