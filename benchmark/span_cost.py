"""The host cost of the program's hot-path spans and timing events: a train
step's trace (six phases, three of them timed, four events) and a decode
call's (a timed span a step, an event after the last), each against the
same loop bare.  Both loops end a step or a call in the host wait the real
one has (the loss read, the call's end), so the difference is what the
instrumentation adds.

    python3 benchmark/span_cost.py [--device cuda] [--steps 2000] [--decode-len 512] [--rounds 7]

Prints one JSON line: host microseconds a train step and a decode step,
each the median over the rounds of (traced - bare), the rounds in turns
bare, traced, traced, bare."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from k8s_operator_libs_tpu_torch.obs import hotpath  # noqa: E402


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_round(device: torch.device, steps: int, traced: bool) -> float:
    """Seconds a step of *steps* instrumented like a train step, or bare."""
    t0 = time.perf_counter()
    for i in range(steps):
        if not traced:
            _wait(device)
            continue
        with hotpath.StepTrace("train.step", device, {"step": i}) as trace:
            with trace.phase("train.poll"):
                pass
            with trace.phase("train.batch"):
                pass
            with hotpath.phase("train.forward", timed=True):
                pass
            with hotpath.phase("train.backward", timed=True):
                pass
            with hotpath.phase("train.optimizer", timed=True, closes=True):
                pass
            with trace.phase("train.loss_read"):
                _wait(device)
                trace.anchor()
            trace.root.set_attribute("tokens", 1)
    return (time.perf_counter() - t0) / steps


def decode_round(device: torch.device, total: int, traced: bool) -> float:
    """Seconds a step of one call of ``total - 1`` steps instrumented like
    a decode call, or bare."""
    t0 = time.perf_counter()
    if traced:
        with hotpath.StepTrace("decode.generate", device, {"batch": 1, "total_len": total,
                                                         "served_tokens": total}) as trace:
            for i in range(total - 1):
                with trace.phase("decode.step", timed=True, i=i):
                    pass
            trace.mark()
            trace.anchor(wait=True)
    else:
        for i in range(total - 1):
            pass
        _wait(device)
    return (time.perf_counter() - t0) / (total - 1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--decode-len", type=int, default=512)
    parser.add_argument("--rounds", type=int, default=7)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    rounds = {"train": [], "decode": []}
    train_round(device, 50, True)  # events into the pool, first calls made
    decode_round(device, args.decode_len, True)
    for r in range(args.rounds):
        for kind, fn, n in (("train", train_round, args.steps), ("decode", decode_round, args.decode_len)):
            order = (False, True, True, False) if r % 2 == 0 else (True, False, False, True)
            took = {False: [], True: []}
            for traced in order:
                took[traced].append(fn(device, n, traced))
            rounds[kind].append((statistics.mean(took[True]) - statistics.mean(took[False])) * 1e6)
    print(json.dumps({
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "train_step_us": statistics.median(rounds["train"]),
        "decode_step_us": statistics.median(rounds["decode"]),
        "rounds_us": rounds,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
