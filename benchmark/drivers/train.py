"""The training driver: ``CheckpointingTrainer.run(1)`` a step, its
watcher on a node of the port's ``InMemoryCluster``, closed loop.

Set-up builds one trainer, loads the benchmark's weights into it, and
drives it through the traffic's ``check_steps`` first steps through the
window's own call, reading what the comparison needs: each step's loss,
each leaf's first gradient (AdamW's first moment after one step, over
1 - beta1) and each leaf's change over those steps.  The same trainer
then runs the window.  After it, the reference runs the same steps from
the same weights and batches."""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time
from typing import Dict, Optional

import torch

from .. import inputs
from ..measure import trace
from . import Phases
from ..reference import compare, gpt2


class _TimedWatcher:
    """The trainer's watcher, with the host time of each poll kept."""

    def __init__(self, watcher) -> None:
        self.watcher = watcher
        self.seconds: list = []

    def check_and_acknowledge(self, on_checkpoint) -> bool:
        t0 = time.perf_counter()
        try:
            return self.watcher.check_and_acknowledge(on_checkpoint)
        finally:
            self.seconds.append(time.perf_counter() - t0)


def model_config(config: Dict, device: torch.device):
    from k8s_operator_libs_tpu_torch.tpu import workload as wl

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return wl.ModelConfig(**config["model"], dtype=dtype, flash_attention=True)


def start_step(seed: int) -> int:
    """The trainer's first step, which seeds its first batch."""
    return seed % inputs.SEED_MOD


class Run:
    """One run of a training cell."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, tracing: bool,
                 fault: Optional[str] = None) -> None:
        from k8s_operator_libs_tpu_torch.cluster.inmem import InMemoryCluster
        from k8s_operator_libs_tpu_torch.cluster.objects import make_node
        from k8s_operator_libs_tpu_torch.tpu import workload as wl
        from k8s_operator_libs_tpu_torch.tpu.drain_handshake import DrainSignalWatcher

        if traffic["seq_len"] != config["model"]["max_seq_len"]:
            raise ValueError("make_batch draws max_seq_len tokens a row: the traffic's seq_len "
                             f"{traffic['seq_len']} must be the model's {config['model']['max_seq_len']}")
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.model = config["model"]
        self.phases = Phases()
        self.cluster = InMemoryCluster()
        self.cluster.create(make_node(traffic["watcher_node"]))
        watcher = DrainSignalWatcher(self.cluster, traffic["watcher_node"])
        self.polls = _TimedWatcher(watcher) if tracing else None
        self.checkpoint_dir = tempfile.mkdtemp(prefix="benchmark-checkpoints-")
        self.trainer = wl.CheckpointingTrainer(
            model_config(config, self.device), self.checkpoint_dir, self.polls or watcher,
            batch_size=traffic["batch"], device=self.device, seed=seed % inputs.SEED_MOD,
        )
        self.phases.lap("trainer")
        with torch.no_grad():
            self.trainer.model.load_state_dict(inputs.make_weights(self.model, seed, self.device))
        self.trainer.step = start_step(seed)
        if fault is not None:
            plant_fault(self.trainer, fault)
        self.phases.lap("weights")
        self.readings = self._first_steps(traffic["check_steps"])
        self.phases.lap("first_steps")
        if self.polls is not None:
            self.polls.seconds.clear()

    def _first_steps(self, n: int) -> Dict:
        trainer = self.trainer
        params = dict(trainer.model.named_parameters())
        trainer.run(1)
        beta1 = trainer.optimizer.param_groups[0]["betas"][0]
        with torch.no_grad():
            # no first moment: the optimizer never took the gradient
            grad = {k: float(trainer.optimizer.state[p]["exp_avg"].norm()) / (1 - beta1)
                    if p in trainer.optimizer.state else 0.0 for k, p in params.items()}
        trainer.run(n - 1)
        with torch.no_grad():
            w0 = inputs.make_weights(self.model, self.seed, self.device)
            change = {k: float((p - w0[k]).norm()) for k, p in params.items()}
        del w0
        return {"losses": list(trainer.losses[:n]), "grad": grad, "change": change}

    def window(self, seconds: float) -> Dict:
        """Steps back to back until *seconds* have passed; the last step
        that started inside the window ends it."""
        from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa

        fa.reset_launch_counts()
        trainer, times = self.trainer, []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            trainer.run(1)
            end = time.perf_counter()
            times.append(end - t)
            if end - t0 >= seconds:
                break
        losses = trainer.losses[-len(times):]
        failed = sum(1 for x in losses if not math.isfinite(x)) + int(trainer.drained)
        tokens = len(times) * self.traffic["batch"] * (self.traffic["seq_len"] - 1)
        return {"elapsed_s": end - t0, "step_s": times, "tokens": tokens, "attempted": len(times), "failed": failed,
                "launches": dict(fa.device_launch_counts)}

    def traced(self) -> Dict:
        """The traffic's ``trace_steps`` more steps under the profiler, with
        the port's launch counters read over them."""
        from k8s_operator_libs_tpu_torch.tpu import flash_attention as fa

        fa.reset_launch_counts()
        prof = trace.profiler()
        with prof:
            self.trainer.run(self.traffic["trace_steps"])
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        summary = trace.summarize(prof)
        if summary is not None:
            summary["steps"] = self.traffic["trace_steps"]
            summary["launches"] = dict(fa.device_launch_counts)
        return summary

    def free(self) -> None:
        """Drop the program's state, so that the reference has the card."""
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.checkpoint_dir, ignore_errors=True)

    def check(self) -> Dict:
        """The numbers compared: the set-up's readings against the
        reference's."""
        return compare.train_numbers(self.readings, reference(self.config, self.traffic, self.seed, self.device))


def reference(config: Dict, traffic: Dict, seed: int, device, cast=None) -> Dict:
    """The reference's readings of a run's checked steps: the same weights
    and batches, in fp32 (or through *cast*, the control)."""
    model = config["model"]
    n, b, s = traffic["check_steps"], traffic["batch"], traffic["seq_len"]
    first = start_step(seed)
    batches = [inputs.train_batch(model["vocab_size"], b, s, first + i) for i in range(n)]
    w0 = inputs.make_weights(model, seed, device)
    with gpt2.fp32_matmuls():
        return gpt2.train_steps(w0, batches, model["n_heads"], model["n_layers"],
                                cast=cast or (lambda x: x))


def plant_fault(trainer, fault: str) -> None:
    """Break the timed path underneath the harness, for the checks that
    must come out false: ``unchanged`` (the step returns its state
    unchanged) or ``half_batch`` (half of the batch left out, the mean
    taken over the rest)."""
    if fault == "unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        step_fn = trainer.step_fn
        trainer.step_fn = lambda tokens: step_fn(tokens[: tokens.shape[0] // 2])
    else:
        raise ValueError(f"no fault {fault!r} for training")
