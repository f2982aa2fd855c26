"""One rank of a multi-process job: data-parallel training, the drain loop,
the ring attention functions, the mesh, the sharded train step (expert
parallelism included), the GPipe pipeline, or the multi-rank dryrun.

    python -m k8s_operator_libs_tpu_torch.hack.dist_worker MODE [--device cpu|cuda]
        [--backend gloo|nccl] [--config tiny|smoke] [--steps N] [--inputs FILE] [--out FILE]
        [--tp N] [--batch N] [--microbatches N]

Every rank reads its identity from the environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; :mod:`..tpu.distributed`),
runs MODE and prints one JSON line.  The port's counterpart of the JAX
package's ``tests/distributed_worker.py`` and
``tests/distributed_drain_worker.py``.  Modes:

* ``train``: ``--steps`` data-parallel steps (:func:`..tpu.workload.make_train_step`
  over the all-data mesh) on the global batch ``make_batch(cfg, 8,
  seed=step)``; prints the rank, the world size and the losses.
* ``drain``: :class:`..tpu.multihost_trainer.MultihostDrainLoop` over that
  step.  Rank 0 watches node ``DRAIN_NODE_NAME`` through
  :class:`..cluster.kubeclient.KubeApiClient` at ``FACADE_URL``; every
  rank saves to ``shadow_dir(DRAIN_CKPT_DIR, rank)``; ``DRAIN_MAX_STEPS``
  and ``DRAIN_MAX_SECONDS`` (default 180) bound the run.  A progress line
  per step goes to stderr (``[rank R] step N loss X``), so that a parent
  can request the drain once training runs.  Prints the rank,
  ``stopped_at_step``, ``drained``, ``final_loss`` and the losses.
* ``ring``: every case of ``--inputs`` (a ``torch.save`` of ``{"cases":
  [{"name", "fn", "causal", "block", "q", "k", "v", "do"}, ...]}``, the
  GLOBAL tensors in natural order) through its ring function over the
  mesh's ``seq`` axis: forward on the rank's shard (zigzag's shard for
  ``zigzag_ring_flash_attention``), backward with its shard of ``do``.
  The local outputs and gradients go to ``--out`` (``torch.save``), the
  flash launches per case and, on the card, event timings of three
  forwards and backwards to the JSON line.
* ``mesh``: :func:`..tpu.distributed.global_mesh` with ``--tp`` model
  ranks and the rest data: its axis names and shape, and
  ``host_allreduce_max`` of the rank.
* ``spmd``: every run of ``--inputs`` (JSON: ``{"runs": [{"name",
  "mesh": [dp, sp, tp] or [dp, sp, tp, ep], "config": {ModelConfig
  fields over --config}, "steps", "batch" (default 8), "fixed_batch",
  "grads", "drain"}, ...]}``) as SPMD train steps from seed-0
  weights on the global batches
  ``make_batch(cfg, batch, seed=step)`` (seed 0 every step with
  ``fixed_batch``), each mesh built once, in the order the runs first
  name it.  Per run the JSON line holds the losses, the step ms, the
  attention plan, the rank's indices and ring pairs, its parameter
  shard shapes, the flash launches and the workload's warnings; with
  ``grads`` the gradients of the first step, gathered to the full
  state_dict, go to rank 0's ``--out``; on the card, a run that is not a
  drain traces one step more (``smoke.device_busy``, under ``device``),
  after the launches are read.  A
  ``drain`` run is the drain job on its mesh (rank 0 watches
  ``DRAIN_NODE_NAME`` at ``FACADE_URL``, every rank
  saves under ``DRAIN_CKPT_DIR``/<name>) for at most ``steps`` steps, then
  one step more, whose loss (``next_loss``) a trainer restored from the
  checkpoint must reproduce.  An ``ep`` wider than one runs the MoE's
  expert parallelism (a config with ``n_experts``).
* ``pipeline``: the GPipe pipeline, one stage a rank
  (:func:`..tpu.workload.make_pipeline_mesh` over the world): from seed-0
  weights, each rank keeps its block and the rest
  (:func:`..tpu.workload.pipeline_stage_params`);
  :func:`..tpu.workload.pipeline_loss_fn` on ``make_batch(cfg, --batch,
  seed=0)`` in ``--microbatches``, its gradients (``block.<key>`` for the
  stage's block, the rest by key) to ``--out``;
  then ``--steps`` pipelined AdamW steps on that batch.  The JSON line
  holds the stage, the loss, the step losses and ms, the stage's tensor
  shapes and the flash launches of the steps; on the card, one step more
  is traced (under ``device``).
* ``dryrun``: :func:`..graft_entry.dryrun_rank`, this rank's part of
  ``dryrun_multichip``; the line holds its losses.

:class:`Ranks` starts every rank of such a job on this host, as the tests
and ``chip_smoke.py`` do.

``--config tiny`` is the JAX workers' model (vocab 64, d_model 32, 4
heads, 2 layers, d_ff 64, seq 16); ``smoke`` is the repo's chip
configuration with the flash kernels (bf16 on the card).  Without a CUDA
device it exits non-zero unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..tpu import distributed
from ..tpu import flash_attention as fa
from ..tpu import ring_attention as ra
from ..tpu import smoke
from ..tpu import workload as wl

GLOBAL_BATCH = 8
RING_FUNCTIONS = {
    "ring_attention": lambda q, k, v, group, case: ra.ring_attention(q, k, v, group, case["causal"]),
    "ring_flash_attention": lambda q, k, v, group, case: ra.ring_flash_attention(
        q, k, v, group, case["causal"], case["block"]
    ),
    "zigzag_ring_flash_attention": lambda q, k, v, group, case: ra.zigzag_ring_flash_attention(
        q, k, v, group, case["block"]
    ),
}


def model_config(name: str, device: torch.device) -> wl.ModelConfig:
    if name == "tiny":
        return wl.ModelConfig(
            vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16
        )
    return dataclasses.replace(smoke.smoke_config(device), flash_attention=True)


def flash_device_launches() -> dict:
    return {name: n for name, n in fa.device_launch_counts.items() if n}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def train_steps(cfg, mesh, device, steps: int) -> dict:
    """*steps* data-parallel steps from seed-0 weights on the global
    batches ``make_batch(cfg, 8, seed=step)``."""
    model, optimizer = wl.create_train_state(cfg, device, seed=0, mesh=mesh)
    step = wl.make_train_step(model, optimizer, mesh)
    losses = []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(float(step(wl.make_batch(cfg, GLOBAL_BATCH, seed=i, device=device))))
    return {"losses": losses, "ms_per_step": (time.perf_counter() - t0) / max(1, steps) * 1e3}


def drain_job(cfg, mesh, rank: int, device, watcher, ckpt_dir: str,
              max_steps: int = 1_000_000, max_seconds: float = float("inf"),
              on_step=None, next_step: bool = False) -> dict:
    """A :class:`..tpu.workload.CheckpointingTrainer` on *mesh* under
    :class:`MultihostDrainLoop`: when drained, every rank saves the full
    state to ``shadow_dir(ckpt_dir, rank)``.  *on_step(step, loss)* sees
    each step's all-reduced loss.  With *next_step*, one more step after
    the loop records its loss as ``next_loss``."""
    from ..tpu.multihost_trainer import MultihostDrainLoop, shadow_dir

    trainer = wl.CheckpointingTrainer(
        cfg, shadow_dir(ckpt_dir, rank), batch_size=GLOBAL_BATCH, device=device, mesh=mesh
    )
    losses, step_ms = [], []

    def do_step(state, step):
        t0 = time.perf_counter()
        loss = float(trainer.step_fn(wl.make_batch(cfg, GLOBAL_BATCH, seed=step, device=device)))
        step_ms.append((time.perf_counter() - t0) * 1e3)  # float() waited for the device
        losses.append(loss)
        if on_step is not None:
            on_step(step + 1, loss)
        return state, loss

    def do_save(state, step):
        trainer.step = step
        trainer.save()

    loop = MultihostDrainLoop(
        do_step, do_save, watcher=watcher, max_steps=max_steps, max_seconds=max_seconds
    )
    _sync(device)
    t0 = time.perf_counter()
    _, stopped, drained = loop.run(None)
    seconds = time.perf_counter() - t0
    rec = {
        "stopped_at_step": stopped,
        "drained": drained,
        "final_loss": losses[-1] if losses else 0.0,
        "losses": losses,
        "step_ms": step_ms,
        "loop_ms_per_step": seconds / max(1, stopped) * 1e3,
    }
    if next_step:
        batch = wl.make_batch(cfg, GLOBAL_BATCH, seed=stopped, device=device)
        rec["next_loss"] = float(trainer.step_fn(batch))
    rec["plan"] = _plan(trainer.model)
    return rec


def _plan(model) -> dict:
    """The attention plan *model* cached for its training shape."""
    cfg = model.config
    return dataclasses.asdict(model.plan(cfg.max_seq_len - 1, cfg.seq_axis is not None))


def _shard(x, rank: int, n: int):
    s = x.shape[1] // n
    return x[:, rank * s:(rank + 1) * s].contiguous()


def _event_ms(fn, device) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def ring_cases(cases, group, device) -> tuple:
    """Run every case; returns (tensors by case, report by case)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    tensors, report = {}, {}
    for case in cases:
        fn = RING_FUNCTIONS[case["fn"]]
        zigzag = case["fn"] == "zigzag_ring_flash_attention"
        q, k, v, do = (
            _shard(ra.to_zigzag(case[x], n) if zigzag else case[x], rank, n).to(device)
            for x in ("q", "k", "v", "do")
        )

        def fwd():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            return leaves, fn(*leaves, group, case)

        fa.reset_launch_counts()
        leaves, out = fwd()
        torch.autograd.backward(out, do)
        _sync(device)
        row = {
            "launches": dict(fa.launch_counts),
            "device_launches": flash_device_launches(),
        }
        if case["fn"] != "ring_attention":
            layout = "zigzag" if zigzag else "contiguous"
            row["pairs"] = len(ra.ring_schedule(n, rank, case["causal"], layout))
        tensors[case["name"]] = {
            "out": out.detach().cpu(),
            **{f"d{x}": t.grad.cpu() for x, t in zip("qkv", leaves)},
        }
        if device.type == "cuda":
            # every timed call starts from a barrier: the ring couples the
            # ranks, so a rank that starts early would time its wait
            fwd_ms, bwd_ms = [], []
            for _ in range(3):
                outs = []
                distributed.sync_global_devices("ring-timing")
                fwd_ms.append(_event_ms(lambda: outs.append(fwd()[1]), device))
                distributed.sync_global_devices("ring-timing")
                bwd_ms.append(_event_ms(lambda: torch.autograd.backward(outs[0], do), device))
            row.update(fwd_ms=fwd_ms, bwd_ms=bwd_ms)
        report[case["name"]] = row
    return tensors, report


class _Warnings(logging.Handler):
    """The workload's warnings, as messages."""

    def __init__(self) -> None:
        super().__init__(logging.WARNING)
        self.messages: list = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


def coordinator_watcher(rank: int):
    """Rank 0's drain watcher of node ``DRAIN_NODE_NAME`` at
    ``FACADE_URL``; None on every other rank."""
    if rank != 0:
        return None
    from ..cluster.kubeclient import KubeApiClient
    from ..tpu.drain_handshake import DrainSignalWatcher

    client = KubeApiClient(os.environ["FACADE_URL"], timeout=10.0)
    return DrainSignalWatcher(client, os.environ["DRAIN_NODE_NAME"])


def spmd_runs(runs, base, device, out_path: str) -> dict:
    """Every run of the ``spmd`` mode (module docstring); returns the
    report by run and writes the gathered gradients to *out_path*."""
    rank = dist.get_rank()
    meshes, tensors, report = {}, {}, {}
    warnings = _Warnings()
    logger = logging.getLogger(wl.__name__)
    logger.addHandler(warnings)
    for run in runs:
        dp, sp, tp, ep = [*run["mesh"], 1][:4]
        if (dp, sp, tp, ep) not in meshes:
            meshes[dp, sp, tp, ep] = distributed.global_mesh(dp=dp, tp=tp, sp=sp, ep=ep)
        mesh = meshes[dp, sp, tp, ep]
        cfg = dataclasses.replace(base, **run.get("config", {}))
        batch = run.get("batch", GLOBAL_BATCH)
        warnings.messages = []
        fa.reset_launch_counts()
        _sync(device)
        if run.get("drain"):
            row = drain_job(cfg, mesh, rank, device, coordinator_watcher(rank),
                            os.path.join(os.environ["DRAIN_CKPT_DIR"], run["name"]),
                            max_steps=run["steps"], max_seconds=120, next_step=True)
            steps = row["stopped_at_step"] + 1
        else:
            model, optimizer = wl.create_train_state(cfg, device, seed=0, mesh=mesh)
            step = wl.make_train_step(model, optimizer, mesh)
            row = {"losses": [], "step_ms": []}
            for i in range(run["steps"]):
                tokens = wl.make_batch(cfg, batch, seed=0 if run.get("fixed_batch") else i, device=device)
                t0 = time.perf_counter()
                row["losses"].append(float(step(tokens)))  # float() waits for the device
                row["step_ms"].append((time.perf_counter() - t0) * 1e3)
                if i == 0 and run.get("grads"):  # the same on every rank: rank 0 keeps them
                    grads = wl.gather_params({n: p.grad for n, p in model.named_parameters()}, mesh)
                    if rank == 0:
                        tensors[run["name"]] = {n: g.cpu() for n, g in grads.items()}
            row["shard_shapes"] = {n: list(p.shape) for n, p in model.named_parameters()}
            row["plan"] = _plan(model)
            steps = run["steps"]
        launches, device_launches = dict(fa.launch_counts), flash_device_launches()
        if not run.get("drain") and device.type == "cuda":
            row["device"] = smoke.device_busy(lambda: step(tokens), 1)  # one more step, traced
        plan = row["plan"]
        seq_index = mesh.get_local_rank("seq")
        row.update(
            steps=steps, warnings=list(warnings.messages),
            index={axis: mesh.get_local_rank(axis) for axis in distributed.AXES},
            pairs=(len(ra.ring_schedule(sp, seq_index, True, plan["layout"]))
                   if plan["tier"] == "ring" and plan["use_flash"] else 0),
            launches=launches, device_launches=device_launches,
            transport=ra.ring_transport(mesh.get_group("seq"), device),
        )
        report[run["name"]] = row
    logger.removeHandler(warnings)
    torch.save(tensors, out_path)
    return report


def pipeline_run(cfg, device, steps: int, microbatches: int, batch: int, out_path: str) -> dict:
    """The ``pipeline`` mode (module docstring); returns the report."""
    mesh = wl.make_pipeline_mesh(dist.get_world_size())
    stage = mesh.get_local_rank()
    block, rest = wl.pipeline_stage_params(wl.TinyLM(cfg, device, seed=0).state_dict(), cfg.n_layers, stage)
    tokens = wl.make_batch(cfg, batch, seed=0, device=device)
    loss = wl.pipeline_loss_fn(cfg, mesh, block, rest, tokens, microbatches)
    loss.backward()
    grads = {**{f"block.{k}": v.grad.cpu() for k, v in block.items()},
             **{k: v.grad.cpu() for k, v in rest.items()}}
    torch.save(grads, out_path)
    optimizer = torch.optim.AdamW([*block.values(), *rest.values()], **wl.ADAMW)
    step = wl.make_pipeline_train_step(cfg, mesh, optimizer, microbatches)
    fa.reset_launch_counts()
    row = {"losses": [], "step_ms": []}
    for _ in range(steps):
        t0 = time.perf_counter()
        row["losses"].append(float(step(block, rest, tokens)))  # float() waits for the device
        row["step_ms"].append((time.perf_counter() - t0) * 1e3)
    row.update(
        stage=stage, loss=float(loss), launches=dict(fa.launch_counts),
        device_launches=flash_device_launches(),
        shapes={k: list(v.shape) for k, v in [*block.items(), *rest.items()]},
    )
    if device.type == "cuda":  # one more step, traced
        row["device"] = smoke.device_busy(lambda: step(block, rest, tokens), 1)
    return row


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """*world* worker processes of one job on this host, started at once:
    ``python -m k8s_operator_libs_tpu_torch.hack.dist_worker *args*``
    (``{rank}`` in an argument becomes the rank), each with its identity
    and *env* in its environment.  As torchrun does for several ranks on
    one host, each gets an equal share of the cores for its intra-op
    threads (``OMP_NUM_THREADS``), unless *env* or the environment sets
    it: ranks that each spin a thread per core starve one another.  A
    thread per pipe keeps every line.  Use it as a context manager:
    leaving it kills what still runs."""

    def __init__(self, world: int, args, env=None) -> None:
        root = Path(__file__).resolve().parents[2]  # the package's parent
        port = str(free_port())
        threads = str(max(1, (os.cpu_count() or 1) // world))
        self.procs, self.stdout, self.stderr, self._readers = [], [], [], []
        for rank in range(world):
            rank_env = dict(os.environ, **(env or {}), MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=port, WORLD_SIZE=str(world), RANK=str(rank))
            rank_env.setdefault("OMP_NUM_THREADS", threads)
            rank_env.pop("LOCAL_RANK", None)
            proc = subprocess.Popen(
                [sys.executable, "-m", __spec__.name, *(a.replace("{rank}", str(rank)) for a in args)],
                env=rank_env, cwd=root, stdin=subprocess.DEVNULL,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            self.procs.append(proc)
            out, err = [], []
            self.stdout.append(out)
            self.stderr.append(err)
            for pipe, lines in ((proc.stdout, out), (proc.stderr, err)):
                reader = threading.Thread(target=self._read, args=(pipe, lines), daemon=True)
                reader.start()
                self._readers.append(reader)

    @staticmethod
    def _read(pipe, lines) -> None:
        for line in pipe:
            lines.append(line.rstrip("\n"))

    def wait_for(self, rank: int, needle: str, timeout: float) -> str:
        """The first stderr line of *rank* holding *needle*; raises if the
        rank exits first or *timeout* seconds pass."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            hit = next((ln for ln in list(self.stderr[rank]) if needle in ln), None)
            if hit is not None:
                return hit
            if self.procs[rank].poll() is not None:
                break
            time.sleep(0.05)
        raise RuntimeError(
            f"rank {rank}: no {needle!r} on stderr (exit {self.procs[rank].poll()}):\n"
            + "\n".join(self.stderr[rank][-30:])
        )

    def finish(self, timeout: float) -> list:
        """Wait for every rank under one deadline; returns (exit code,
        stdout lines, stderr lines) by rank.  Raises TimeoutError, after
        killing every rank, when the deadline passes."""
        deadline = time.monotonic() + timeout
        for proc in self.procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired as err:
                self.kill()
                raise TimeoutError(
                    f"a rank outlived {timeout} s; stderr tails:\n"
                    + "\n".join("\n".join(lines[-10:]) for lines in self.stderr)
                ) from err
        for reader in self._readers:
            reader.join(timeout=10)
        return [(p.returncode, out, err) for p, out, err in zip(self.procs, self.stdout, self.stderr)]

    def results(self, timeout: float) -> list:
        """Each rank's JSON line, by rank; raises unless every rank exited 0."""
        ranks = self.finish(timeout)
        for rank, (code, _, err) in enumerate(ranks):
            if code != 0:
                raise RuntimeError(f"rank {rank} exited {code}:\n" + "\n".join(err[-40:]))
        return [json.loads(next(ln for ln in reversed(out) if ln.startswith("{"))) for _, out, _ in ranks]

    def kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs:
            proc.wait(timeout=30)

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.kill()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("train", "drain", "ring", "mesh", "spmd", "pipeline", "dryrun"))
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                        help="default: nccl on the card, gloo on the CPU")
    parser.add_argument("--config", choices=("tiny", "smoke"), default="tiny")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--inputs", help="ring: the cases, from torch.save; spmd: the runs, JSON")
    parser.add_argument("--out", help="ring, spmd: where this rank's tensors go")
    parser.add_argument("--tp", type=int, default=1, help="mesh: the model axis")
    parser.add_argument("--batch", type=int, default=GLOBAL_BATCH, help="pipeline: the batch")
    parser.add_argument("--microbatches", type=int, default=2, help="pipeline: microbatches")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("dist_worker: torch sees no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    if args.mode in ("ring", "spmd") and not (args.inputs and args.out):
        parser.error(f"{args.mode} needs --inputs and --out")
    if args.mode == "pipeline" and not args.out:
        parser.error("pipeline needs --out")
    t_start = time.perf_counter()
    rank, world = distributed.initialize_from_env(device=device, backend=args.backend)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    distributed.sync_global_devices("post-init")
    t_init = time.perf_counter()
    line = {"rank": rank, "world_size": world, "backend": dist.get_backend()}
    cfg = model_config(args.config, device)

    if args.mode == "mesh":
        mesh = distributed.global_mesh(tp=args.tp)
        line.update(
            mesh={"names": list(mesh.mesh_dim_names), "shape": list(mesh.shape)},
            allreduce_max=distributed.host_allreduce_max(float(rank)),
        )
    elif args.mode == "train":
        line.update(train_steps(cfg, distributed.global_mesh(), device, args.steps))
        line["flash_launches"] = flash_device_launches()
    elif args.mode == "drain":
        def progress(step, loss):
            print(f"[rank {rank}] step {step} loss {loss}", file=sys.stderr, flush=True)

        line.update(drain_job(
            cfg, distributed.global_mesh(), rank, device, coordinator_watcher(rank),
            os.environ["DRAIN_CKPT_DIR"],
            max_steps=int(os.environ.get("DRAIN_MAX_STEPS", "1000000")),
            max_seconds=float(os.environ.get("DRAIN_MAX_SECONDS", "180")),
            on_step=progress,
        ))
        line["flash_launches"] = flash_device_launches()
    elif args.mode == "spmd":
        with open(args.inputs) as f:
            runs = json.load(f)["runs"]
        line["runs"] = spmd_runs(runs, cfg, device, args.out)
    elif args.mode == "pipeline":
        line.update(pipeline_run(cfg, device, args.steps, args.microbatches, args.batch, args.out))
    elif args.mode == "dryrun":
        from ..graft_entry import dryrun_rank

        line["dryrun"] = dryrun_rank(device)
    else:
        group = distributed.global_mesh(dp=1, sp=world).get_group("seq")
        cases = torch.load(args.inputs, weights_only=True)["cases"]
        tensors, report = ring_cases(cases, group, device)
        torch.save(tensors, args.out)
        line.update(transport=ra.ring_transport(group, device), cases=report)

    distributed.sync_global_devices("pre-exit")
    line["seconds"] = {"init": t_init - t_start, "mode": time.perf_counter() - t_init}
    dist.destroy_process_group()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
