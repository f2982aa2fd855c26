"""The entry points of the port: a loss step on TinyLM, and the
multi-rank dryrun of every parallel train step.

The port of the JAX package's ``__graft_entry__.py``:

* :func:`entry`: the same configuration (vocab 256, d_model 128, 8 heads,
  2 layers, d_ff 512, seq 128, bf16) and batch (8 rows of ``make_batch``
  seed 0);
* :func:`dryrun_multichip`: one full train step (forward, backward and
  AdamW) of each parallel layout over a job of ``n_ranks`` processes,
  each rank running :func:`dryrun_rank`.  The JAX dryrun takes one
  process with a virtual device per chip; here each device is a rank of
  ``torch.distributed``, started by ``hack.dist_worker``'s launcher.
"""

from __future__ import annotations

import torch

from .tpu import workload as wl

#: The dryrun's model: the JAX dryrun's (vocab 64, d_model 32, 4 heads,
#: 2 layers, d_ff 64, seq 16).
DRYRUN_BASE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16)
#: How far the ring and flash losses may stray from the gather losses on
#: the same weights and batch: the JAX dryrun's bound.
DRYRUN_TOL = 1e-4


def entry(device="cuda"):
    """Returns ``(fn, (model, tokens))``, where ``fn(model, tokens)`` is
    :func:`~.tpu.workload.loss_fn`: the next-token loss of the batch."""
    config = wl.ModelConfig(
        vocab_size=256,
        d_model=128,
        n_heads=8,
        n_layers=2,
        d_ff=512,
        max_seq_len=128,
        dtype=torch.bfloat16,
    )
    device = wl.resolve_device(device)
    model, _optimizer = wl.create_train_state(config, device)
    tokens = wl.make_batch(config, batch_size=8, device=device)
    return wl.loss_fn, (model, tokens)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_rank(device) -> dict:
    """This rank's part of :func:`dryrun_multichip`, in an initialized job
    of n ranks; every rank runs every step and gets the same losses.
    Raises RuntimeError when a check fails.  The steps, as in JAX:

    * the dense model over dp x sp x tp (tp 2 and sp 2 where they fit);
    * the MoE (4 experts) over dp x tp x ep (ep 2 where it fits);
    * with sp > 1, gather SP, the ring and the flash ring at ``8·sp + 1``
      tokens: ring and flash ring within :data:`DRYRUN_TOL` of gather SP;
    * flash attention under pure data parallelism, within
      :data:`DRYRUN_TOL` of the gather model;
    * with n >= 2, one step of a 2-stage GPipe pipeline (ranks 0 and 1).

    Returns the losses by check."""
    import torch.distributed as dist

    from .tpu import distributed

    n = dist.get_world_size()

    def second_axis_fits(tp_: int) -> int:
        """2 when a second parallel axis (sp or ep) fits next to tp."""
        return 2 if n % (tp_ * 2) == 0 and n // tp_ >= 2 else 1

    def run_step(mesh, config, dp_: int) -> float:
        model, optimizer = wl.create_train_state(config, device, seed=0, mesh=mesh)
        step = wl.make_train_step(model, optimizer, mesh)
        return float(step(wl.make_batch(config, 2 * dp_, device=device)))

    losses = {}
    tp = 2 if n % 2 == 0 and n > 1 else 1
    sp = second_axis_fits(tp)
    dp = n // (tp * sp)
    mesh = distributed.global_mesh(dp=dp, tp=tp, sp=sp)
    losses["dense"] = run_step(mesh, wl.ModelConfig(seq_axis="seq" if sp > 1 else None, **DRYRUN_BASE), dp)
    _check(losses["dense"] > 0.0, f"dense loss {losses['dense']}")

    ep = second_axis_fits(tp)
    dp_moe = n // (tp * ep)
    losses["moe"] = run_step(
        distributed.global_mesh(dp=dp_moe, tp=tp, ep=ep),
        wl.ModelConfig(n_experts=4, **DRYRUN_BASE), dp_moe,
    )
    _check(losses["moe"] > 0.0, f"MoE loss {losses['moe']}")

    if sp > 1:
        # the sequence after the shift divides by sp, or the ring would
        # fall back to gather and the comparison be vacuous
        ring_base = dict(DRYRUN_BASE, max_seq_len=sp * 8 + 1, seq_axis="seq")
        for name, fields in (("gather_sp", {}), ("ring", {"ring_attention": True}),
                             ("ring_flash", {"ring_attention": True, "ring_flash": True})):
            losses[name] = run_step(mesh, wl.ModelConfig(**ring_base, **fields), dp)
        for name in ("ring", "ring_flash"):
            _check(abs(losses[name] - losses["gather_sp"]) < DRYRUN_TOL,
                   f"{name} loss {losses[name]} != gather-SP loss {losses['gather_sp']}")

    flash_mesh = distributed.global_mesh(dp=n)
    losses["gather"] = run_step(flash_mesh, wl.ModelConfig(**DRYRUN_BASE), n)
    losses["flash"] = run_step(flash_mesh, wl.ModelConfig(flash_attention=True, **DRYRUN_BASE), n)
    _check(abs(losses["flash"] - losses["gather"]) < DRYRUN_TOL,
           f"flash-attention loss {losses['flash']} != gather loss {losses['gather']}")

    if n >= 2:
        config = wl.ModelConfig(**DRYRUN_BASE)
        pp_mesh = wl.make_pipeline_mesh(2)
        if dist.get_rank() < 2:
            block, rest = wl.pipeline_stage_params(
                wl.TinyLM(config, device, seed=0).state_dict(), config.n_layers, pp_mesh.get_local_rank()
            )
            optimizer = torch.optim.AdamW([*block.values(), *rest.values()], **wl.ADAMW)
            step = wl.make_pipeline_train_step(config, pp_mesh, optimizer)
            losses["pipeline"] = float(step(block, rest, wl.make_batch(config, 4, device=device)))
            _check(losses["pipeline"] > 0.0, f"pipeline loss {losses['pipeline']}")
        distributed.sync_global_devices("dryrun-pipeline")
    return losses


def dryrun_multichip(n_ranks: int, device="cuda", backend=None, timeout: float = 300.0) -> dict:
    """One full sharded train step of each parallel layout (:func:`dryrun_rank`)
    over a job of *n_ranks* worker processes on this host, started by
    ``hack.dist_worker``.  *backend* is the transport, which the caller
    picks: gloo on the CPU; NCCL across cards, one a rank; gloo through
    the card's host buffers when ranks share a card (NCCL refuses that).
    None takes ``initialize_from_env``'s default, NCCL for ``cuda`` and
    gloo for ``cpu``.  The device defaults to ``cuda`` and raises without
    it.  Raises RuntimeError when a rank fails or a check does not hold;
    returns rank 0's losses by check."""
    device = wl.resolve_device(device)
    from .hack.dist_worker import Ranks

    args = ["dryrun", "--device", device.type, *(["--backend", backend] if backend else [])]
    with Ranks(n_ranks, args) as ranks:
        lines = ranks.results(timeout)
    return lines[0]["dryrun"]
