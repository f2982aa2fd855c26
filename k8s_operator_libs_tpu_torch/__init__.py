"""k8s_operator_libs_tpu_torch — the PyTorch/CUDA port of the workload
side of :mod:`k8s_operator_libs_tpu`, for an NVIDIA H100.

Module names follow the JAX package, so each module's counterpart is
easy to find.  The port imports ``torch`` and numpy, never jax, and
nothing of the JAX package: where it needs a few lines of the control
plane (the drain-handshake annotation keys) it keeps its own copy.

  tpu/flash_attention.py   flash attention: three CUDA kernels
                           (csrc/flash_attention.cu) beside their plain
                           PyTorch versions
  tpu/ring_attention.py    the dense attention oracle; the einsum, flash
                           and zigzag flash rings over a process group
  tpu/workload.py          TinyLM, the train step (data-parallel over a
                           mesh), checkpoints and the drain-aware
                           CheckpointingTrainer
  tpu/distributed.py       process identity, the global mesh and the host
                           collectives of a torch.distributed job
  tpu/multihost_trainer.py MultihostDrainLoop: the drain of a
                           multi-process job
  tpu/drain_handshake.py   the workload side of the pre-drain handshake,
                           under a checkpoint-drain span
  tpu/smoke.py             train, time, drain, restore and resume; the
                           staged benches (STAGES, run_stage)
  obs/tracing.py           spans and the W3C traceparent carrier
  cluster/inmem.py         a minimal in-memory node store
  cluster/kubeclient.py    a minimal Node client over urllib, and a
                           server of the in-memory store
  upgrade/consts.py,       the annotation key formats and values, and the
  upgrade/util.py          component-name setting
  convert.py               flax TinyLM params <-> torch state_dict
  graft_entry.py           entry(): a loss step on TinyLM
  examples/generate.py     train or restore, then KV-cache decode
  hack/gpu_smoke.py,       runners: run_smoke's record, and every stage
  hack/gpu_stage.py        in its own process
  hack/dist_worker.py      one rank of a multi-process job (train, drain,
                           ring, mesh), and Ranks to start a job
  _build.py                nvcc build and ctypes loading of csrc/
"""

__version__ = "0.1.0"
