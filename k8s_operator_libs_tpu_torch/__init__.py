"""k8s_operator_libs_tpu_torch — the PyTorch/CUDA port of the workload
side of :mod:`k8s_operator_libs_tpu`, for an NVIDIA H100.

Module names follow the JAX package, so each module's counterpart is
easy to find.  The port imports ``torch`` and numpy, never jax, and
nothing of the JAX package: where it needs a few lines of the control
plane (the drain-handshake annotation keys) it keeps its own copy.

  tpu/flash_attention.py   flash attention: three CUDA kernels
                           (csrc/flash_attention.cu) beside their plain
                           PyTorch versions
  tpu/ring_attention.py    the dense attention oracle
  tpu/workload.py          TinyLM, the train step, checkpoints and the
                           drain-aware CheckpointingTrainer
  tpu/drain_handshake.py   the workload side of the pre-drain handshake
  tpu/smoke.py             train, time, drain, restore and resume
  cluster/inmem.py         a minimal in-memory node store
  upgrade/consts.py,       the annotation key format and values, and the
  upgrade/util.py          component-name setting
  convert.py               flax TinyLM params <-> torch state_dict
  _build.py                nvcc build and ctypes loading of csrc/
"""

__version__ = "0.1.0"
