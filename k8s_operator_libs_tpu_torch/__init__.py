"""k8s_operator_libs_tpu_torch — the PyTorch/CUDA port of
:mod:`k8s_operator_libs_tpu`, for NVIDIA H100 fleets: the workload side
and, so far, the control plane's vocabulary, its in-memory cluster and
HTTP client, and the observability leaves.

Module names follow the JAX package, so each module's counterpart is
easy to find.  The port imports ``torch`` and numpy, never jax, and
nothing of the JAX package: it keeps its own copy of what it needs.  Its
control-plane strings are the GPU fleet's (the ``nvidia.com`` domain,
component ``gpu-driver``); their semantics are the JAX package's.

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
  obs/tracing.py           spans, the W3C traceparent carrier, and the
                           Chrome and OTLP exporters
  obs/events.py            the reason-coded decision log and its sinks
  obs/history.py           bounded in-process metric history
  consts.py                log levels
  metrics.py               counters, gauges, histograms and their
                           Prometheus exposition
  api/intstr.py,           IntOrString and the upgrade-policy spec types
  api/upgrade_spec.py
  upgrade/consts.py        states, label and annotation key formats
  upgrade/util.py          key builders, StringSet, KeyedMutex, events
  upgrade/history.py       per-node rollout history from cluster Events
  upgrade/timeline.py      per-node transition timelines (FlightRecorder)
  upgrade/schedule.py      maintenance windows and admission pacing
  tpu/topology.py          NVLink domains: the unit of unavailability
  tpu/health.py            degraded-GPU detection and domain quarantine
  cluster/errors.py        the apiserver error taxonomy
  cluster/objects.py       object builders and predicates
  cluster/selectors.py,    label and field selectors; CRD structural
  cluster/schema.py        schemas (validation, defaulting)
  cluster/strategicmerge.py  strategic merge patch
  cluster/retry.py         retry on conflict and on overload
  cluster/client.py        the client protocol and the kind registry
  cluster/inmem.py         InMemoryCluster: the in-memory apiserver
  cluster/cache.py         InformerCache
  cluster/writepipeline.py WriteOp and the batching WriteDispatcher
  cluster/execauth.py      exec credential plugins (user.exec)
  cluster/kubeclient.py    KubeApiClient and KubeConfig: the Kubernetes
                           client over HTTP (watches, batches, TLS)
  cluster/apiserver.py     ApiServerFacade: the in-memory cluster served
                           over HTTP on a local port
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
