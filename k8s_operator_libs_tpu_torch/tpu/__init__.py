"""The workload side: model, kernels, trainer and drain handshake.

Submodules are imported by the caller (``from
k8s_operator_libs_tpu_torch.tpu import workload``)."""
