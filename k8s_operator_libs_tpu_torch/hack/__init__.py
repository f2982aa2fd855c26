"""Runners for the card: ``python -m k8s_operator_libs_tpu_torch.hack.gpu_smoke``,
``python -m k8s_operator_libs_tpu_torch.hack.gpu_stage``, and one rank of a
multi-process job, ``python -m k8s_operator_libs_tpu_torch.hack.dist_worker``."""
