"""Runners for the card: ``python -m k8s_operator_libs_tpu_torch.hack.gpu_smoke`` and
``python -m k8s_operator_libs_tpu_torch.hack.gpu_stage``."""
