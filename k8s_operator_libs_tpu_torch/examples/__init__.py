"""Runnable examples of the port (``python -m k8s_operator_libs_tpu_torch.examples.<name>``)."""
