"""The workload side and the fleet's topology.

* :mod:`.topology` — NVLink-domain grouping for the throttle
* :mod:`.health`   — degraded-GPU detection and domain quarantine

The workload modules (``workload``, ``flash_attention``,
``drain_handshake``, ...) are imported by the caller (``from
k8s_operator_libs_tpu_torch.tpu import workload``), keeping torch out of
the control plane's import path.
"""

from . import health, topology
from .health import SliceHealthManager

__all__ = ["topology", "health", "SliceHealthManager"]
