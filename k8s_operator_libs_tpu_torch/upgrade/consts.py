"""Annotation key format and values of the pre-drain checkpoint handshake.

A copy of the lines of ``k8s_operator_libs_tpu/upgrade/consts.py``
(``DOMAIN``, ``PRE_DRAIN_CHECKPOINT_ANNOTATION_KEY_FMT`` and its two
values, ``PRE_DRAIN_TRACEPARENT_ANNOTATION_KEY_FMT``) that the workload
side needs, so that the port imports nothing of
the JAX package.  The strings must stay equal to the orchestrator's: the
two sides meet on them.
"""

DOMAIN = "tpu.google.com"

#: Node annotation used for the checkpoint-on-drain handshake.
PRE_DRAIN_CHECKPOINT_ANNOTATION_KEY_FMT = DOMAIN + "/%s-pre-drain-checkpoint"

#: Values of the pre-drain-checkpoint annotation (each may carry a
#: ``:<token>`` suffix that the acknowledgement echoes).
PRE_DRAIN_CHECKPOINT_REQUESTED = "requested"
PRE_DRAIN_CHECKPOINT_DONE = "done"

#: Sibling annotation carrying the orchestrator's W3C ``traceparent``
#: across the handshake, so the workload's checkpoint save appears as a
#: child span of the drain that requested it.
PRE_DRAIN_TRACEPARENT_ANNOTATION_KEY_FMT = DOMAIN + "/%s-pre-drain-traceparent"
