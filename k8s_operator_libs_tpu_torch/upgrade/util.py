"""The managed-component name and the handshake key built from it.

A copy of the component-name setting of
``k8s_operator_libs_tpu/upgrade/util.py``: the name parameterizes the
annotation key (``tpu.google.com/<name>-pre-drain-checkpoint``)."""

from __future__ import annotations

import threading

from . import consts

_component_name = "tpu-runtime"
_component_lock = threading.Lock()


def set_component_name(name: str) -> None:
    """Set the process-global managed-component name."""
    if not name:
        raise ValueError("component name must be non-empty")
    global _component_name
    with _component_lock:
        _component_name = name


def get_component_name() -> str:
    with _component_lock:
        return _component_name


def get_pre_drain_checkpoint_annotation_key() -> str:
    """The checkpoint-on-drain handshake annotation key."""
    return consts.PRE_DRAIN_CHECKPOINT_ANNOTATION_KEY_FMT % get_component_name()
