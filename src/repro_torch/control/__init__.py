"""The port's network control plane (its own copy of ``repro.control``):
:class:`NetworkView` over traces (:class:`TraceView`), full-mesh EWMA
probing (:class:`MonitorView`) and Vivaldi coordinates
(:class:`VivaldiView`); :class:`ControlPlane`, which owns the damped
``Replanner`` and the relay-order search and emits typed
:class:`NetworkEvent`\\ s; the trainer (``repro_torch.train.trainer``)
subscribes and reacts to :class:`RelayOrderChanged` through each
``device_sync`` strategy's declared reaction."""

from .events import (
    LinkDegraded,
    LinkRecovered,
    NetworkEvent,
    PlanChanged,
    RelayOrderChanged,
)
from .network import MonitorView, NetworkView, TraceView, VivaldiView, as_view
from .plane import ControlPlane, relay_ring_order, ring_cost

__all__ = [
    "NetworkEvent",
    "LinkDegraded",
    "LinkRecovered",
    "PlanChanged",
    "RelayOrderChanged",
    "NetworkView",
    "TraceView",
    "MonitorView",
    "VivaldiView",
    "as_view",
    "ControlPlane",
    "relay_ring_order",
    "ring_cost",
]
