"""The port's core: its own copies of the reference's numpy-only modules
(the strategy registry, the latency models ``latency``, the monitors
``monitor``, the planners with the damped ``Replanner`` ``planner``, the
transfer DAGs ``schedule``, the WAN simulator ``simulator``, the epoch
sinks ``sinks``) and the WAN sync plane's database on the device: the
CRDT store ``crdt``, epoch OCC ``occ``, the white-data filter
``whitedata``, the YCSB and TPC-C generators and the diurnal load
``workload``, the replication engine ``replication`` (its WAN payloads
compressed under ``geococo-zlib``, the Raft plane ``RaftCluster`` beside
it) with its streaming timeline ``stream``.  The read serving plane that
reads its views sits above it, in ``repro_torch.serve``."""

from .replication import advance_views
from .sinks import EpochContext, EpochSink
from .stream import EpochTimings, StreamingTimeline

__all__ = ["EpochContext", "EpochSink", "EpochTimings", "StreamingTimeline", "advance_views"]
