"""The port's core: its own copies of the reference's numpy-only modules
(the strategy registry, the latency models ``latency``, the monitors
``monitor``, the planners with the damped ``Replanner`` ``planner``, the
transfer DAGs ``schedule``, the WAN simulator ``simulator``, the epoch
sinks ``sinks``) and the WAN sync plane's database on the device: the
CRDT store ``crdt``, epoch OCC ``occ``, the white-data filter
``whitedata``, the YCSB and TPC-C generators and the diurnal load
``workload``, and the replication engine ``replication``."""
