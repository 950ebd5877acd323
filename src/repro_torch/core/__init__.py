"""The port's own copies of the reference's numpy-only core modules that the
device plane and its control plane need: the strategy registry, the latency
models (``latency``), the latency monitors (``monitor``) and the planners
with the damped ``Replanner`` (``planner``)."""
