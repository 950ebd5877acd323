"""The port's own copies of the reference's numpy-only core modules that the
device plane needs: the strategy registry and ``GroupPlan``."""
