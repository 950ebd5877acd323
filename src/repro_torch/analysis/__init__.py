"""The port's own copies of the reference's static-analysis types that the
WAN plane needs: the shared :class:`Violation` diagnostic and the
declarative config-compatibility rule table that ``EngineConfig`` and
``ServeConfig`` validate through.  The reference's schedule verifier, lint, model checker
and mutation pass are not ported yet (ROADMAP §1, W7 and W8)."""

from .config_check import ConfigRule, check_config, validate_config
from .violations import Violation, format_violations

__all__ = ["ConfigRule", "check_config", "validate_config", "Violation",
           "format_violations"]
