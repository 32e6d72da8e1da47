"""Observability utilities: structured step logs, phase timers, traces."""

from gmpnp_tpu_torch.utils.logging import StepLogger
from gmpnp_tpu_torch.utils.profiling import PhaseTimer, trace_profile

__all__ = ["StepLogger", "PhaseTimer", "trace_profile"]
