"""Observability utilities: structured step logs, the program's spans and
counters, traces."""

from gmpnp_tpu_torch.utils.logging import StepLogger
from gmpnp_tpu_torch.utils.profiling import (
    COUNTS, Span, Trace, count, span, trace_profile, tracing)

__all__ = ["COUNTS", "Span", "StepLogger", "Trace", "count", "span",
           "trace_profile", "tracing"]
