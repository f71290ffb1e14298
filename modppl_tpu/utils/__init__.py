"""Numeric and pytree utilities.

JAX counterpart of the reference's free functions
(``logsumexp`` at modppl/src/lib.rs:34-45).
"""

from modppl_tpu.utils.numerics import logsumexp, effective_sample_size_from_log_weights
from modppl_tpu.utils.profiling import (
    annotate,
    capture_trace,
    compiled_cost,
    device_time,
    hlo_text,
)

__all__ = [
    "logsumexp",
    "effective_sample_size_from_log_weights",
    "annotate", "capture_trace", "device_time", "compiled_cost", "hlo_text",
]
