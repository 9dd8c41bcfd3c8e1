"""Utilities: profiling, checkpoints, metrics and the numeric sanitizer,
the JAX package's exports; conversions to and from its states
(`utils.convert`), weights, the tokenizer and the export's specs stay in
their modules."""

from .checkpoint import restore_pipeline_state, save_pipeline_state
from .metrics import MetricsLogger
from .profiler import FrameTimer, device_trace
from .sanitizer import enable_from_env, nan_debug, validate_if_enabled, validate_outputs

# Honor MADPP_DEBUG_NANS=1 as soon as the package is imported.
enable_from_env()

__all__ = [
    "FrameTimer",
    "device_trace",
    "save_pipeline_state",
    "restore_pipeline_state",
    "MetricsLogger",
    "nan_debug",
    "validate_outputs",
    "validate_if_enabled",
    "enable_from_env",
]
