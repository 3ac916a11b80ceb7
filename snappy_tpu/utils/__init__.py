"""Metrics, profiling, and compile-cache utilities."""

from .metrics import Metrics, time_fn
from .profiling import profile_to, trace_annotation

__all__ = ["Metrics", "profile_to", "time_fn", "trace_annotation"]
