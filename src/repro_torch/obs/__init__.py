"""Structured tracing (Chrome/Perfetto trace-event JSON)."""
from .tracer import (NullTracer, Tracer, disable_tracing, enable_tracing,
                     get_tracer, set_tracer, tracing)

__all__ = ["Tracer", "NullTracer", "get_tracer", "set_tracer",
           "enable_tracing", "disable_tracing", "tracing"]
