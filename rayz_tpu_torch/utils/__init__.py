from . import profiling, sampling, vec
from .profiling import RenderStats, timed_render, trace

__all__ = ["vec", "sampling", "profiling", "RenderStats", "timed_render",
           "trace"]
