from .convert import init_params, state_dict_from_flax
from .tracing import ProcessPerformanceTrace, profiler_trace

__all__ = [
    "init_params",
    "state_dict_from_flax",
    "ProcessPerformanceTrace",
    "profiler_trace",
]
