from .grad import grad_multiply
from .profiling import device_breakdown, span, trace

__all__ = ["device_breakdown", "grad_multiply", "span", "trace"]
