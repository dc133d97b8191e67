from .grad import grad_multiply
from .profiling import Throughput, device_breakdown, trace

__all__ = ["Throughput", "device_breakdown", "grad_multiply", "trace"]
