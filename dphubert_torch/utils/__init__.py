from .grad import grad_multiply

__all__ = ["grad_multiply"]
