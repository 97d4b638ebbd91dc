from .ops import het_kernel

__all__ = ["het_kernel"]
