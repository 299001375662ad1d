from . import sampling, vec

__all__ = ["vec", "sampling"]
