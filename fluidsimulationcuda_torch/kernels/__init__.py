from .dispatch import OpSet, get_ops

__all__ = ["OpSet", "get_ops"]
