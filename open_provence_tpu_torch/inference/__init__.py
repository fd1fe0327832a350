from .engine import OpenProvenceModel

__all__ = ["OpenProvenceModel"]
