from .engine import OpenProvenceModel, OpenProvenceRawPrediction

__all__ = ["OpenProvenceModel", "OpenProvenceRawPrediction"]
