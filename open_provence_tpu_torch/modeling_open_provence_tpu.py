"""Legacy/compat import path re-exports.

The port's counterpart of the JAX package's ``modeling_open_provence_tpu.py``
(itself after the reference's modeling_open_provence_transformers.py): the
standalone-bundle module names from inside the installed package, so code
written against a checkpoint bundle (``import modeling_open_provence_tpu``)
also works as ``from open_provence_tpu_torch import modeling_open_provence_tpu``.
"""

from .configs import (
    DEFAULT_PROCESS_THRESHOLD,
    ModernBertBackboneConfig,
    OpenProvenceConfig,
    PruningHeadConfig,
)
from .encoder import OpenProvenceEncoder
from .inference import OpenProvenceModel, OpenProvenceRawPrediction
from .models.hf_wrappers import (
    OpenProvenceForSequenceClassification,
    OpenProvenceForTokenClassification,
)
from .utils.tracing import ProcessPerformanceTrace

__all__ = [
    "DEFAULT_PROCESS_THRESHOLD",
    "ModernBertBackboneConfig",
    "OpenProvenceConfig",
    "PruningHeadConfig",
    "OpenProvenceEncoder",
    "OpenProvenceModel",
    "OpenProvenceForSequenceClassification",
    "OpenProvenceForTokenClassification",
    "OpenProvenceRawPrediction",
    "ProcessPerformanceTrace",
]
