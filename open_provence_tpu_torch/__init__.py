"""open_provence_tpu_torch — the PyTorch/CUDA port of open_provence_tpu.

The same Provence-style reranker–pruner (a cross-encoder that scores a
query–context pair and emits per-token keep probabilities used to delete
irrelevant sentences from RAG context), on PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (``kernels/csrc``). On a CPU the kernels' plain
PyTorch versions run instead. The JAX package ``open_provence_tpu`` is the
numerics reference; this package imports neither it nor jax.
"""

from .configs import (
    DEFAULT_PROCESS_THRESHOLD,
    ModernBertBackboneConfig,
    OpenProvenceConfig,
    PruningHeadConfig,
)
from .inference import OpenProvenceModel
from .models.model import (
    OpenProvenceModule,
    build_module,
    keep_probs_from_logits,
    ranking_score_from_logits,
)
from .utils.convert import init_params, state_dict_from_flax

__version__ = "0.1.0"


def __getattr__(name):
    # The encoder, the wrappers and the training names load lazily, as in
    # the JAX package's __init__, so ``import open_provence_tpu_torch`` stays
    # light.
    if name == "OpenProvenceEncoder":
        from .encoder import OpenProvenceEncoder

        return OpenProvenceEncoder
    if name == "OpenProvenceDataCollator":
        from .train.collator import OpenProvenceDataCollator

        return OpenProvenceDataCollator
    if name == "OpenProvenceLoss":
        from .train.losses import OpenProvenceLoss

        return OpenProvenceLoss
    if name == "OpenProvenceTrainer":
        from .train.trainer import OpenProvenceTrainer

        return OpenProvenceTrainer
    if name == "runner":
        from .train import runner

        return runner
    if name in (
        "OpenProvenceForSequenceClassification",
        "OpenProvenceForTokenClassification",
    ):
        from .models import hf_wrappers

        return getattr(hf_wrappers, name)
    raise AttributeError(name)


__all__ = [
    "DEFAULT_PROCESS_THRESHOLD",
    "ModernBertBackboneConfig",
    "OpenProvenceConfig",
    "PruningHeadConfig",
    "OpenProvenceEncoder",
    "OpenProvenceModel",
    "OpenProvenceForSequenceClassification",
    "OpenProvenceForTokenClassification",
    "OpenProvenceModule",
    "build_module",
    "keep_probs_from_logits",
    "ranking_score_from_logits",
    "init_params",
    "state_dict_from_flax",
    "__version__",
]
