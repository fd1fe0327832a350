from .heads import PruningHead
from .model import (
    OpenProvenceModule,
    build_module,
    keep_probs_from_logits,
    ranking_score_from_logits,
)
from .modernbert import ModernBertForSequenceClassification, ModernBertModel

__all__ = [
    "PruningHead",
    "OpenProvenceModule",
    "build_module",
    "keep_probs_from_logits",
    "ranking_score_from_logits",
    "ModernBertForSequenceClassification",
    "ModernBertModel",
]
