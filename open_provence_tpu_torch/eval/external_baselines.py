"""External-baseline adapters for eval_mldr.

The port's copy of the JAX package's ``eval/external_baselines.py``,
unchanged: the adapter was torch already.

Counterpart of the reference's naver-provence support in
scripts/eval_mldr.py:34 (detection regex), :68-74 (routing) and :75-125
(``_prepare_naver_provence_model``): the published
``naver/provence-reranker-debertav3-v1`` baseline is a torch ``AutoModel``
with ``trust_remote_code`` whose ``process()`` signature matches ours, so the
MLDR harness can produce apples-to-apples rows for eval_report.md:44.

Torch-side by necessity (the baseline ships torch remote code); everything is
gated on torch availability and exercised with fakes in tests — loading the
real checkpoint needs network access.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path
from typing import Any, Callable

NAVER_PROVENCE_PATTERN = re.compile(r"^naver/.*provence.*", re.IGNORECASE)


def is_naver_provence_model(model_identifier: str, *, is_local: bool | None = None) -> bool:
    """True for hub ids like ``naver/provence-reranker-debertav3-v1``
    (reference eval_mldr.py:68-74). Local checkpoint paths never match."""
    if is_local is None:
        is_local = Path(model_identifier).expanduser().exists()
    if is_local:
        return False
    return bool(NAVER_PROVENCE_PATTERN.search(model_identifier.strip()))


def prepare_naver_provence_model(
    model: Any,
    *,
    max_length: int | None = None,
    disable_progress: bool = False,
) -> Callable[..., dict[str, Any]]:
    """Adapt a loaded naver-provence torch model into a ``process()`` callable
    usable by the MLDR harness (behavioral counterpart of reference
    eval_mldr.py:75-125; the *patch points* below are dictated by the
    checkpoint's remote code, not chosen here):

    * the remote ``process()`` converts forward outputs straight to numpy,
      which raises on bfloat16 — we shadow ``forward`` at the instance level
      and promote every half-precision tensor in its output mapping to fp32
      (covers ``ranking_scores`` and ``compression_logits``, the two fields
      the remote code touches);
    * a requested ``max_length`` must land on BOTH ``model.max_len`` (read by
      the remote tokenization loop) and
      ``config.max_position_embeddings`` (read when building position ids);
    * the remote module iterates batches under its own module-level ``tqdm``
      symbol, so silencing progress means replacing that symbol.
    """
    import torch

    unpatched_forward = model.forward

    def _promoting_forward(*args: Any, **kwargs: Any):
        out = unpatched_forward(*args, **kwargs)
        if hasattr(out, "keys"):
            for name in list(out.keys()):
                value = out[name]
                if torch.is_tensor(value) and value.dtype == torch.bfloat16:
                    out[name] = value.float()
        return out

    model.forward = _promoting_forward

    if max_length is not None:
        if hasattr(model, "max_len"):
            model.max_len = max_length
        config = getattr(model, "config", None)
        if config is not None and hasattr(config, "max_position_embeddings"):
            config.max_position_embeddings = max_length

    if disable_progress:
        remote_module = sys.modules.get(type(model).__module__)
        if remote_module is not None and hasattr(remote_module, "tqdm"):
            remote_module.tqdm = lambda iterable, *a, **k: iterable

    process_fn = getattr(model, "process", None)
    if not callable(process_fn):
        raise AttributeError(
            "naver-provence remote code exposes no callable `process` method; "
            "cannot adapt it for the MLDR harness"
        )
    return process_fn


def load_naver_process_fn(
    model_identifier: str,
    *,
    max_length: int | None = None,
    device: str | None = None,
    torch_dtype: Any = None,
    disable_progress: bool = False,
    auto_model_cls: Any = None,
) -> tuple[Callable[..., dict[str, Any]], Any]:
    """Load the baseline via ``AutoModel.from_pretrained(trust_remote_code)``
    and return (process_fn, model). Requires torch + network; tests inject
    ``auto_model_cls`` fakes."""
    if auto_model_cls is None:
        from transformers import AutoModel as auto_model_cls  # type: ignore[no-redef]

    kwargs: dict[str, Any] = {"trust_remote_code": True}
    if torch_dtype is not None:
        # Older transformers silently ignore an unknown ``dtype`` kwarg,
        # loading fp32 with no warning; ``torch_dtype`` is accepted by all
        # versions (a deprecated alias on current ones).
        kwargs["torch_dtype"] = torch_dtype
    model = auto_model_cls.from_pretrained(model_identifier, **kwargs)
    if device:
        model = model.to(device)
    model.eval()
    process_fn = prepare_naver_provence_model(
        model, max_length=max_length, disable_progress=disable_progress
    )
    return process_fn, model
