"""process() input-shape contract: normalization of questions, contexts, and
titles (behavior of reference modeling_open_provence_standalone.py:2261-2434).

The contract supports four context shapes, detected up front and carried as a
tag through the pipeline so the output can be collapsed back to the caller's
layout (inference/postprocess.py):

* ``str``     — one query, one context string
* ``list``    — one query, many contexts
* ``aligned`` — N queries ↔ N context strings, one each
* ``nested``  — N queries ↔ N context lists (inner lists may be pre-split
  sentences)

Implementation style differs from the reference: a shape classifier picks a
tag, and per-shape builder functions (dispatch table) produce the normalized
``list[list[context]]``.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any

_SCALAR_SEQUENCES = (str, bytes, bytearray)


def _is_listish(value: Any) -> bool:
    """A sequence that is not a string-like scalar."""
    return isinstance(value, Sequence) and not isinstance(value, _SCALAR_SEQUENCES)


def _coerce_entry(item: Any) -> Any:
    """One context entry: a pre-split sentence list stays a list of strings,
    anything else becomes a string."""
    if _is_listish(item):
        return [str(part) for part in item]
    return str(item)


def _classify_shape(n_queries: int, context: Any) -> str:
    if isinstance(context, str):
        return "str"
    if not _is_listish(context):
        raise ValueError("Unsupported context format: expected str or sequence")
    if n_queries == 1:
        return "list"
    if all(not _is_listish(entry) for entry in context):
        return "aligned"
    return "nested"


def _build_str(queries: list[str], context: Any) -> list[list[Any]]:
    if len(queries) != 1:
        raise ValueError("A single context string requires exactly one query")
    return [[context]]


def _build_list(queries: list[str], context: Any) -> list[list[Any]]:
    if len(queries) != 1:
        raise ValueError("A flat context list requires exactly one query")
    return [[_coerce_entry(item) for item in context]]


def _build_aligned(queries: list[str], context: Any) -> list[list[Any]]:
    rows = [[str(entry)] for entry in context]
    if len(rows) != len(queries):
        raise ValueError(
            f"Aligned contexts: got {len(rows)} contexts for {len(queries)} queries"
        )
    return rows


def _build_nested(queries: list[str], context: Any) -> list[list[Any]]:
    rows: list[list[Any]] = []
    for entry in context:
        if not _is_listish(entry):
            raise ValueError(
                "Nested contexts: every per-query entry must itself be a sequence"
            )
        rows.append([_coerce_entry(item) for item in entry])
    if len(rows) != len(queries):
        raise ValueError(
            f"Nested contexts: got {len(rows)} context lists for {len(queries)} queries"
        )
    return rows


_CONTEXT_BUILDERS = {
    "str": _build_str,
    "list": _build_list,
    "aligned": _build_aligned,
    "nested": _build_nested,
}


def normalize_inputs(
    question: str | Any,
    context: Any,
) -> tuple[list[str], list[list[Any]], str]:
    """→ (queries, per-query context groups, shape tag)."""
    queries = [question] if isinstance(question, str) else [str(q) for q in question]
    shape = _classify_shape(len(queries), context)
    return queries, _CONTEXT_BUILDERS[shape](queries, context), shape


# --- titles -----------------------------------------------------------------


def prepare_titles(
    title: Any,
    queries: list[str],
    contexts: list[list[Any]],
) -> list[Any]:
    """Broadcast the ``title`` argument to one spec per query (behavior of
    standalone:2325-2360). Possible per-query specs: None, the sentinel
    string "first_sentence", or a list of per-context titles."""
    n = len(queries)
    if title is None:
        return [None] * n
    if isinstance(title, str):
        if title == "first_sentence":
            return ["first_sentence"] * n
        # One literal title applied to every context of every query.
        return [[title] * len(group) for group in contexts]
    if _is_listish(title):
        entries = [_coerce_entry(item) for item in title]
        flat = all(isinstance(item, str) for item in entries)
        if n == 1 and flat:
            return [entries]
        if len(entries) == n:
            if all(isinstance(item, list) for item in entries):
                return entries
            if flat:
                # One title per query, broadcast over that query's contexts.
                return [[value] * len(contexts[idx]) for idx, value in enumerate(entries)]
    raise ValueError("Unsupported title format")


def _behead_lines(segments: list[str]) -> tuple[str, list[str]]:
    """Pop the first non-blank segment off as the title; return
    (title, remaining segments)."""
    for idx, segment in enumerate(segments):
        if segment.strip():
            return segment.rstrip("\r\n"), segments[idx + 1 :]
    return "", segments


def extract_first_line_titles(
    contexts: list[list[Any]],
) -> tuple[list[list[Any]], list[list[str]]]:
    """Split the first non-empty line off each context as its title
    (standalone:2362-2410). Pre-split (list) contexts behead a sentence;
    string contexts behead a line."""
    beheaded: list[list[Any]] = []
    titles: list[list[str]] = []
    for group in contexts:
        group_out: list[Any] = []
        heads: list[str] = []
        for entry in group:
            if type(entry) is list:
                head, rest = _behead_lines([str(v) for v in entry])
                group_out.append(rest)
            else:
                head, rest_lines = _behead_lines(str(entry).splitlines(keepends=True))
                group_out.append("".join(rest_lines))
            heads.append(head)
        beheaded.append(group_out)
        titles.append(heads)
    return beheaded, titles


def resolve_titles(
    queries: list[str],
    contexts: list[list[Any]],
    title: Any,
    *,
    first_line_as_title: bool,
) -> tuple[list[list[Any]], list[Any]]:
    """Apply first-line extraction (mutually exclusive with an explicit
    title) and broadcast to per-query specs (standalone:2412-2434)."""
    if first_line_as_title:
        if title not in (None, "first_sentence"):
            raise ValueError(
                "first_line_as_title=True cannot be combined with an explicit title override."
            )
        contexts, extracted = extract_first_line_titles(contexts)
        title = extracted
    return contexts, prepare_titles(title, queries, contexts)


def resolve_prefix_sentences(
    title_spec: Any,
    context_idx: int,
) -> tuple[list[str], bool]:
    """One context's title prefix sentences + whether the title is the
    context's own first sentence (standalone:1971-2005). The final prefix
    sentence is newline-terminated so it splits off cleanly downstream."""
    if title_spec == "first_sentence":
        return [], True

    if isinstance(title_spec, list):
        entry = title_spec[context_idx] if context_idx < len(title_spec) else None
    else:
        entry = title_spec

    raw: list[Any]
    if type(entry) is list:
        raw = entry
    elif isinstance(entry, str):
        raw = [entry]
    else:
        raw = []
    prefixes = [item.strip() for item in raw if isinstance(item, str) and item.strip()]
    if prefixes:
        prefixes[-1] = prefixes[-1].rstrip("\n") + "\n"
    return prefixes, False
