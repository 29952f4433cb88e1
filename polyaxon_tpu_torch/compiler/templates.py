"""Minimal template engine for ``{{ expr }}`` resolution.

The reference uses Jinja-style templating inside specs.  We implement the
subset the capability surface needs — dotted lookups, bare IO names, and a
few filters — with no external dependency:

    {{ lr }}                      -> inputs.lr
    {{ globals.run_outputs_path }}
    {{ matrix.lr }}
    {{ params.batch | int }}

The port's own copy of ``polyaxon_tpu/compiler/templates.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Union

from ..flow.io import TEMPLATE_RE

_FILTERS = {
    "int": int,
    "float": float,
    "str": str,
    "bool": bool,
    "json": lambda v: json.dumps(v),
    "upper": lambda v: str(v).upper(),
    "lower": lambda v: str(v).lower(),
    "basename": lambda v: str(v).rsplit("/", 1)[-1],
}


class TemplateError(ValueError):
    pass


def _lookup(path: str, ctx: Dict[str, Any]) -> Any:
    cur: Any = ctx
    for part in path.split("."):
        if isinstance(cur, dict):
            if part not in cur:
                raise TemplateError(f"Unknown context path: {path!r}")
            cur = cur[part]
        elif isinstance(cur, (list, tuple)) and part.lstrip("-").isdigit():
            try:
                cur = cur[int(part)]
            except IndexError:
                raise TemplateError(
                    f"Index {part} out of range in context path {path!r} "
                    f"(length {len(cur)})"
                )
        else:
            attr = getattr(cur, part, _MISSING)
            if attr is _MISSING:
                raise TemplateError(f"Unknown context path: {path!r}")
            cur = attr
    return cur


_MISSING = object()


def _eval_expr(expr: str, ctx: Dict[str, Any]) -> Any:
    parts = [p.strip() for p in expr.split("|")]
    value = _lookup(parts[0], ctx)
    for filt in parts[1:]:
        fn = _FILTERS.get(filt)
        if fn is None:
            raise TemplateError(f"Unknown template filter: {filt!r}")
        value = fn(value)
    return value


def resolve_str(text: str, ctx: Dict[str, Any]) -> Any:
    """Resolve templates in one string.

    A string that is exactly one template returns the native value
    (so ``{{ epochs }}`` can stay an int); otherwise values are
    interpolated into the surrounding text.
    """
    match = TEMPLATE_RE.fullmatch(text.strip())
    if match:
        return _eval_expr(match.group(1), ctx)

    def sub(m: "re.Match[str]") -> str:
        v = _eval_expr(m.group(1), ctx)
        return json.dumps(v) if isinstance(v, (dict, list)) else str(v)

    return TEMPLATE_RE.sub(sub, text)


def resolve_obj(obj: Any, ctx: Dict[str, Any]) -> Any:
    """Recursively resolve templates in nested dicts/lists/strings."""
    if isinstance(obj, str):
        return resolve_str(obj, ctx) if "{{" in obj else obj
    if isinstance(obj, dict):
        return {k: resolve_obj(v, ctx) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [resolve_obj(v, ctx) for v in obj]
    return obj


def has_template(obj: Any) -> bool:
    if isinstance(obj, str):
        return "{{" in obj
    if isinstance(obj, dict):
        return any(has_template(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(has_template(v) for v in obj)
    return False
