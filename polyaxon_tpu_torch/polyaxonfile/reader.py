"""Read, merge and normalize polyaxonfiles.

A polyaxonfile may contain:
  - ``kind: operation`` — an operation (optionally with inline component);
  - ``kind: component`` — a bare component (wrapped into an operation).

Multiple ``-f`` files deep-merge in order (later wins); ``-P name=value``
overrides params; ``--preset`` files apply with their declared patch
strategy (default post_merge).

The port's own copy of ``polyaxon_tpu/polyaxonfile/reader.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Union

import yaml

from ..flow import V1Component, V1Operation
from ..flow.base import patch_dict
from ..flow.io import params_from_dict


class PolyaxonfileError(ValueError):
    pass


def _load_file(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        raise PolyaxonfileError(f"Polyaxonfile not found: {path}")
    with open(path) as f:
        try:
            data = yaml.safe_load(f)
        except yaml.YAMLError as e:
            raise PolyaxonfileError(f"Invalid YAML in {path}: {e}") from e
    if not isinstance(data, dict):
        raise PolyaxonfileError(
            f"Polyaxonfile {path} must contain a mapping, got {type(data).__name__}"
        )
    return data


def _load(source: Union[str, Dict[str, Any]]) -> Dict[str, Any]:
    if isinstance(source, dict):
        return source
    # Only multi-line strings are treated as inline YAML; anything else is a
    # file path (so a typo'd path errors with "not found", not a parse error).
    if isinstance(source, str) and "\n" in source and not os.path.exists(source):
        data = yaml.safe_load(source)
        if not isinstance(data, dict):
            raise PolyaxonfileError("Inline polyaxonfile must be a mapping")
        return data
    return _load_file(source)


def _coerce_param_value(raw: str) -> Any:
    """CLI `-P key=value` values arrive as strings; YAML-parse scalars."""
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def read_polyaxonfile(
    sources: Union[str, Dict[str, Any], List[Union[str, Dict[str, Any]]]],
) -> Dict[str, Any]:
    """Deep-merge one or more YAML sources into a single spec dict."""
    if not isinstance(sources, list):
        sources = [sources]
    if not sources:
        raise PolyaxonfileError("No polyaxonfile provided")
    merged: Optional[Dict[str, Any]] = None
    for src in sources:
        data = _load(src)
        merged = data if merged is None else patch_dict(merged, data, "post_merge")
    return merged


def get_op_from_files(
    sources: Union[str, Dict[str, Any], List[Union[str, Dict[str, Any]]]],
    params: Optional[Dict[str, Any]] = None,
    presets: Optional[List[Union[str, Dict[str, Any]]]] = None,
    patches: Optional[List[Dict[str, Any]]] = None,
    name: Optional[str] = None,
) -> V1Operation:
    """Full CLI-equivalent pipeline: files + presets + -P params -> V1Operation."""
    import copy

    # Deep-copy so caller-supplied spec dicts are never mutated by merges
    # or -P writes (one dict may seed many operations).
    spec = copy.deepcopy(read_polyaxonfile(sources))
    kind = spec.get("kind")

    if kind == "component":
        component = V1Component.from_dict(spec)
        op_spec: Dict[str, Any] = {
            "kind": "operation",
            "component": spec,
            "name": name or component.name,
        }
    elif kind == "operation":
        op_spec = spec
        if name:
            op_spec["name"] = name
    else:
        raise PolyaxonfileError(
            f"Polyaxonfile kind must be 'operation' or 'component', got {kind!r}"
        )

    # Presets: operation-shaped fragments (isPreset: true) merged in.
    for preset in presets or []:
        pdata = _load(preset)
        pdata = dict(pdata)
        pdata.pop("isPreset", None)
        pdata.pop("is_preset", None)
        pdata.pop("kind", None)
        strategy = pdata.pop("patchStrategy", pdata.pop("patch_strategy", "post_merge"))
        op_spec = patch_dict(op_spec, pdata, strategy)

    # Explicit --patch fragments.
    for patch in patches or []:
        op_spec = patch_dict(op_spec, dict(patch), "post_merge")

    # -P overrides win over everything.
    if params:
        op_params = dict(op_spec.get("params") or {})
        for key, value in params.items():
            if isinstance(value, str):
                value = _coerce_param_value(value)
            op_params[key] = {"value": value}
        op_spec["params"] = op_params

    return V1Operation.from_dict(op_spec)


def check_polyaxonfile(
    sources,
    params: Optional[Dict[str, Any]] = None,
    presets=None,
    patches=None,
) -> V1Operation:
    """Validate a polyaxonfile; raises PolyaxonfileError on any problem."""
    try:
        op = get_op_from_files(sources, params=params, presets=presets,
                               patches=patches)
    except PolyaxonfileError:
        raise
    except Exception as e:
        raise PolyaxonfileError(str(e)) from e
    if op.has_component:
        op.component.validate_params(
            {k: p for k, p in (op.params or {}).items()},
            is_template=op.matrix is not None,
        )
    return op


class OperationSpecification:
    """Namespace mirror of the reference's spec-reading entrypoints."""

    read = staticmethod(get_op_from_files)
    check = staticmethod(check_polyaxonfile)
