"""IO (inputs/outputs) and param schemas.

Capability parity with the reference's ``V1IO``/``V1Param`` (SURVEY.md 2.3;
expected reference location ``polyaxon/_flow/io/`` — unverified).  An IO
declares a typed input/output of a component; a param supplies a value (or a
reference to another run's output / dag / matrix context) for it.

The port's own copy of ``polyaxon_tpu/flow/io.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Union

from pydantic import field_validator

from .base import BaseSchema

# Supported IO types and their python validators.
IO_TYPES = {
    "int": int,
    "float": float,
    "bool": bool,
    "str": str,
    "dict": dict,
    "list": list,
    "path": str,
    "uri": str,
    "auth": dict,
    "git": dict,
    "image": str,
    "dockerfile": str,
    "event": dict,
    "artifacts": dict,
    "tensorboard": str,
    "any": object,
}

REF_RE = re.compile(r"^(runs\.[\w-]+|ops\.[\w-]+|dag|matrix|globals)$")
# Canonical template pattern; the compiler's template engine imports this.
TEMPLATE_RE = re.compile(r"{{\s*(.*?)\s*}}")


def check_declared_params(names, declared, out_names, owner: str = "component"):
    """Raise if any supplied param name is not a declared input/output."""
    for name in names:
        if name not in declared and name not in out_names:
            raise ValueError(
                f"Param {name!r} is not declared as an input/output of {owner}"
            )


def fill_default_params(declared, resolved, owner: str = "component",
                        require: bool = True):
    """Fill IO defaults into ``resolved``; raise on missing required inputs."""
    for name, io in declared.items():
        if name in resolved:
            continue
        if io.value is not None:
            resolved[name] = io.value
        elif not io.is_optional and require:
            raise ValueError(
                f"Input {name!r} of {owner} is required but no param was "
                "given and it has no default"
            )
    return resolved


def check_io_value(value: Any, type_: Optional[str]) -> bool:
    """True if ``value`` conforms to declared IO ``type_``."""
    if type_ is None or type_ == "any" or value is None:
        return True
    expected = IO_TYPES.get(type_)
    if expected is None:
        raise ValueError(f"Unknown IO type: {type_!r}")
    if expected is object:
        return True
    if expected is float and isinstance(value, int) and not isinstance(value, bool):
        return True
    if expected is int and isinstance(value, bool):
        return False
    return isinstance(value, expected)


def parse_io_value(value: Any, type_: Optional[str]) -> Any:
    """Coerce a (possibly string) param value to the IO's declared type."""
    if value is None or type_ in (None, "any"):
        return value
    if isinstance(value, str):
        try:
            if type_ == "int":
                return int(value)
            if type_ == "float":
                return float(value)
            if type_ == "bool":
                if value.lower() in ("true", "1", "yes", "on"):
                    return True
                if value.lower() in ("false", "0", "no", "off"):
                    return False
                raise ValueError(value)
            if type_ in ("dict", "list"):
                import json

                parsed = json.loads(value)
                if not check_io_value(parsed, type_):
                    raise ValueError(value)
                return parsed
        except ValueError as e:
            raise ValueError(
                f"Value {value!r} cannot be parsed as IO type {type_!r}"
            ) from e
    if not check_io_value(value, type_):
        raise ValueError(f"Value {value!r} is not a valid {type_!r}")
    return value


class V1IO(BaseSchema):
    """A typed input or output declaration on a component."""

    name: str
    description: Optional[str] = None
    type: Optional[str] = None
    value: Optional[Any] = None
    is_optional: Optional[bool] = None
    is_list: Optional[bool] = None
    is_flag: Optional[bool] = None
    arg_format: Optional[str] = None
    connection: Optional[str] = None
    to_init: Optional[bool] = None
    to_env: Optional[str] = None
    options: Optional[List[Any]] = None

    @field_validator("type")
    @classmethod
    def _check_type(cls, v: Optional[str]) -> Optional[str]:
        if v is not None and v not in IO_TYPES:
            raise ValueError(f"Unknown IO type {v!r}; expected one of {sorted(IO_TYPES)}")
        return v

    def validate_value(self, value: Any) -> Any:
        if self.is_list:
            if not isinstance(value, list):
                raise ValueError(f"IO {self.name!r} expects a list, got {value!r}")
            return [self._validate_one(v) for v in value]
        return self._validate_one(value)

    def _validate_one(self, value: Any) -> Any:
        value = parse_io_value(value, self.type)
        if self.options and value not in self.options:
            raise ValueError(
                f"IO {self.name!r} value {value!r} not in options {self.options}"
            )
        return value


class V1Param(BaseSchema):
    """A value (or reference) supplied for a component input.

    ``ref`` points at another entity whose output is resolved at compile
    time: ``runs.<uuid>``, ``ops.<name>`` (dag sibling), ``dag``,
    ``matrix``, or ``globals``.
    """

    value: Optional[Any] = None
    ref: Optional[str] = None
    context_only: Optional[bool] = None
    connection: Optional[str] = None
    to_init: Optional[bool] = None
    to_env: Optional[str] = None

    @field_validator("ref")
    @classmethod
    def _check_ref(cls, v: Optional[str]) -> Optional[str]:
        if v is not None and not REF_RE.match(v):
            raise ValueError(
                f"Invalid param ref {v!r}: expected runs.<uuid>, ops.<name>, "
                "dag, matrix, or globals"
            )
        return v

    @property
    def is_literal(self) -> bool:
        return self.ref is None and not (
            isinstance(self.value, str) and TEMPLATE_RE.search(self.value)
        )

    @property
    def is_template(self) -> bool:
        return isinstance(self.value, str) and bool(TEMPLATE_RE.search(self.value))


def params_from_dict(data: Optional[Dict[str, Any]]) -> Dict[str, V1Param]:
    """Normalize a params mapping: bare literals become V1Param(value=...).

    Caller-supplied V1Param instances are copied so later validation/coercion
    never mutates objects the caller may reuse across operations.
    """
    out: Dict[str, V1Param] = {}
    for name, spec in (data or {}).items():
        if isinstance(spec, V1Param):
            out[name] = spec.model_copy(deep=True)
        elif isinstance(spec, dict) and ("value" in spec or "ref" in spec):
            out[name] = V1Param.from_dict(spec)
        else:
            out[name] = V1Param(value=spec)
    return out
