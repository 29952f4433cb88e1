"""Base model plumbing for all flow schemas.

The reference's polyflow schemas (SURVEY.md section 2.3, expected at
``polyaxon/_flow/`` in the reference tree — unavailable/unverified) are
pydantic-style models with camelCase YAML fields.  We use pydantic v2 with
a camelCase alias generator so YAML written for the reference parses here.

The port's own copy of ``polyaxon_tpu/flow/base.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Type, TypeVar

from pydantic import BaseModel, ConfigDict

T = TypeVar("T", bound="BaseSchema")


def to_camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


class BaseSchema(BaseModel):
    """Base for every V1* schema: camelCase aliases, permissive extras off."""

    model_config = ConfigDict(
        alias_generator=to_camel,
        populate_by_name=True,
        extra="forbid",
        validate_assignment=True,
        protected_namespaces=(),
    )

    @classmethod
    def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
        return cls.model_validate(data)

    def to_dict(self, exclude_none: bool = True) -> Dict[str, Any]:
        return self.model_dump(by_alias=True, exclude_none=exclude_none)

    def to_json(self, exclude_none: bool = True) -> str:
        return self.model_dump_json(by_alias=True, exclude_none=exclude_none)

    def clone(self: T) -> T:
        return self.model_copy(deep=True)


class BaseOpenSchema(BaseSchema):
    """Schema that tolerates unknown fields (forward compatibility)."""

    model_config = ConfigDict(
        alias_generator=to_camel,
        populate_by_name=True,
        extra="allow",
        protected_namespaces=(),
    )


def patch_dict(base: Optional[Dict[str, Any]], patch: Optional[Dict[str, Any]],
               strategy: str = "post_merge") -> Optional[Dict[str, Any]]:
    """Recursive dict merge used by presets/patches.

    Strategies (mirroring the reference's patch semantics, SURVEY.md 2.2):
      - post_merge: patch wins on conflicts (deep merge).
      - pre_merge:  base wins on conflicts (deep merge).
      - replace:    patch replaces base wholesale.
      - isnull:     patch fills only keys absent/None in base.
    """
    if base is None:
        return patch if patch is None else dict(patch)
    if patch is None:
        return dict(base)
    if strategy == "replace":
        return dict(patch)

    out: Dict[str, Any] = dict(base)
    for key, pval in patch.items():
        bval = out.get(key)
        if isinstance(bval, dict) and isinstance(pval, dict):
            out[key] = patch_dict(bval, pval, strategy)
        elif strategy == "post_merge":
            out[key] = pval
        elif strategy == "pre_merge":
            if key not in out:
                out[key] = pval
        elif strategy == "isnull":
            if bval is None:
                out[key] = pval
        else:
            raise ValueError(f"Unknown patch strategy: {strategy}")
    return out
