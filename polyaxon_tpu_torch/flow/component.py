"""Component / Operation / CompiledOperation schemas.

Parity targets: reference ``V1Component``, ``V1Operation``,
``V1CompiledOperation`` (SURVEY.md 2.3/2.6; expected at
``polyaxon/_flow/component.py`` / ``operations/`` — unverified).

The port's own copy of ``polyaxon_tpu/flow/component.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from pydantic import field_validator, model_validator

from .base import BaseSchema, patch_dict
from .environment import V1Build, V1Cache, V1Hook, V1Plugins, V1Termination
from .io import V1IO, V1Param, params_from_dict
from .matrix import V1Matrix, parse_matrix
from .run import (
    RunKind,
    V1Runtime,
    V1Schedule,
    parse_runtime,
    parse_schedule,
)

SPEC_VERSION = 1.1


class V1Join(BaseSchema):
    """Collect upstream runs matching a query into a param (fan-in)."""

    query: str
    sort: Optional[str] = None
    limit: Optional[int] = None
    offset: Optional[int] = None
    params: Optional[Dict[str, V1Param]] = None

    @field_validator("params", mode="before")
    @classmethod
    def _params(cls, v):
        return params_from_dict(v) if v is not None else None


class V1Component(BaseSchema):
    """A reusable, typed, runnable unit: IO contract + runtime."""

    version: Optional[float] = None
    kind: str = "component"
    name: Optional[str] = None
    description: Optional[str] = None
    tags: Optional[List[str]] = None
    presets: Optional[List[str]] = None
    queue: Optional[str] = None
    priority: Optional[int] = None
    cache: Optional[V1Cache] = None
    termination: Optional[V1Termination] = None
    plugins: Optional[V1Plugins] = None
    build: Optional[V1Build] = None
    hooks: Optional[List[V1Hook]] = None
    inputs: Optional[List[V1IO]] = None
    outputs: Optional[List[V1IO]] = None
    template: Optional[Dict[str, Any]] = None
    run: Optional[Any] = None

    @field_validator("kind")
    @classmethod
    def _kind(cls, v):
        if v != "component":
            raise ValueError(f"Expected kind 'component', got {v!r}")
        return v

    @field_validator("run", mode="before")
    @classmethod
    def _run(cls, v):
        return parse_runtime(v)

    def get_io(self, name: str) -> Optional[V1IO]:
        for io in (self.inputs or []) + (self.outputs or []):
            if io.name == name:
                return io
        return None

    def validate_params(self, params: Optional[Dict[str, Any]],
                        is_template: bool = False) -> Dict[str, V1Param]:
        """Check supplied params against the IO contract; fill defaults.

        Returns the full resolved param dict (including defaulted inputs).
        Raises on unknown params, missing required inputs, or type errors.
        """
        from .io import check_declared_params, fill_default_params

        params = params_from_dict(params)
        declared = {io.name: io for io in (self.inputs or [])}
        out_names = {io.name for io in (self.outputs or [])}
        owner = f"component {self.name!r}"

        check_declared_params(
            [n for n, p in params.items() if not p.context_only],
            declared, out_names, owner,
        )
        for name, param in params.items():
            io = declared.get(name)
            if io is not None and param.is_literal and param.value is not None:
                param.value = io.validate_value(param.value)

        filled = fill_default_params(
            declared, {n: p for n, p in params.items()}, owner,
            require=not is_template,
        )
        for name, value in filled.items():
            if name not in params:
                params[name] = V1Param(value=value)
        return params


class V1Operation(BaseSchema):
    """An invocation of a component with params/overrides/matrix/schedule."""

    version: Optional[float] = None
    kind: str = "operation"
    name: Optional[str] = None
    description: Optional[str] = None
    tags: Optional[List[str]] = None
    presets: Optional[List[str]] = None
    queue: Optional[str] = None
    priority: Optional[int] = None
    cache: Optional[V1Cache] = None
    termination: Optional[V1Termination] = None
    plugins: Optional[V1Plugins] = None
    build: Optional[V1Build] = None
    hooks: Optional[List[V1Hook]] = None
    params: Optional[Dict[str, V1Param]] = None
    run_patch: Optional[Dict[str, Any]] = None
    patch_strategy: Optional[str] = None
    is_preset: Optional[bool] = None
    is_approved: Optional[bool] = None
    matrix: Optional[Any] = None
    joins: Optional[List[V1Join]] = None
    schedule: Optional[Any] = None
    dependencies: Optional[List[str]] = None
    trigger: Optional[str] = None  # all_succeeded|all_failed|all_done|one_succeeded|...
    conditions: Optional[str] = None
    skip_on_upstream_skip: Optional[bool] = None
    # Component source: exactly one of these.
    component: Optional[V1Component] = None
    hub_ref: Optional[str] = None
    dag_ref: Optional[str] = None
    url_ref: Optional[str] = None
    path_ref: Optional[str] = None

    @field_validator("kind")
    @classmethod
    def _kind(cls, v):
        if v != "operation":
            raise ValueError(f"Expected kind 'operation', got {v!r}")
        return v

    @field_validator("params", mode="before")
    @classmethod
    def _params(cls, v):
        return params_from_dict(v) if v is not None else None

    @field_validator("matrix", mode="before")
    @classmethod
    def _matrix(cls, v):
        return parse_matrix(v)

    @field_validator("schedule", mode="before")
    @classmethod
    def _schedule(cls, v):
        return parse_schedule(v)

    @model_validator(mode="after")
    def _one_component_source(self):
        sources = [
            s for s in (self.component, self.hub_ref, self.dag_ref,
                        self.url_ref, self.path_ref)
            if s is not None
        ]
        if len(sources) > 1:
            raise ValueError(
                "Operation must reference exactly one component source "
                "(component | hubRef | dagRef | urlRef | pathRef)"
            )
        return self

    @property
    def has_component(self) -> bool:
        return self.component is not None

    @property
    def effective_queue(self) -> Optional[str]:
        """None-aware op-over-component merge (the resolver's `pick`)."""
        if self.queue is not None:
            return self.queue
        return self.component.queue if self.has_component else None

    @property
    def effective_priority(self) -> int:
        # `is not None`, not truthiness: an explicit `priority: 0` on
        # the operation must override a component's nonzero priority.
        if self.priority is not None:
            return self.priority
        if self.has_component and self.component.priority is not None:
            return self.component.priority
        return 0


class V1CompiledOperation(BaseSchema):
    """Operation after resolution: component inlined, params validated,
    run patched, matrix/schedule carried for the scheduler."""

    version: Optional[float] = None
    kind: str = "compiled_operation"
    name: Optional[str] = None
    description: Optional[str] = None
    tags: Optional[List[str]] = None
    presets: Optional[List[str]] = None
    queue: Optional[str] = None
    priority: Optional[int] = None
    cache: Optional[V1Cache] = None
    termination: Optional[V1Termination] = None
    plugins: Optional[V1Plugins] = None
    build: Optional[V1Build] = None
    hooks: Optional[List[V1Hook]] = None
    params: Optional[Dict[str, V1Param]] = None
    matrix: Optional[Any] = None
    joins: Optional[List[V1Join]] = None
    schedule: Optional[Any] = None
    dependencies: Optional[List[str]] = None
    trigger: Optional[str] = None
    conditions: Optional[str] = None
    skip_on_upstream_skip: Optional[bool] = None
    inputs: Optional[List[V1IO]] = None
    outputs: Optional[List[V1IO]] = None
    run: Optional[Any] = None

    @field_validator("kind")
    @classmethod
    def _kind(cls, v):
        if v != "compiled_operation":
            raise ValueError(f"Expected kind 'compiled_operation', got {v!r}")
        return v

    @field_validator("params", mode="before")
    @classmethod
    def _params(cls, v):
        return params_from_dict(v) if v is not None else None

    @field_validator("matrix", mode="before")
    @classmethod
    def _matrix(cls, v):
        return parse_matrix(v)

    @field_validator("schedule", mode="before")
    @classmethod
    def _schedule(cls, v):
        return parse_schedule(v)

    @field_validator("run", mode="before")
    @classmethod
    def _run(cls, v):
        return parse_runtime(v)

    @property
    def run_kind(self) -> Optional[str]:
        return getattr(self.run, "kind", None)

    @property
    def is_distributed(self) -> bool:
        return self.run_kind in RunKind.DISTRIBUTED

    @property
    def has_pipeline(self) -> bool:
        return self.matrix is not None or self.run_kind == RunKind.DAG or \
            self.schedule is not None

    def get_io_dict(self) -> Dict[str, Any]:
        """Resolved input values by name (for contexts/tracking)."""
        out = {}
        for io in self.inputs or []:
            out[io.name] = io.value
        return out
