"""Operation resolution: V1Operation -> V1CompiledOperation.

Parity with the reference's compiler pipeline (SURVEY.md 2.6, call stack
3.1 step 4): validate params against the component IO contract, resolve
references and ``{{ ... }}`` templates against contexts, apply run patches,
and inline everything into a self-contained compiled operation.

The port's own copy of ``polyaxon_tpu/compiler/resolver.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ..flow import V1CompiledOperation, V1Component, V1Operation
from ..flow.base import patch_dict
from ..flow.io import V1IO, V1Param
from .contexts import RESERVED_CONTEXT_KEYS, build_contexts, build_globals
from .templates import TemplateError, has_template, resolve_obj


class CompilerError(ValueError):
    pass


RefResolver = Callable[[str, str], Any]
"""(ref, key) -> value; resolves runs.<uuid>/ops.<name> output references."""


def make_compiled(operation: V1Operation) -> V1CompiledOperation:
    """Inline component into the operation (no resolution yet)."""
    if not operation.has_component:
        raise CompilerError(
            "Operation has no inline component; hub/path refs must be "
            "materialized before compilation"
        )
    comp: V1Component = operation.component
    run = comp.run
    if run is None:
        raise CompilerError(f"Component {comp.name!r} declares no run section")

    run_dict = run.to_dict()
    if operation.run_patch:
        run_dict = patch_dict(run_dict, operation.run_patch,
                              operation.patch_strategy or "post_merge")

    def pick(op_val, comp_val):
        return op_val if op_val is not None else comp_val

    return V1CompiledOperation.from_dict(
        {
            "kind": "compiled_operation",
            "version": pick(operation.version, comp.version),
            "name": operation.name or comp.name,
            "description": pick(operation.description, comp.description),
            "tags": sorted(set(operation.tags or []) | set(comp.tags or [])) or None,
            "presets": operation.presets,
            "queue": pick(operation.queue, comp.queue),
            "priority": pick(operation.priority, comp.priority),
            "cache": pick(operation.cache, comp.cache),
            "termination": pick(
                operation.termination.to_dict() if operation.termination else None,
                comp.termination.to_dict() if comp.termination else None,
            ),
            "plugins": pick(
                operation.plugins.to_dict() if operation.plugins else None,
                comp.plugins.to_dict() if comp.plugins else None,
            ),
            "build": pick(
                operation.build.to_dict() if operation.build else None,
                comp.build.to_dict() if comp.build else None,
            ),
            "hooks": [h.to_dict() for h in (operation.hooks or comp.hooks or [])] or None,
            "params": {k: p.to_dict() for k, p in (operation.params or {}).items()} or None,
            "matrix": operation.matrix.to_dict() if operation.matrix else None,
            "joins": [j.to_dict()
                      for j in (operation.joins
                                or getattr(comp, "joins", None)
                                or [])] or None,
            "schedule": operation.schedule.to_dict() if operation.schedule else None,
            "dependencies": operation.dependencies,
            "trigger": operation.trigger,
            "conditions": operation.conditions,
            "skip_on_upstream_skip": operation.skip_on_upstream_skip,
            "inputs": [io.to_dict() for io in (comp.inputs or [])] or None,
            "outputs": [io.to_dict() for io in (comp.outputs or [])] or None,
            "run": run_dict,
        }
    )


def resolve_params(
    compiled: V1CompiledOperation,
    matrix_values: Optional[Dict[str, Any]] = None,
    ref_resolver: Optional[RefResolver] = None,
    join_values: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Materialize param values into the compiled op's inputs.

    Returns the resolved {name: value} dict.  ``matrix_values`` supplies
    ``{{ matrix.* }}`` / ref="matrix" params for sweep children;
    ``ref_resolver`` resolves runs./ops. references (wired to the store or
    DAG state by the scheduler).
    """
    from ..flow.io import check_declared_params, fill_default_params

    declared: Dict[str, V1IO] = {io.name: io for io in (compiled.inputs or [])}
    out_names = {io.name for io in (compiled.outputs or [])}
    owner = f"operation {compiled.name!r}"
    resolved: Dict[str, Any] = {}

    for name, param in (compiled.params or {}).items():
        if param.context_only:
            continue
        value = param.value
        if param.ref is not None:
            if param.ref == "matrix":
                if matrix_values is None or value not in matrix_values:
                    raise CompilerError(
                        f"Param {name!r} references matrix.{value} but no "
                        "matrix value was provided"
                    )
                value = matrix_values[value]
            elif param.ref in ("dag", "globals"):
                # Left template-shaped; resolved against contexts below.
                value = f"{{{{ {param.ref}.{value} }}}}"
            else:  # runs.<uuid> | ops.<name>
                if ref_resolver is None:
                    raise CompilerError(
                        f"Param {name!r} references {param.ref!r} but no "
                        "ref resolver is available in this compilation pass"
                    )
                value = ref_resolver(param.ref, str(value))
        resolved[name] = value

    try:
        check_declared_params(resolved, declared, out_names, owner)
    except ValueError as e:
        raise CompilerError(str(e)) from e

    # Matrix/join params flow in even without explicit ref= entries.
    for name, value in (matrix_values or {}).items():
        resolved.setdefault(name, value)
    for name, value in (join_values or {}).items():
        resolved.setdefault(name, value)

    try:
        fill_default_params(declared, resolved, owner)
    except ValueError as e:
        raise CompilerError(str(e)) from e
    return resolved


def resolve(
    operation: V1Operation,
    run_uuid: str,
    run_name: Optional[str] = None,
    project: Optional[str] = None,
    iteration: Optional[int] = None,
    matrix_values: Optional[Dict[str, Any]] = None,
    ref_resolver: Optional[RefResolver] = None,
    store_path: Optional[str] = None,
    dag_values: Optional[Dict[str, Any]] = None,
    join_values: Optional[Dict[str, Any]] = None,
) -> V1CompiledOperation:
    """Full resolution: compile, materialize params, resolve templates.

    ``dag_values`` supplies the ``{{ dag.* }}`` context (upstream op
    outputs) when this op runs inside a DAG; ``join_values`` the
    query-joined param lists (``runner.joins``).
    """
    compiled = make_compiled(operation)

    resolved = resolve_params(compiled, matrix_values=matrix_values,
                              ref_resolver=ref_resolver,
                              join_values=join_values)

    globals_ctx = build_globals(
        run_uuid=run_uuid, run_name=run_name or compiled.name,
        project=project, iteration=iteration, store_path=store_path,
    )
    ctx = build_contexts(globals_ctx, inputs=resolved, matrix=matrix_values,
                         dag=dag_values)

    # Resolve templates inside param values themselves (e.g. paths built
    # from globals or from other params).  Params may chain (a param whose
    # template names another templated param), so iterate to a fixpoint.
    declared = {io.name: io for io in (compiled.inputs or [])}
    for _ in range(len(resolved) + 1):
        progressed = False
        for name, value in list(resolved.items()):
            if not has_template(value):
                continue
            try:
                new_value = resolve_obj(value, ctx)
            except TemplateError:
                continue  # may depend on a not-yet-resolved param
            if has_template(new_value) and new_value == value:
                continue
            resolved[name] = new_value
            ctx["inputs"][name] = new_value
            ctx["params"][name] = new_value
            if name not in RESERVED_CONTEXT_KEYS:
                ctx[name] = new_value
            progressed = True
        if not progressed:
            break
    unresolvable = {n: v for n, v in resolved.items() if has_template(v)}
    if unresolvable:
        # Surface the real lookup error when there is one; otherwise the
        # template is circular/self-referential — fail explicitly rather
        # than shipping literal '{{ ... }}' text into the container.
        for name, value in unresolvable.items():
            try:
                resolve_obj(value, ctx)
            except TemplateError as e:
                raise CompilerError(
                    f"Param {name!r} cannot be resolved: {e}"
                ) from e
        raise CompilerError(
            f"Circular or self-referential param templates: "
            f"{sorted(unresolvable)}"
        )

    for name, value in list(resolved.items()):
        io = declared.get(name)
        if io is not None:
            value = io.validate_value(value)
        resolved[name] = value
        ctx["inputs"][name] = value
        ctx["params"][name] = value
        if name not in RESERVED_CONTEXT_KEYS:
            ctx[name] = value

    # Write resolved values onto the IO declarations.
    new_inputs = []
    for io in compiled.inputs or []:
        io = io.clone()
        if io.name in resolved:
            io.value = resolved[io.name]
        new_inputs.append(io)
    compiled.inputs = new_inputs or None

    # Resolve templates throughout the run section.  Dag member operations
    # keep their templates: each member resolves against its OWN run
    # context when the DagRunner executes it.
    run_dict = compiled.run.to_dict()
    if compiled.run_kind == "dag":
        member_ops = run_dict.pop("operations", None)
        member_comps = run_dict.pop("components", None)
        run_dict = resolve_obj(run_dict, ctx)
        if member_ops is not None:
            run_dict["operations"] = member_ops
        if member_comps is not None:
            run_dict["components"] = member_comps
    else:
        run_dict = resolve_obj(run_dict, ctx)
    compiled.run = run_dict  # validator re-parses into the proper kind

    return compiled
