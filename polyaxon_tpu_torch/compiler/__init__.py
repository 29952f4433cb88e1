"""Compiler: operation -> compiled operation with resolved params/contexts.

The port's own copy of ``polyaxon_tpu/compiler/__init__.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from .contexts import build_contexts, build_globals, run_artifacts_path, run_outputs_path
from .resolver import CompilerError, make_compiled, resolve, resolve_params
from .templates import TemplateError, has_template, resolve_obj, resolve_str
from .topology import ProcessTopology, ReplicaGroup, TopologyError, normalize
