"""Polyaxonfile reading: YAML -> V1Operation / V1Component.

Parity with the reference's ``polyaxon/_polyaxonfile/`` (SURVEY.md 2.2 —
unverified path): multi-file merge, ``-P`` param overrides, presets,
``--patch`` run patches.

The port's own copy of ``polyaxon_tpu/polyaxonfile/__init__.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from .reader import (
    OperationSpecification,
    check_polyaxonfile,
    get_op_from_files,
    read_polyaxonfile,
)
