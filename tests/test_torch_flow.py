"""The port's polyaxonfile path (``flow/``, ``polyaxonfile/``,
``compiler/``) against the JAX package's.

Every polyaxonfile under ``examples/`` and the port's own examples parse,
validate and compile to the same operation in both packages; ``-P``
overrides, presets and a missing required param behave the same; the
normal form of a distributed kind (``ProcessTopology`` and the PTPU_* env
each process gets) is the same.  The schemas are the user's contract, so
the comparison is exact.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from polyaxon_tpu import compiler as jcompiler
from polyaxon_tpu.polyaxonfile import check_polyaxonfile as j_check
from polyaxon_tpu.polyaxonfile.reader import PolyaxonfileError as JError
from polyaxon_tpu.tune.space import sample_params
from polyaxon_tpu_torch import compiler as tcompiler
from polyaxon_tpu_torch.polyaxonfile import check_polyaxonfile as t_check
from polyaxon_tpu_torch.polyaxonfile.reader import \
    PolyaxonfileError as TError

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
REF_EXAMPLES = sorted((ROOT / "examples").glob("*/*.yaml"))
PORT_EXAMPLES = sorted((ROOT / "polyaxon_tpu_torch" / "examples")
                       .glob("*.yaml"))
# Required inputs without a value in the file.
REQUIRED = {"finetune.yaml": {"weights": "/ckpt/bert.pt"},
            "bert_finetune.yaml": {"weights": "/ckpt/bert.pt"},
            "hyperband.yaml": {"data_dir": "/data/tokens"}}


def _params(path: Path):
    return REQUIRED.get(path.name) if path.parent.name in (
        "bert", "examples") else None


def _matrix_values(op):
    """One concrete suggestion for a sweep's child (both packages get the
    same dict)."""
    if op.matrix is None:
        return None
    params = getattr(op.matrix, "params", None)
    if params is None:  # a mapping lists its values
        return dict(op.matrix.values[0])
    values = sample_params(params, np.random.default_rng(0))
    resource = getattr(op.matrix, "resource", None)
    if resource is not None:
        values[resource.name] = resource.cast(1)
    return values


def test_every_example_is_checked():
    assert len(REF_EXAMPLES) == 13
    assert [p.name for p in PORT_EXAMPLES] == [
        "bert_finetune.yaml", "bert_job.yaml", "bert_pytorchjob.yaml",
        "convnet_hyperband.yaml", "gpt2_job.yaml", "gpt2_mpijob.yaml",
        "hyperband.yaml", "mnist.yaml", "moe_gpt_job.yaml",
        "moe_gpt_tpujob.yaml", "resnet50_job.yaml", "resnet50_tfjob.yaml",
        "serving.yaml", "t5_job.yaml", "t5_tpujob.yaml",
        "tinyllama_job.yaml", "tinyllama_longcontext.yaml",
        "tinyllama_tpujob.yaml", "vit_job.yaml", "vit_tpujob.yaml"]


@pytest.mark.parametrize("path", REF_EXAMPLES + PORT_EXAMPLES,
                         ids=[str(p.relative_to(ROOT))
                              for p in REF_EXAMPLES + PORT_EXAMPLES])
def test_example_compiles_the_same(path, tmp_path):
    params = _params(path)
    j_op = j_check([str(path)], params=params)
    t_op = t_check([str(path)], params=params)
    assert t_op.to_dict() == j_op.to_dict()
    values = _matrix_values(j_op)
    kw = dict(run_uuid="u1", project="p", store_path=str(tmp_path),
              matrix_values=values)
    j_compiled = jcompiler.resolve(j_op, **kw)
    t_compiled = tcompiler.resolve(t_op, **kw)
    assert t_compiled.to_dict() == j_compiled.to_dict()


def test_missing_required_param_raises_the_same():
    path = str(ROOT / "examples" / "bert" / "finetune.yaml")
    with pytest.raises(ValueError) as j_err:
        j_check([path])
    with pytest.raises(ValueError) as t_err:
        t_check([path])
    assert type(t_err.value).__name__ == type(j_err.value).__name__
    assert str(t_err.value) == str(j_err.value)
    assert "weights" in str(t_err.value)


def test_param_overrides_and_presets_apply_the_same(tmp_path):
    path = str(ROOT / "polyaxon_tpu_torch" / "examples" / "serving.yaml")
    preset = tmp_path / "port.yaml"
    preset.write_text("isPreset: true\nparams: {port: {value: 9001}}\n"
                      "component: {run: {ports: [9001]}}\n")
    for kw in ({"params": {"model": "gpt2-tiny", "port": "9002"}},
               {"presets": [str(preset)]},
               {"presets": [str(preset)], "params": {"port": "9003"}}):
        j_op, t_op = j_check([path], **kw), t_check([path], **kw)
        assert t_op.to_dict() == j_op.to_dict()
    assert t_op.component.run.ports == [9001]
    assert t_op.params["port"].value == 9003
    gpt2 = str(ROOT / "examples" / "gpt2" / "polyaxonfile.yaml")
    params = {"lr": "0.001", "steps": "5", "batch_size": "16"}
    assert t_check([gpt2], params=params).to_dict() == \
        j_check([gpt2], params=params).to_dict()


def test_distributed_topology_env_is_the_same():
    """``examples/bert`` (a ``pytorchjob``): the normal form and the
    PTPU_* block every process of the gang receives."""
    path = str(ROOT / "examples" / "bert" / "polyaxonfile.yaml")
    j_run = jcompiler.resolve(j_check([path]), run_uuid="u1").run
    t_run = tcompiler.resolve(t_check([path]), run_uuid="u1").run
    j_topo, t_topo = jcompiler.normalize(j_run), tcompiler.normalize(t_run)
    assert t_topo.kind == j_topo.kind == "pytorchjob"
    assert t_topo.num_processes == j_topo.num_processes > 1
    assert [(g.role, g.replicas) for g in t_topo.groups] == \
        [(g.role, g.replicas) for g in j_topo.groups]
    for group in t_topo.groups:
        for index in range(group.replicas):
            assert t_topo.process_env(group.role, index, run="u1",
                                      port=1234) == \
                j_topo.process_env(group.role, index, run="u1", port=1234)


def test_invalid_files_raise_the_same(tmp_path):
    bad = tmp_path / "bad.yaml"
    for text in ("kind: operation\ncomponent: {run: {kind: nope}}\n",
                 "- a list\n", "kind: [unclosed\n"):
        bad.write_text(text)
        with pytest.raises(JError) as j_err:
            j_check([str(bad)])
        with pytest.raises(TError) as t_err:
            t_check([str(bad)])
        assert str(t_err.value) == str(j_err.value)
