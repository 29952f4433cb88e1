"""The distributed runtime: processes, meshes and the train step.

Port of ``polyaxon_tpu/parallel``:

- ``bootstrap``:   ``torch.distributed`` from the injected PTPU_* env.
- ``mesh``:        mesh construction (the six named axes over the ranks)
                   and the batch's row sharding.
- ``collectives``: differentiable collectives over mesh axes.
- ``health``:      the slice health probe.
- ``constraints``: the ambient mesh and the serving-exact mesh.
- ``strategies``:  the train step on one device, dp, fsdp, tp, ep, sp
                   and pp.
- ``pipeline``:    GPipe and 1F1B schedules over pp.
- ``moe``:         switch routing and ``moe_layer`` over ep.
- ``ring``:        ring attention (K/V rotation over the sp axis).
- ``ulysses``:     all-to-all head / sequence resharding attention.

``constraints`` also carries the serving-exact mesh of
``serving/meshed.py`` (tensor and expert parallelism in serving).
"""

from .bootstrap import initialize_from_env, topology_from_env
from .collectives import (
    all_gather,
    all_reduce,
    all_reduce_mean,
    all_to_all,
    hierarchical_all_reduce,
    reduce_scatter,
    ring_permute,
)
from .constraints import BATCH, ambient_mesh, constrain, current_mesh
from .health import SliceHealth, check_slice_health
from .mesh import (
    MeshSpec,
    build_mesh,
    data_sharding,
    local_mesh,
    replicate_sharding,
)
from .moe import moe_layer, top1_dispatch
from .pipeline import pipeline_apply
from .ring import ring_attention
from .strategies import (
    TrainStep,
    infer_param_spec,
    make_param_placements,
    make_train_step,
)
from .ulysses import ulysses_attention

__all__ = [
    "BATCH", "MeshSpec", "SliceHealth", "TrainStep", "all_gather",
    "all_reduce", "all_reduce_mean", "all_to_all", "ambient_mesh",
    "build_mesh", "check_slice_health", "constrain", "current_mesh",
    "data_sharding", "hierarchical_all_reduce", "infer_param_spec",
    "initialize_from_env", "local_mesh", "make_param_placements",
    "make_train_step", "moe_layer", "pipeline_apply", "reduce_scatter",
    "replicate_sharding", "ring_attention", "ring_permute",
    "top1_dispatch", "topology_from_env", "ulysses_attention",
]
