"""GPU scheduling vocabulary: resources, selectors, topologies.

The port's counterpart of ``polyaxon_tpu/k8s/tpu.py``.  The reference
asks for ``google.com/tpu: chipsPerHost`` per pod, because one JAX
process drives a whole slice host.  A process of the port drives one
card (``cuda:{PTPU_PROCESS_ID % device_count}``,
``parallel/bootstrap.py``) and the operator stamps one pod, one process,
per replica, so every pod asks for exactly one ``nvidia.com/gpu``.

Node selection: a slice typed with a GPU family (``h100-8``) pins the
NVIDIA product label of that card; a slice typed with one of the
reference's TPU families (every existing polyaxonfile, and the default
``v5litepod-8``) selects no product, so any GPU node will do.  The CR's
``slice`` block keeps the reference's arithmetic (``default_topology``)
so it equals the reference's; the operator reads none of it.
"""

from __future__ import annotations

from typing import Dict

from ..flow.run import V1SliceSpec

GPU_RESOURCE = "nvidia.com/gpu"
PRODUCT_LABEL = "nvidia.com/gpu.product"

# GPU family (prefix of the slice ``type``) -> the value of the GPU
# operator's product label on the nodes that carry that card.
_PRODUCTS = {
    "h100": "NVIDIA-H100-80GB-HBM3",
}

# The reference's TPU families with their torus rank (2D for the lite
# parts, 3D for v4/v5p): accepted, and scheduled on any GPU node.
_TPU_FAMILIES = {
    "v6e": 2,
    "v5litepod": 2,
    "v5e": 2,
    "v5p": 3,
    "v4": 3,
    "v3": 2,
}


class SliceError(ValueError):
    pass


def _family(slice_type: str) -> str:
    return slice_type.split("-", 1)[0].lower()


def product_for(slice_type: str) -> Dict[str, str]:
    """The node-selector labels of a slice type: the product label for a
    GPU family, nothing for a TPU family, ``SliceError`` otherwise."""
    fam = _family(slice_type)
    if fam in _PRODUCTS:
        return {PRODUCT_LABEL: _PRODUCTS[fam]}
    if fam in _TPU_FAMILIES:
        return {}
    raise SliceError(
        f"Unknown slice family {fam!r} (from {slice_type!r}); "
        f"known: {sorted([*_PRODUCTS, *_TPU_FAMILIES])}")


def default_topology(slice_type: str, chips: int) -> str:
    """Near-square power-of-two factorization of the chip count onto the
    generation's torus rank (2D for lite parts, 3D for v4/v5p)."""
    fam = _family(slice_type)
    rank = _TPU_FAMILIES.get(fam, 2)
    if chips <= 0 or chips & (chips - 1):
        raise SliceError(
            f"Cannot derive a torus topology for {chips} chips; give "
            "slice.topology explicitly")
    dims = [1] * rank
    remaining = chips
    i = 0
    while remaining > 1:
        dims[i % rank] *= 2
        remaining //= 2
        i += 1
    dims.sort()
    return "x".join(str(d) for d in dims)


def slice_node_selector(spec: V1SliceSpec) -> Dict[str, str]:
    return product_for(spec.type)


def gpu_resources(spec: V1SliceSpec) -> Dict[str, int]:
    """Per-pod card request: each pod is one process on one card."""
    return {GPU_RESOURCE: 1}


def gpu_toleration() -> Dict[str, str]:
    return {"key": GPU_RESOURCE, "operator": "Exists",
            "effect": "NoSchedule"}
