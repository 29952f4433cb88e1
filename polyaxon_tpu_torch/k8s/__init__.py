"""Kubernetes layer: converter + custom resources (SURVEY.md L2).

Turns compiled operations into ``Operation`` CRs with GPU scheduling
(one ``nvidia.com/gpu`` a pod, the NVIDIA product label for a GPU slice
family) and env injection for tracking + the ``torch.distributed``
bootstrap.  The C++
operator (``operator/``) reconciles these CRs into pods.

The port's own copy of ``polyaxon_tpu/k8s/__init__.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from .converter import (
    API_VERSION,
    COORDINATOR_PORT,
    MAIN_CONTAINER,
    OPERATION_KIND,
    ConverterConfig,
    ConverterError,
    convert,
    cluster_ip_service,
    headless_service,
)
from .gpu import (
    GPU_RESOURCE,
    PRODUCT_LABEL,
    SliceError,
    default_topology,
    gpu_resources,
    product_for,
    slice_node_selector,
)

__all__ = [
    "API_VERSION",
    "COORDINATOR_PORT",
    "ConverterConfig",
    "ConverterError",
    "MAIN_CONTAINER",
    "OPERATION_KIND",
    "GPU_RESOURCE",
    "PRODUCT_LABEL",
    "SliceError",
    "convert",
    "default_topology",
    "cluster_ip_service",
    "gpu_resources",
    "headless_service",
    "product_for",
    "slice_node_selector",
]
