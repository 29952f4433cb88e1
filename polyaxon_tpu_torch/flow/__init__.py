"""Declarative spec schemas (the polyflow-equivalent surface).

The port's own copy of ``polyaxon_tpu/flow/__init__.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from .base import BaseOpenSchema, BaseSchema, patch_dict, to_camel
from .component import (
    SPEC_VERSION,
    V1CompiledOperation,
    V1Component,
    V1Join,
    V1Operation,
)
from .environment import (
    V1ArtifactsInit,
    V1Build,
    V1Cache,
    V1DockerfileInit,
    V1Environment,
    V1FileInit,
    V1GitInit,
    V1Hook,
    V1Init,
    V1Notification,
    V1Plugins,
    V1TensorboardInit,
    V1Termination,
)
from .io import IO_TYPES, V1IO, V1Param, params_from_dict
from .k8s_refs import (
    V1Container,
    V1ContainerPort,
    V1EnvVar,
    V1ResourceRequirements,
    V1VolumeMount,
)
from .matrix import (
    MATRIX_BY_KIND,
    V1Bayes,
    V1EarlyStopping,
    V1FailureEarlyStopping,
    V1GridSearch,
    V1HpChoice,
    V1HpLinSpace,
    V1HpLogSpace,
    V1HpLogUniform,
    V1HpNormal,
    V1HpPChoice,
    V1HpRange,
    V1HpUniform,
    V1Asha,
    V1Hyperband,
    V1Hyperopt,
    V1Iterative,
    V1Mapping,
    V1MetricEarlyStopping,
    V1OptimizationMetric,
    V1OptimizationResource,
    V1RandomSearch,
    parse_matrix,
)
from .run import (
    RUNTIME_BY_KIND,
    RunKind,
    V1CleanerJob,
    V1CronSchedule,
    V1Dag,
    V1DateTimeSchedule,
    V1IntervalSchedule,
    V1Job,
    V1KFReplica,
    V1MPIJob,
    V1NotifierJob,
    V1PaddleJob,
    V1PytorchJob,
    V1RayJob,
    V1Service,
    V1SliceSpec,
    V1TFJob,
    V1TPUJob,
    V1TPUReplica,
    V1TunerJob,
    V1XGBoostJob,
    V1DaskJob,
    V1MXNetJob,
    parse_runtime,
    parse_schedule,
)
