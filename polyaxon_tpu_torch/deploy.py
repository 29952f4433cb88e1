"""Deployment manifest generation: ``ptpu-torch admin deploy``.

Parity: reference deploy/config subsystem (SURVEY.md 2.15 — helm charts
+ ``polyaxon deploy``; expected at ``polyaxon/_deploy/``, unverified).
No helm here: a typed ``DeploymentConfig`` renders the exact k8s
manifests for the three services this framework runs in-cluster —
control plane (API+scheduler), agent, and the native operator — plus
the Operation CRD, RBAC, and the auth secret skeleton.

The port's own copy of ``polyaxon_tpu/deploy.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class DeploymentConfig:
    namespace: str = "polyaxon-tpu"
    # The port's own image (its package and CUDA runtime); the operator
    # is shared with the reference, so its image stays the reference's.
    image: str = "polyaxon-tpu-torch/core:latest"
    operator_image: str = "polyaxon-tpu/operator:latest"
    api_port: int = 8000
    replicas_api: int = 1
    agent_name: str = "agent-0"
    artifacts_claim: Optional[str] = None
    service_account: str = "polyaxon-tpu"
    env: Dict[str, str] = field(default_factory=dict)
    # The API listens on 0.0.0.0 behind a Service, so a bearer token is
    # mandatory in-cluster (ADVICE r1: unauthenticated remote store access).
    # None -> a random token is generated at render time.
    auth_secret_name: str = "polyaxon-tpu-auth"
    auth_token: Optional[str] = None
    # Cluster transport: "kube" — agent applies Operation CRs through the
    # kube-apiserver and the operator reconciles them into real pods
    # (``--kube-api``); "manifest" — single-box file protocol over a
    # shared emptyDir (no pods are created; everything runs inside the
    # agent pod).
    transport: str = "kube"
    # The operator's HTTP client is plaintext; in-cluster it reaches the
    # apiserver through a kubectl-proxy sidecar on localhost.
    kube_proxy_port: int = 8001


def _meta(name: str, config: DeploymentConfig) -> Dict[str, Any]:
    return {
        "name": name,
        "namespace": config.namespace,
        "labels": {"app.kubernetes.io/name": name,
                   "app.kubernetes.io/part-of": "polyaxon-tpu"},
    }


def _env_list(config: DeploymentConfig,
              extra: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
    env = {**config.env, **(extra or {})}
    out: List[Dict[str, Any]] = [{"name": k, "value": v}
                                 for k, v in sorted(env.items())]
    out.append({"name": "POLYAXON_TPU_AUTH_TOKEN",
                "valueFrom": {"secretKeyRef":
                              {"name": config.auth_secret_name,
                               "key": "token"}}})
    return out


def auth_secret(config: DeploymentConfig) -> Dict[str, Any]:
    """Pass ``auth_token`` (or export POLYAXON_TPU_AUTH_TOKEN) to keep the
    credential stable across re-renders; otherwise each render generates a
    fresh token, which rotates the cluster credential on re-apply."""
    import os as _os
    import secrets as _secrets

    token = config.auth_token \
        or _os.environ.get("POLYAXON_TPU_AUTH_TOKEN") \
        or _secrets.token_hex(24)
    return {
        "apiVersion": "v1", "kind": "Secret",
        "metadata": _meta(config.auth_secret_name, config),
        "type": "Opaque",
        "stringData": {"token": token},
    }


def crd() -> Dict[str, Any]:
    """The Operation CRD the native operator reconciles."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "operations.core.polyaxon-tpu.io"},
        "spec": {
            "group": "core.polyaxon-tpu.io",
            "names": {"kind": "Operation", "plural": "operations",
                      "singular": "operation", "shortNames": ["op"]},
            "scope": "Namespaced",
            "versions": [{
                "name": "v1",
                "served": True,
                "storage": True,
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "properties": {"spec": {
                        "type": "object",
                        "x-kubernetes-preserve-unknown-fields": True,
                    }},
                }},
                "subresources": {"status": {}},
            }],
        },
    }


def rbac(config: DeploymentConfig) -> List[Dict[str, Any]]:
    return [
        {"apiVersion": "v1", "kind": "ServiceAccount",
         "metadata": _meta(config.service_account, config)},
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "Role",
         "metadata": _meta("polyaxon-tpu-role", config),
         "rules": [
             {"apiGroups": ["core.polyaxon-tpu.io"],
              "resources": ["operations", "operations/status"],
              "verbs": ["*"]},
             {"apiGroups": [""],
              "resources": ["pods", "pods/log", "services", "events",
                            "secrets", "configmaps"],
              "verbs": ["get", "list", "watch", "create", "delete",
                        "patch"]},
         ]},
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "RoleBinding",
         "metadata": _meta("polyaxon-tpu-rolebinding", config),
         "subjects": [{"kind": "ServiceAccount",
                       "name": config.service_account,
                       "namespace": config.namespace}],
         "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                     "kind": "Role", "name": "polyaxon-tpu-role"}},
    ]


def control_plane(config: DeploymentConfig) -> List[Dict[str, Any]]:
    deployment = {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": _meta("polyaxon-tpu-api", config),
        "spec": {
            "replicas": config.replicas_api,
            "selector": {"matchLabels":
                         {"app.kubernetes.io/name": "polyaxon-tpu-api"}},
            "template": {
                "metadata": {"labels":
                             {"app.kubernetes.io/name":
                              "polyaxon-tpu-api"},
                             # the control plane serves Prometheus
                             # text at /metrics (scheduler/api.py)
                             "annotations": {
                                 "prometheus.io/scrape": "true",
                                 "prometheus.io/path": "/metrics",
                                 "prometheus.io/port":
                                     str(config.api_port)}},
                "spec": {
                    "serviceAccountName": config.service_account,
                    "containers": [{
                        "name": "api",
                        "image": config.image,
                        "command": ["python", "-m", "polyaxon_tpu_torch.cli",
                                    "server", "--host", "0.0.0.0",
                                    "--port", str(config.api_port)],
                        "ports": [{"containerPort": config.api_port}],
                        "env": _env_list(config),
                        "readinessProbe": {"httpGet": {
                            "path": "/api/v1/healthz",
                            "port": config.api_port}},
                    }],
                    "volumes": [],
                },
            },
        },
    }
    if config.artifacts_claim:
        deployment["spec"]["template"]["spec"]["volumes"].append({
            "name": "artifacts",
            "persistentVolumeClaim":
                {"claimName": config.artifacts_claim}})
        api_container = deployment["spec"]["template"]["spec"][
            "containers"][0]
        api_container["volumeMounts"] = [{"name": "artifacts",
                                          "mountPath": "/ptpu-artifacts"}]
        # The run store must live ON the claim, or API restarts lose
        # every run record/log.
        api_container["env"].append({"name": "POLYAXON_TPU_HOME",
                                     "value": "/ptpu-artifacts"})
    service = {
        "apiVersion": "v1", "kind": "Service",
        "metadata": _meta("polyaxon-tpu-api", config),
        "spec": {
            "selector": {"app.kubernetes.io/name": "polyaxon-tpu-api"},
            "ports": [{"port": config.api_port,
                       "targetPort": config.api_port}],
        },
    }
    return [deployment, service]


def agent(config: DeploymentConfig) -> List[Dict[str, Any]]:
    """The agent deployment, per transport.

    ``kube``: agent submits Operation CRs to the apiserver
    (``--backend kube``); the operator container reconciles them into
    real pods via ``--kube-api`` through a kubectl-proxy sidecar
    (the operator's HTTP client is plaintext; the proxy terminates TLS
    with the pod's service account).  RBAC for both is the Role below.

    ``manifest``: agent + operator share ONE pod so the manifest
    hand-off directory (agent writes CRs, operator reconciles them) is
    a single shared emptyDir — split pods would each get a private
    volume and the operator would never see the agent's manifests."""
    host = f"http://polyaxon-tpu-api.{config.namespace}:{config.api_port}"
    if config.transport == "kube":
        proxy = f"http://127.0.0.1:{config.kube_proxy_port}"
        containers = [
            {
                "name": "agent",
                "image": config.image,
                "command": ["python", "-m", "polyaxon_tpu_torch.cli",
                            "agent", "--name", config.agent_name,
                            "--backend", "kube"],
                "env": _env_list(config, {
                    "POLYAXON_TPU_HOST": host,
                    "PTPU_K8S_NAMESPACE": config.namespace,
                }),
            },
            {
                "name": "operator",
                "image": config.operator_image,
                "command": ["/ptpu-operator",
                            "--kube-api", proxy,
                            "--namespace", config.namespace],
            },
            {
                "name": "kubectl-proxy",
                "image": "bitnami/kubectl:latest",
                "command": ["kubectl", "proxy",
                            f"--port={config.kube_proxy_port}",
                            "--address=127.0.0.1"],
            },
        ]
        pod_spec = {"serviceAccountName": config.service_account,
                    "containers": containers}
    else:
        pod_spec = {
            "serviceAccountName": config.service_account,
            "containers": [
                {
                    "name": "agent",
                    "image": config.image,
                    "command": ["python", "-m",
                                "polyaxon_tpu_torch.cli",
                                "agent", "--name",
                                config.agent_name,
                                "--backend", "manifest",
                                "--cluster-dir", "/ptpu-cluster"],
                    "env": _env_list(config,
                                     {"POLYAXON_TPU_HOST": host}),
                    "volumeMounts": [{"name": "cluster",
                                      "mountPath":
                                      "/ptpu-cluster"}],
                },
                {
                    "name": "operator",
                    "image": config.operator_image,
                    "command": ["/ptpu-operator", "--cluster-dir",
                                "/ptpu-cluster"],
                    "volumeMounts": [{"name": "cluster",
                                      "mountPath":
                                      "/ptpu-cluster"}],
                },
            ],
            "volumes": [{"name": "cluster", "emptyDir": {}}],
        }
    return [{
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": _meta("polyaxon-tpu-agent", config),
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels":
                         {"app.kubernetes.io/name": "polyaxon-tpu-agent"}},
            "template": {
                "metadata": {"labels":
                             {"app.kubernetes.io/name":
                              "polyaxon-tpu-agent"}},
                "spec": pod_spec,
            },
        },
    }]


def render_all(config: Optional[DeploymentConfig] = None
               ) -> List[Dict[str, Any]]:
    config = config or DeploymentConfig()
    manifests: List[Dict[str, Any]] = [
        {"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": config.namespace}},
        crd(),
        auth_secret(config),
    ]
    manifests += rbac(config)
    manifests += control_plane(config)
    manifests += agent(config)  # agent pod carries the operator sidecar
    return manifests
