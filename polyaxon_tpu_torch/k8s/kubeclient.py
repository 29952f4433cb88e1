"""Minimal Kubernetes REST client (stdlib only).

Parity: the reference agent applies converted resources through the k8s
API server and watches them back (SURVEY.md §2.9, §3.1 step 8-9).  This
client covers exactly the verbs our transport uses — create/get/list/
merge-patch/status-patch/delete plus line-delimited watch — over plain
``http.client``, so the framework adds no kubernetes-package dependency.

Config resolution mirrors kubectl's precedence, trimmed to what a pod or
operator box actually has:

1. explicit ``host``/``token`` arguments,
2. ``PTPU_K8S_HOST`` / ``PTPU_K8S_TOKEN`` / ``PTPU_K8S_NAMESPACE`` env,
3. the in-cluster service account
   (``/var/run/secrets/kubernetes.io/serviceaccount``).

TLS: in-cluster config uses https with the mounted CA.  The stub server
and ``kubectl proxy`` use plain http.

The port's own copy of ``polyaxon_tpu/k8s/kubeclient.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, Optional

OPERATIONS_GROUP = "core.polyaxon-tpu.io"
OPERATIONS_VERSION = "v1"
_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeApiError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


class KubeClient:
    def __init__(self, host: Optional[str] = None,
                 token: Optional[str] = None,
                 namespace: Optional[str] = None,
                 ca_file: Optional[str] = None,
                 timeout: float = 10.0):
        env = os.environ
        self.host = (host or env.get("PTPU_K8S_HOST") or
                     self._in_cluster_host() or "").rstrip("/")
        if not self.host:
            raise KubeApiError(0, "no API server host configured "
                                  "(PTPU_K8S_HOST or in-cluster)")
        self.token = token or env.get("PTPU_K8S_TOKEN") or \
            self._read_sa("token")
        self.namespace = namespace or env.get("PTPU_K8S_NAMESPACE") or \
            self._read_sa("namespace") or "default"
        self.timeout = timeout
        ca = ca_file or (os.path.join(_SA_DIR, "ca.crt")
                         if os.path.exists(os.path.join(_SA_DIR, "ca.crt"))
                         else None)
        self._ctx: Optional[ssl.SSLContext] = None
        if self.host.startswith("https"):
            self._ctx = ssl.create_default_context(cafile=ca)

    @staticmethod
    def _in_cluster_host() -> Optional[str]:
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        return f"https://{host}:{port}" if host else None

    @staticmethod
    def _read_sa(name: str) -> Optional[str]:
        try:
            with open(os.path.join(_SA_DIR, name)) as f:
                return f.read().strip()
        except OSError:
            return None

    # -- plumbing ----------------------------------------------------------

    def _path(self, plural: str, name: Optional[str] = None,
              group: str = "", subresource: Optional[str] = None,
              namespace: Optional[str] = None) -> str:
        ns = namespace or self.namespace
        base = (f"/apis/{group}/{OPERATIONS_VERSION}" if group
                else "/api/v1")
        path = f"{base}/namespaces/{ns}/{plural}"
        if name:
            path += f"/{name}"
        if subresource:
            path += f"/{subresource}"
        return path

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None,
                 content_type: str = "application/json",
                 timeout: Optional[float] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.host + path, data=data,
                                     method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            return urllib.request.urlopen(
                req, timeout=timeout or self.timeout, context=self._ctx)
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:500]
            try:
                detail = json.loads(detail).get("message", detail)
            except ValueError:
                pass
            raise KubeApiError(e.code, detail) from None
        except urllib.error.URLError as e:
            raise KubeApiError(0, str(e.reason)) from None

    def _json(self, method: str, path: str, body: Optional[dict] = None,
              content_type: str = "application/json") -> Dict[str, Any]:
        with self._request(method, path, body, content_type) as resp:
            return json.loads(resp.read() or b"{}")

    # -- verbs -------------------------------------------------------------

    def create(self, plural: str, obj: dict, group: str = "",
               namespace: Optional[str] = None) -> Dict[str, Any]:
        return self._json("POST",
                          self._path(plural, group=group,
                                     namespace=namespace), obj)

    def get(self, plural: str, name: str, group: str = "",
            namespace: Optional[str] = None) -> Dict[str, Any]:
        return self._json("GET", self._path(plural, name, group,
                                            namespace=namespace))

    def list(self, plural: str, group: str = "",
             namespace: Optional[str] = None) -> Dict[str, Any]:
        return self._json("GET", self._path(plural, group=group,
                                            namespace=namespace))

    def patch(self, plural: str, name: str, patch: dict, group: str = "",
              namespace: Optional[str] = None) -> Dict[str, Any]:
        return self._json("PATCH", self._path(plural, name, group,
                                              namespace=namespace),
                          patch, "application/merge-patch+json")

    def patch_status(self, plural: str, name: str, status: dict,
                     group: str = "",
                     namespace: Optional[str] = None) -> Dict[str, Any]:
        return self._json("PATCH",
                          self._path(plural, name, group, "status",
                                     namespace=namespace),
                          {"status": status},
                          "application/merge-patch+json")

    def delete(self, plural: str, name: str, group: str = "",
               namespace: Optional[str] = None) -> Dict[str, Any]:
        return self._json("DELETE", self._path(plural, name, group,
                                               namespace=namespace))

    def watch(self, plural: str, group: str = "",
              resource_version: Optional[str] = None,
              timeout_seconds: float = 5.0,
              namespace: Optional[str] = None) -> Iterator[Dict[str, Any]]:
        """Yield ``{"type": ..., "object": ...}`` events until the server
        closes the stream (bounded by ``timeout_seconds``)."""
        path = self._path(plural, group=group, namespace=namespace)
        path += f"?watch=true&timeoutSeconds={timeout_seconds:g}"
        if resource_version:
            path += f"&resourceVersion={resource_version}"
        with self._request("GET", path,
                           timeout=timeout_seconds + 5) as resp:
            for raw in resp:
                line = raw.strip()
                if line:
                    yield json.loads(line)
