"""HOST-SYNC: no implicit device->host syncs in the decode hot path.

The port's own copy of ``polyaxon_tpu/analysis/rules/host_sync.py``,
retargeted from JAX to torch.  The reference flagged ``np.asarray`` /
``float`` / ``int`` over a jax-rooted call and ``.tolist()`` /
``.item()``; here the sinks are the torch calls that wait for the card:
``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``torch.cuda.synchronize`` (any ``.synchronize()``), and ``float`` /
``int`` / ``bool`` over a ``torch.*`` call, in the engine, slot and
paged step modules.  The reference's sanctioned ``jax.device_get``
becomes ``slots.host_copy``, the one fetch of a window's outputs
(``StepPool._replay``'s ``fetch``), and ``slots.sync_device`` is the
sanctioned fence; neither is flagged, and the two carry the one local
suppression each their own bodies need.
"""

from __future__ import annotations

import ast
from typing import List

from ._base import Finding, Rule, _ScopedVisitor, _src_line, \
    dotted_name


_HOT_PATHS = ("serving/engine.py", "serving/slots.py",
              "serving/paged.py")

# Tensor methods whose result lives on the host: each waits for the
# card when the tensor is on it.
_HOST_COPIES = frozenset({"item", "tolist", "cpu", "numpy"})


def _is_torch_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func) or ""
    return name.split(".", 1)[0] == "torch"


def _host_copy(node: ast.AST) -> bool:
    """``x.cpu()``, ``host_copy(x)`` and the like: what a chained
    ``.numpy()`` reads is already on the host, so one sync is counted
    once (and ``host_copy``, the sanctioned fetch, not at all)."""
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Attribute):
        return node.func.attr in _HOST_COPIES \
            or node.func.attr == "host_copy"
    return dotted_name(node.func) == "host_copy"


class HostSyncRule(Rule):
    """No implicit device->host syncs in the decode hot path.

    ``float``/``int``/``bool`` applied directly to a torch-producing
    call, ``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` and
    ``torch.cuda.synchronize`` each wait for the card — the decode
    loop stalls on device work the author never sees.  The sanctioned
    spellings are ``slots.host_copy`` (the fetch of a step's outputs)
    and ``slots.sync_device`` (the fence).  Scoped to the engine step /
    decode modules (serving/engine.py, serving/slots.py,
    serving/paged.py) where one stray sync costs every resident
    stream a step."""

    id = "HOST-SYNC"

    def applies_to(self, relpath: str) -> bool:
        return any(relpath.endswith(p) for p in _HOT_PATHS)

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self

        class V(_ScopedVisitor):
            def visit_Call(self, node):
                name = dotted_name(node.func) or ""
                tail = name.rsplit(".", 1)[-1]
                if isinstance(node.func, ast.Attribute):
                    tail = node.func.attr
                if name in ("float", "int", "bool") and node.args and \
                        _is_torch_call(node.args[0]):
                    findings.append(Finding(
                        rule.id, relpath, node.lineno, self.func,
                        _src_line(lines, node.lineno),
                        f"{name}() directly on a torch call is an "
                        f"implicit device->host sync in the decode "
                        f"hot path; fetch once per window and index "
                        f"on the host"))
                elif tail == "synchronize" and \
                        isinstance(node.func, ast.Attribute):
                    findings.append(Finding(
                        rule.id, relpath, node.lineno, self.func,
                        _src_line(lines, node.lineno),
                        f"{name or '.synchronize'}() in the decode hot "
                        f"path: fence with slots.sync_device, which "
                        f"also waits out a capture in flight"))
                elif tail in _HOST_COPIES and \
                        isinstance(node.func, ast.Attribute) and \
                        not node.args and \
                        not _host_copy(node.func.value):
                    findings.append(Finding(
                        rule.id, relpath, node.lineno, self.func,
                        _src_line(lines, node.lineno),
                        f".{tail}() in the decode hot path is an "
                        f"implicit device->host sync; fetch once per "
                        f"window, index on the host"))
                self.generic_visit(node)

        V().visit(tree)
        return findings

RULES = (HostSyncRule(),)
