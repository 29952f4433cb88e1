"""JIT-PURITY: no capture-time-frozen impurity inside CUDA-graph
captures.

The port's own copy of ``polyaxon_tpu/analysis/rules/jit_purity.py``,
retargeted from ``jax.jit`` bodies to CUDA-graph capture bodies
(``_jit._collect_captured``).  The reference's static-argument check has
no counterpart (a captured body takes no arguments); in its place the
rule holds the standing rule of the port's graph pools: no host copy,
no clock and no Python-side state change inside a capture.
"""

from __future__ import annotations

import ast
import re
from typing import List

from ._base import Finding, Rule, _src_line, dotted_name
from ._jit import _collect_captured


_IMPURE_CALLS = re.compile(
    r"^(time\.(time|perf_counter|monotonic)"
    r"|np\.random\.\w+|numpy\.random\.\w+"
    r"|random\.\w+)$")

# Tensor methods that copy to the host: a sync, which a capture
# refuses, and a value read once at capture time.
_HOST_COPIES = frozenset({"item", "tolist", "cpu", "numpy"})


class JitPurityRule(Rule):
    """No capture-time impurity inside CUDA-graph captures.

    A captured body's Python runs ONCE, at capture time; every replay
    runs only the kernels it queued.  ``time.time()`` /
    ``np.random.*`` / stdlib ``random.*`` results are baked into the
    graph as constants, a host copy (``.item()`` / ``.tolist()`` /
    ``.cpu()`` / ``.numpy()``) syncs inside the capture (an error on
    the card) and reads a value once, and a ``global`` / ``nonlocal``
    write or an assignment to a ``self`` attribute happens once per
    capture, not per replay — all silent wrong-answer bugs, or a
    capture that fails only on the card."""

    id = "JIT-PURITY"

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        for body, label in _collect_captured(tree):
            for node in ast.walk(body):
                msg = None
                if isinstance(node, ast.Call):
                    name = dotted_name(node.func) or ""
                    if _IMPURE_CALLS.match(name):
                        msg = (f"{name}() inside a CUDA-graph capture "
                               f"runs once at CAPTURE time and is baked "
                               f"into the graph as a constant")
                    elif isinstance(node.func, ast.Attribute) and \
                            node.func.attr in _HOST_COPIES and \
                            not node.args:
                        msg = (f"host copy .{node.func.attr}() inside a "
                               f"CUDA-graph capture: it syncs (which a "
                               f"capture refuses) and reads the value "
                               f"once, not per replay")
                elif isinstance(node, (ast.Global, ast.Nonlocal)):
                    msg = ("global/nonlocal mutation inside a CUDA-graph "
                           "capture happens once per capture, not per "
                           "replay")
                elif isinstance(node, (ast.Assign, ast.AugAssign,
                                       ast.AnnAssign)):
                    targets = node.targets \
                        if isinstance(node, ast.Assign) else [node.target]
                    for t in targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            msg = (f"Python-side state change "
                                   f"(self.{t.attr}) inside a CUDA-graph "
                                   f"capture happens once per capture, "
                                   f"not per replay")
                            break
                if msg is not None:
                    findings.append(Finding(
                        self.id, relpath, node.lineno, label,
                        _src_line(lines, node.lineno), msg))
        return findings

RULES = (JitPurityRule(),)
