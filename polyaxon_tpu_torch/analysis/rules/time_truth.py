"""TIME-TRUTH: host-clock deltas must not time async CUDA launches.

The port's own copy of ``polyaxon_tpu/analysis/rules/time_truth.py``,
retargeted from JAX to torch.  The reference's launches were jax-rooted
calls and its syncs ``block_until_ready`` / ``device_get``; here a
launch is a ``torch.*`` call (``torch.profiler`` markers, grad-mode and
device-query helpers excluded) or a CUDA graph's ``.replay()``, and a
sync is ``slots.sync_device``, ``slots.host_copy``, any
``.synchronize()`` (device, stream or event), an event's
``elapsed_time``, or a host copy (``.item()``, ``.tolist()``,
``.cpu()``), which waits for the card.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from ._base import Finding, Rule, _ScopedVisitor, _in_serving, \
    _src_line, dotted_name


_CLOCK_CALLS = {"time.perf_counter", "time.time"}
# The sanctioned device-sync spellings: any of these on a line
# between the clock read and the delta makes the delta honest.
_SYNC_TAILS = {"sync_device", "host_copy", "synchronize", "elapsed_time",
               "item", "tolist", "cpu"}
# torch calls that enqueue no work on the card.
_NOT_LAUNCHES = ("torch.profiler", "torch.no_grad", "torch.inference_mode",
                 "torch.enable_grad", "torch.cuda.Event",
                 "torch.cuda.Stream", "torch.cuda.stream",
                 "torch.cuda.current_stream", "torch.cuda.is_available",
                 "torch.cuda.device_count", "torch.cuda.get_device_name",
                 "torch.device", "torch.get_num_threads",
                 "torch.set_num_threads")


def _is_launch(name: str) -> bool:
    if name.rsplit(".", 1)[-1] == "replay":
        return True             # a CUDA graph's replay
    return name.split(".", 1)[0] == "torch" \
        and not name.startswith(_NOT_LAUNCHES)


class TimeTruthRule(Rule):
    """Host-clock deltas must not time ASYNC CUDA launches.

    A CUDA launch is asynchronous: a torch call on a CUDA tensor
    returns once the kernel is queued, so ``t0 = time.perf_counter();
    fn(...); dt = perf_counter() - t0`` measures how fast the HOST
    enqueued work, not how long the device ran — the number silently
    shrinks as programs grow (more async tail) and every consumer
    downstream (step_device_share, SLO math) inherits the lie.
    Flagged: a ``<name> - t0``-style delta whose anchor is a
    ``time.perf_counter()``/``time.time()`` assignment in the same
    function, with at least one launch (a ``torch.*`` call that
    queues work, or a CUDA graph's ``.replay()``) on the lines between
    anchor and delta and NO sync (``sync_device``, ``host_copy``,
    ``.synchronize()``, ``elapsed_time``, or a host copy ``.item()`` /
    ``.tolist()`` / ``.cpu()``) in that span.  Scoped to serving/ and benchmarks/ —
    the layers whose timings feed dashboards and committed rows.
    HTTP/thread timing (no launch in the span) never matches."""

    id = "TIME-TRUTH"

    def applies_to(self, relpath: str) -> bool:
        rp = "/" + relpath.replace("\\", "/")
        return _in_serving(relpath) or "/benchmarks/" in rp

    @staticmethod
    def _call_lines(body: ast.AST):
        """(clock assigns, launch lines, sync lines) for one
        function body, NOT descending into nested defs/lambdas (their
        calls run on their own schedule, not between this function's
        clock reads)."""
        anchors: Dict[str, List[int]] = {}
        jax_lines: List[int] = []
        sync_lines: Set[int] = set()

        def scan(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                if isinstance(child, ast.Assign) \
                        and len(child.targets) == 1 \
                        and isinstance(child.targets[0], ast.Name) \
                        and isinstance(child.value, ast.Call) \
                        and dotted_name(child.value.func) \
                        in _CLOCK_CALLS:
                    anchors.setdefault(child.targets[0].id,
                                       []).append(child.lineno)
                if isinstance(child, ast.Call):
                    name = dotted_name(child.func) or ""
                    tail = name.rsplit(".", 1)[-1]
                    if isinstance(child.func, ast.Attribute):
                        tail = child.func.attr
                        name = name or f".{tail}"
                    if tail in _SYNC_TAILS:
                        sync_lines.add(child.lineno)
                    elif _is_launch(name):
                        jax_lines.append(child.lineno)
                scan(child)

        scan(body)
        return anchors, jax_lines, sync_lines

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self

        class V(_ScopedVisitor):
            def visit_FunctionDef(self, node):
                self._stack.append(node.name)
                anchors, jax_lines, sync_lines = \
                    rule._call_lines(node)
                if anchors:
                    for sub in self._own_nodes(node):
                        if isinstance(sub, ast.BinOp) \
                                and isinstance(sub.op, ast.Sub) \
                                and isinstance(sub.right, ast.Name) \
                                and sub.right.id in anchors:
                            self._check_delta(sub, anchors,
                                              jax_lines, sync_lines)
                self.generic_visit(node)
                self._stack.pop()

            @staticmethod
            def _own_nodes(fn):
                """Walk ``fn``'s body without descending into nested
                defs/lambdas — their deltas anchor (and get checked)
                in their own scope."""
                stack = list(ast.iter_child_nodes(fn))
                while stack:
                    n = stack.pop()
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.Lambda)):
                        continue
                    yield n
                    stack.extend(ast.iter_child_nodes(n))

            visit_AsyncFunctionDef = visit_FunctionDef

            def _check_delta(self, sub, anchors, jax_lines,
                             sync_lines):
                # Anchor = the nearest clock assignment ABOVE the
                # delta (re-assignment in a loop re-anchors).
                prior = [ln for ln in anchors[sub.right.id]
                         if ln < sub.lineno]
                if not prior:
                    return
                a = max(prior)
                span_jax = [ln for ln in jax_lines
                            if a < ln <= sub.lineno]
                span_sync = any(a < ln <= sub.lineno
                                for ln in sync_lines)
                if span_jax and not span_sync:
                    findings.append(Finding(
                        rule.id, relpath, sub.lineno, self.func,
                        _src_line(lines, sub.lineno),
                        f"host-clock delta over async CUDA launches "
                        f"(launch at line {span_jax[0]}, no "
                        f"sync_device/synchronize/host copy since the "
                        f"clock read at line {a}): the delta times "
                        f"the ENQUEUE, not the device — sync first, "
                        f"or use the flight recorder's trace "
                        f"attribution for device truth"))

        V().visit(tree)
        return findings

RULES = (TimeTruthRule(),)
