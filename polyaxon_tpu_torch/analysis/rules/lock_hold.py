"""LOCK-HOLD: no unbounded blocking inside a ``with <...lock>`` body.

The port's own copy of ``polyaxon_tpu/analysis/rules/lock_hold.py``,
retargeted from JAX to torch.  The reference's device sink was the
method-form ``x.block_until_ready()`` (the functional
``jax.block_until_ready`` was its sanctioned fence).  Here the sink is
every spelling that waits for the card: ``torch.cuda.synchronize``,
``Stream.synchronize`` / ``Event.synchronize`` (any ``.synchronize()``)
and the blocking host copies ``.item()``, ``.tolist()`` and ``.cpu()``.
``slots.sync_device`` is the sanctioned fence, as
``jax.block_until_ready`` was: it waits on ``slots._CAPTURE_LOCK`` by
design, so a synchronize never lands inside another engine's capture.
``slots.host_copy``, the fetch of a step's outputs (the reference's
functional ``jax.device_get``), is sanctioned the same way.
"""

from __future__ import annotations

import ast
from typing import List

from ._base import (Finding, Rule, _LOCK_NAME, _SOCKET_IO,
                    _ScopedVisitor, _src_line, dotted_name)


# Tensor methods that copy to the host and so wait for the card.
_HOST_COPIES = frozenset({"item", "tolist", "cpu"})


class LockHoldRule(Rule):
    """No unbounded blocking inside a ``with <...lock>`` body.

    A serving lock (``device_lock``, ``_lock``, ``_stats_lock``,
    ``_prefix_lock``, anything matching ``*_lock``) serializes every
    handler thread behind its holder: an untimed wait under one turns
    a single slow caller into a server-wide stall, and an inversion-
    prone sleep is a deadlock seed.  Flags, inside such a body (not
    descending into nested function defs, which run later):
    ``time.sleep``; ``.wait()`` / ``.get()`` / ``.join()`` with no
    timeout; socket/HTTP I/O calls; a device wait
    (``torch.cuda.synchronize``, ``.synchronize()`` on a stream or an
    event) and the host copies ``.item()`` / ``.tolist()`` / ``.cpu()``
    that wait for it.  ``slots.sync_device(dev)``, the fence of a
    device step, and ``slots.host_copy(x)``, the fetch of its outputs,
    are the sanctioned sync idioms and are NOT flagged — the step sync
    is why the lock is held at all."""

    id = "LOCK-HOLD"

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self

        class V(_ScopedVisitor):
            def visit_With(self, node):
                held = None
                for item in node.items:
                    name = dotted_name(item.context_expr)
                    if name is None and \
                            isinstance(item.context_expr, ast.Call):
                        name = dotted_name(item.context_expr.func)
                    last = (name or "").rsplit(".", 1)[-1]
                    if _LOCK_NAME.search(last):
                        held = last
                        break
                if held is not None:
                    for stmt in node.body:
                        self._scan(stmt, held)
                self.generic_visit(node)

            visit_AsyncWith = visit_With

            def _scan(self, node, held: str) -> None:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    return          # runs later, not under the lock
                if isinstance(node, ast.Call):
                    self._check_call(node, held)
                for child in ast.iter_child_nodes(node):
                    self._scan(child, held)

            @staticmethod
            def _none_const(a) -> bool:
                return isinstance(a, ast.Constant) and a.value is None

            @staticmethod
            def _true_const(a) -> bool:
                return isinstance(a, ast.Constant) and a.value is True

            def _untimed(self, node: ast.Call, tail: str) -> bool:
                """True when this wait/join/get/wait_for call blocks
                without a bound.  A positional arg is only a timeout
                where the stdlib signature puts one — ``q.get(True)``
                and ``t.join(None)`` are still unbounded."""
                kw = {k.arg: k.value for k in node.keywords}
                timeout = kw.get("timeout")
                if timeout is not None and \
                        not self._none_const(timeout):
                    return False
                if tail in ("wait", "join"):
                    # signature: (timeout=None)
                    return not node.args \
                        or self._none_const(node.args[0])
                if tail == "wait_for":
                    # signature: (predicate, timeout=None)
                    return len(node.args) < 2 \
                        or self._none_const(node.args[1])
                # get: signature (block=True, timeout=None) — only
                # the blocking forms count (q.get(), q.get(True),
                # block=True); d.get(key[, default]) never matches.
                # (acquire shares the (blocking, timeout) shape but
                # has its own check: see _unbounded_acquire.)
                if len(node.args) >= 2 and \
                        not self._none_const(node.args[1]):
                    return False
                blocking = (not node.args and "block" not in kw) \
                    or (node.args and self._true_const(node.args[0])) \
                    or self._true_const(kw.get("block"))
                return bool(blocking)

            @staticmethod
            def _neg_num_const(a) -> bool:
                """A literal negative number (parses as USub over a
                Constant): acquire's spelled-out block-forever."""
                if isinstance(a, ast.UnaryOp) \
                        and isinstance(a.op, ast.USub) \
                        and isinstance(a.operand, ast.Constant):
                    v = a.operand.value
                    return isinstance(v, (int, float)) \
                        and not isinstance(v, bool)
                return False

            def _unbounded_acquire(self, node: ast.Call) -> bool:
                """Lock.acquire(blocking=True, timeout=-1): blocking
                with no timeout.  ``acquire(False)`` (try-lock) and
                an explicit non-literal-negative timeout are bounded
                — but ``timeout=-1`` (or ``acquire(True, -1)``) is
                the stdlib's SPELLED-OUT block-forever and stays
                flagged; a variable timeout gets the benefit of the
                doubt like the rest of the rule."""
                kw = {k.arg: k.value for k in node.keywords}
                if "timeout" in kw:
                    t = kw["timeout"]
                    return self._none_const(t) \
                        or self._neg_num_const(t)
                if len(node.args) >= 2:
                    t = node.args[1]
                    return self._none_const(t) \
                        or self._neg_num_const(t)
                blocking = (not node.args and "blocking" not in kw) \
                    or (node.args
                        and self._true_const(node.args[0])) \
                    or self._true_const(kw.get("blocking"))
                return bool(blocking)

            def _check_call(self, node: ast.Call, held: str) -> None:
                name = dotted_name(node.func) or ""
                tail = name.rsplit(".", 1)[-1]
                msg = None
                if name == "time.sleep":
                    msg = "time.sleep while holding"
                elif tail in ("wait", "get", "join", "wait_for") and \
                        isinstance(node.func, ast.Attribute) and \
                        self._untimed(node, tail):
                    msg = f"untimed .{tail}() while holding"
                elif tail == "acquire" and \
                        isinstance(node.func, ast.Attribute) and \
                        _LOCK_NAME.search(
                            (dotted_name(node.func.value) or "")
                            .rsplit(".", 1)[-1]) and \
                        self._unbounded_acquire(node):
                    # Nested blocking lock acquisition under a held
                    # lock is the lock-order-inversion seed the
                    # cancellation/eviction paths must never plant:
                    # `with a_lock: b_lock.acquire()` deadlocks
                    # against any thread doing the reverse.
                    msg = "untimed nested lock .acquire() while " \
                          "holding"
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "synchronize":
                    msg = (f"device wait ({name or '.synchronize'}()) "
                           f"while holding")
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _HOST_COPIES and \
                        not node.args:
                    msg = (f"device->host copy .{node.func.attr}() "
                           f"while holding")
                elif tail in _SOCKET_IO and (
                        name.startswith(("socket.", "requests.",
                                         "urllib.", "http."))
                        or tail in ("urlopen", "create_connection")):
                    msg = f"socket/HTTP I/O ({tail}) while holding"
                if msg is not None:
                    findings.append(Finding(
                        rule.id, relpath, node.lineno, self.func,
                        _src_line(lines, node.lineno),
                        f"{msg} {held}: one slow caller stalls every "
                        f"thread queued on the lock — bound it with a "
                        f"timeout or move it outside the critical "
                        f"section"))

        V().visit(tree)
        return findings

RULES = (LockHoldRule(),)
