"""LOCK-ORDER: interprocedural lock-acquisition-graph analysis.

The per-module rule families (`analysis/rules/`) see one function at
a time; lock-order inversions live *between* functions — thread A
takes `_prefix_lock` then calls into something that takes
`_page_lock`, thread B does the reverse, and nothing in either
function alone looks wrong.  This module builds a whole-program model
of `serving/` (plus `analysis/locksan.py`, whose registry below names
the sanitized locks) and derives the static lock-acquisition graph:

1. **Program model** (`ProgramModel`): every function/method in the
   checked file set, with its class context; every lock *declaration*
   (``self.x = threading.Lock()/RLock()/Condition()``, ``FairLock()``,
   ``sanitizer.wrap("name", ...)``); attribute types inferred from
   ``self.x = ClassName(...)`` assignments; and, per function, the
   lexical walk results — lock acquisitions (``with`` items and
   ``.acquire()/.release()`` pairs, including try-lock forms), call
   sites, attribute writes, and thread spawns — each tagged with the
   set of locks lexically held at that point.

2. **Lock identity**: a lock is named by its declaring class —
   ``Telemetry._lock`` and ``Replica._lock`` are different locks even
   though both attributes are spelled ``_lock``.  The
   :data:`~polyaxon_tpu_torch.analysis.locksan.LOCK_REGISTRY` in locksan.py
   canonicalizes aliases (the engine's ``device_lock`` *is* the
   server's ``_lock``) and pins static names to the runtime
   sanitizer's names so the static graph and ``LockSanitizer.stats()``
   edges speak the same vocabulary — that equality is what makes the
   static ⊇ runtime cross-check (``chip_smoke.py`` on the card,
   ``tests/test_torch_faults.py`` on the CPU) a real test rather than
   a name-translation exercise.  A module-level lock
   (``_CAPTURE_LOCK = threading.Lock()`` at the top of a module) has
   no declaring class: it is named ``<module>.<NAME>``
   (``slots._CAPTURE_LOCK``), and a bare name or a
   ``from .module import NAME`` reaches it from any function.

3. **Edges**: ``a -> b`` when some thread can block acquiring ``b``
   while holding ``a`` — either lexically (nested ``with``) or
   through a call chain (may-analysis: the transitive acquisition set
   of every callee, propagated to fixpoint).  Every edge carries a
   witness: the function chain and line numbers from the frame that
   holds ``a`` down to the frame that acquires ``b``.

4. **Cycles**: a cycle over *blocking* edges is a potential deadlock
   and becomes a LOCK-ORDER finding whose message prints the full
   witness path for each edge.  Try-lock acquisitions
   (``acquire(False)`` / ``acquire(blocking=False)`` / finite
   ``timeout=``) still produce edges — the runtime sanitizer records
   them, so the cross-check needs them — but never *complete* a
   cycle, because a try-lock never waits.

The acyclic graph is committed as ``analysis/lockorder.json`` (the
canonical lock-order DAG); tests/test_torch_check_clean.py regenerates
it and fails on drift, so a PR that adds an ordering edge must ship the
artifact diff for review.

Known precision limits (deliberate, documented): receivers are
resolved through ``self`` attributes, single-declaring-class lookup,
and the RECEIVER_TYPES hints in locksan.py — a receiver the model
cannot type contributes no call edge (a bare-name call reaches a
function of its own module, or of another module through a relative
``from .module import name``); two instances of the same class
share one lock node (cross-instance hand-off looks like
self-deadlock, none exists in serving/ today); branches are explored
with copies of the held set, except ``try`` bodies and ``finally``
blocks, whose acquire/release effects flow through (the
acquire-in-try / release-in-finally idiom).

The port's own copy of ``polyaxon_tpu/analysis/lockgraph.py``
(stdlib only, kept here so the port imports nothing of the JAX
package).  It adds the module-level locks and the relative imports
that reach them and the functions around them; on sources with
neither (the reference's fixtures) it builds the reference's graph.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .rules._base import Finding, dotted_name, _src_line, _LOCK_NAME
from .locksan import LOCK_REGISTRY, RECEIVER_TYPES

__all__ = ["ProgramModel", "LockGraph", "build_model", "build_lock_graph",
           "lock_order_findings", "canonical_graph", "PROGRAM_SCOPE",
           "in_program_scope"]

# Files the whole-program analyses read.  Fixture tests feed virtual
# paths through the same predicate, so `/serving/` matching stays
# prefix-free.
PROGRAM_SCOPE = ("/serving/", "/analysis/locksan.py")


def in_program_scope(relpath: str) -> bool:
    p = "/" + relpath.replace("\\", "/")
    return any(s in p for s in PROGRAM_SCOPE)


_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "FairLock"}

# Mutating method calls that count as writes to the receiver attr for
# the THREAD-SHARE analysis (threads.py rides this model).
_MUTATORS = {"append", "appendleft", "add", "update", "clear", "extend",
             "remove", "discard", "insert", "pop", "popleft", "popitem",
             "setdefault", "sort", "reverse"}

_CTOR_NAMES = {"__init__", "__post_init__", "__new__"}

# Method names that collide with builtin-collection / stdlib APIs.
# The *unknown-receiver* call fallback (link iff exactly one program
# class defines the method) must not fire for these: `children.get()`
# on a dict would otherwise resolve to whatever program class happens
# to define `get`.  Typed receivers are unaffected — if the model
# knows the receiver's class, its `get` resolves normally.
_GENERIC_METHODS = frozenset({
    "get", "pop", "popitem", "setdefault", "update", "keys", "values",
    "items", "clear", "copy", "append", "appendleft", "extend",
    "insert", "remove", "sort", "reverse", "index", "count", "add",
    "discard", "popleft", "split", "rsplit", "join", "strip",
    "lstrip", "rstrip", "startswith", "endswith", "encode", "decode",
    "format", "read", "readline", "readinto", "write", "flush",
    "seek", "tell", "send", "recv", "put", "get_nowait", "put_nowait",
    "acquire", "release", "wait", "notify", "notify_all", "set",
    "is_set", "submit", "result", "close", "start", "run",
})


@dataclasses.dataclass
class LockDecl:
    cls: str                      # declaring class
    attr: str                     # attribute name
    relpath: str
    line: int
    wrap_name: Optional[str] = None   # sanitizer.wrap("<name>", ...) alias

    @property
    def static_id(self) -> str:
        return f"{self.cls}.{self.attr}"


@dataclasses.dataclass
class Acq:
    """One direct lock acquisition site."""
    canon: str
    line: int
    blocking: bool
    held: Tuple[str, ...]         # locks lexically held at this point


@dataclasses.dataclass
class CallSite:
    line: int
    held: Tuple[str, ...]
    targets: Tuple[str, ...]      # resolved callee fqns (may be empty)


@dataclasses.dataclass
class WriteSite:
    cls: str                      # owning class of the written attr
    attr: str
    line: int
    held: Tuple[str, ...]
    func: str                     # enclosing def chain (for findings)
    relpath: str


@dataclasses.dataclass
class ThreadSpawn:
    """A ``Thread(target=...)`` / ``Timer(t, fn)`` site."""
    line: int
    target_fqn: Optional[str]
    thread_name: Optional[str]
    relpath: str
    func: str


@dataclasses.dataclass
class FuncInfo:
    fqn: str                      # "relpath::Qual.chain"
    qual: str                     # def chain within the module
    name: str
    cls: Optional[str]            # innermost enclosing class, if any
    relpath: str
    node: ast.AST
    acquisitions: List[Acq] = dataclasses.field(default_factory=list)
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    writes: List[WriteSite] = dataclasses.field(default_factory=list)
    spawns: List[ThreadSpawn] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ClassInfo:
    name: str
    relpath: str
    bases: Tuple[str, ...]        # base-class tail names
    methods: Dict[str, str] = dataclasses.field(default_factory=dict)  # name -> fqn


class ProgramModel:
    """Parsed whole-program facts shared by LOCK-ORDER and
    THREAD-SHARE.  Build with :func:`build_model`."""

    def __init__(self) -> None:
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.lock_decls: Dict[Tuple[str, str], LockDecl] = {}
        self.lock_attr_classes: Dict[str, List[str]] = {}
        self.attr_types: Dict[Tuple[str, str], str] = {}
        self.module_funcs: Dict[Tuple[str, str], List[str]] = {}
        # (relpath, NAME) -> "<module>.<NAME>" for a module-level
        # ``NAME = threading.Lock()``; (relpath, local name) ->
        # (module basename, name) for a relative ``from .m import n``.
        self.module_locks: Dict[Tuple[str, str], str] = {}
        self.imports: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self.sources: Dict[str, Sequence[str]] = {}
        self.unresolved_calls: int = 0

    # -- identity -----------------------------------------------------

    def canon_lock(self, cls: Optional[str], attr: str,
                   wrap_name: Optional[str] = None) -> str:
        """Canonical graph-node name for a lock attribute."""
        static_id = f"{cls}.{attr}" if cls else attr
        if static_id in LOCK_REGISTRY:
            return LOCK_REGISTRY[static_id]
        decl = self.lock_decls.get((cls or "", attr))
        if decl is not None and decl.wrap_name:
            return decl.wrap_name
        if wrap_name:
            return wrap_name
        return static_id

    # -- class/method lookup ------------------------------------------

    def method_of(self, cls: str, name: str,
                  _seen: Optional[Set[str]] = None) -> Optional[str]:
        """fqn of ``cls.name``, walking base classes."""
        seen = _seen or set()
        if cls in seen:
            return None
        seen.add(cls)
        info = self.classes.get(cls)
        if info is None:
            return None
        if name in info.methods:
            return info.methods[name]
        for b in info.bases:
            got = self.method_of(b, name, seen)
            if got:
                return got
        return None

    def subclasses_of(self, cls: str) -> List[str]:
        out = []
        for name, info in self.classes.items():
            if cls in info.bases:
                out.append(name)
                out.extend(self.subclasses_of(name))
        return out

    def declaring_classes(self, attr: str) -> List[str]:
        return self.lock_attr_classes.get(attr, [])

    def module_file(self, near: str, module: str) -> Optional[str]:
        """The relpath of module ``module`` (a basename), preferring
        the package directory of ``near``."""
        want = f"{module}.py"
        cands = [rp for rp in sorted(self.sources)
                 if rp == want or rp.endswith("/" + want)]
        pkg = near.rsplit("/", 1)[0] + "/" if "/" in near else ""
        same = [rp for rp in cands if rp == pkg + want]
        return (same or cands or [None])[0]

    def module_lock(self, relpath: str, name: str) -> Optional[str]:
        """Canonical name of the module-level lock ``name`` as seen
        from ``relpath``: declared there, or imported there with a
        relative ``from .module import name``."""
        got = self.module_locks.get((relpath, name))
        if got is None and (relpath, name) in self.imports:
            module, orig = self.imports[(relpath, name)]
            src = self.module_file(relpath, module)
            got = self.module_locks.get((src or "", orig))
        if got is None:
            return None
        return LOCK_REGISTRY.get(got, got)


# ---------------------------------------------------------------------
# pass 1: indexes (classes, methods, lock decls, attr types)
# ---------------------------------------------------------------------

def _tail(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


class _IndexVisitor(ast.NodeVisitor):
    def __init__(self, model: ProgramModel, relpath: str) -> None:
        self.m = model
        self.relpath = relpath
        self._cls: List[str] = []
        self._def: List[str] = []

    def _fqn(self, name: str) -> str:
        qual = ".".join(self._cls + self._def + [name])
        return f"{self.relpath}::{qual}"

    def visit_Module(self, node: ast.Module) -> None:
        module = self.relpath.rsplit("/", 1)[-1][:-3]
        for st in node.body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name) \
                    and isinstance(st.value, ast.Call) \
                    and _tail(st.value.func) in _LOCK_FACTORIES:
                name = st.targets[0].id
                self.m.module_locks[(self.relpath, name)] = \
                    f"{module}.{name}"
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level and node.module:
            base = node.module.rsplit(".", 1)[-1]
            for alias in node.names:
                self.m.imports[(self.relpath,
                                alias.asname or alias.name)] = \
                    (base, alias.name)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        bases = tuple(b for b in (_tail(x) for x in node.bases) if b)
        # Innermost class wins for nested classes (handler-in-closure).
        self.m.classes.setdefault(
            node.name, ClassInfo(node.name, self.relpath, bases))
        self._cls.append(node.name)
        saved, self._def = self._def, []
        self.generic_visit(node)
        self._def = saved
        self._cls.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        fqn = self._fqn(node.name)
        cls = self._cls[-1] if self._cls and not self._def else None
        qual = ".".join(self._cls + self._def + [node.name])
        self.m.functions[fqn] = FuncInfo(
            fqn=fqn, qual=qual, name=node.name, cls=cls,
            relpath=self.relpath, node=node)
        if cls is not None:
            self.m.classes[cls].methods.setdefault(node.name, fqn)
        self.m.module_funcs.setdefault(
            (self.relpath, node.name), []).append(fqn)
        if cls is not None:
            self._scan_decls(node, cls)
        self._def.append(node.name)
        self.generic_visit(node)
        self._def.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _scan_decls(self, fn: ast.FunctionDef, cls: str) -> None:
        """Lock declarations + attr types from ``self.X = ...``."""
        for st in ast.walk(fn):
            if not isinstance(st, ast.Assign) or len(st.targets) != 1:
                continue
            tgt = st.targets[0]
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            attr = tgt.attr
            wrap_name: Optional[str] = None
            is_lock = False
            first_cls: Optional[str] = None
            for sub in ast.walk(st.value):
                if not isinstance(sub, ast.Call):
                    continue
                t = _tail(sub.func)
                if t in _LOCK_FACTORIES:
                    is_lock = True
                elif t == "wrap" and sub.args and isinstance(
                        sub.args[0], ast.Constant) and isinstance(
                        sub.args[0].value, str):
                    is_lock = True
                    wrap_name = sub.args[0].value
                elif (t and first_cls is None and t in self.m.classes
                      ) or (t and first_cls is None and t[:1].isupper()):
                    first_cls = t
            if is_lock:
                key = (cls, attr)
                if key not in self.m.lock_decls or wrap_name:
                    self.m.lock_decls[key] = LockDecl(
                        cls, attr, self.relpath, st.lineno, wrap_name)
                    lst = self.m.lock_attr_classes.setdefault(attr, [])
                    if cls not in lst:
                        lst.append(cls)
            elif first_cls is not None:
                self.m.attr_types.setdefault((cls, attr), first_cls)


# ---------------------------------------------------------------------
# pass 2: per-function lexical walk (held sets, acqs, calls, writes)
# ---------------------------------------------------------------------

def _call_blocking(call: ast.Call) -> bool:
    """Is ``lock.acquire(...)`` an unbounded blocking acquisition?"""
    if call.args:
        a0 = call.args[0]
        if isinstance(a0, ast.Constant) and a0.value is False:
            return False
        if len(call.args) > 1:       # acquire(True, timeout)
            a1 = call.args[1]
            if not (isinstance(a1, ast.Constant)
                    and isinstance(a1.value, (int, float))
                    and a1.value < 0):
                return False
    for kw in call.keywords:
        if kw.arg == "blocking" and isinstance(
                kw.value, ast.Constant) and kw.value.value is False:
            return False
        if kw.arg == "timeout":
            if not (isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, (int, float))
                    and kw.value.value < 0):
                return False
    return True


class _BodyWalker:
    def __init__(self, model: ProgramModel, fi: FuncInfo) -> None:
        self.m = model
        self.fi = fi

    def run(self) -> None:
        node = self.fi.node
        held: List[str] = []
        self._stmts(node.body, held)

    # -- receiver typing ----------------------------------------------

    def _receiver_class(self, expr: ast.AST) -> Optional[str]:
        d = dotted_name(expr)
        if d is None:
            return None
        parts = d.split(".")
        if parts[0] == "self":
            if self.fi.cls is None:
                return None
            cur: Optional[str] = self.fi.cls
            rest = parts[1:]
        else:
            cur = RECEIVER_TYPES.get(parts[0])
            if cur is None and parts[0] in self.m.classes:
                cur = parts[0]       # ClassName.method style
            if cur is None:
                return None
            rest = parts[1:]
        for attr in rest:
            nxt = self._attr_type(cur, attr)
            if nxt is None:
                nxt = RECEIVER_TYPES.get(attr)
            if nxt is None:
                return None
            cur = nxt
        return cur

    def _attr_type(self, cls: str, attr: str,
                   _seen: Optional[Set[str]] = None) -> Optional[str]:
        seen = _seen or set()
        if cls in seen:
            return None
        seen.add(cls)
        got = self.m.attr_types.get((cls, attr))
        if got:
            return got
        info = self.m.classes.get(cls)
        if info:
            for b in info.bases:
                got = self._attr_type(b, attr, seen)
                if got:
                    return got
        return None

    # -- lock site resolution -----------------------------------------

    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        """Canonical lock name for a ``with X`` item / ``X.acquire()``
        receiver, or None if X is not a known lock."""
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            owner = self._receiver_class(expr.value)
            if owner is None and isinstance(expr.value, ast.Name):
                # ``slots._CAPTURE_LOCK`` through an imported module.
                src = self.m.module_file(self.fi.relpath, expr.value.id)
                got = self.m.module_locks.get((src or "", attr))
                if got is not None:
                    return LOCK_REGISTRY.get(got, got)
        elif isinstance(expr, ast.Name):
            attr, owner = expr.id, None
            got = self.m.module_lock(self.fi.relpath, attr)
            if got is not None:
                return got
        else:
            return None
        if owner is not None:
            cur: Optional[str] = owner
            seen: Set[str] = set()
            while cur and cur not in seen:
                seen.add(cur)
                if (cur, attr) in self.m.lock_decls:
                    return self.m.canon_lock(cur, attr)
                info = self.m.classes.get(cur)
                cur = info.bases[0] if info and info.bases else None
            if _LOCK_NAME.search(attr):
                return self.m.canon_lock(owner, attr)
            return None
        declaring = self.m.declaring_classes(attr)
        if len(declaring) == 1:
            return self.m.canon_lock(declaring[0], attr)
        if len(declaring) > 1:
            same_file = [c for c in declaring
                         if self.m.classes[c].relpath == self.fi.relpath]
            if len(same_file) == 1:
                return self.m.canon_lock(same_file[0], attr)
            return self.m.canon_lock(sorted(declaring)[0], attr)
        if _LOCK_NAME.search(attr):
            return self.m.canon_lock(self.fi.cls, attr)
        return None

    # -- call target resolution ---------------------------------------

    def _resolve_call(self, call: ast.Call) -> Tuple[str, ...]:
        fn = call.func
        t = _tail(fn)
        if t is None:
            return ()
        if isinstance(fn, ast.Name):
            # Class instantiation -> __init__.
            if t in self.m.classes:
                init = self.m.method_of(t, "__init__")
                return (init,) if init else ()
            # Local / module-level function in the same module.
            cands = self.m.module_funcs.get((self.fi.relpath, t), [])
            if cands:
                # Prefer one nested inside the current def chain.
                prefix = f"{self.fi.relpath}::{self.fi.qual}."
                nested = [c for c in cands if c.startswith(prefix)]
                return tuple(nested or cands[:1])
            return self._imported_function(t)
        # Attribute call: type the receiver.
        owner = self._receiver_class(fn.value)
        if owner is None and t in self.m.classes:
            init = self.m.method_of(t, "__init__")
            return (init,) if init else ()
        if owner is not None:
            out: List[str] = []
            got = self.m.method_of(owner, t)
            if got:
                out.append(got)
            for sub in self.m.subclasses_of(owner):
                sm = self.m.classes[sub].methods.get(t)
                if sm:
                    out.append(sm)
            if not out:
                self.m.unresolved_calls += 1
            return tuple(dict.fromkeys(out))
        # Unknown receiver: link only if exactly one program class
        # defines the method (avoids stdlib-name collisions), and
        # never for names that shadow builtin-collection APIs.
        if t in _GENERIC_METHODS:
            self.m.unresolved_calls += 1
            return ()
        definers = [c for c in self.m.classes.values() if t in c.methods]
        if len(definers) == 1:
            cls = definers[0]
            out = [cls.methods[t]]
            for sub in self.m.subclasses_of(cls.name):
                sm = self.m.classes[sub].methods.get(t)
                if sm:
                    out.append(sm)
            return tuple(dict.fromkeys(out))
        self.m.unresolved_calls += 1
        return ()

    def _imported_function(self, name: str) -> Tuple[str, ...]:
        """A top-level function brought in by ``from .m import name``."""
        if (self.fi.relpath, name) not in self.m.imports:
            return ()
        module, orig = self.m.imports[(self.fi.relpath, name)]
        src = self.m.module_file(self.fi.relpath, module)
        fqn = f"{src}::{orig}"
        return (fqn,) if fqn in self.m.functions else ()

    # -- statement walk ------------------------------------------------

    def _stmts(self, body: Sequence[ast.stmt], held: List[str]) -> None:
        for st in body:
            self._stmt(st, held)

    def _stmt(self, st: ast.stmt, held: List[str]) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return                      # walked as their own FuncInfos
        if isinstance(st, (ast.With, ast.AsyncWith)):
            taken: List[str] = []
            for item in st.items:
                self._expr(item.context_expr, held)
                lk = self._resolve_lock(item.context_expr)
                if lk is not None:
                    self._acquire(lk, item.context_expr.lineno, True, held)
                    held.append(lk)
                    taken.append(lk)
            self._stmts(st.body, held)
            for _ in taken:
                held.pop()
            return
        if isinstance(st, ast.Try):
            # try/finally flows acquire/release effects through: the
            # acquire-in-try / release-in-finally idiom must leave the
            # held set balanced after the statement.
            self._stmts(st.body, held)
            for h in st.handlers:
                self._stmts(h.body, list(held))
            self._stmts(st.orelse, list(held))
            self._stmts(st.finalbody, held)
            return
        if isinstance(st, ast.If):
            self._expr(st.test, held)   # `if not x.acquire(False):`
            self._stmts(st.body, list(held))
            self._stmts(st.orelse, list(held))
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(st.iter, held)
            self._stmts(st.body, list(held))
            self._stmts(st.orelse, list(held))
            return
        if isinstance(st, ast.While):
            self._expr(st.test, held)
            self._stmts(st.body, list(held))
            self._stmts(st.orelse, list(held))
            return
        # Simple statements: writes + expression scan.
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (st.targets if isinstance(st, ast.Assign)
                       else [st.target])
            for tgt in targets:
                self._write_target(tgt, st.lineno, held)
            if getattr(st, "value", None) is not None:
                self._expr(st.value, held)
            return
        if isinstance(st, ast.Delete):
            for tgt in st.targets:
                self._write_target(tgt, st.lineno, held)
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._expr(child, held)

    # -- expression scan -----------------------------------------------

    def _expr(self, node: ast.AST, held: List[str]) -> None:
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            return                      # deferred execution
        if isinstance(node, ast.Call):
            self._call(node, held)
            return
        for child in ast.iter_child_nodes(node):
            self._expr(child, held)

    def _call(self, call: ast.Call, held: List[str]) -> None:
        fn = call.func
        # Arguments first (inner calls run before the outer one).
        for a in call.args:
            self._expr(a, held)
        for kw in call.keywords:
            self._expr(kw.value, held)
        if isinstance(fn, ast.Attribute) and fn.attr in ("acquire",
                                                         "release"):
            lk = self._resolve_lock(fn.value)
            if lk is not None:
                if fn.attr == "acquire":
                    self._acquire(lk, call.lineno, _call_blocking(call),
                                  held)
                    held.append(lk)
                else:
                    # Remove the most recent matching hold.
                    for i in range(len(held) - 1, -1, -1):
                        if held[i] == lk:
                            del held[i]
                            break
                return
        t = _tail(fn)
        if t in ("Thread", "Timer"):
            self._spawn(call, t)
            return
        if (isinstance(fn, ast.Attribute) and t in _MUTATORS
                and isinstance(fn.value, (ast.Attribute, ast.Subscript))):
            base = fn.value
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Attribute):
                self._record_write(base, call.lineno, held)
        targets = self._resolve_call(call)
        if targets:
            self.fi.calls.append(
                CallSite(call.lineno, tuple(held), targets))
        if isinstance(fn, ast.Attribute):
            self._expr(fn.value, held)

    # -- recording -----------------------------------------------------

    def _acquire(self, canon: str, line: int, blocking: bool,
                 held: List[str]) -> None:
        self.fi.acquisitions.append(
            Acq(canon, line, blocking, tuple(held)))

    def _write_target(self, tgt: ast.AST, line: int,
                      held: List[str]) -> None:
        while isinstance(tgt, (ast.Subscript, ast.Starred)):
            tgt = tgt.value
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._write_target(el, line, held)
            return
        if isinstance(tgt, ast.Attribute):
            self._record_write(tgt, line, held)

    def _record_write(self, attr_node: ast.Attribute, line: int,
                      held: List[str]) -> None:
        owner = self._receiver_class(attr_node.value)
        if owner is None:
            return
        attr = attr_node.attr
        if (owner, attr) in self.m.lock_decls:
            return                      # lock rebinding, not shared data
        self.fi.writes.append(WriteSite(
            owner, attr, line, tuple(held), self.fi.qual,
            self.fi.relpath))

    def _spawn(self, call: ast.Call, kind: str) -> None:
        target_expr: Optional[ast.AST] = None
        tname: Optional[str] = None
        if kind == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
                elif kw.arg == "name" and isinstance(
                        kw.value, ast.Constant):
                    tname = str(kw.value.value)
        elif len(call.args) >= 2:       # Timer(interval, fn)
            target_expr = call.args[1]
        fqn = self._resolve_target_fqn(target_expr)
        self.fi.spawns.append(ThreadSpawn(
            call.lineno, fqn, tname, self.fi.relpath, self.fi.qual))

    def _resolve_target_fqn(self,
                            expr: Optional[ast.AST]) -> Optional[str]:
        if expr is None:
            return None
        if isinstance(expr, ast.Name):
            cands = self.m.module_funcs.get(
                (self.fi.relpath, expr.id), [])
            prefix = f"{self.fi.relpath}::{self.fi.qual}."
            nested = [c for c in cands if c.startswith(prefix)]
            return (nested or cands or [None])[0]
        if isinstance(expr, ast.Attribute):
            owner = self._receiver_class(expr.value)
            if owner is not None:
                return self.m.method_of(owner, expr.attr)
        return None


# ---------------------------------------------------------------------
# model + graph construction
# ---------------------------------------------------------------------

def build_model(sources: Dict[str, str]) -> ProgramModel:
    """Parse the program file set ({relpath: source}) into a model."""
    model = ProgramModel()
    trees: Dict[str, ast.Module] = {}
    for relpath in sorted(sources):
        tree = ast.parse(sources[relpath])
        trees[relpath] = tree
        model.sources[relpath] = sources[relpath].splitlines()
        _IndexVisitor(model, relpath).visit(tree)
    for fi in model.functions.values():
        _BodyWalker(model, fi).run()
    return model


@dataclasses.dataclass
class Edge:
    src: str
    dst: str
    blocking: bool = False
    # Witness: list of (relpath, func-qual, line, note) frames from
    # the holder of `src` down to the acquisition of `dst`.
    witness: Tuple[Tuple[str, str, int, str], ...] = ()


class LockGraph:
    def __init__(self, model: ProgramModel) -> None:
        self.model = model
        self.edges: Dict[Tuple[str, str], Edge] = {}

    def _add(self, src: str, dst: str, blocking: bool,
             witness: Tuple[Tuple[str, str, int, str], ...]) -> None:
        key = (src, dst)
        e = self.edges.get(key)
        if e is None:
            self.edges[key] = Edge(src, dst, blocking, witness)
        elif blocking and not e.blocking:
            # Upgrade to a blocking witness — cycles only form over
            # blocking edges, so keep the witness that proves one.
            e.blocking = True
            e.witness = witness

    def edge_names(self) -> Set[str]:
        return {f"{a}->{b}" for (a, b) in self.edges}

    def nodes(self) -> Set[str]:
        out: Set[str] = set()
        for a, b in self.edges:
            out.add(a)
            out.add(b)
        return out


def build_lock_graph(model: ProgramModel) -> LockGraph:
    g = LockGraph(model)
    # 1. Lexical edges.
    for fi in model.functions.values():
        for acq in fi.acquisitions:
            for h in acq.held:
                if h != acq.canon:
                    g._add(h, acq.canon, acq.blocking,
                           ((fi.relpath, fi.qual, acq.line,
                             f"acquires {acq.canon} holding {h}"),))
    # 2. Transitive acquisition sets (may-analysis, to fixpoint).
    #    acq_star[fqn] = {canon: (blocking_any, origin)} where origin
    #    is ("direct", line) or ("call", line, callee_fqn).
    acq_star: Dict[str, Dict[str, Tuple[bool, tuple]]] = {
        fqn: {} for fqn in model.functions}
    for fqn, fi in model.functions.items():
        for acq in fi.acquisitions:
            cur = acq_star[fqn].get(acq.canon)
            if cur is None or (acq.blocking and not cur[0]):
                acq_star[fqn][acq.canon] = (
                    acq.blocking, ("direct", acq.line))
    changed = True
    while changed:
        changed = False
        for fqn, fi in model.functions.items():
            mine = acq_star[fqn]
            for cs in fi.calls:
                for t in cs.targets:
                    for canon, (blk, _origin) in acq_star.get(
                            t, {}).items():
                        cur = mine.get(canon)
                        if cur is None or (blk and not cur[0]):
                            mine[canon] = (blk, ("call", cs.line, t))
                            changed = True
    # 3. Call edges: held at a call site -> anything the callee (or
    #    its callees) may acquire.
    def chain(fqn: str, canon: str,
              depth: int = 0) -> Tuple[Tuple[str, str, int, str], ...]:
        fi = model.functions[fqn]
        if depth > 24:
            return ((fi.relpath, fi.qual, 0, "..."),)
        entry = acq_star[fqn].get(canon)
        if entry is None:
            return ()
        _blk, origin = entry
        if origin[0] == "direct":
            return ((fi.relpath, fi.qual, origin[1],
                     f"acquires {canon}"),)
        _tag, line, callee = origin
        callee_qual = model.functions[callee].qual
        return ((fi.relpath, fi.qual, line, f"calls {callee_qual}"),
                ) + chain(callee, canon, depth + 1)

    for fqn, fi in model.functions.items():
        for cs in fi.calls:
            if not cs.held:
                continue
            for t in cs.targets:
                for canon, (blk, _origin) in acq_star.get(t, {}).items():
                    for h in cs.held:
                        if h == canon:
                            continue
                        key = (h, canon)
                        e = g.edges.get(key)
                        if e is not None and (e.blocking or not blk):
                            continue
                        callee_qual = model.functions[t].qual
                        wit = ((fi.relpath, fi.qual, cs.line,
                                f"holding {h}, calls {callee_qual}"),
                               ) + chain(t, canon)
                        g._add(h, canon, blk, wit)
    return g


# ---------------------------------------------------------------------
# cycle detection -> findings
# ---------------------------------------------------------------------

def _blocking_cycles(g: LockGraph) -> List[List[str]]:
    """Minimal node cycles over blocking edges, one per SCC."""
    adj: Dict[str, List[str]] = {}
    for (a, b), e in g.edges.items():
        if e.blocking:
            adj.setdefault(a, []).append(b)
    # Tarjan SCC (iterative).
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v0: str) -> None:
        work = [(v0, iter(adj.get(v0, ())))]
        index[v0] = low[v0] = counter[0]
        counter[0] += 1
        stack.append(v0)
        on.add(v0)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                if w in on:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)

    for v in list(adj):
        if v not in index:
            strongconnect(v)

    cycles: List[List[str]] = []
    for comp in sccs:
        compset = set(comp)
        has_cycle = len(comp) > 1 or any(
            v in adj.get(v, ()) for v in comp)
        if not has_cycle:
            continue
        start = min(comp)
        if start in adj.get(start, ()):
            cycles.append([start, start])
            continue
        # BFS within the SCC back to `start`.
        prev: Dict[str, str] = {}
        queue = [start]
        found: Optional[str] = None
        seen = {start}
        while queue and found is None:
            v = queue.pop(0)
            for w in adj.get(v, ()):
                if w == start:
                    found = v
                    break
                if w in compset and w not in seen:
                    seen.add(w)
                    prev[w] = v
                    queue.append(w)
        if found is None:
            continue
        path = [found]
        while path[-1] != start:
            path.append(prev[path[-1]])
        path.reverse()
        cycles.append(path + [start])
    return cycles


def _fmt_witness(e: Edge) -> str:
    frames = " ; ".join(
        f"{rel}:{line} {qual} ({note})"
        for rel, qual, line, note in e.witness)
    return f"{e.src} -> {e.dst}: {frames}"


def lock_order_findings(g: LockGraph) -> List[Finding]:
    out: List[Finding] = []
    for cyc in _blocking_cycles(g):
        edges = [g.edges[(cyc[i], cyc[i + 1])]
                 for i in range(len(cyc) - 1)]
        first = edges[0]
        rel, qual, line, _note = first.witness[0] if first.witness else (
            "<unknown>", "<unknown>", 0, "")
        code = " -> ".join(cyc)
        msg = ("potential deadlock: lock-acquisition cycle "
               + " -> ".join(cyc) + ". "
               + " || ".join(_fmt_witness(e) for e in edges))
        out.append(Finding(
            rule="LOCK-ORDER", path=rel, line=line, func=qual,
            code=code, message=msg))
    out.sort(key=lambda f: f.sort_key())
    return out


# ---------------------------------------------------------------------
# canonical artifact (analysis/lockorder.json)
# ---------------------------------------------------------------------

def canonical_graph(g: LockGraph) -> Dict[str, object]:
    """Line-number-free canonical form of the static graph — the
    committed, reviewed lock-order artifact.  Sorted and stable so
    PR diffs show exactly the ordering edges that changed."""
    edges = []
    for (a, b), e in sorted(g.edges.items()):
        edges.append({"from": a, "to": b,
                      "blocking": bool(e.blocking)})
    return {"nodes": sorted(g.nodes()), "edges": edges}


# ---------------------------------------------------------------------
# checker entry point (program analysis)
# ---------------------------------------------------------------------

def analyze(sources: Dict[str, str]) -> List[Finding]:
    """LOCK-ORDER program analysis over the in-scope file set."""
    model = build_model(sources)
    return lock_order_findings(build_lock_graph(model))
