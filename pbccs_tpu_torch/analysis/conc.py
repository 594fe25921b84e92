"""Concurrency lint: lock discipline inferred per class, checked by AST.

Three rules, tuned to this repo's threading conventions (every shared
mutable class declares `self._lock` / `self._cv` in __init__; worker
threads are plain `threading.Thread` targets):

  CONC001  an instance attribute written from >=2 distinct methods of a
           lock-holding class must have EVERY such write inside a
           `with self._lock` (or an alias: a Condition constructed over
           the same lock counts as the lock).  Writes in __init__ are
           construction, not sharing, and are exempt.
  CONC002  no blocking call while holding a lock: Future.result, .wait
           on anything that is not the held condition itself, thread
           .join, queue .get, socket recv/sendall/accept/connect,
           time.sleep, semaphore .acquire.  Blocking under a lock turns
           one slow participant into a stalled subsystem (the
           "future completed while holding the pool lock" class).
  CONC003  the cross-module lock-acquisition-order graph must be acyclic.
           Nodes are (module, class, lock); an edge A->B means code
           acquires B while holding A (directly, or through a resolvable
           method call, e.g. `self._pool.submit(...)` under the engine
           lock).  A cycle is a potential deadlock even if today's
           schedulers never interleave it.

The pass is intentionally conservative: attribute types resolve only
through direct `self.x = ClassName(...)` / module `VAR = ClassName(...)`
assignments, and calls that cannot be resolved contribute nothing.  A
finding is therefore strong evidence; silence is not proof.
"""

from __future__ import annotations

import ast
import dataclasses

from pbccs_tpu_torch.analysis.core import Finding, SourceFile, dotted_name

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

# receiver-less / dotted blocking calls (CONC002)
_BLOCKING_ATTRS = {"result", "recv", "recv_into", "sendall", "accept",
                   "connect", "acquire"}


def _is_lock_ctor(node: ast.expr) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = dotted_name(node.func)
    return d is not None and d[-1] in LOCK_FACTORIES and (
        len(d) == 1 or d[0] in ("threading", "th"))


@dataclasses.dataclass
class ClassInfo:
    module: str                       # repo-relative path
    name: str
    node: ast.ClassDef
    # lock attr -> canonical lock attr (Condition(self._lock) aliases)
    locks: dict[str, str] = dataclasses.field(default_factory=dict)
    methods: dict[str, ast.FunctionDef] = dataclasses.field(
        default_factory=dict)
    # self.<attr> -> class name (from `self.x = ClassName(...)`)
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)

    def lock_node(self, attr: str) -> tuple[str, str, str]:
        return (self.module, self.name, self.locks.get(attr, attr))


def _collect_class(src: SourceFile, node: ast.ClassDef) -> ClassInfo:
    info = ClassInfo(src.rel, node.name, node)
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info.methods[item.name] = item
        elif isinstance(item, ast.Assign) and _is_lock_ctor(item.value):
            for t in item.targets:      # class-level lock (Logger)
                if isinstance(t, ast.Name):
                    info.locks[t.id] = t.id
    for meth in info.methods.values():
        for stmt in ast.walk(meth):
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            t = stmt.targets[0]
            d = dotted_name(t)
            if d is None or len(d) != 2 or d[0] != "self":
                continue
            attr = d[1]
            if _is_lock_ctor(stmt.value):
                # Condition(self._lock) aliases the wrapped lock
                canonical = attr
                call = stmt.value
                if (dotted_name(call.func) or ("",))[-1] == "Condition" \
                        and call.args:
                    wrapped = dotted_name(call.args[0])
                    if wrapped and len(wrapped) == 2 and wrapped[0] == "self":
                        canonical = info.locks.get(wrapped[1], wrapped[1])
                info.locks[attr] = canonical
            elif isinstance(stmt.value, ast.Call):
                ctor = dotted_name(stmt.value.func)
                if ctor is not None:
                    info.attr_types[attr] = ctor[-1]
    return info


def _module_locks(src: SourceFile) -> dict[str, tuple[str, str, str]]:
    """Module-level NAME = threading.Lock() -> lock node."""
    out = {}
    for node in src.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and _is_lock_ctor(node.value)):
            name = node.targets[0].id
            out[name] = (src.rel, "", name)
    return out


def _with_lock_attrs(stmt: ast.With, info: ClassInfo | None,
                     mod_locks: dict[str, tuple[str, str, str]]
                     ) -> list[tuple[tuple[str, str, str], tuple[str, ...]]]:
    """Lock nodes this `with` acquires, with the dotted expr that names
    each (the dotted form exempts `self._cv.wait()` under `with
    self._cv`)."""
    out = []
    for item in stmt.items:
        d = dotted_name(item.context_expr)
        if d is None:
            continue
        if info is not None and len(d) == 2 and d[0] in ("self", "cls") \
                and d[1] in info.locks:
            out.append((info.lock_node(d[1]), d))
        elif info is not None and len(d) == 2 and d[0] == info.name \
                and d[1] in info.locks:
            out.append((info.lock_node(d[1]), d))
        elif len(d) == 1 and d[0] in mod_locks:
            out.append((mod_locks[d[0]], d))
    return out


def _is_blocking_call(call: ast.Call,
                      held_names: list[tuple[str, ...]]) -> str | None:
    """Return a description when `call` can block; None otherwise."""
    func = call.func
    d = dotted_name(func)
    if d is None or len(d) < 2:
        return None
    attr = d[-1]
    recv = d[:-1]
    if attr == "wait":
        # waiting on the HELD condition releases it -- the one legal wait
        if any(recv == held for held in held_names):
            return None
        return f"{'.'.join(d)}() blocks while the lock is held"
    if attr == "sleep" and recv[-1] == "time":
        return "time.sleep() under a lock stalls every other holder"
    if attr == "join":
        # thread.join() / thread.join(timeout): 0 args or one numeric /
        # timeout kwarg.  str.join(iterable) and os.path.join(a, b, ...)
        # do not match this shape.
        numeric = (len(call.args) == 1
                   and isinstance(call.args[0], ast.Constant)
                   and isinstance(call.args[0].value, (int, float)))
        kw_timeout = all(k.arg == "timeout" for k in call.keywords)
        if (not call.args and kw_timeout) or (numeric and not call.keywords):
            return f"{'.'.join(d)}() joins a thread while the lock is held"
        return None
    if attr == "get" and any("queue" in part.lower() or part == "q"
                             for part in recv):
        if any(k.arg == "block" and isinstance(k.value, ast.Constant)
               and k.value.value is False for k in call.keywords):
            return None
        return f"{'.'.join(d)}() dequeues (blocking) while the lock is held"
    if attr in _BLOCKING_ATTRS:
        return f"{'.'.join(d)}() can block while the lock is held"
    return None


class _LockWalker(ast.NodeVisitor):
    """Walk one method/function carrying the held-lock stack."""

    def __init__(self, src: SourceFile, info: ClassInfo | None,
                 mod_locks: dict, findings: list[Finding],
                 edges: dict, call_sites: list):
        self.src = src
        self.info = info
        self.mod_locks = mod_locks
        self.findings = findings
        # lock node -> set of (lock node acquired inside, lineno)
        self.edges = edges
        # (held lock node, call ast.Call) for cross-class edge resolution
        self.call_sites = call_sites
        self.held: list[tuple[tuple[str, str, str], tuple[str, ...]]] = []

    # nested defs run in another execution context: locks held here are
    # not held when the closure eventually runs
    def visit_FunctionDef(self, node):  # noqa: N802 (ast API)
        saved, self.held = self.held, []
        self.generic_visit(node)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):  # noqa: N802
        saved, self.held = self.held, []
        self.generic_visit(node)
        self.held = saved

    def visit_With(self, node):  # noqa: N802
        for item in node.items:
            self.visit(item.context_expr)
        acquired = _with_lock_attrs(node, self.info, self.mod_locks)
        for lock, _d in acquired:
            for held, _hd in self.held:
                if held != lock:
                    self.edges.setdefault(held, {}).setdefault(
                        lock, (self.src.rel, node.lineno))
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.held[-len(acquired):]

    def visit_Call(self, node):  # noqa: N802
        if self.held:
            desc = _is_blocking_call(node, [d for _, d in self.held])
            if desc is not None:
                lock = self.held[-1][0]
                self.findings.append(Finding(
                    "CONC002", self.src.rel, node.lineno,
                    f"{desc} (holding {_fmt_lock(lock)})"))
            self.call_sites.append(
                (self.held[-1][0], node, self.src.rel, node.lineno))
        self.generic_visit(node)


def _fmt_lock(lock: tuple[str, str, str]) -> str:
    mod, cls, attr = lock
    return f"{cls}.{attr}" if cls else f"{mod}:{attr}"


def _method_writes(info: ClassInfo, mod_locks: dict
                   ) -> dict[str, dict[str, list[tuple[int, frozenset]]]]:
    """attr -> method -> [(lineno, held lock nodes)] for self.<attr>
    stores.  The HELD SET matters, not a boolean: two methods writing
    the same attribute under two different locks have no mutual
    exclusion at all."""
    writes: dict[str, dict[str, list[tuple[int, frozenset]]]] = {}

    def walk(node: ast.AST, method: str, held: frozenset) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # different execution context
        if isinstance(node, ast.With):
            acquired = frozenset(
                lock for lock, _ in _with_lock_attrs(node, info, mod_locks))
            for item in node.items:
                walk(item.context_expr, method, held)
            for stmt in node.body:
                walk(stmt, method, held | acquired)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                base = t
                if isinstance(base, ast.Subscript):
                    base = base.value
                d = dotted_name(base)
                if d is not None and len(d) == 2 and d[0] == "self" \
                        and d[1] not in info.locks:
                    writes.setdefault(d[1], {}).setdefault(
                        method, []).append((node.lineno, held))
        for child in ast.iter_child_nodes(node):
            walk(child, method, held)

    for name, meth in info.methods.items():
        if name == "__init__":
            continue
        for stmt in meth.body:
            walk(stmt, name, frozenset())
    return writes


def analyze_conc(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    classes: dict[str, ClassInfo] = {}       # by class NAME (repo-unique)
    per_src: list[tuple[SourceFile, list[ClassInfo], dict]] = []

    for src in sources:
        mod_locks = _module_locks(src)
        infos = [_collect_class(src, n) for n in src.tree.body
                 if isinstance(n, ast.ClassDef)]
        for info in infos:
            classes.setdefault(info.name, info)
        per_src.append((src, infos, mod_locks))

    # module-level instance vars + trivial factory returns, for resolving
    # `_reg.counter(...)`-style calls to a class
    mod_instances: dict[tuple[str, str], str] = {}   # (module, var) -> class
    for src, infos, _ in per_src:
        for node in src.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                ctor = dotted_name(node.value.func)
                if ctor and ctor[-1] in classes:
                    mod_instances[(src.rel, node.targets[0].id)] = ctor[-1]

    edges: dict = {}
    call_sites: list = []

    for src, infos, mod_locks in per_src:
        for info in infos:
            if not info.locks:
                continue
            # CONC001 -------------------------------------------------
            writes = _method_writes(info, mod_locks)
            for attr, by_method in sorted(writes.items()):
                if len(by_method) < 2:
                    continue
                all_held = [held for sites in by_method.values()
                            for _, held in sites]
                common = frozenset.intersection(*all_held)
                if common:
                    continue   # one lock serializes every write
                methods = ", ".join(sorted(by_method))
                bare = {m: min(ln for ln, held in sites if not held)
                        for m, sites in by_method.items()
                        if any(not held for _, held in sites)}
                if bare:
                    for m, line in sorted(bare.items()):
                        findings.append(Finding(
                            "CONC001", src.rel, line,
                            f"{info.name}.{attr} is written from "
                            f"multiple methods ({methods}) but {m}() "
                            "writes it without holding any lock"))
                else:
                    # every write holds SOME lock, but no single lock
                    # covers them all -- zero mutual exclusion
                    line = min(ln for sites in by_method.values()
                               for ln, _ in sites)
                    locks = sorted({_fmt_lock(lk) for held in all_held
                                    for lk in held})
                    findings.append(Finding(
                        "CONC001", src.rel, line,
                        f"{info.name}.{attr} is written under DIFFERENT "
                        f"locks across methods ({methods}: "
                        f"{', '.join(locks)}) -- no common lock "
                        "serializes the writes"))
            # CONC002 + order-graph collection ------------------------
            for meth in info.methods.values():
                walker = _LockWalker(src, info, mod_locks, findings,
                                     edges, call_sites)
                for stmt in meth.body:
                    walker.visit(stmt)
        # module-level functions (module locks only)
        for node in src.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walker = _LockWalker(src, None, mod_locks, findings,
                                     edges, call_sites)
                for stmt in node.body:
                    walker.visit(stmt)

    _resolve_call_edges(call_sites, classes, mod_instances, edges)
    findings.extend(_order_cycles(edges))
    return findings


def _scoped_walk(fn: ast.AST):
    """ast.walk that does NOT descend into nested defs/lambdas: code in
    a closure runs in another execution context (often another thread),
    so its lock acquisitions are not part of the enclosing call."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _locks_acquired_by(classes: dict[str, ClassInfo]
                       ) -> dict[tuple[str, str], set]:
    """Fixpoint: (class, method) -> lock nodes it may acquire inline
    (nested defs excluded -- see _scoped_walk), including through
    same-class and typed-attribute method calls."""
    direct: dict[tuple[str, str], set] = {}
    calls: dict[tuple[str, str], set[tuple[str, str]]] = {}
    for info in classes.values():
        for mname, meth in info.methods.items():
            key = (info.name, mname)
            acquired: set = set()
            callees: set[tuple[str, str]] = set()
            for node in _scoped_walk(meth):
                if isinstance(node, ast.With):
                    for lock, _ in _with_lock_attrs(node, info, {}):
                        acquired.add(lock)
                elif isinstance(node, ast.Call):
                    d = dotted_name(node.func)
                    if d is None:
                        continue
                    if len(d) == 2 and d[0] == "self" \
                            and d[1] in info.methods:
                        callees.add((info.name, d[1]))
                    elif len(d) == 3 and d[0] == "self":
                        cls = info.attr_types.get(d[1])
                        if cls in classes and d[2] in classes[cls].methods:
                            callees.add((cls, d[2]))
            direct[key] = acquired
            calls[key] = callees
    changed = True
    while changed:
        changed = False
        for key, callees in calls.items():
            for callee in callees:
                extra = direct.get(callee, set()) - direct[key]
                if extra:
                    direct[key] |= extra
                    changed = True
    return direct


def _resolve_call_edges(call_sites, classes, mod_instances, edges) -> None:
    acquires = _locks_acquired_by(classes)
    for held, call, rel, lineno in call_sites:
        d = dotted_name(call.func)
        if d is None:
            continue
        target: tuple[str, str] | None = None
        if len(d) == 2 and d[0] == "self":
            owner = held[1]
            if owner and owner in classes and d[1] in classes[owner].methods:
                target = (owner, d[1])
        elif len(d) == 3 and d[0] == "self":
            owner = held[1]
            if owner and owner in classes:
                cls = classes[owner].attr_types.get(d[1])
                if cls in classes and d[2] in classes[cls].methods:
                    target = (cls, d[2])
        elif len(d) == 2:
            cls = mod_instances.get((rel, d[0]))
            if cls in classes and d[1] in classes[cls].methods:
                target = (cls, d[1])
        if target is None:
            continue
        for lock in acquires.get(target, ()):
            if lock != held:
                edges.setdefault(held, {}).setdefault(lock, (rel, lineno))


def _order_cycles(edges: dict) -> list[Finding]:
    """DFS cycle detection over the lock-order graph; one finding per
    distinct cycle."""
    findings: list[Finding] = []
    seen_cycles: set[frozenset] = set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict = {}
    stack: list = []

    def dfs(node) -> None:
        color[node] = GRAY
        stack.append(node)
        for nxt, site in edges.get(node, {}).items():
            c = color.get(nxt, WHITE)
            if c == GRAY:
                cycle = stack[stack.index(nxt):] + [nxt]
                key = frozenset(cycle)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    chain = " -> ".join(_fmt_lock(x) for x in cycle)
                    findings.append(Finding(
                        "CONC003", site[0], site[1],
                        f"lock-order cycle: {chain}"))
            elif c == WHITE:
                dfs(nxt)
        stack.pop()
        color[node] = BLACK

    for node in list(edges):
        if color.get(node, WHITE) == WHITE:
            dfs(node)
    return findings
