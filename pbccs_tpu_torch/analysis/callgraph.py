"""Project-wide call graph for the interprocedural passes.

The flat passes look at one function (or one class) at a time, so an
invariant enforced *across* functions -- "this helper releases the
lease my caller acquired", "that method only runs under the router
lock" -- is invisible to them.  This module builds the whole-program
view the dataflow passes (exsafe, leases, protolint) share:

  * every class in the repository with its methods, base classes (by
    name -- class names are repo-unique by convention, enforced
    nowhere but broken nowhere either), and `self.x = ClassName(...)`
    attribute types;
  * every module-level function;
  * conservative call resolution: a call resolves only when the AST
    names its target unambiguously (`self.m()`, `self.attr.m()` through
    a typed attribute, `ClassName.m()`, a same-module function, or a
    module-level instance variable).  Unresolved calls contribute
    nothing -- a finding built on this graph is strong evidence,
    silence is not proof (the conc.py philosophy);
  * a transitive *effect closure*: for each function, the set of
    callee names (last dotted segment) it can reach through resolved
    calls.  "Does `_on_submit` transitively call `send`?" and "does
    this helper transitively call `release`?" are the queries the
    lease-release and protocol passes are built on.

Nested functions and lambdas are deliberately NOT graph nodes: they run
in another context (often another thread -- they are the callbacks).
The passes inspect them in place via `node_call_names` /
`closure_calls`.
"""

from __future__ import annotations

import ast
import dataclasses

from pbccs_tpu_torch.analysis.core import SourceFile, dotted_name


@dataclasses.dataclass
class FuncInfo:
    """One module-level function or method."""

    module: str                 # repo-relative path
    cls: str | None             # owning class name (None for module funcs)
    name: str
    node: ast.FunctionDef | ast.AsyncFunctionDef

    @property
    def key(self) -> tuple[str, str]:
        qual = f"{self.cls}.{self.name}" if self.cls else self.name
        return (self.module, qual)


@dataclasses.dataclass
class ClassDecl:
    """One class: methods, base names, and typed attributes."""

    module: str
    name: str
    node: ast.ClassDef
    bases: tuple[str, ...]
    methods: dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    # self.<attr> -> class name, from `self.attr = ClassName(...)`
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)


def scoped_walk(node: ast.AST):
    """ast.walk that does not descend into nested defs/lambdas (they run
    in another execution context; the callback passes inspect them
    separately)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def node_call_names(node: ast.AST, scoped: bool = True) -> set[str]:
    """Last dotted segment of every call inside `node` (`self.a.b()` ->
    "b").  With scoped (default) nested defs/lambdas are skipped; pass
    scoped=False to look inside them too (closure inspection)."""
    walker = scoped_walk(node) if scoped else ast.walk(node)
    out: set[str] = set()
    for n in walker:
        if isinstance(n, ast.Call):
            d = dotted_name(n.func)
            if d is not None:
                out.add(d[-1])
    return out


class CallGraph:
    """Classes + functions + resolved edges + transitive effect sets."""

    def __init__(self) -> None:
        self.classes: dict[str, ClassDecl] = {}
        self.funcs: dict[tuple[str, str], FuncInfo] = {}
        # module-level functions by (module, name)
        self.module_funcs: dict[tuple[str, str], FuncInfo] = {}
        # (module, var) -> class name, for module-level instances
        self.mod_instances: dict[tuple[str, str], str] = {}
        self._reaches: dict[tuple[str, str], frozenset[str]] | None = None

    # ------------------------------------------------------------ lookup

    def method(self, cls_name: str, meth: str,
               _seen: frozenset = frozenset()) -> FuncInfo | None:
        """Resolve a method through the base-class chain (by name)."""
        decl = self.classes.get(cls_name)
        if decl is None or cls_name in _seen:
            return None
        if meth in decl.methods:
            return decl.methods[meth]
        seen = _seen | {cls_name}
        for base in decl.bases:
            hit = self.method(base, meth, seen)
            if hit is not None:
                return hit
        return None

    def attr_type(self, cls_name: str, attr: str,
                  _seen: frozenset = frozenset()) -> str | None:
        """The declared type of self.<attr>, searching base classes."""
        decl = self.classes.get(cls_name)
        if decl is None or cls_name in _seen:
            return None
        if attr in decl.attr_types:
            return decl.attr_types[attr]
        seen = _seen | {cls_name}
        for base in decl.bases:
            hit = self.attr_type(base, attr, seen)
            if hit is not None:
                return hit
        return None

    def resolve(self, call: ast.Call, module: str,
                cls: str | None) -> FuncInfo | None:
        """Resolve one call site to a FuncInfo, or None when the target
        is not unambiguous from the AST."""
        d = dotted_name(call.func)
        if d is None:
            return None
        if len(d) == 1:
            return self.module_funcs.get((module, d[0]))
        if len(d) == 2:
            recv, meth = d
            if recv in ("self", "cls") and cls is not None:
                return self.method(cls, meth)
            if recv in self.classes:
                return self.method(recv, meth)
            inst = self.mod_instances.get((module, recv))
            if inst is not None:
                return self.method(inst, meth)
            return None
        if len(d) == 3 and d[0] == "self" and cls is not None:
            typed = self.attr_type(cls, d[1])
            if typed is not None:
                return self.method(typed, d[2])
        return None

    # ------------------------------------------------------------ effects

    def reaches(self, info: FuncInfo) -> frozenset[str]:
        """Every callee name (last dotted segment) `info` can reach
        through resolved calls, transitively.  Includes its own direct
        call names, so `"send" in graph.reaches(f)` answers "may f
        (transitively) call something named send?"."""
        if self._reaches is None:
            self._compute_reaches()
        return self._reaches.get(info.key, frozenset())

    def _compute_reaches(self) -> None:
        direct: dict[tuple[str, str], set[str]] = {}
        edges: dict[tuple[str, str], set[tuple[str, str]]] = {}
        for info in self.funcs.values():
            names: set[str] = set()
            callees: set[tuple[str, str]] = set()
            for n in scoped_walk(info.node):
                if not isinstance(n, ast.Call):
                    continue
                d = dotted_name(n.func)
                if d is not None:
                    names.add(d[-1])
                target = self.resolve(n, info.module, info.cls)
                if target is not None:
                    callees.add(target.key)
            direct[info.key] = names
            edges[info.key] = callees
        changed = True
        while changed:
            changed = False
            for key, callees in edges.items():
                mine = direct[key]
                for callee in callees:
                    extra = direct.get(callee, set()) - mine
                    if extra:
                        mine |= extra
                        changed = True
        self._reaches = {k: frozenset(v) for k, v in direct.items()}


def build_graph(sources: list[SourceFile]) -> CallGraph:
    g = CallGraph()
    for src in sources:
        for node in src.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = FuncInfo(src.rel, None, node.name, node)
                g.module_funcs[(src.rel, node.name)] = info
                g.funcs[info.key] = info
            elif isinstance(node, ast.ClassDef):
                bases = tuple(b for b in
                              ((dotted_name(base) or ("",))[-1]
                               for base in node.bases) if b)
                decl = ClassDecl(src.rel, node.name, node, bases)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        info = FuncInfo(src.rel, node.name, item.name, item)
                        decl.methods[item.name] = info
                        g.funcs[info.key] = info
                # first declaration wins (class names are repo-unique
                # by convention; a duplicate resolves to the first)
                g.classes.setdefault(node.name, decl)
    # typed attributes + module instances need the class table complete
    for decl in g.classes.values():
        for meth in decl.methods.values():
            for stmt in ast.walk(meth.node):
                if not isinstance(stmt, ast.Assign) \
                        or len(stmt.targets) != 1 \
                        or not isinstance(stmt.value, ast.Call):
                    continue
                t = dotted_name(stmt.targets[0])
                ctor = dotted_name(stmt.value.func)
                if (t is not None and len(t) == 2 and t[0] == "self"
                        and ctor is not None and ctor[-1] in g.classes):
                    decl.attr_types.setdefault(t[1], ctor[-1])
    for src in sources:
        for node in src.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                ctor = dotted_name(node.value.func)
                if ctor is not None and ctor[-1] in g.classes:
                    g.mod_instances[(src.rel, node.targets[0].id)] = ctor[-1]
    return g
