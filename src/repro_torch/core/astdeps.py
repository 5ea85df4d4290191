"""AST dependency analysis (paper §II-D) and cell-parameter extraction (§II-C).

``Load`` nodes name the objects a cell reads; resolving them against the
*live* namespace and recursively walking function globals/closures/defaults
builds the dependency closure — run-time analysis, so untaken branches cost
nothing and dynamically-built containers are captured by construction (their
contents serialize with the named object).

``Call`` keyword arguments with constant values (e.g. ``model.fit(epochs=10)``)
feed the Knowledge Base ("Notebook to Knowledge Base" service, PROV-lite).
"""
from __future__ import annotations

import ast
import builtins
import inspect
import types
from dataclasses import dataclass, field
from typing import Any


@dataclass
class CellAnalysis:
    loads: set[str] = field(default_factory=set)
    stores: set[str] = field(default_factory=set)
    call_kwargs: dict[str, dict[str, Any]] = field(default_factory=dict)
    imports: set[str] = field(default_factory=set)


def _dotted(node: ast.AST) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self):
        self.out = CellAnalysis()

    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Load):
            self.out.loads.add(node.id)
        elif isinstance(node.ctx, (ast.Store, ast.Del)):
            self.out.stores.add(node.id)
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self.out.imports.add(a.name.split(".")[0])
            self.out.stores.add((a.asname or a.name).split(".")[0])

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module:
            self.out.imports.add(node.module.split(".")[0])
        for a in node.names:
            self.out.stores.add(a.asname or a.name)

    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func)
        if name:
            kwargs = {}
            for kw in node.keywords:
                if kw.arg is not None and isinstance(kw.value, ast.Constant):
                    kwargs[kw.arg] = kw.value.value
            if kwargs:
                self.out.call_kwargs.setdefault(name, {}).update(kwargs)
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self.out.stores.add(node.name)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef):
        self.out.stores.add(node.name)
        self.generic_visit(node)


def analyze_cell(source: str) -> CellAnalysis:
    tree = ast.parse(source)
    v = _Visitor()
    v.visit(tree)
    # names assigned before use inside this cell are not external deps,
    # but a name can be both (x = x + 1) — keep it as a load then.
    return v.out


_BUILTIN_NAMES = set(dir(builtins))


def _function_refs(fn) -> set[str]:
    """Global names a function (or its nested code objects) references."""
    names: set[str] = set()
    codes = [fn.__code__]
    while codes:
        code = codes.pop()
        names.update(code.co_names)
        for const in code.co_consts:
            if isinstance(const, types.CodeType):
                codes.append(const)
    return names


def dependency_closure(roots: set[str], ns: dict[str, Any]) -> tuple[set[str], set[str]]:
    """Expand root Load-names into the full set of namespace names (and module
    names) the execution depends on (paper: recursive inspection of variable
    definitions, functions, and loaded modules)."""
    needed: set[str] = set()
    modules: set[str] = set()
    work = [r for r in roots if r in ns]
    seen_objs: set[int] = set()

    while work:
        name = work.pop()
        if name in needed:
            continue
        needed.add(name)
        obj = ns[name]
        if id(obj) in seen_objs:
            continue
        seen_objs.add(id(obj))

        if isinstance(obj, types.ModuleType):
            # modules are re-imported on the remote side, never serialized
            modules.add(obj.__name__.split(".")[0])
            continue

        fns = []
        if isinstance(obj, types.FunctionType):
            fns.append(obj)
        elif inspect.isclass(obj):
            fns.extend(f for f in vars(obj).values()
                       if isinstance(f, types.FunctionType))
        elif not isinstance(obj, (int, float, str, bytes, bool, type(None))):
            # instances: walk methods defined on their class
            fns.extend(f for f in vars(type(obj)).values()
                       if isinstance(f, types.FunctionType)
                       and type(obj).__module__ == "__main__")

        for fn in fns:
            for ref in _function_refs(fn):
                if ref in _BUILTIN_NAMES:
                    continue
                if ref in ns and ref not in needed:
                    work.append(ref)
            # closure cells
            if fn.__closure__:
                for cell in fn.__closure__:
                    try:
                        val = cell.cell_contents
                    except ValueError:
                        continue
                    for k, v in ns.items():
                        if v is val and k not in needed:
                            work.append(k)
            # referenced modules
            g = fn.__globals__
            for ref in _function_refs(fn):
                v = g.get(ref)
                if isinstance(v, types.ModuleType):
                    modules.add(v.__name__.split(".")[0])
    return needed, modules


def cell_dependencies(source: str, ns: dict[str, Any]) -> tuple[set[str], set[str], CellAnalysis]:
    """Names (and modules) this cell's execution needs from the namespace."""
    info = analyze_cell(source)
    roots = {n for n in info.loads if n in ns and n not in _BUILTIN_NAMES}
    needed, modules = dependency_closure(roots, ns)
    modules |= info.imports
    needed = {n for n in needed
              if not isinstance(ns.get(n), types.ModuleType)}
    return needed, modules, info


# ----------------------------------------------------------------------
# live-variable analysis over the remaining notebook cells
# ----------------------------------------------------------------------
#
# Classic backward dataflow at cell granularity: live_in = uses ∪
# (live_out − kills).  A name live at the migration point must travel;
# anything else is *provably dead* — no remaining cell can read it before
# (re)defining it — and may be pruned from trickle and migration without
# changing what the remaining cells compute.
#
# Safety is one-sided: ``uses`` over-approximates (every Load anywhere in
# the cell, plus augmented-assignment and ``del`` targets, which need the
# name bound), ``kills`` under-approximates (only *unconditional top-level
# simple-name* bindings end liveness — an assignment inside an ``if`` or a
# loop may never run).  Dynamic constructs that can read arbitrary names
# (``exec``/``eval``, ``globals()``/``locals()``/``vars()``, star-imports)
# or an unparseable cell force the conservative answer: everything lives.

_DYNAMIC_NAMES = frozenset({"exec", "eval", "globals", "locals", "vars",
                            "__import__"})


@dataclass
class LivenessResult:
    """Outcome of :func:`live_roots` over the remaining cells."""
    live: set[str]          # root names live at entry (uses before kills)
    conservative: bool      # True: analysis gave up — treat everything live
    reason: str = ""


class _DefUseVisitor(ast.NodeVisitor):
    """Per-cell gen/kill sets with scope-aware uses.

    ``uses``: names read from the enclosing namespace.  Comprehension
    targets, lambda/function parameters and function-local bindings are
    tracked per scope so a comprehension-local ``i`` does not keep an outer
    ``i`` alive; names declared ``global``/``nonlocal`` stay visible as
    uses/outer bindings.
    """

    def __init__(self):
        self.uses: set[str] = set()
        self.kills: set[str] = set()
        self.dynamic: str | None = None       # reason, when analysis gave up
        self._scopes: list[set[str]] = []     # per-inner-scope local names
        self._declared: list[set[str]] = []   # global/nonlocal per scope

    # -- helpers --------------------------------------------------------
    def _bound_locally(self, name: str) -> bool:
        return any(name in s for s in self._scopes)

    def _use(self, name: str) -> None:
        if not self._bound_locally(name):
            self.uses.add(name)

    def _target_names(self, node: ast.AST) -> list[str]:
        """Simple Name targets of an assignment target tree."""
        if isinstance(node, ast.Name):
            return [node.id]
        if isinstance(node, (ast.Tuple, ast.List)):
            out = []
            for elt in node.elts:
                out.extend(self._target_names(elt))
            return out
        if isinstance(node, ast.Starred):
            return self._target_names(node.value)
        return []

    # -- uses -----------------------------------------------------------
    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Load):
            if node.id in _DYNAMIC_NAMES:
                self.dynamic = f"dynamic construct {node.id!r}"
            self._use(node.id)
        elif isinstance(node.ctx, ast.Del):
            # ``del x`` needs x bound, then unbinds it: a use AND a kill
            # (the kill lands only for top-level Delete statements, below)
            self._use(node.id)
        elif isinstance(node.ctx, ast.Store) and self._scopes:
            if node.id not in self._declared[-1]:
                self._scopes[-1].add(node.id)

    def visit_AugAssign(self, node: ast.AugAssign):
        # ``x += 1``: the target's ctx is Store, but the old value is read
        for name in self._target_names(node.target):
            self._use(name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if any(a.name == "*" for a in node.names):
            self.dynamic = f"star-import from {node.module!r}"

    def visit_Global(self, node: ast.Global):
        # declared names resolve in the enclosing namespace even inside a
        # function scope: later Stores must not shadow them as locals
        if self._declared:
            self._declared[-1].update(node.names)
        for scope in self._scopes:
            scope.difference_update(node.names)

    visit_Nonlocal = visit_Global

    # -- inner scopes ----------------------------------------------------
    def _visit_scoped(self, bound: set[str], children) -> None:
        self._scopes.append(set(bound))
        self._declared.append(set())
        for child in children:
            self.visit(child)
        self._scopes.pop()
        self._declared.pop()

    def _visit_function(self, node) -> None:
        args = node.args
        params = {a.arg for a in (args.posonlyargs + args.args
                                  + args.kwonlyargs)}
        if args.vararg:
            params.add(args.vararg.arg)
        if args.kwarg:
            params.add(args.kwarg.arg)
        # defaults/annotations/decorators evaluate in the enclosing scope
        for d in list(args.defaults) + [d for d in args.kw_defaults if d]:
            self.visit(d)
        for dec in getattr(node, "decorator_list", []):
            self.visit(dec)
        body = getattr(node, "body", [])
        self._visit_scoped(params, body if isinstance(body, list) else [body])

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._visit_function(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda):
        self._visit_function(node)

    def _visit_comprehension(self, node) -> None:
        # iterables are visited in the ENCLOSING scope: the first one
        # genuinely evaluates there (``[x for x in x]`` reads the outer
        # ``x``), and treating the nested ones the same way only grows
        # ``uses`` — the safe direction.  Only the element expressions and
        # the filter conditions see the comprehension-local targets.
        for gen in node.generators:
            self.visit(gen.iter)
        bound: set[str] = set()
        for gen in node.generators:
            bound.update(self._target_names(gen.target))
        if isinstance(node, ast.DictComp):
            elts = [node.key, node.value]
        else:
            elts = [node.elt]
        self._visit_scoped(
            bound, elts + [c for g in node.generators for c in g.ifs])

    visit_ListComp = _visit_comprehension
    visit_SetComp = _visit_comprehension
    visit_GeneratorExp = _visit_comprehension
    visit_DictComp = _visit_comprehension


def cell_def_use(source: str) -> tuple[set[str], set[str], str | None]:
    """Per-cell (uses, kills, dynamic_reason).  ``kills`` holds only the
    *certain* top-level bindings; ``dynamic_reason`` is non-None when the
    cell defeats static analysis and everything must be treated live."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return set(), set(), f"unparseable cell: {e.msg}"
    v = _DefUseVisitor()
    v.visit(tree)
    kills: set[str] = set()
    for stmt in tree.body:                 # top-level, unconditional only
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                kills.update(v._target_names(t) if not isinstance(
                    t, (ast.Attribute, ast.Subscript)) else ())
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and isinstance(stmt.target, ast.Name):
            kills.add(stmt.target.id)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            kills.add(stmt.name)
        elif isinstance(stmt, ast.Import):
            kills.update((a.asname or a.name).split(".")[0]
                         for a in stmt.names)
        elif isinstance(stmt, ast.ImportFrom):
            if not any(a.name == "*" for a in stmt.names):
                kills.update(a.asname or a.name for a in stmt.names)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    kills.add(t.id)
    return v.uses, kills, v.dynamic


def live_roots(remaining_sources) -> LivenessResult:
    """Backward dataflow over the remaining cells (in execution order):
    the returned ``live`` set is every name some remaining cell may read
    before rebinding it.  Any dynamic construct in any remaining cell
    forces the conservative result (``conservative=True``)."""
    live: set[str] = set()
    for src in reversed(list(remaining_sources)):
        uses, kills, dynamic = cell_def_use(src)
        if dynamic is not None:
            return LivenessResult(set(), True, dynamic)
        live = uses | (live - kills)
    return LivenessResult(live, False)


def live_names(remaining_sources, ns: dict[str, Any]) -> set[str] | None:
    """Namespace names the remaining cells can reach: the live roots plus
    their dependency closure (a live function pins the globals it reads).
    Returns ``None`` when the analysis is conservative — callers must then
    treat every name as live."""
    result = live_roots(remaining_sources)
    if result.conservative:
        return None
    roots = {n for n in result.live if n in ns and n not in _BUILTIN_NAMES}
    needed, _modules = dependency_closure(roots, ns)
    return needed
