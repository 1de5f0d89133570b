"""torchlint static rules: the port's failure classes as AST checks (the
port's counterpart of cocoa_tpu/analysis/rules.py).

JAX's rules find jit and lax bodies; the port has none.  Its counterpart
of traced code is **captured code**: what runs inside a CUDA graph that
the drive loops capture once and replay (solvers/base.py ``ChunkRunner``,
``DeviceLoopRunner``, ``FleetRunner``), where a host read either breaks
the capture or, run eagerly on the CPU, syncs once a chunk.
:class:`ModuleIndex` seeds it with

- the callables handed to the runners and drive loops (``ChunkRunner``,
  ``DeviceLoopRunner``, ``FleetRunner``, ``drive``, ``drive_device``,
  ``drive_fleet_on_device``, ``per_round`` and a ``Schedule``'s
  ``jump``), resolved through names, lambdas and ``functools.partial``;
- a solver's ``round_fn``, the :func:`~cocoa_torch.solvers.base.
  per_round` protocol, which reaches the body through lists of branches
  that no name resolution follows;
- every kernel wrapper: a def registered with ``kernels.count_launches``
  or one that reaches ``kernels.load``;

and closes it over the module's own defs: everything nested in a
captured def, and every def of the module a captured def calls by name.
A static pass follows no call into another module; the transfer guard
(sanitize.py) is the backstop there.

Rules (ids are what ``torchlint: allow=<rule>`` and the baseline key on):

- ``scatter-order`` (JAX's ``donation``; torch has no donation) —
  ``scatter_add_``, ``index_add_``, ``index_put_(..., accumulate=True)``
  and ``put_(..., accumulate=True)`` in ``ops/`` and ``solvers/``.  On
  CUDA their sum order follows the atomics wherever an index repeats, so
  two runs differ in the last bits (the C4 and C5 faults).  The fix shapes
  are C5's ``_block_alpha_add`` (ops/local_sdca.py: scatter only where an
  index is a row's last draw) and B6's ordered fold (ops/rows.py
  ``_scatter_add``: a sorted ``index_put`` on the card).  A site that is
  safe because its indices are distinct carries a justified allow.
- ``host-sync`` — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``float()``/``int()``/``bool()`` of a tensor, ``if``/``while`` on a
  tensor and ``torch.cuda.synchronize()`` inside captured code.  Reads
  inside ``with intended_fetch(...)`` and through ``host_fetch(...)``
  are the sanctioned ones and are not flagged.
- ``f64`` — literal ``torch.float64``, ``np.float64``, ``"float64"`` and
  ``.double()`` outside ``evals/`` (the certificate math).  The port's
  float64 paths and host-side loaders are baselined with a reason.
- ``kernel-budget`` (the AST half; kernel_budget.py holds the numeric
  one) — a module that calls ``kernels.load`` registers its wrapper with
  ``kernels.count_launches``; one whose kernel takes dynamic shared
  memory (its ``csrc/<name>.cu`` declares ``extern __shared__``) declares
  a ``*_plan`` and feeds a plan ``kernels.smem_optin``; and every plan is
  consulted outside its own module (a gate nobody calls protects
  nothing).
- ``span-hygiene`` — a ``tracing.span`` / ``@traced`` inside captured
  code (it times the capture once, not the replays), and a span
  attribute that reads a device tensor (a sync at emit).
- ``overlap-hygiene`` — ``async_host_allgather_bytes`` /
  ``async_kv_get`` launched inside captured code, or a handle that is
  never ``.join()``ed and never escapes its scope.
- ``fleet-hygiene`` — a Python loop over tenants inside captured code
  (the graph holds T unrolled copies), or a per-tenant device read
  inside a host tenant loop.
- ``serve-hygiene`` — in ``serving/`` hot paths (every def but the
  builders): an allocation sized by ``len(...)`` (one shape a request),
  a device read outside ``host_fetch``/``intended_fetch``, a clock read
  inside captured code, and quantization (a narrowing cast or a
  max-of-abs scale) outside the swap-time quantizer.

JAX's ``mesh-api`` inventory (the jax-0.4.37 API debt) has no torch
counterpart and no rule here.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Optional

from cocoa_torch.analysis.core import Finding, SourceFile, \
    unexplained_allows

# --- shared AST infrastructure ---------------------------------------------

# callees whose arguments at these positions (and keywords of these
# names) run inside a captured CUDA graph
_RUNNER_ARGS = {
    "ChunkRunner": (0,), "DeviceLoopRunner": (0, 1), "FleetRunner": (0, 1),
    "drive": (4, 5), "drive_device": (4, 5),
    "drive_fleet_on_device": (2, 3), "per_round": (0,), "Schedule": (),
}
_RUNNER_KWARGS = {"body", "metrics", "step_fn", "eval_fn", "round_fn",
                  "jump"}
# the per_round protocol's round function, which the solvers hand to the
# body through lists of branches
_BODY_NAMES = {"round_fn"}

# the sanctioned reads: a ``with intended_fetch(...)`` block, and the
# argument of ``host_fetch(...)``
_FETCH_CONTEXTS = {"intended_fetch", "allow_transfers"}
_FETCH_CALLEES = {"host_fetch"}

_NP_MODULES = {"np", "numpy", "onp"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "itemsize", "is_cuda",
                 "layout", "requires_grad"}
# tensor methods that return tensors (a value built from a tensor)
_TENSOR_METHODS = {
    "sum", "max", "min", "amax", "amin", "mean", "norm", "abs", "any",
    "all", "clamp", "where", "to", "float", "double", "long", "int",
    "view", "reshape", "clone", "sqrt", "exp", "log", "dot", "matmul",
    "logical_not", "logical_or", "logical_and", "gather", "index_select",
    "argmax", "argmin", "count_nonzero", "isnan", "isfinite", "squeeze",
    "unsqueeze", "flatten", "contiguous", "detach", "prod", "cumsum"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# the runners' iterate parameters: tuples of device tensors
_ITERATE_NAMES = {"state", "iterate"}


def _attr_chain(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for nested Attribute/Name chains."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _callee_tail(call: ast.Call) -> str:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    chain = _attr_chain(call.func)
    return chain.rsplit(".", 1)[-1] if chain else ""


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _params(fn) -> list:
    a = fn.args
    return [arg.arg for arg in (a.posonlyargs + a.args + a.kwonlyargs
                                + ([a.vararg] if a.vararg else [])
                                + ([a.kwarg] if a.kwarg else []))]


def _body(node) -> list:
    body = getattr(node, "body", None)
    return body if isinstance(body, list) else [body] if body else []


def _build_parents(tree) -> dict:
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _nearest_def(node, parents) -> Optional[ast.AST]:
    p = parents.get(node)
    while p is not None and not isinstance(
            p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        p = parents.get(p)
    return p


def _own_nodes(d, parents):
    """The nodes of def ``d``'s body that belong to ``d`` itself (nested
    defs are visited as themselves)."""
    for stmt in _body(d):
        for node in ast.walk(stmt):
            if _nearest_def(node, parents) is d:
                yield node


def _in_fetch(node, parents) -> bool:
    """Whether ``node`` sits in a sanctioned read: inside a ``with
    intended_fetch(...)`` (or ``allow_transfers()``) block or in the
    argument of a ``host_fetch(...)`` call."""
    p = parents.get(node)
    while p is not None:
        if isinstance(p, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and _callee_tail(it.context_expr) in _FETCH_CONTEXTS
                for it in p.items):
            return True
        if isinstance(p, ast.Call) and _callee_tail(p) in _FETCH_CALLEES:
            return True
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            return False
        p = parents.get(p)
    return False


def _mentions(expr: ast.AST, names: set) -> bool:
    """Whether ``expr`` reads a value of ``names`` (metadata attributes
    like ``x.shape`` do not count)."""
    def walk(node):
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return False
        if isinstance(node, ast.Name) and node.id in names:
            return True
        return any(walk(c) for c in ast.iter_child_nodes(node))

    return walk(expr)


def _tensorish(expr: ast.AST, tensors: set, params: set) -> bool:
    """Whether ``expr`` is (statically, conservatively) a tensor value: a
    ``torch.*`` call, a tensor method of a value that mentions a tensor or
    parameter, an element of a parameter or tensor, or a local name bound
    to one of those; comparisons and boolean ops of such values too."""
    names = tensors | params
    if isinstance(expr, ast.Name):
        return expr.id in tensors
    if isinstance(expr, ast.Call):
        chain = _attr_chain(expr.func) or ""
        if chain.startswith("torch.") and not chain.startswith(
                ("torch.cuda", "torch.device", "torch.Size")):
            return True
        return (isinstance(expr.func, ast.Attribute)
                and expr.func.attr in _TENSOR_METHODS
                and _mentions(expr.func.value, names))
    if isinstance(expr, ast.Subscript):
        return _mentions(expr.value, names) and not (
            isinstance(expr.value, ast.Attribute)
            and expr.value.attr in _STATIC_ATTRS)
    if isinstance(expr, ast.Compare):
        return any(_tensorish(e, tensors, params)
                   for e in [expr.left, *expr.comparators])
    if isinstance(expr, ast.BoolOp):
        return any(_tensorish(e, tensors, params) for e in expr.values)
    if isinstance(expr, ast.UnaryOp):
        return _tensorish(expr.operand, tensors, params)
    if isinstance(expr, ast.BinOp):
        return _tensorish(expr.left, tensors, params) or _tensorish(
            expr.right, tensors, params)
    return False


def _local_tensors(d, parents, params: set) -> set:
    """Names a def binds to tensor values (:func:`_tensorish`), to a fixed
    point over its own assignments."""
    tensors: set = set()
    assigns = [n for n in _own_nodes(d, parents)
               if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))]
    changed = True
    while changed:
        changed = False
        for n in assigns:
            value = n.value
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            # a tensor, or the tensors of an iterate unpacked from the body
            # protocols' ``state``/``iterate`` (``w, alpha = state``)
            unpack = isinstance(value, (ast.Name, ast.Subscript)) and \
                _mentions(value, tensors | (params & _ITERATE_NAMES))
            for t in targets:
                if isinstance(t, ast.Name) and value is not None and \
                        _tensorish(value, tensors, params):
                    names = [t.id]
                elif isinstance(t, (ast.Tuple, ast.List)) and unpack:
                    names = [e.id for e in t.elts if isinstance(e, ast.Name)]
                else:
                    continue
                for name in names:
                    if name not in tensors:
                        tensors.add(name)
                        changed = True
    return tensors


class ModuleIndex(ast.NodeVisitor):
    """One pass over a module: def tables per scope, parent links, the
    captured seeds, the kernel loaders and the call edges by name."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.parent_def: dict = {}      # def node -> enclosing def | None
        self.defs: list = []            # every FunctionDef/Lambda
        self.scope_defs: dict = {}      # scope (def|Module) -> {name: def}
        self.seeds: set = set()         # def ids seeded captured
        self.loaders: set = set()       # def ids that call kernels.load
        self.calls: dict = {}           # def id -> {def ids it calls}
        self._scope_stack: list = []
        self._captured = None

    def index(self):
        self.scope_defs[self.src.tree] = {}
        self._scope_stack = [self.src.tree]
        self.visit(self.src.tree)
        return self

    def _resolve(self, name: str) -> Optional[ast.AST]:
        for scope in reversed(self._scope_stack):
            d = self.scope_defs.get(scope, {})
            if name in d:
                return d[name]
        return None

    def _resolve_fn_arg(self, node: ast.AST) -> Optional[ast.AST]:
        if isinstance(node, ast.Name):
            return self._resolve(node.id)
        if isinstance(node, ast.Lambda):
            return node
        if isinstance(node, ast.Call) and node.args and \
                _callee_tail(node) in ("partial", "per_round"):
            return self._resolve_fn_arg(node.args[0])
        return None

    def _current_def(self):
        for scope in reversed(self._scope_stack):
            if scope is not self.src.tree:
                return scope
        return None

    def visit_FunctionDef(self, node):
        self._handle_def(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._handle_def(node, None)

    def _handle_def(self, node, name):
        parent = self._scope_stack[-1]
        self.parent_def[node] = parent if parent is not self.src.tree else None
        self.defs.append(node)
        if name is not None:
            self.scope_defs.setdefault(parent, {})[name] = node
            if name in _BODY_NAMES:
                self.seeds.add(id(node))
        self.scope_defs.setdefault(node, {})
        self._scope_stack.append(node)
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self._scope_stack.pop()

    def visit_Call(self, node):
        tail = _callee_tail(node)
        chain = _attr_chain(node.func) or ""
        cur = self._current_def()
        if tail in _RUNNER_ARGS:
            args = [node.args[i] for i in _RUNNER_ARGS[tail]
                    if i < len(node.args)]
            args += [kw.value for kw in node.keywords
                     if kw.arg in _RUNNER_KWARGS]
            for a in args:
                t = self._resolve_fn_arg(a)
                if t is not None:
                    self.seeds.add(id(t))
        elif chain.endswith("count_launches") and node.args:
            t = self._resolve_fn_arg(node.args[0])
            if t is not None:
                self.seeds.add(id(t))
        elif chain in ("kernels.load", "load") and cur is not None:
            self.loaders.add(id(cur))
        if cur is not None and isinstance(node.func, ast.Name):
            t = self._resolve(node.func.id)
            if t is not None:
                self.calls.setdefault(id(cur), set()).add(id(t))
        self.generic_visit(node)

    def captured_defs(self) -> set:
        """ids of the defs whose bodies run in a captured graph: the
        seeds, the kernel wrappers (the loaders and their callers in the
        module), everything nested in a captured def, and every def a
        captured def calls by name."""
        if self._captured is not None:
            return self._captured
        captured = set(self.seeds)
        wrappers = set(self.loaders)
        changed = True
        while changed:
            changed = False
            for caller, callees in self.calls.items():
                if caller not in wrappers and callees & wrappers:
                    wrappers.add(caller)
                    changed = True
        captured |= wrappers
        changed = True
        while changed:
            changed = False
            for d in self.defs:
                if id(d) in captured:
                    for callee in self.calls.get(id(d), ()):
                        if callee not in captured:
                            captured.add(callee)
                            changed = True
                    continue
                p = self.parent_def.get(d)
                if p is not None and id(p) in captured:
                    captured.add(id(d))
                    changed = True
        self._captured = captured
        return captured


def _captured(index: ModuleIndex):
    ids = index.captured_defs()
    return [d for d in index.defs if id(d) in ids]


def _flagger(findings, rule, src):
    def flag(node, msg, severity="error"):
        findings.append(Finding(
            rule=rule, severity=severity, path=src.path, line=node.lineno,
            col=node.col_offset, message=msg))
    return flag


# --- rule: scatter-order ----------------------------------------------------

_SCATTER_PATH_RE = re.compile(r"(^|/)(ops|solvers)/")


def _scatter_kind(call: ast.Call) -> Optional[str]:
    """The order-unstable scatter ``call`` makes, else None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in ("scatter_add_", "scatter_add", "index_add_", "index_add"):
        return attr
    if attr in ("index_put_", "index_put"):
        acc = _kw(call, "accumulate")
        if acc is None and len(call.args) >= 3:
            acc = call.args[2]
        return f"{attr}(accumulate=True)" if _is_true(acc) else None
    if attr == "put_":
        acc = _kw(call, "accumulate")
        if acc is None and len(call.args) >= 3:
            acc = call.args[2]
        return "put_(accumulate=True)" if _is_true(acc) else None
    return None


def check_scatter_order(src: SourceFile, index: ModuleIndex) -> list:
    if not _SCATTER_PATH_RE.search(src.path):
        return []
    findings = []
    flag = _flagger(findings, "scatter-order", src)
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            kind = _scatter_kind(node)
            if kind is not None:
                flag(node,
                     f"`{kind}` sums in the order of CUDA atomics wherever "
                     f"an index repeats, so two runs differ in the last "
                     f"bits (the C4/C5 fault class); scatter only distinct "
                     f"indices (ops/local_sdca.py _block_alpha_add) or fold "
                     f"in a fixed order (ops/rows.py _scatter_add), or "
                     f"allow it with the reason its indices are distinct")
    return findings


# --- rule: host-sync --------------------------------------------------------


def check_host_sync(src: SourceFile, index: ModuleIndex) -> list:
    findings = []
    flag = _flagger(findings, "host-sync", src)
    parents = _build_parents(src.tree)
    for d in _captured(index):
        params = set(_params(d))
        tensors = _local_tensors(d, parents, params)
        for node in _own_nodes(d, parents):
            if isinstance(node, ast.Call):
                if _in_fetch(node, parents):
                    continue
                chain = _attr_chain(node.func) or ""
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _SYNC_METHODS:
                    flag(node,
                         f"`.{node.func.attr}()` inside captured code reads "
                         f"the device once a replay (or breaks the capture) "
                         f"— keep it on the device, or fetch once at the "
                         f"host boundary under intended_fetch")
                elif chain.endswith("cuda.synchronize"):
                    flag(node,
                         "`torch.cuda.synchronize()` inside captured code "
                         "waits for the device inside the graph's body — "
                         "sync at the host boundary")
                elif isinstance(node.func, ast.Name) and \
                        node.func.id in ("float", "int", "bool") and \
                        node.args and _tensorish(node.args[0], tensors,
                                                 params):
                    flag(node,
                         f"`{node.func.id}()` of a tensor inside captured "
                         f"code reads the device — keep it a tensor "
                         f"(torch.where), or fetch once after the chunk")
            elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
                if not _in_fetch(node, parents) and \
                        _tensorish(node.test, tensors, params):
                    kw = {ast.If: "if", ast.While: "while",
                          ast.IfExp: "if"}[type(node)]
                    flag(node,
                         f"`{kw}` on a tensor inside captured code is an "
                         f"implicit bool() read of the device — use "
                         f"torch.where")
    return findings


# --- rule: f64 --------------------------------------------------------------

# float64 belongs to the certificate math (evals/) and, in the port, to
# the float64 runs that the parity tests pin: the latter are baselined
_F64_ALLOWED_RE = re.compile(r"(^|/)evals/")


def check_f64(src: SourceFile, index: ModuleIndex) -> list:
    if _F64_ALLOWED_RE.search(src.path):
        return []
    findings = []

    def flag(node, what):
        findings.append(Finding(
            rule="f64", severity="error", path=src.path, line=node.lineno,
            col=node.col_offset,
            message=(f"{what} — float64 belongs in evals/ certificate math "
                     f"and the parity tests; fix the dtype or add a "
                     f"justified `torchlint: allow=f64`")))

    for node in ast.walk(src.tree):
        if isinstance(node, ast.Attribute) and node.attr == "float64":
            chain = _attr_chain(node)
            if chain:
                flag(node, f"`{chain}`")
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "double" and not node.args:
                flag(node, "`.double()`")
            elif any(isinstance(a, ast.Constant) and a.value == "float64"
                     for a in list(node.args)
                     + [kw.value for kw in node.keywords]):
                flag(node, '"float64" dtype argument')
    return findings


# --- rule: kernel-budget (AST half) ----------------------------------------

def _library_names(src: SourceFile) -> list:
    return [n.args[0].value for n in ast.walk(src.tree)
            if isinstance(n, ast.Call)
            and (_attr_chain(n.func) or "") in ("kernels.load", "load")
            and n.args and isinstance(n.args[0], ast.Constant)
            and isinstance(n.args[0].value, str)]


def _takes_dynamic_smem(src: SourceFile, lib: str) -> bool:
    """Whether library ``lib``'s source declares dynamic shared memory;
    a source that cannot be found counts as one that does."""
    root = src.abspath[:len(src.abspath) - len(src.path)]
    pkg = src.path.split("/", 1)[0]
    cu = os.path.join(root, pkg, "csrc", f"{lib}.cu")
    try:
        with open(cu, encoding="utf-8") as f:
            return "extern __shared__" in f.read()
    except OSError:
        return True


def check_kernel_budget_ast(src: SourceFile, index: ModuleIndex,
                            all_sources: dict) -> list:
    loads = [n for n in ast.walk(src.tree)
             if isinstance(n, ast.Call)
             and (_attr_chain(n.func) or "") == "kernels.load"]
    if not loads:
        return []
    findings = []
    flag = _flagger(findings, "kernel-budget", src)
    calls = [n for n in ast.walk(src.tree) if isinstance(n, ast.Call)]
    if not any((_attr_chain(n.func) or "").endswith("count_launches")
               for n in calls):
        flag(loads[0],
             "module loads a kernel library but registers no wrapper with "
             "kernels.count_launches — its launches cannot be shown on the "
             "main path")
    plans = [n for n in ast.walk(src.tree)
             if isinstance(n, ast.FunctionDef) and n.name.endswith("_plan")
             and not n.name.startswith("_")]
    dynamic = any(_takes_dynamic_smem(src, lib)
                  for lib in _library_names(src))
    if dynamic:
        fed = any(_callee_tail(n).endswith("_plan") and any(
            isinstance(s, ast.Call) and _callee_tail(s) == "smem_optin"
            for a in list(n.args) + [kw.value for kw in n.keywords]
            for s in ast.walk(a)) for n in calls)
        if not plans:
            flag(loads[0],
                 "module's kernel takes dynamic shared memory but the "
                 "module declares no *_plan — its bytes are never held "
                 "to the card's opt-in before the launch")
        elif not fed:
            flag(loads[0],
                 "no *_plan of this module is given kernels.smem_optin — "
                 "the plan sizes shared memory against no budget of the "
                 "card")
    for plan in plans:
        consulted = False
        for other_path, other in all_sources.items():
            if other_path == src.path:
                continue
            if any((isinstance(n, ast.Name) and n.id == plan.name)
                   or (isinstance(n, ast.Attribute)
                       and n.attr == plan.name)
                   for n in ast.walk(other.tree)):
                consulted = True
                break
        if not consulted:
            flag(plan,
                 f"plan `{plan.name}` is never consulted outside "
                 f"{os.path.basename(src.path)} — a gate nobody calls "
                 f"protects nothing",
                 severity="warning")
    return findings


# --- rule: span-hygiene -----------------------------------------------------

_SPAN_CALLEES = {"span", "traced"}
_TRACING_RECEIVERS = ("tracing", "tracer")


def _is_span_call(node: ast.Call) -> Optional[str]:
    """'span'/'traced' when ``node`` is a tracing call, else None: a
    receiver naming the tracing surface, ``get_tracer().span(...)``, or a
    bare call with a string phase (``re.Match.span()`` is not one)."""
    tail = _callee_tail(node)
    if tail not in _SPAN_CALLEES:
        return None
    phase_is_str = bool(node.args) and isinstance(
        node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
    if isinstance(node.func, ast.Name):
        return tail if phase_is_str else None
    recv = node.func.value
    chain = (_attr_chain(recv) or "").lower()
    if any(r in chain for r in _TRACING_RECEIVERS):
        return tail
    if isinstance(recv, ast.Call) and _callee_tail(recv) == "get_tracer":
        return tail
    return tail if phase_is_str else None


def check_span_hygiene(src: SourceFile, index: ModuleIndex) -> list:
    findings = []
    flag = _flagger(findings, "span-hygiene", src)
    parents = _build_parents(src.tree)
    captured = index.captured_defs()
    for d in _captured(index):
        for node in _own_nodes(d, parents):
            if isinstance(node, ast.Call) and _is_span_call(node):
                flag(node,
                     f"tracing `{_is_span_call(node)}(...)` inside captured "
                     f"code times the capture once, not the replays — span "
                     f"the host boundary (the chunk's dispatch and fetch, "
                     f"solvers/base.py)")
        if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in d.decorator_list:
                if isinstance(dec, ast.Call) and \
                        _is_span_call(dec) == "traced":
                    flag(dec,
                         f"@traced on `{d.name}`, which runs inside a "
                         f"captured graph — the span wraps the capture, "
                         f"not the replays; decorate the host caller")
    # span attributes that read a device tensor, anywhere
    for d in [src.tree] + list(index.defs):
        if id(d) in captured:
            continue
        params = set() if d is src.tree or isinstance(d, ast.Module) \
            else set(_params(d))
        tensors = set() if d is src.tree else _local_tensors(
            d, parents, params)
        for stmt in _body(d):
            for node in ast.walk(stmt):
                nd = _nearest_def(node, parents)
                if nd is not (None if d is src.tree else d):
                    continue
                if not isinstance(node, ast.Call) or \
                        _is_span_call(node) is None:
                    continue
                if any(_tensorish(kw.value, tensors, set())
                       or (isinstance(kw.value, ast.Call)
                           and isinstance(kw.value.func, ast.Attribute)
                           and kw.value.func.attr in _SYNC_METHODS)
                       for kw in node.keywords):
                    flag(node,
                         "span attribute reads a device tensor — emitting "
                         "it syncs the device; tag values the host already "
                         "holds, or fetch after the chunk")
    return findings


# --- rule: overlap-hygiene ---------------------------------------------------

_EXCHANGE_CALLEES = {"async_host_allgather_bytes", "async_kv_get"}


def check_overlap_hygiene(src: SourceFile, index: ModuleIndex) -> list:
    findings = []
    flag = _flagger(findings, "overlap-hygiene", src)
    parents = _build_parents(src.tree)
    captured = index.captured_defs()

    for d in _captured(index):
        for node in _own_nodes(d, parents):
            if isinstance(node, ast.Call) and \
                    _callee_tail(node) in _EXCHANGE_CALLEES:
                flag(node,
                     f"`{_callee_tail(node)}` inside captured code — the "
                     f"exchange thread would read tensors a replay is "
                     f"still writing, and a capture cannot hold a host "
                     f"thread; launch it at the host boundary with host "
                     f"bytes")

    for scope in [src.tree] + list(index.defs):
        if scope is not src.tree and id(scope) in captured:
            continue
        handles: dict = {}
        joined: set = set()
        for stmt in _body(scope):
            for node in ast.walk(stmt):
                nd = _nearest_def(node, parents)
                if not (nd is scope or (scope is src.tree and nd is None)):
                    continue
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Call) \
                        and _callee_tail(node.value) in _EXCHANGE_CALLEES:
                    handles[node.targets[0].id] = node
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "join" \
                        and isinstance(node.func.value, ast.Name):
                    joined.add(node.func.value.id)
        if not handles:
            continue
        used = set()
        for stmt in _body(scope):
            for node in ast.walk(stmt):
                if isinstance(node, ast.Name) and isinstance(
                        node.ctx, ast.Load) and node.id in handles:
                    p = parents.get(node)
                    if not (isinstance(p, ast.Attribute)
                            and p.attr == "join"):
                        used.add(node.id)
        for name, assign in handles.items():
            if name not in joined and name not in used:
                flag(assign,
                     f"exchange handle `{name}` is never joined and never "
                     f"escapes this scope — its payload is read by nobody "
                     f"and every chunk it crosses runs against an "
                     f"un-joined exchange; call `{name}.join()` at the "
                     f"barrier (or hand it to a StaleJoinWindow)")
    return findings


# --- rule: fleet-hygiene -----------------------------------------------------

_FLEET_NAME_RE = re.compile(r"(^|_)(tenants?|fleet|lanes?)(_|$|\d)",
                            re.IGNORECASE)
_FLEET_FETCH_CALLEES = {"item", "tolist", "cpu", "numpy", "host_fetch",
                        "synchronize"}


def _fleet_named(node) -> bool:
    """Whether a for-loop or comprehension generator iterates over
    tenants or lanes: its target or iterable names say so."""
    names = []
    for part in (node.target, node.iter):
        for sub in ast.walk(part):
            if isinstance(sub, ast.Name):
                names.append(sub.id)
            elif isinstance(sub, ast.Attribute):
                names.append(sub.attr)
    return any(_FLEET_NAME_RE.search(n) for n in names)


def check_fleet_hygiene(src: SourceFile, index: ModuleIndex) -> list:
    findings = []
    flag = _flagger(findings, "fleet-hygiene", src)
    parents = _build_parents(src.tree)
    captured = index.captured_defs()

    for d in _captured(index):
        for node in _own_nodes(d, parents):
            if isinstance(node, (ast.For, ast.comprehension)) and \
                    _fleet_named(node):
                where = node if isinstance(node, ast.For) else node.iter
                flag(where,
                     "Python loop over tenants inside captured code — the "
                     "graph holds T unrolled copies of its body (capture "
                     "time and launches scale with T); batch the tenant "
                     "axis (parallel/fanout.lane_fanout)")

    for scope in [src.tree] + [d for d in index.defs
                               if id(d) not in captured]:
        for stmt in _body(scope):
            for node in ast.walk(stmt):
                nd = _nearest_def(node, parents)
                if not (nd is scope or (scope is src.tree and nd is None)):
                    continue
                if not isinstance(node, ast.For) or not _fleet_named(node):
                    continue
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) and \
                            _callee_tail(sub) in _FLEET_FETCH_CALLEES:
                        flag(sub,
                             f"per-tenant `{_callee_tail(sub)}` inside a "
                             f"tenant loop — T reads of the device where "
                             f"one of the stacked result does; fetch once "
                             f"before the loop (the run_cocoa_fleet "
                             f"pattern)")
    return findings


# --- rule: serve-hygiene -----------------------------------------------------

_SERVING_PATH_RE = re.compile(r"(^|/)serving/")
# the swap-time quantizer, where quantization belongs
_QUANTIZER_RE = re.compile(r"(^|/)serving/quantize\.py$")
# defs that build static buffers and published forms: construction, the
# build/warmup helpers and a model's swap — everything else in a serving
# module is the request path
_SERVE_BUILDER_RE = re.compile(
    r"^(__init__|_?build\w*|make_\w+|warmup|swap|_publish)$")
_SERVE_ALLOC_CALLEES = {"zeros", "ones", "empty", "full"}
_SERVE_CLOCK_CHAINS = {"time.time", "time.monotonic", "time.perf_counter",
                       "time.perf_counter_ns", "time.monotonic_ns"}
_SERVE_NARROW_DTYPES = {"bfloat16", "float16", "half", "int8", "uint8",
                        "int16", "float8_e4m3fn", "float8_e5m2"}
_SERVE_NARROW_METHODS = {"half", "bfloat16", "char", "byte"}


def _contains_len_call(expr: ast.AST) -> bool:
    return any(isinstance(s, ast.Call) and isinstance(s.func, ast.Name)
               and s.func.id == "len" for s in ast.walk(expr))


def _narrowing(call: ast.Call) -> Optional[str]:
    """The narrow dtype a ``.to(...)``/``.type(...)`` or a narrowing
    method call casts to, else None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    if call.func.attr in _SERVE_NARROW_METHODS and not call.args:
        return call.func.attr
    if call.func.attr in ("to", "type", "astype"):
        for a in list(call.args) + [kw.value for kw in call.keywords]:
            chain = _attr_chain(a) or ""
            tail = chain.rsplit(".", 1)[-1]
            if tail in _SERVE_NARROW_DTYPES:
                return tail
    return None


def check_serve_hygiene(src: SourceFile, index: ModuleIndex) -> list:
    if not _SERVING_PATH_RE.search(src.path):
        return []
    findings = []
    flag = _flagger(findings, "serve-hygiene", src)
    parents = _build_parents(src.tree)
    captured = index.captured_defs()
    quantizer = bool(_QUANTIZER_RE.search(src.path))
    for d in index.defs:
        name = getattr(d, "name", "") or ""
        if _SERVE_BUILDER_RE.match(name):
            continue
        is_captured = id(d) in captured
        for node in _own_nodes(d, parents):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func) or ""
            if _callee_tail(node) in _SERVE_ALLOC_CALLEES and node.args \
                    and chain.split(".")[0] in (_NP_MODULES | {"torch"}) \
                    and _contains_len_call(node.args[0]):
                flag(node,
                     f"request-dependent shape in the serving hot path — "
                     f"`{chain}` sized by `len(...)` allocates one shape a "
                     f"request; pad up to a static bucket "
                     f"(serving/scorer.pick_bucket)")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_METHODS and \
                    not _in_fetch(node, parents):
                flag(node,
                     f"`.{node.func.attr}()` in the serving hot path reads "
                     f"the device outside the batch's one fetch — read "
                     f"through events.host_fetch (the batcher's "
                     f"serve_fetch)")
            elif chain.endswith("cuda.synchronize"):
                flag(node,
                     "`torch.cuda.synchronize()` in the serving hot path "
                     "waits for the whole device once a request — the "
                     "batch's one fetch orders what it needs")
            elif is_captured and chain in _SERVE_CLOCK_CHAINS:
                flag(node,
                     f"`{chain}()` inside captured scoring code reads the "
                     f"clock once at capture, not per request — time at "
                     f"the host boundary (the batcher's spans)")
            elif not quantizer and (_narrowing(node) or (
                    _callee_tail(node) in ("max", "amax")
                    and any(isinstance(s, ast.Call)
                            and _callee_tail(s) == "abs"
                            for a in [*node.args, node.func]
                            for s in ast.walk(a)))):
                flag(node,
                     "quantization in the serving hot path (a narrowing "
                     "cast or a max-of-abs scale) — quantize once at swap "
                     "time (serving/quantize.quantize) and serve the "
                     "published form")
    return findings


# --- registry ---------------------------------------------------------------

RULES = ("scatter-order", "host-sync", "f64", "kernel-budget",
         "span-hygiene", "overlap-hygiene", "fleet-hygiene",
         "serve-hygiene", "suppression")


def run_static_rules(sources: dict) -> list:
    """Run every AST rule over {path: SourceFile}; returns findings."""
    findings = []
    for path, src in sources.items():
        index = ModuleIndex(src).index()
        findings += check_scatter_order(src, index)
        findings += check_host_sync(src, index)
        findings += check_f64(src, index)
        findings += check_kernel_budget_ast(src, index, sources)
        findings += check_span_hygiene(src, index)
        findings += check_overlap_hygiene(src, index)
        findings += check_fleet_hygiene(src, index)
        findings += check_serve_hygiene(src, index)
    findings += unexplained_allows(sources)
    return findings
