"""AST lints for the port's device footguns (kanlint KL1xx in torch terms).

Pure-``ast`` passes: the linter imports nothing of the scanned code, so it
can judge a broken tree.  Rules, each meaning in PyTorch and CUDA what it
means in ``repro/analysis/ast_rules.py``:

* **KL100 syntax error**: the file does not parse.
* **KL102 host sync**: a blocking device-to-host read of a device value
  (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``; ``float()``,
  ``int()``, ``bool()``, ``np.asarray`` or ``np.array`` of it) or a
  ``torch.cuda.synchronize()``, outside a ``return``, in the port's serving
  and training loops (``serve/``, ``train/``, ``launch/``).  Each read
  waits for the stream to drain; a loop reads a chunk once, through one
  ``.cpu()`` of a ``torch.cat`` or ``torch.stack`` of the chunk's tensors
  (the counterpart of the reference's one ``jax.device_get((...))``).
  Device values, by a linear taint walk per function as the reference's:
  names assigned from a call into the model layer (a module of
  ``repro_torch.models`` or ``repro_torch.kernels``, or
  ``repro_torch.serve.speculative``, which runs the drafter and the
  sampler), from a call of a step function (a name bound to
  ``make_train_step`` or ``make_pp_loss``, what ``jax.jit`` builds in the
  reference), or from a call of a device function: a function of the
  module, or a method of the class through ``self``, that returns such a
  value.  The registry is the import graph and these two factories, so it
  needs no list of methods to keep up to date; anything else (an
  attribute, a container, an argument) is not resolved and the rule
  abstains.  A reassignment from anything else clears the taint, and a
  ``return`` is exempt (the API's one final transfer).
* **KL103 float64 on a device path**: ``torch.float64``, ``torch.double``,
  ``.double()``, ``np.float64`` or ``numpy.float64`` under the device-path
  packages (``models``, ``kernels``, ``serve``, ``dist``).  fp64 runs at a
  fraction of the card's fp32 rate, and a float64 operand promotes what it
  meets; host precompute (``core/``) is out of scope, as in the reference.

Not ported, for want of a torch meaning (ROADMAP.md): KL101 (donation) and
KL104 (impure traced function) concern tracing, which the eager port does
not do; they get one with CUDA graphs.  KL105 (the sharding contract) is
``sharding_audit.py``.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

# KL102: blocking reads, the sanctioned batch, and where the rule looks.
READBACK_METHODS = {"item", "tolist", "cpu", "numpy"}
READBACK_FUNCS = {"float", "int", "bool", "np.asarray", "np.array", "numpy.asarray",
                  "numpy.array"}
SYNC_CALLS = {"torch.cuda.synchronize"}
BATCH_CALLS = {"torch.cat", "torch.stack"}
# views and casts between the batch and its ``.cpu()`` (``torch.cat(...).T.cpu()``)
VIEW_STEPS = {"T", "mT", "t", "long", "int", "float", "to", "reshape", "view", "flatten",
              "contiguous", "squeeze", "unsqueeze"}
LOOP_DIRS = {"serve", "train", "launch"}
MODEL_LAYER = ("repro_torch.models", "repro_torch.kernels", "repro_torch.serve.speculative")
STEP_FACTORIES = {"make_train_step", "make_pp_loss"}
# KL103: float64 tokens and the directories where device code lives.
F64_TOKENS = {"torch.float64", "torch.double", "np.float64", "numpy.float64"}
DEVICE_PATH_DIRS = {"models", "kernels", "serve", "dist"}

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_COMPREHENSIONS = (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.DictComp)


def _dotted(node: ast.AST) -> str | None:
    """'torch.cat' for Attribute chains, 'float' for Names, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


# ---------------------------------------------------------------------------
# KL102: host reads of device values
# ---------------------------------------------------------------------------


def _model_imports(tree: ast.AST) -> tuple[set[str], set[str]]:
    """(module aliases, function names) this file imports from the model
    layer."""
    modules: set[str] = set()
    funcs: set[str] = set()

    def in_layer(name: str) -> bool:
        return any(name == p or name.startswith(p + ".") for p in MODEL_LAYER)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules.update(a.asname for a in node.names if in_layer(a.name) and a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                name = a.asname or a.name
                if node.module in MODEL_LAYER[:2] or (
                        not in_layer(node.module) and in_layer(f"{node.module}.{a.name}")):
                    modules.add(name)           # a module of the layer
                elif in_layer(node.module):
                    funcs.add(name)             # a function of one
    return modules, funcs


class _Context:
    """What a file's taint walks share: the model-layer imports, and the
    device functions and methods (fixed point over their returns)."""

    def __init__(self, tree: ast.AST):
        self.modules, self.funcs = _model_imports(tree)
        self.device_funcs: set[str] = set()
        self.device_methods: dict[ast.ClassDef, set[str]] = {}


def _strip(node: ast.AST) -> ast.AST:
    while isinstance(node, ast.Subscript):
        node = node.value
    return node


class _Walk:
    """The linear taint walk over one function body (the reference's
    ``_scan_taint``)."""

    def __init__(self, ctx: _Context, cls: ast.ClassDef | None, path: str,
                 out: list[Finding] | None):
        self.ctx, self.cls, self.path, self.out = ctx, cls, path, out
        self.tainted: set[str] = set()
        self.step_fns: set[str] = set()
        self.returns_device = False

    # -- sources ------------------------------------------------------------
    def is_source(self, v: ast.AST) -> bool:
        v = _strip(v)
        if not isinstance(v, ast.Call):
            return False
        f = v.func
        if isinstance(f, ast.Name):
            return (f.id in self.ctx.funcs or f.id in self.step_fns
                    or f.id in self.ctx.device_funcs)
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id == "self" and self.cls is not None:
                return f.attr in self.ctx.device_methods.get(self.cls, set())
            return f.value.id in self.ctx.modules
        return False

    def carries(self, v: ast.AST) -> bool:
        elts = v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]
        return any(self.is_source(e) or (isinstance(_strip(e), ast.Name)
                                         and _strip(e).id in self.tainted) for e in elts)

    # -- reads --------------------------------------------------------------
    def _root(self, node: ast.AST) -> ast.AST:
        """Through subscripts, attributes and method calls to the value a
        chain starts from."""
        while True:
            if isinstance(node, (ast.Subscript, ast.Attribute)):
                node = node.value
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and _dotted(node.func) not in BATCH_CALLS and not self.is_source(node):
                node = node.func.value
            else:
                return node

    def _batched(self, node: ast.AST) -> bool:
        """``torch.cat/stack(...)``, through views and casts only."""
        while True:
            if isinstance(node, ast.Attribute) and node.attr in VIEW_STEPS:
                node = node.value
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in VIEW_STEPS:
                node = node.func.value
            else:
                return isinstance(node, ast.Call) and _dotted(node.func) in BATCH_CALLS

    def _device(self, node: ast.AST, tainted: set[str]) -> str | None:
        root = self._root(node)
        if isinstance(root, ast.Name) and root.id in tainted:
            return root.id
        if self.is_source(root):
            return _dotted(_strip(root).func) or "call"
        return None

    def reads(self, expr: ast.AST) -> list[tuple[int, str, bool]]:
        """(line, what, is_sync) for each host read of a device value in
        ``expr``; a batched ``.cpu()`` is sanctioned, its subtree skipped."""
        hits: dict[tuple[int, str, bool], None] = {}    # one per line and value

        def visit(node: ast.AST, tainted: set[str]) -> None:
            if isinstance(node, _COMPREHENSIONS):
                extra = {g.target.id for g in node.generators
                         if isinstance(g.target, ast.Name)
                         and isinstance(g.iter, (ast.Tuple, ast.List))
                         and any(isinstance(e, ast.Name) and e.id in tainted
                                 for e in g.iter.elts)}
                tainted = tainted | extra
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d in SYNC_CALLS:
                    hits[(node.lineno, d, True)] = None
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in READBACK_METHODS:
                    if node.func.attr == "cpu" and self._batched(node.func.value):
                        return          # the sanctioned read of a chunk
                    name = self._device(node.func.value, tainted)
                    if name is not None:
                        hits[(node.lineno, name, False)] = None
                elif d in READBACK_FUNCS and node.args:
                    name = self._device(node.args[0], tainted)
                    if name is not None:
                        hits[(node.lineno, name, False)] = None
            for child in ast.iter_child_nodes(node):
                visit(child, tainted)

        visit(expr, self.tainted)
        return list(hits)

    def flag(self, expr: ast.AST) -> None:
        if self.out is None:
            return
        for line, what, sync in self.reads(expr):
            if sync:
                self.out.append(Finding(
                    "KL102", self.path, line,
                    f"'{what}' in a serving or training loop (the host waits for "
                    f"the device)",
                    "drop it, or waive a deliberate one with its reason",
                ))
            else:
                self.out.append(Finding(
                    "KL102", self.path, line,
                    f"host readback of device value '{what}' in a serving or "
                    f"training loop (blocking device-to-host sync)",
                    "read a chunk once: one .cpu() of a torch.cat or torch.stack "
                    "of its tensors",
                ))

    # -- statements ---------------------------------------------------------
    def assign(self, targets: list[ast.AST], value: ast.AST) -> None:
        names: list[str] = []
        for t in targets:
            if isinstance(t, ast.Name):
                names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                names.extend(e.id for e in t.elts if isinstance(e, ast.Name))
                names.extend(e.value.id for e in t.elts
                             if isinstance(e, ast.Starred) and isinstance(e.value, ast.Name))
        source = self.is_source(value) or (
            isinstance(value, ast.Tuple) and any(self.is_source(e) for e in value.elts))
        (self.tainted.update if source else self.tainted.difference_update)(names)
        factory = isinstance(value, ast.Call) and \
            (_dotted(value.func) or "").split(".")[-1] in STEP_FACTORIES
        (self.step_fns.update if factory else self.step_fns.difference_update)(names)

    def stmts(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, _DEFS):
                _Walk(self.ctx, self.cls, self.path, self.out).stmts(stmt.body)
                continue                                  # a fresh scope
            if isinstance(stmt, ast.ClassDef):
                continue
            if isinstance(stmt, ast.Return):
                if stmt.value is not None and self.carries(stmt.value):
                    self.returns_device = True
                continue                                  # the final-transfer exemption
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)) and stmt.value is not None:
                self.flag(stmt.value)
                targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                self.assign(targets, stmt.value)
                continue
            for field in ("value", "test", "iter"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, ast.AST):
                    self.flag(sub)
            for item in getattr(stmt, "items", []):       # with
                self.flag(item.context_expr)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list) and sub and isinstance(sub[0], ast.stmt):
                    self.stmts(sub)
            for handler in getattr(stmt, "handlers", []):
                self.stmts(handler.body)


def check_host_sync(tree: ast.AST, path: str) -> list[Finding]:
    if not LOOP_DIRS & set(path.split("/")):
        return []
    ctx = _Context(tree)
    funcs = [(None, f) for f in tree.body if isinstance(f, _DEFS)]
    for cls in (n for n in tree.body if isinstance(n, ast.ClassDef)):
        ctx.device_methods[cls] = set()
        funcs += [(cls, f) for f in cls.body if isinstance(f, _DEFS)]
    changed = True
    while changed:                  # device functions and methods: a fixed point
        changed = False
        for cls, fn in funcs:
            w = _Walk(ctx, cls, path, None)
            w.stmts(fn.body)
            known = ctx.device_funcs if cls is None else ctx.device_methods[cls]
            if w.returns_device and fn.name not in known:
                known.add(fn.name)
                changed = True
    out: list[Finding] = []
    for cls, fn in funcs:
        _Walk(ctx, cls, path, out).stmts(fn.body)
    _Walk(ctx, None, path, out).stmts(
        [s for s in tree.body if not isinstance(s, (*_DEFS, ast.ClassDef))])
    return sorted(out, key=lambda f: f.line)


# ---------------------------------------------------------------------------
# KL103: float64 on device paths
# ---------------------------------------------------------------------------


def check_float64(tree: ast.AST, path: str) -> list[Finding]:
    if not DEVICE_PATH_DIRS & set(path.split("/")):
        return []
    out: list[Finding] = []
    for node in ast.walk(tree):
        token = None
        if isinstance(node, ast.Attribute) and _dotted(node) in F64_TOKENS:
            token = _dotted(node)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "double" and not node.args:
            token = ".double()"
        if token is not None:
            out.append(Finding(
                "KL103", path, node.lineno,
                f"float64 token '{token}' on a device path (fp64 runs at a "
                f"fraction of the card's fp32 rate and promotes what it meets)",
                "compute in float32, or move the fp64 precompute to core/",
            ))
    return out


ALL_AST_RULES = (check_host_sync, check_float64)


def lint_source(source: str, path: str) -> list[Finding]:
    """Run every KL1xx rule of the port over one file's source."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("KL100", path, e.lineno or 1,
                        f"syntax error: {e.msg}", "fix the parse error")]
    out: list[Finding] = []
    for rule in ALL_AST_RULES:
        out.extend(rule(tree, path))
    return out
