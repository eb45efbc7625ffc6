"""Tracer-safety lint: host control flow and host syncs in captured scope.

The port's form of the reference's pass.  There the "traced scope" is
what ``jax.jit`` traces; here it is what a CUDA graph captures: every
function reachable from a compiled entry of ``dragonboat_tpu_torch
.graphs`` (a module-level ``name = graphs.compiled(fn, static_argnums=...)``
assignment, or a per-position entry ``entry.position(key, fn,
static_argnums)``) in the kernel module set.  A capture records the
device work of ONE run of the Python body and replays it: a Python branch
on a device value, a wall-clock read or a host RNG draw is frozen into
the graph exactly as a trace freezes it, and a device->host read raises
inside a capture on the card while the CPU, where the tests run the eager
body, passes it silently.  Inside that scope the pass flags:

- TS001  Python ``if`` / ``while`` (or conditional expression) whose
         test depends on a device value — the capture bakes the branch it
         saw into every replay (a ``for`` over a tensor walks its static
         leading dim, and is not flagged);
- TS002  ``int()`` / ``float()`` / ``bool()`` / ``.item()`` /
         ``.tolist()`` on a device value (a host read: refused inside a
         capture on the card);
- TS003  host syncs and data-dependent output shapes: ``.cpu()``,
         ``.numpy()``, ``.to("cpu")``, ``np.asarray`` / ``np.array`` of a
         device value, ``torch.cuda.synchronize()``, ``nonzero`` /
         ``argwhere`` / ``masked_select`` / ``unique`` / one-argument
         ``torch.where`` and boolean-mask indexing (each syncs on the card
         to size its result, and a capture refuses it);
- TS004  ``time.*`` / ``random.*`` / ``datetime.*`` / ``np.random.*``,
         and torch RNG calls with no explicit ``generator=`` —
         host-side effects that run once at capture and then freeze.

Traced-ness is a forward single-pass taint over each function body:
parameters are tainted unless they are static for that function (the
``static_argnums`` of the compiled entry it seeds; a parameter of a
helper that every captured call of it passes a host value, by the
caller's own taint, or leaves at its default; or a name in
``STATIC_PARAM_NAMES`` — the repo's conventional static-argument
spellings, see that constant), and any ``torch.*`` result is tainted.
Shape and device metadata (``.shape`` / ``.ndim`` / ``.dim()`` /
``.dtype`` / ``.device`` / ``.is_cuda`` / ``.numel()`` / ``len()`` /
``isinstance()`` / ``x is None``) sanitizes, so the kernel's static
specialization branches (``if kp.onehot_reads:``, ``if x is None:``) and
the kernel wrappers' choice of arm (``kernels.use_kernel(...)``, a pure
function of the tensors' devices) and ctypes launch (``.data_ptr()``: an
address, not a read) stay clean by construction, not by waiver.

The pass is intra-module-set: calls are resolved through plain names,
``from m import f`` aliases, and ``mod.f`` attributes against the
scanned file set; anything it cannot resolve is assumed host-side and
not descended into (its *result* is still tainted when its arguments
are).
"""

from __future__ import annotations

import ast
import os

from dragonboat_tpu_torch.analysis.common import Finding, rel

PASS = "tracer-safety"

# Modules whose compiled entries seed the captured-scope walk, plus the
# helper modules their bodies call into (the kernel wrappers of K1, K2
# and K3 among them).
DEFAULT_MODULES = (
    "dragonboat_tpu_torch/core/kernel.py",
    "dragonboat_tpu_torch/core/router.py",
    "dragonboat_tpu_torch/core/kstate.py",
    "dragonboat_tpu_torch/core/params.py",
    "dragonboat_tpu_torch/rsm/device_kv.py",
    "dragonboat_tpu_torch/rsm/device_kv_kernels.py",
    "dragonboat_tpu_torch/parallel/ici.py",
    "dragonboat_tpu_torch/parallel/fabric_kernels.py",
    "dragonboat_tpu_torch/bench_loop.py",
)

# Conventional static-argument names in this repo: every compiled entry
# passes these via static_argnums, and the helpers thread them under the
# same spellings.  A name listed here is never treated as traced.
STATIC_PARAM_NAMES = frozenset({
    "self",          # DeviceKV methods: a frozen dataclass, static
    "kp", "kv", "cluster", "family", "replicas", "iters",
    "write_width", "do_reads", "R", "n_local", "axis",
    "T", "D", "AB", "hash_keys", "interpret", "unroll",
})

# Attribute reads that yield static metadata, never a device value.
META_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                        "layout", "names", "_fields"})

# Method calls that yield static metadata (shape, device, addresses).
META_METHODS = frozenset({"dim", "numel", "size", "data_ptr", "stride",
                          "element_size", "is_contiguous", "get_device",
                          "nelement", "storage_offset"})

# Builtins whose result is host/static regardless of argument taint.
CLEAN_FUNCS = frozenset({"len", "isinstance", "type", "hasattr", "getattr",
                         "range", "zip", "enumerate", "sorted", "min", "max",
                         "tuple", "list", "dict", "set", "repr", "str",
                         "issubclass", "callable", "id"})

# Helpers outside the module set whose result depends only on devices
# (the kernel wrappers' choice of arm) or is a library handle.
CLEAN_CALLS = frozenset({"use_kernel", "library", "stream_ptr",
                         "resolve_device"})

# torch calls whose result is host metadata, not a device value
TORCH_META_CALLS = frozenset({"device", "Size", "iinfo", "finfo",
                              "is_tensor", "is_available", "current_device",
                              "device_count", "get_device_name",
                              "is_floating_point", "promote_types"})

COERCE_FUNCS = frozenset({"int", "float", "bool", "complex"})
COERCE_METHODS = frozenset({"item", "tolist"})
SYNC_METHODS = frozenset({"cpu", "numpy", "synchronize"})
# calls whose output shape depends on the data: the card syncs to size
# the result
DATA_SHAPE_CALLS = frozenset({"nonzero", "argwhere", "masked_select",
                              "unique", "unique_consecutive"})
HOST_EFFECT_MODULES = frozenset({"time", "random", "datetime"})
# torch RNG: frozen at capture unless a generator is passed explicitly
TORCH_RNG_CALLS = frozenset({
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "rand_like", "randn_like", "randint_like", "poisson",
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})

# Call sites whose function-valued argument enters captured scope, with
# the positions of that argument and of its static_argnums:
# ``graphs.compiled(fn, static_argnums=...)`` and
# ``entry.position(key, fn, static_argnums, donate_argnums)``.
TRACING_CALLS = {"compiled": (0, None), "position": (1, 2)}


def _callee_names(call: ast.Call) -> list[str]:
    """Function names referenced by a call argument (unwraps partial)."""
    out = []
    for a in list(call.args) + [k.value for k in call.keywords]:
        out.extend(_func_refs(a))
    return out


def _func_refs(node: ast.AST) -> list[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Attribute):
        return [node.attr]
    if isinstance(node, ast.Call):
        # functools.partial(f, ...) nesting
        return [n for a in [node.func] + list(node.args)
                for n in _func_refs(a)]
    if isinstance(node, ast.Lambda):
        return []          # analyzed in place as part of the enclosing scope
    return []


def _call_basename(func: ast.AST) -> str | None:
    """`graphs.compiled` -> "compiled", `sel` -> "sel"."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class _Module:
    def __init__(self, path: str, tree: ast.Module) -> None:
        self.path = path
        self.tree = tree
        self.funcs: dict[str, ast.FunctionDef] = {}
        self.imports: dict[str, str] = {}   # local alias -> imported name
        self.aliases: dict[str, set[str]] = {}  # container -> funcs inside
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs.setdefault(node.name, node)
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    self.imports[a.asname or a.name] = a.name
        # module-level dispatch tables (e.g. _FAMILY_HANDLERS): a traced
        # function referencing the container calls everything inside it
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                refs = {n.id for n in ast.walk(node.value)
                        if isinstance(n, ast.Name) and n.id in self.funcs}
                if refs:
                    self.aliases[node.targets[0].id] = refs


def _argnums(node: ast.AST | None) -> tuple:
    if node is None:
        return ()
    try:
        val = ast.literal_eval(node)
    except ValueError:
        return ()
    return tuple(val) if isinstance(val, (tuple, list)) else (val,)


def _seed_sites(mod: _Module) -> dict[str, set[str]]:
    """Functions of ``mod`` that a compiled entry captures -> the names of
    their parameters pinned static by that entry's ``static_argnums``."""
    out: dict[str, set[str]] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        site = TRACING_CALLS.get(_call_basename(node.func) or "")
        if site is None:
            continue
        fn_pos, static_pos = site
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        fn_node = node.args[fn_pos] if len(node.args) > fn_pos \
            else kw.get("fn")
        if not isinstance(fn_node, ast.Name) or fn_node.id not in mod.funcs:
            continue
        static_node = kw.get("static_argnums")
        if static_node is None and static_pos is not None \
                and len(node.args) > static_pos:
            static_node = node.args[static_pos]
        fn = mod.funcs[fn_node.id]
        params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        names = out.setdefault(fn_node.id, set())
        for it in _argnums(static_node):
            if isinstance(it, int) and it < len(params):
                names.add(params[it])
    return out


def _is_tensor_type(node: ast.AST) -> bool:
    """Does an isinstance() type argument name a tensor type?"""
    return any(isinstance(n, (ast.Name, ast.Attribute))
               and _call_basename(n) in ("Tensor", "Split")
               for n in ast.walk(node))


class _FunctionLinter(ast.NodeVisitor):
    """Single forward taint pass over one captured top-level function."""

    def __init__(self, mod: _Module, fn: ast.FunctionDef,
                 findings: list[Finding], relpath: str,
                 static: set[str] | None = None) -> None:
        self.mod = mod
        self.findings = findings
        self.relpath = relpath
        self.tainted: set[str] = set()
        self.bools: set[str] = set()    # names bound to bool masks
        # each call evaluated: (taint of each positional argument, taint
        # of each keyword argument, None for ``**``)
        self.arg_taint: dict[ast.Call, tuple[list[bool],
                                             dict[str | None, bool]]] = {}
        self._flagged_lines: set[tuple[int, str]] = set()
        self._bind_params(fn, static or set())

    # -- parameter and name binding -------------------------------------
    def _bind_params(self, fn: ast.FunctionDef | ast.Lambda,
                     static: set[str] = frozenset()) -> None:
        static = STATIC_PARAM_NAMES | static
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            if a.arg not in static:
                self.tainted.add(a.arg)

    def _bind_target(self, target: ast.AST, tainted: bool,
                     is_bool: bool = False) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
            if is_bool:
                self.bools.add(target.id)
            else:
                self.bools.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind_target(el, tainted)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, tainted)
        # attribute/subscript stores don't create local names

    # -- reporting ------------------------------------------------------
    def _flag(self, node: ast.AST, rule: str, msg: str) -> None:
        key = (node.lineno, rule)
        if key in self._flagged_lines:
            return
        self._flagged_lines.add(key)
        self.findings.append(Finding(PASS, self.relpath, node.lineno,
                                     rule, msg))

    # -- bool-mask tracking (boolean-mask indexing is TS003) -----------
    def _is_bool(self, node: ast.AST | None) -> bool:
        """Is ``node`` a boolean mask expression (a comparison, a logical
        combination of masks, a name bound to one)?"""
        if isinstance(node, ast.Compare):
            return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                           ast.NotIn)) for op in node.ops)
        if isinstance(node, ast.Name):
            return node.id in self.bools
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._is_bool(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._is_bool(node.left) or self._is_bool(node.right)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in ("any", "all", "isfinite", "isnan",
                                  "logical_and", "logical_or", "logical_not",
                                  "eq", "ne", "lt", "le", "gt", "ge", "bool"):
                return True
        return False

    # -- taint evaluation (with side-effect flagging of bad calls) ------
    def _taint(self, node: ast.AST | None) -> bool:
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in META_ATTRS:
                self._taint(node.value)   # still surface bad calls inside
                return False
            return self._taint(node.value)
        if isinstance(node, ast.Call):
            return self._taint_call(node)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                # identity tests are host decisions (x is None)
                for sub in [node.left] + node.comparators:
                    self._taint(sub)   # still surface bad calls inside
                return False
            return any([self._taint(x)
                        for x in [node.left] + node.comparators])
        if isinstance(node, ast.BoolOp):
            return any([self._taint(v) for v in node.values])
        if isinstance(node, ast.BinOp):
            return self._taint(node.left) | self._taint(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._taint(node.operand)
        if isinstance(node, ast.Subscript):
            value_t = self._taint(node.value)
            slice_t = self._taint(node.slice)
            items = (node.slice.elts if isinstance(node.slice, ast.Tuple)
                     else [node.slice])
            if value_t and slice_t and any(self._is_bool(i) for i in items):
                self._flag(node, "TS003",
                           "boolean-mask indexing of a device value: its "
                           "output shape depends on the data (a host sync "
                           "on the card; use torch.where)")
            return value_t | slice_t
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any([self._taint(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            return any([self._taint(x)
                        for x in list(node.keys) + list(node.values) if x])
        if isinstance(node, ast.IfExp):
            if self._taint(node.test):
                self._flag(node, "TS001",
                           "conditional expression on a device value")
            return self._taint(node.body) | self._taint(node.orelse)
        if isinstance(node, ast.Starred):
            return self._taint(node.value)
        if isinstance(node, ast.Lambda):
            # analyzed when called at a tracing site; the object is clean
            return False
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            t = False
            for gen in node.generators:
                it = self._taint(gen.iter)
                self._bind_target(gen.target, it)
                t |= it
                for cond in gen.ifs:
                    if self._taint(cond):
                        self._flag(cond, "TS001",
                                   "comprehension filter on a device value")
            if isinstance(node, ast.DictComp):
                return t | self._taint(node.key) | self._taint(node.value)
            return t | self._taint(node.elt)
        if isinstance(node, ast.JoinedStr):
            return any([self._taint(v) for v in node.values])
        if isinstance(node, ast.FormattedValue):
            return self._taint(node.value)
        if isinstance(node, ast.Slice):
            return (self._taint(node.lower) | self._taint(node.upper)
                    | self._taint(node.step))
        if isinstance(node, ast.NamedExpr):
            t = self._taint(node.value)
            self._bind_target(node.target, t)
            return t
        return False   # unknown node kinds: assume host-static

    def _root_module(self, node: ast.AST) -> str | None:
        """`time.monotonic` -> "time"; `np.random.rand` -> "np.random"."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            parts.reverse()
            return ".".join(parts[:-1]) if len(parts) > 1 else None
        return None

    def _taint_call(self, node: ast.Call) -> bool:
        func = node.func
        pos_t = [self._taint(a) for a in node.args]
        kw_t = {k.arg: self._taint(k.value) for k in node.keywords}
        self.arg_taint[node] = (pos_t, kw_t)
        args_tainted = any(pos_t) or any(kw_t.values())

        if isinstance(func, ast.Name):
            if func.id in CLEAN_FUNCS or func.id in CLEAN_CALLS:
                return False
            if func.id in COERCE_FUNCS and args_tainted:
                self._flag(node, "TS002",
                           f"{func.id}() on a device value forces a host "
                           "read inside captured scope")
                return False
        if isinstance(func, ast.Attribute):
            root = self._root_module(func)
            recv_t = self._taint(func.value)
            if root in HOST_EFFECT_MODULES or root in (
                    "np.random", "numpy.random"):
                self._flag(node, "TS004",
                           f"{root}.{func.attr}() inside captured scope "
                           "executes once at capture and freezes")
                return False
            if func.attr in TORCH_RNG_CALLS and (
                    root == "torch" or recv_t) and not any(
                    k.arg == "generator" for k in node.keywords):
                self._flag(node, "TS004",
                           f"{func.attr}() draws from the global torch RNG "
                           "inside captured scope (pass generator= "
                           "explicitly)")
                return recv_t or root == "torch"
            if func.attr in COERCE_METHODS and recv_t:
                self._flag(node, "TS002",
                           f".{func.attr}() on a device value")
                return False
            if func.attr in META_METHODS or func.attr in CLEAN_CALLS:
                return False
            if func.attr in SYNC_METHODS and (
                    recv_t or root in ("torch.cuda", "cuda")):
                self._flag(node, "TS003",
                           f".{func.attr}() host sync inside captured scope")
                return False
            if func.attr == "to" and recv_t and any(
                    isinstance(a, ast.Constant) and a.value == "cpu"
                    for a in list(node.args)
                    + [k.value for k in node.keywords]):
                self._flag(node, "TS003",
                           '.to("cpu") host copy inside captured scope')
                return False
            if func.attr in DATA_SHAPE_CALLS and (
                    recv_t or (root == "torch" and args_tainted)):
                self._flag(node, "TS003",
                           f"{func.attr}() output shape depends on the data "
                           "(a host sync on the card, refused in a capture)")
                return True
            if func.attr == "where" and root == "torch" \
                    and len(node.args) == 1 and args_tainted:
                self._flag(node, "TS003",
                           "one-argument torch.where() is nonzero(): its "
                           "output shape depends on the data")
                return True
            if root in ("np", "numpy") and func.attr in (
                    "asarray", "array") and args_tainted:
                self._flag(node, "TS003",
                           f"{root}.{func.attr}() on a device value pulls "
                           "the buffer to host")
                return False
            if root is not None and root.split(".")[0] == "torch":
                # torch-family result: a device value (metadata excepted)
                return func.attr not in TORCH_META_CALLS
            if recv_t:
                return True        # method on a device value yields one
        # helper call: device result iff any device argument flowed in
        return args_tainted

    # -- statements -----------------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        t = self._taint(node.value)
        b = self._is_bool(node.value)
        for tgt in node.targets:
            self._bind_target(tgt, t, b)
            self._taint(tgt)       # flag bad calls in subscript targets

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._bind_target(node.target, self._taint(node.value),
                          self._is_bool(node.value))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        t = self._taint(node.value) or self._taint(node.target)
        self._bind_target(node.target, t)

    def _isinstance_narrowed(self, test: ast.AST
                             ) -> tuple[set[str], set[str]]:
        """Names proven host-typed by an isinstance test: (in the body,
        in the else arm).  ``isinstance(x, <non-tensor>)`` and
        ``not isinstance(x, torch.Tensor)`` narrow in the body;
        ``isinstance(x, torch.Tensor)`` alone narrows in the else arm."""
        if (isinstance(test, ast.Call) and isinstance(test.func, ast.Name)
                and test.func.id == "isinstance" and len(test.args) == 2
                and isinstance(test.args[0], ast.Name)):
            if _is_tensor_type(test.args[1]):
                return set(), {test.args[0].id}
            return {test.args[0].id}, set()
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            body, orelse = self._isinstance_narrowed(test.operand)
            return orelse, body
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            out: set[str] = set()
            for v in test.values:
                out |= self._isinstance_narrowed(v)[0]
            return out, set()
        return set(), set()

    def visit_If(self, node: ast.If) -> None:
        if self._taint(node.test):
            self._flag(node, "TS001",
                       "Python `if` on a device value inside captured "
                       "scope (use torch.where)")
        in_body, in_else = self._isinstance_narrowed(node.test)
        narrowed = in_body & self.tainted
        self.tainted -= narrowed
        for st in node.body:
            self.visit(st)
        self.tainted |= narrowed
        narrowed = in_else & self.tainted
        self.tainted -= narrowed
        for st in node.orelse:
            self.visit(st)
        self.tainted |= narrowed

    def visit_While(self, node: ast.While) -> None:
        if self._taint(node.test):
            self._flag(node, "TS001",
                       "Python `while` on a device value inside captured "
                       "scope")
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        it = self._taint(node.iter)
        # dict-structure iteration is static control flow (the key set is
        # a capture-time constant) even when the VALUES are device values;
        # so is iteration over a struct's fields or a tuple of tensors
        # (its length is static)
        if (isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Attribute)
                and node.iter.func.attr in ("items", "keys", "values")) \
                or isinstance(node.iter, (ast.Tuple, ast.List)):
            self._bind_target(node.target, it)
            self.generic_visit(node)
            return
        self._bind_target(node.target, it)
        self.generic_visit(node)

    def visit_Expr(self, node: ast.Expr) -> None:
        self._taint(node.value)

    def visit_Return(self, node: ast.Return) -> None:
        self._taint(node.value)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._taint(node.test)     # surface bad calls; asserts themselves ok

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested defs (loop bodies, routers' closures) are captured with
        # the parent; their params are fresh device values
        self._bind_params(node)
        for st in node.body:
            self.visit(st)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._bind_params(node)
        self._taint(node.body)

    def run(self, fn: ast.FunctionDef) -> None:
        for st in fn.body:
            self.visit(st)
        # lambdas appearing in expression statements are visited via
        # _taint -> visit? no: evaluate them explicitly
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Lambda):
                self.visit_Lambda(sub)


#: a reference to a function from another's body: (name as written, the
#: call when it is a direct call, else None — passed on as a value)
Site = tuple[str, "ast.Call | None"]


def _seed_and_calls(mod: _Module) -> tuple[dict[str, set[str]],
                                           dict[str, set[str]],
                                           dict[str, list[Site]]]:
    """(captured seed function -> its static parameter names,
    per-function called-name sets: plain names, imported names and the
    attribute of ``obj.f(...)`` calls, resolved by ``traced_functions``,
    and per-function call sites, whose arguments carry static parameters
    into the callee)."""
    seeds = _seed_sites(mod)
    calls: dict[str, set[str]] = {name: set() for name in mod.funcs}
    sites: dict[str, list[Site]] = {name: [] for name in mod.funcs}

    for name, fn in mod.funcs.items():
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and node.id in mod.aliases:
                calls[name].update(mod.aliases[node.id])
                sites[name].extend((r, None) for r in mod.aliases[node.id])
            if not isinstance(node, ast.Call):
                continue
            if _call_basename(node.func) in TRACING_CALLS:
                continue   # a seed site: its function is captured apart
            calls[name].update(_func_refs(node.func) + _callee_names(node))
            # the callee of a direct call; a function passed on as an
            # argument (a call nested in the arguments is a site of its own)
            if (direct := _call_basename(node.func)) is not None:
                sites[name].append((direct, node))
            sites[name].extend(
                (_call_basename(a), None)
                for a in list(node.args) + [k.value for k in node.keywords]
                if isinstance(a, (ast.Name, ast.Attribute)))
    return seeds, calls, sites


def _static_at(call: ast.Call | None, fn: ast.FunctionDef,
               taint: tuple[list[bool], dict] | None) -> set[str]:
    """Parameters of ``fn`` that ``call`` binds to a host value (an
    untainted argument, by the caller's own taint, or a left-out default);
    none for a function passed on as a value or a call never evaluated."""
    if call is None or taint is None:
        return set()
    pos_t, kw_t = taint
    args = fn.args
    params = [a.arg for a in args.posonlyargs + args.args]
    # defaulted parameters left out of the call keep their (constant)
    # default, unless a ``*`` / ``**`` argument may supply them
    spread = any(isinstance(a, ast.Starred) for a in call.args) \
        or None in kw_t
    out = set() if spread else (
        set(params[len(params) - len(args.defaults):])
        | {a.arg for a, d in zip(args.kwonlyargs, args.kw_defaults)
           if d is not None})
    off = 1 if params[:1] == ["self"] \
        and isinstance(call.func, ast.Attribute) else 0
    for i, (a, t) in enumerate(zip(call.args, pos_t)):
        if isinstance(a, ast.Starred):
            break
        if i + off < len(params):
            (out.discard if t else out.add)(params[i + off])
    for name, t in kw_t.items():
        if name is not None:
            (out.discard if t else out.add)(name)
    return out


#: a function of the scanned set: (module path, name)
Key = tuple[str, str]


def _resolver(mods: list[_Module]):
    """name as written in ``mod`` -> the function it calls: the module's
    own function of that name, else the imported one, else the first
    module of the set defining it (a method called on a static object,
    a ``mod.f`` attribute)."""
    owners: dict[str, list[_Module]] = {}
    for m in mods:
        for name in m.funcs:
            owners.setdefault(name, []).append(m)

    def resolve(mod: _Module, name: str) -> Key | None:
        if name in mod.funcs:
            return (mod.path, name)
        name = mod.imports.get(name, name)
        found = [m for m in owners.get(name, ()) if m is not mod]
        return (found[0].path, name) if found else None

    return resolve


def traced_functions(mods: list[_Module]
                     ) -> tuple[dict[Key, tuple[_Module, ast.FunctionDef,
                                                set[str]]],
                                dict[Key, set[Key]]]:
    """Every function of ``mods`` reachable from a compiled entry (with
    its static parameter names: those its entry pins, and those every
    captured call of it binds to a host value), and the resolved call
    graph of the whole set."""
    resolve = _resolver(mods)
    by_path = {m.path: m for m in mods}
    pinned: dict[Key, set[str]] = {}
    graph: dict[Key, set[Key]] = {}
    callers: dict[Key, list[tuple[Key, ast.Call | None]]] = {}
    for m in mods:
        seeds, calls, sites = _seed_and_calls(m)
        for name, names in seeds.items():
            pinned.setdefault((m.path, name), set()).update(names)
        for name, callees in calls.items():
            graph[(m.path, name)] = {k for c in callees
                                     if (k := resolve(m, c)) is not None}
        for name, refs in sites.items():
            for callee, call in refs:
                if (k := resolve(m, callee)) is not None:
                    callers.setdefault(k, []).append(((m.path, name), call))
    traced = set(pinned)
    frontier = list(traced)
    while frontier:
        key = frontier.pop()
        for callee in graph.get(key, ()):
            if callee not in traced:
                traced.add(callee)
                frontier.append(callee)
    # carry static parameters into callees: a helper's parameter is static
    # when every captured call of it passes a host value there, by the
    # caller's own taint.  The greatest fixed point (a recursive call that
    # passes its own static parameter on keeps it static): start with every
    # parameter of a called helper static; statics only shrink, so it ends
    def params(key: Key) -> set[str]:
        a = by_path[key[0]].funcs[key[1]].args
        return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}

    static = {k: set(pinned.get(k, ())) | (
        params(k) if any(c in traced for c, _ in callers.get(k, ()))
        else set()) for k in traced}
    changed = True
    while changed:
        taint = {}
        for key in traced:
            mod = by_path[key[0]]
            linter = _FunctionLinter(mod, mod.funcs[key[1]], [], key[0],
                                     static[key])
            linter.run(mod.funcs[key[1]])
            taint[key] = linter.arg_taint
        changed = False
        for key in traced:
            sites = [(c, call) for c, call in callers.get(key, ())
                     if c in traced]
            if not sites:
                continue
            fn = by_path[key[0]].funcs[key[1]]
            kept = pinned.get(key, set()) | set.intersection(*(
                _static_at(call, fn, taint[c].get(call))
                for c, call in sites))
            if static[key] - kept:
                static[key] &= kept
                changed = True
    out = {}
    for path, name in traced:
        mod = by_path[path]
        out[(path, name)] = (mod, mod.funcs[name], static[(path, name)])
    return out, graph


def load_modules(paths: list[str]) -> list[_Module]:
    mods: list[_Module] = []
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p, encoding="utf-8") as f:
            mods.append(_Module(p, ast.parse(f.read(), filename=p)))
    return mods


def run(root: str, files: list[str] | None = None) -> list[Finding]:
    paths = files if files is not None else [
        os.path.join(root, m) for m in DEFAULT_MODULES]
    traced, _ = traced_functions(load_modules(paths))
    findings: list[Finding] = []
    for key in sorted(traced):
        mod, fn, static = traced[key]
        linter = _FunctionLinter(mod, fn, findings, rel(root, mod.path),
                                 static)
        linter.run(fn)
    # nested defs are analyzed both standalone and within their parent
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))
