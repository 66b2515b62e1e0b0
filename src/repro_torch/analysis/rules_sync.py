"""host-sync: device→host syncs in the per-step decode/verify loops
(the PyTorch counterpart of `repro.analysis.rules_sync`).

The continuous engine is pipelined: step N+1 is dispatched before step
N's tokens are read, so exactly one sync per iteration reaches the host.
The speculative loop is synchronous by design but still meters its
reads. A *new* sync anywhere in these loops silently serializes host
dispatch against the card — correct output, throughput cliff, no test
failure on the CPU (where nothing is asynchronous).

Inside the configured hot functions (`Config.hot_functions`), lexically
inside any `for`/`while`, the rule flags a PyTorch sync:

  * ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``
    (or ``device="cpu"``) on any receiver;
  * ``torch.cuda.synchronize()`` and an event's or stream's
    ``.synchronize()``; ``torch.equal`` / ``torch.allclose`` (they
    return Python bools);
  * ``np.asarray(...)`` / ``np.array(...)`` of a tensor;
  * ``int(...)`` / ``float(...)`` / ``bool(...)`` of a tensor-tagged
    name or of a tensor expression (a reduction such as ``y.sum()``,
    ``need.any()``, a ``torch.*`` call);
  * a tensor used as the test of an ``if`` / ``while`` / ``assert`` /
    conditional expression / ``and`` / ``or`` (Python asks the tensor
    for its truth value: ``if y.any():``, ``if y > 0:``);
  * a tensor-tagged name inside a tracer emit's arguments —
    ``*.instant/complete/counter/span(...)`` on a ``trace``-named
    receiver (`Config.obs_emit_methods`): emits carry host mirrors only;
  * a call of a function or method of the same module whose own body
    syncs (one level): ``self._sync()``, or ``fetch.get(h)`` where
    ``fetch = _TokenFetch(...)`` and `_TokenFetch.get` waits on an
    event — the engine's pipelined token reads.

Tensor producers: ``torch.*`` calls (bar the host-side namespaces such
as ``torch.cuda.*``, ``torch.device``), tensor methods and operators
on tagged names, and the engine's per-step handles
(`Config.device_handles`: ``obj._decode(...)``, ``_verify``,
``_prefill``). ``torch.tensor`` / ``as_tensor`` / ``from_numpy`` and
``Engine._h2d*`` go host→device and are never a sync themselves (as
``jnp.asarray`` in the JAX rule). Metadata reads (``.shape``,
``.dtype``, ``.device``, ``.size()``, ``.dim()``, ``.numel()``,
``.data_ptr()``) and ``is None`` tests are host values.

Heuristic dataflow, as the JAX rule's: a name is tensor-tagged if it is
ever bound to a tensor expression and never to a host value (literals,
containers, ``np.*``, ``len``/``range``/casts, ``.item()``...), within
the hot function (nested defs included).

Every intentional sync carries ``# kvlint: ok(host-sync: <where it sits
in the pipeline>)`` — the annotations double as the sync design's
record. `rules_step` runs the same detector over the per-step functions'
whole bodies (``step-sync``).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.config import (Config, qualname_matches,
                                        scoped_quals)
from repro_torch.analysis.model import (Finding, SourceFile, dotted_name,
                                       dotted_root)

RULE = "host-sync"

SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
SYNC_FUNCS = {"torch.equal", "torch.allclose"}
CASTS = {"int", "float", "bool"}
# tensor reductions whose result is a 0-dim or small tensor; `any` /
# `all` count on any receiver that is not a host value (they are the
# idiom of a flag test)
REDUCTIONS = {"any", "all", "sum", "max", "min", "mean", "amax", "amin",
              "argmax", "argmin", "count_nonzero", "prod", "norm",
              "nonzero", "eq", "ne", "ge", "gt", "le", "lt"}
TRUTH_REDUCTIONS = {"any", "all"}
STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "is_cpu",
                "is_meta", "is_sparse", "is_quantized", "layout",
                "requires_grad", "is_leaf", "grad_fn", "itemsize", "nbytes"}
HOST_METHODS = SYNC_METHODS | {
    "size", "dim", "numel", "nelement", "element_size", "data_ptr",
    "stride", "is_contiguous", "get_device", "storage_offset",
    "untyped_storage", "is_floating_point", "is_complex", "_asdict",
    "keys", "values", "items", "get", "pop", "append"}
HOST_ROOTS = {"time", "len", "range", "sorted", "list", "dict", "set",
              "tuple", "min", "max", "sum", "enumerate", "zip", "str",
              "int", "float", "bool", "isinstance", "getattr", "hasattr",
              "abs", "round", "any", "all", "divmod", "math", "repr"}
HOST_TORCH = {"torch.device", "torch.Size", "torch.finfo", "torch.iinfo",
              "torch.Generator", "torch.no_grad", "torch.inference_mode",
              "torch.get_default_dtype", "torch.manual_seed",
              "torch.is_tensor", "torch.is_grad_enabled"}
HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.backends.",
                       "torch.distributed.", "torch.jit.", "torch.compiler.",
                       "torch.profiler.", "torch.utils.", "torch._C.",
                       "torch.testing.", "torch.autograd.")


def _is_static_read(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS


class Tags:
    """Tensor / host tags of the names one function binds, and the names
    bound to instances of the module's classes (`classes`)."""

    def __init__(self, fn: ast.AST, cfg: Config,
                 classes: Iterable[str] = ()) -> None:
        self.cfg = cfg
        self.device: Set[str] = set()
        self.host: Set[str] = set()
        self.instances: Dict[str, str] = {}
        classes = set(classes)
        binds: List[Tuple[List[str], ast.AST]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                names: List[str] = []
                for t in node.targets:
                    names.extend(_target_names(t))
                binds.append((names, node.value))
                v = node.value
                if isinstance(v, ast.Call) and isinstance(v.func, ast.Name) \
                        and v.func.id in classes:
                    for n in names:
                        self.instances[n] = v.func.id
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                binds.append((_target_names(node.target), node.value))
        # to a fixed point: a tag can flow through later bindings
        for _ in range(4):
            before = len(self.device) + len(self.host)
            for names, value in binds:
                if not names:
                    continue
                if self.is_host_value(value):
                    self.host.update(names)
                elif self.is_tensor(value):
                    self.device.update(names)
            if len(self.device) + len(self.host) == before:
                break

    def tagged(self, name: str) -> bool:
        return name in self.device and name not in self.host

    def host_tagged(self, name: str) -> bool:
        return name in self.host

    # -- producers -----------------------------------------------------
    def is_producer_call(self, node: ast.Call) -> bool:
        """A call whose result is a tensor on the device."""
        name = dotted_name(node.func)
        if name is not None:
            if name.startswith("torch."):
                return not (name in HOST_TORCH
                            or name.startswith(HOST_TORCH_PREFIXES))
            parts = name.split(".")
            if len(parts) >= 2 and parts[-1] in self.cfg.device_handles:
                return True
        func = node.func
        if isinstance(func, ast.Attribute) \
                and func.attr not in HOST_METHODS:
            return self.is_tensor(func.value)
        return False

    def is_host_value(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Constant, ast.List, ast.Dict, ast.Set,
                             ast.ListComp, ast.DictComp, ast.SetComp,
                             ast.GeneratorExp, ast.JoinedStr)):
            return True
        if isinstance(node, ast.Tuple):
            return all(self.is_host_value(e) for e in node.elts)
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            root = dotted_root(node.func)
            if name.split(".")[0] in self.cfg.host_numpy_roots:
                return True
            if root in HOST_ROOTS and isinstance(node.func, ast.Name):
                return True
            if name.startswith("math.") or name.startswith("time."):
                return True
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in HOST_METHODS:
                return True
        if _is_static_read(node):
            return True
        return False

    def is_tensor(self, node: ast.AST) -> bool:
        """Whether `node` evaluates to a tensor, as far as the tags tell."""
        if isinstance(node, ast.Name):
            return self.tagged(node.id)
        if isinstance(node, ast.Call):
            return self.is_producer_call(node)
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            if _is_static_read(node):
                return False
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return any(self.is_tensor(x)
                       for x in [node.left] + list(node.comparators))
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        return False

    def is_reduction(self, node: ast.AST, strict: bool = False) -> bool:
        """A reduction of a tensor, or (unless `strict`) `x.any()` /
        `x.all()` on a receiver not known to be a host value."""
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            return False
        attr, recv = node.func.attr, node.func.value
        if dotted_root(recv) in self.cfg.host_numpy_roots:
            return False
        if attr in TRUTH_REDUCTIONS and not strict:
            root = dotted_root(recv)
            return not (self.is_host_value(recv)
                        or (root is not None and self.host_tagged(root)
                            and isinstance(recv, ast.Name)))
        return attr in REDUCTIONS and self.is_tensor(recv)

    def is_truth_tensor(self, node: ast.AST) -> bool:
        """Whether Python asks a tensor for its truth value when `node`
        is used as a test."""
        if isinstance(node, ast.BoolOp):
            return any(self.is_truth_tensor(v) for v in node.values)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return self.is_truth_tensor(node.operand)
        return self.is_reduction(node) or self.is_tensor(node)


def _target_names(t: ast.AST) -> List[str]:
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in t.elts:
            out.extend(_target_names(e))
        return out
    if isinstance(t, ast.Starred):
        return _target_names(t.value)
    return []


def _to_cpu(node: ast.Call) -> bool:
    """`x.to("cpu")`, `x.to(device="cpu")`, `x.to(torch.device("cpu"))`."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    cands = list(node.args[:1]) + [kw.value for kw in node.keywords
                                   if kw.arg == "device"]
    for c in cands:
        if isinstance(c, ast.Call) and dotted_name(c.func) == "torch.device" \
                and c.args:
            c = c.args[0]
        if isinstance(c, ast.Constant) and isinstance(c.value, str) \
                and c.value.split(":")[0] == "cpu":
            return True
    return False


def sync_of_call(node: ast.Call, tags: Tags, cfg: Config,
                 strict: bool = False) -> Optional[str]:
    """What sync a call is (for the message), or None. `strict` counts
    only tensors the tags know (no `x.any()` on an unknown receiver)."""
    name = dotted_name(node.func)
    if name in SYNC_FUNCS:
        return name + "()"
    if isinstance(node.func, ast.Attribute):
        if node.func.attr in SYNC_METHODS:
            return "." + node.func.attr + "()"
        if _to_cpu(node):
            return '.to("cpu")'
    if name is not None and name.split(".")[0] in cfg.host_numpy_roots \
            and name.split(".")[-1] in ("asarray", "array") and node.args:
        arg = node.args[0]
        if tags.is_tensor(arg) or any(
                isinstance(n, ast.Name) and tags.tagged(n.id)
                for n in ast.walk(arg)):
            return name + "() of a tensor"
    if isinstance(node.func, ast.Name) and node.func.id in CASTS \
            and node.args:
        arg = node.args[0]
        if tags.is_reduction(arg, strict) or tags.is_tensor(arg):
            return "%s() of a tensor" % node.func.id
    return None


def _emit_tensor(node: ast.Call, tags: Tags, cfg: Config) -> Optional[str]:
    """A tensor-tagged name in a tracer emit's arguments. Names that are
    the receiver of an attribute read (``adm.slot``, ``req.uid``) are
    exempt: those read host-side mirror fields."""
    if not (isinstance(node.func, ast.Attribute)
            and node.func.attr in cfg.obs_emit_methods):
        return None
    recv = dotted_name(node.func.value)
    if recv is None or cfg.obs_emit_receiver_hint not in recv:
        return None
    exprs = list(node.args) + [kw.value for kw in node.keywords]
    owners = set()
    for e in exprs:
        for sub in ast.walk(e):
            if isinstance(sub, ast.Attribute) \
                    and isinstance(sub.value, ast.Name):
                owners.add(id(sub.value))
    for e in exprs:
        for sub in ast.walk(e):
            if isinstance(sub, ast.Name) and id(sub) not in owners \
                    and tags.tagged(sub.id):
                return "tensor %r in %s.%s() emit args" % (
                    sub.id, recv, node.func.attr)
    return None


def syncing_functions(sf: SourceFile, cfg: Config) -> Set[Tuple]:
    """(class name or None, function name) of the module's functions and
    methods whose own bodies hold a sync (`sync_of_call`, strict) that
    no ``ok(host-sync: ...)`` / ``ok(step-sync: ...)`` annotation
    accounts for already."""
    out: Set[Tuple] = set()

    def annotated(line: int) -> bool:
        return any(sup.rule in (RULE, "step-sync")
                   for sup in sf.suppressions.get(line, []))

    def scan(fn, owner) -> None:
        tags = Tags(fn, cfg)
        if any(isinstance(n, ast.Call) and not annotated(n.lineno)
               and sync_of_call(n, tags, cfg, strict=True)
               for n in ast.walk(fn)):
            out.add((owner, fn.name))

    tree = sf.tree
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan(node, None)
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scan(m, node.name)
    return out


class ScopedSyncVisitor(ast.NodeVisitor):
    """Walks a module, and inside the functions whose qualnames match
    `quals` (nested defs inherit) reports each sync as `rule`. With
    `loops_only`, only syncs lexically inside a `for` / `while` of the
    scope count (the hot loops); otherwise the whole body does."""

    def __init__(self, sf: SourceFile, cfg: Config, quals: Iterable[str],
                 rule: str, loops_only: bool) -> None:
        self.sf = sf
        self.cfg = cfg
        self.quals = list(quals)
        self.rule = rule
        self.loops_only = loops_only
        self.stack: List[str] = []
        self.scope: List[str] = []      # entered scope's qualname
        self.depth = 0                  # >0: inside a scoped function
        self.loop_depth = 0
        self.tags: List[Tags] = []
        self.hits: List[Tuple[ast.AST, str, str]] = []
        self.classes = [n.name for n in sf.tree.body
                        if isinstance(n, ast.ClassDef)]
        self.syncing = syncing_functions(sf, cfg)
        self.owner: List[Optional[str]] = [None]

    def _enters(self, qn: str) -> bool:
        if self.loops_only:
            return qn in self.quals
        return any(qualname_matches(qn, q) for q in self.quals)

    def _visit_fn(self, node) -> None:
        self.stack.append(node.name)
        qn = ".".join(self.stack)
        entering = self.depth == 0 and self._enters(qn)
        if entering:
            self.tags.append(Tags(node, self.cfg, self.classes))
            self.scope.append(qn)
        if entering or self.depth:
            self.depth += 1
        saved = self.loop_depth
        if entering:
            self.loop_depth = 0
        try:
            self.generic_visit(node)
        finally:
            self.loop_depth = saved
            if self.depth:
                self.depth -= 1
            if entering:
                self.tags.pop()
                self.scope.pop()
            self.stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.owner.append(node.name)
        try:
            self.generic_visit(node)
        finally:
            self.owner.pop()
            self.stack.pop()

    def _calls_syncing(self, node: ast.Call) -> Optional[str]:
        """A call of a same-module function or method that syncs."""
        f = node.func
        if isinstance(f, ast.Name) and (None, f.id) in self.syncing:
            return "%s() (it syncs)" % f.id
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            recv = f.value.id
            owner = (self.owner[-1] if recv == "self"
                     else self.tags[-1].instances.get(recv))
            if owner is not None and (owner, f.attr) in self.syncing:
                return "%s.%s() (%s.%s syncs)" % (recv, f.attr, owner,
                                                  f.attr)
        return None

    def _hit(self, node: ast.AST, what: str) -> None:
        self.hits.append((node, what, self.scope[-1]))

    def _active(self) -> bool:
        return bool(self.depth) and (not self.loops_only
                                     or self.loop_depth > 0)

    def _visit_loop(self, node) -> None:
        if self.depth:
            self.loop_depth += 1
            try:
                if isinstance(node, ast.While):
                    self._test(node.test, "a while")
                self.generic_visit(node)
            finally:
                self.loop_depth -= 1
        else:
            self.generic_visit(node)

    visit_For = _visit_loop
    visit_While = _visit_loop
    visit_AsyncFor = _visit_loop

    def _test(self, test: ast.AST, what: str) -> None:
        if self._active() and self.tags[-1].is_truth_tensor(test):
            self._hit(test, "a tensor as the test of %s" % what)

    def visit_If(self, node: ast.If) -> None:
        self._test(node.test, "an if")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._test(node.test, "a conditional expression")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._test(node.test, "an assert")
        self.generic_visit(node)

    def visit_BoolOp(self, node: ast.BoolOp) -> None:
        if self._active() and any(self.tags[-1].is_truth_tensor(v)
                                  for v in node.values[:-1]):
            self._hit(node, "a tensor as an operand of and / or")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self._active():
            what = sync_of_call(node, self.tags[-1], self.cfg) \
                or _emit_tensor(node, self.tags[-1], self.cfg) \
                or self._calls_syncing(node)
            if what:
                self._hit(node, what)
        self.generic_visit(node)

    def findings(self, message: str) -> List[Finding]:
        """One finding per line (a cast around a flagged read would
        otherwise report twice); `message` is formatted with `what` (the
        sync) and `scope` (the entered function's qualname)."""
        seen: Set[int] = set()
        out: List[Finding] = []
        for node, what, scope in self.hits:
            if node.lineno in seen:
                continue
            seen.add(node.lineno)
            out.append(Finding(rule=self.rule, path=self.sf.path,
                               line=node.lineno,
                               message=message.format(what=what,
                                                      scope=scope)))
        return out


def check_host_sync(sf: SourceFile, cfg: Config) -> List[Finding]:
    hot = scoped_quals(sf.path, cfg.hot_functions)
    if not hot:
        return []
    v = ScopedSyncVisitor(sf, cfg, hot, RULE, loops_only=True)
    v.visit(sf.tree)
    return v.findings("{what} inside a per-step hot loop serializes the "
                      "pipelined step; annotate its place in the pipeline "
                      "or move it off-step")
