"""CUDA launch contracts of the kernel wrappers (the PyTorch counterpart
of `repro.analysis.rules_pallas`).

A CPU test never launches a kernel, so a wrapper whose ctypes
declaration disagrees with its ``extern "C"`` entry point, or that hands
the card a pointer to an unchecked tensor, shows only on the card — as a
crash or a silent misread. These rules check the wrappers statically:

  * ``launch-arity`` — each ``NAME = CudaKernel(SOURCE, "<symbol>",
    argtypes)`` declaration (the files of `Config.launch_files`): the
    argtypes length, folded from ``[_P] * 4 + [_I] * 7 + [_F, _P]``
    forms, equals the parameter count of ``extern "C" int
    <symbol>(...)`` in the ``.cu`` file that ``SOURCE = CudaSource(...)``
    names (resolved against the wrapper's directory from the path's
    string parts), and every direct call ``NAME(...)`` whose positional
    arguments can be counted (no ``*args``) passes that many.
  * ``launch-checked`` — in those files, each tensor whose pointer
    (``t.data_ptr()``, or ``_ptr(t)``) is taken for a launch was checked
    in the same function — passed to a checker (`Config.launch_checkers`:
    ``_check``, ``_check_q``, ``_aligned``) directly or inside a list it
    builds, or bound from one or from ``.contiguous()`` — or was
    allocated there: a ``torch.*`` factory with explicit ``device=`` and
    ``dtype=``, ``torch.*_like`` of a checked tensor, a module-level
    ``DeviceScratch`` (its dtype fixed at construction), or a value a
    same-module helper returns from any of these (its parameters count
    as checked where the call passes checked tensors). Pointers read
    inside a comparison (the alignment test ``t.data_ptr() % 16 == 0``)
    and the pointer helper's own body are not launches.
  * ``launch-flag`` — ``use_kernels=`` is never a literal at a call site
    in the package (`Config.launch_flag_scope`; tests are outside): it
    is threaded from ``ModelConfig.use_kernels`` or an argument, the
    counterpart of ``pallas-interpret``.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.config import Config, path_matches
from repro_torch.analysis.model import Finding, SourceFile, dotted_name

RULE_ARITY = "launch-arity"
RULE_CHECKED = "launch-checked"
RULE_FLAG = "launch-flag"

POINTER_HELPERS = {"_ptr"}
_FACTORIES = {"empty", "zeros", "ones", "full", "empty_strided", "rand",
              "randn", "arange"}
_LIKE = {"empty_like", "zeros_like", "ones_like", "full_like"}


def _is_launch_file(sf: SourceFile, cfg: Config) -> bool:
    return any(path_matches(sf.path, p) for p in cfg.launch_files)


# ---------------------------------------------------------------------------
# launch-arity
# ---------------------------------------------------------------------------


def fold_len(node: ast.AST) -> Optional[int]:
    """Length of a list expression built from literals, `+` and `* n`."""
    if isinstance(node, (ast.List, ast.Tuple)):
        if any(isinstance(e, ast.Starred) for e in node.elts):
            return None
        return len(node.elts)
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            a, b = fold_len(node.left), fold_len(node.right)
            return None if a is None or b is None else a + b
        if isinstance(node.op, ast.Mult):
            for seq, n in ((node.left, node.right), (node.right, node.left)):
                if isinstance(n, ast.Constant) and isinstance(n.value, int):
                    m = fold_len(seq)
                    if m is not None:
                        return m * n.value
    return None


_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def cu_param_count(text: str, symbol: str) -> Optional[int]:
    """Parameter count of `extern "C" ... symbol(...)` in CUDA source
    `text`, or None when no such definition is there."""
    text = _COMMENT_RE.sub("", text)
    m = re.search(r'extern\s+"C"\s+[^;{()]*?\b' + re.escape(symbol)
                  + r"\s*\(", text)
    if m is None:
        return None
    depth, i, start = 1, m.end(), m.end()
    while depth and i < len(text):
        depth += {"(": 1, ")": -1}.get(text[i], 0)
        i += 1
    params = text[start:i - 1].strip()
    if not params or params == "void":
        return 0
    depth, n = 0, 1
    for ch in params:
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        elif ch == "," and depth == 0:
            n += 1
    return n


def _cu_path(sf: SourceFile, call: ast.Call) -> Optional[str]:
    """The `.cu` path a `CudaSource(Path(__file__).parent / "csrc" /
    "x.cu")` names: its string parts joined under the wrapper's
    directory."""
    consts = sorted((n for n in ast.walk(call) if isinstance(n, ast.Constant)
                     and isinstance(n.value, str)),
                    key=lambda n: (n.lineno, n.col_offset))
    parts = [n.value for n in consts]
    if not parts or not parts[-1].endswith(".cu"):
        return None
    return os.path.join(os.path.dirname(sf.path), *parts).replace("\\", "/")


def _cu_text(path: str, cfg: Config) -> Optional[str]:
    for suffix, text in cfg.cuda_sources.items():
        if path_matches(path, suffix):
            return text
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return fh.read()
    except OSError:
        return None


def check_launch_arity(sf: SourceFile, cfg: Config) -> List[Finding]:
    if not _is_launch_file(sf, cfg):
        return []
    findings: List[Finding] = []
    sources: Dict[str, ast.Call] = {}
    kernels: Dict[str, Tuple[int, ast.Call]] = {}
    for stmt in sf.tree.body:
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)):
            continue
        name, call = stmt.targets[0].id, stmt.value
        cls = dotted_name(call.func) or ""
        if cls.split(".")[-1] == cfg.source_class:
            sources[name] = call
        elif cls.split(".")[-1] == cfg.kernel_class:
            if len(call.args) < 3 \
                    or not isinstance(call.args[1], ast.Constant):
                findings.append(Finding(
                    rule=RULE_ARITY, path=sf.path, line=call.lineno,
                    message="%s declaration %r needs (source, \"symbol\", "
                            "argtypes)" % (cfg.kernel_class, name)))
                continue
            symbol = call.args[1].value
            n_arg = fold_len(call.args[2])
            if n_arg is None:
                findings.append(Finding(
                    rule=RULE_ARITY, path=sf.path, line=call.lineno,
                    message="argtypes of %r do not fold to a length "
                            "(literal lists, + and * n only)" % symbol))
                continue
            kernels[name] = (n_arg, call)
            src = call.args[0]
            cu = (_cu_path(sf, sources[src.id])
                  if isinstance(src, ast.Name) and src.id in sources
                  else None)
            text = _cu_text(cu, cfg) if cu else None
            if text is None:
                findings.append(Finding(
                    rule=RULE_ARITY, path=sf.path, line=call.lineno,
                    message="cannot read the CUDA source of %r (%s)"
                            % (symbol, cu)))
                continue
            n_cu = cu_param_count(text, symbol)
            if n_cu is None:
                findings.append(Finding(
                    rule=RULE_ARITY, path=sf.path, line=call.lineno,
                    message='no extern "C" %s(...) in %s' % (symbol, cu)))
            elif n_cu != n_arg:
                findings.append(Finding(
                    rule=RULE_ARITY, path=sf.path, line=call.lineno,
                    message='argtypes of %r hold %d entries but extern "C" '
                            "%s in %s takes %d parameters"
                            % (symbol, n_arg, symbol, cu, n_cu)))
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in kernels and not node.keywords \
                and not any(isinstance(a, ast.Starred) for a in node.args):
            n_arg = kernels[node.func.id][0]
            if len(node.args) != n_arg:
                findings.append(Finding(
                    rule=RULE_ARITY, path=sf.path, line=node.lineno,
                    message="%s(...) passes %d arguments; its argtypes "
                            "declare %d" % (node.func.id, len(node.args),
                                            n_arg)))
    return findings


# ---------------------------------------------------------------------------
# launch-checked
# ---------------------------------------------------------------------------


def _names(node: Optional[ast.AST]) -> Set[str]:
    if node is None:
        return set()
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _targets(t: ast.AST) -> List[ast.AST]:
    return list(t.elts) if isinstance(t, (ast.Tuple, ast.List)) else [t]


def _params(fn) -> List[str]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


class _Module:
    """Module-level facts of a launch file: its functions and scratch
    objects."""

    def __init__(self, sf: SourceFile, cfg: Config) -> None:
        self.cfg = cfg
        self.functions: Dict[str, ast.FunctionDef] = {
            n.name: n for n in sf.tree.body
            if isinstance(n, ast.FunctionDef)}
        self.scratch: Set[str] = set()
        for stmt in sf.tree.body:
            if isinstance(stmt, ast.Assign) \
                    and isinstance(stmt.value, ast.Call) \
                    and (dotted_name(stmt.value.func) or "").split(".")[-1] \
                    in cfg.launch_scratch_classes:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.scratch.add(t.id)


class _Vouch:
    """Which names of one function are checked or explicitly allocated
    (flow-insensitive, to a fixed point)."""

    def __init__(self, fn: ast.FunctionDef, mod: _Module,
                 given: Set[str], depth: int = 0) -> None:
        self.fn = fn
        self.mod = mod
        self.depth = depth
        self.ok: Set[str] = set(given)
        self.binds: List[Tuple[ast.AST, ast.AST]] = []   # (target, value)
        self.holds: Dict[str, Set[str]] = {}   # container -> names in it
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    self.binds.append((t, node.value))
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Name):
                self.holds.setdefault(node.target.id, set()).update(
                    _names(node.value))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("append", "extend") \
                    and isinstance(node.func.value, ast.Name):
                self.holds.setdefault(node.func.value.id, set()).update(
                    *(_names(a) for a in node.args))
        for t, v in self.binds:
            if isinstance(t, ast.Name):
                self.holds.setdefault(t.id, set()).update(_names(v))
        for _ in range(6):
            before = len(self.ok)
            self._pass()
            if len(self.ok) == before:
                break

    def _checker(self, call: ast.AST) -> bool:
        if not isinstance(call, ast.Call):
            return False
        f = call.func
        if isinstance(f, ast.Name):
            return f.id in self.mod.cfg.launch_checkers
        return isinstance(f, ast.Attribute) \
            and f.attr in self.mod.cfg.launch_checkers

    def contents(self, name: str) -> Set[str]:
        """Names held in container `name`, transitively."""
        out, todo = set(), [name]
        while todo:
            n = todo.pop()
            for m in self.holds.get(n, ()):
                if m not in out:
                    out.add(m)
                    todo.append(m)
        return out

    def expr_ok(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Constant) and e.value is None:
            return True
        if isinstance(e, ast.Name):
            return e.id in self.ok
        if isinstance(e, ast.IfExp):
            return self.expr_ok(e.body) and self.expr_ok(e.orelse)
        if not isinstance(e, ast.Call):
            return False
        if self._checker(e):
            return True
        name = dotted_name(e.func) or ""
        kws = {kw.arg for kw in e.keywords}
        if name.startswith("torch.") and name.split(".")[-1] in _FACTORIES:
            return {"device", "dtype"} <= kws
        if name.startswith("torch.") and name.split(".")[-1] in _LIKE:
            return bool(e.args) and self.expr_ok(e.args[0])
        if isinstance(e.func, ast.Name) and e.func.id in self.mod.scratch:
            return True
        return False

    def _helper(self, call: ast.Call) -> Optional["_Vouch"]:
        """The vouching of a same-module helper a call reaches, with
        its parameters checked where the call passes checked names."""
        if self.depth >= 2 or not isinstance(call.func, ast.Name):
            return None
        g = self.mod.functions.get(call.func.id)
        if g is None or g is self.fn:
            return None
        params = _params(g)
        given = {p for p, a in zip(params, call.args)
                 if isinstance(a, ast.Name) and a.id in self.ok}
        return _Vouch(g, self.mod, given, self.depth + 1)

    def _returns(self, g: ast.FunctionDef) -> List[ast.AST]:
        return [n.value for n in ast.walk(g)
                if isinstance(n, ast.Return) and n.value is not None]

    def _pass(self) -> None:
        # names passed to a checker, and what the containers passed hold
        for node in ast.walk(self.fn):
            if self._checker(node):
                for a in list(node.args) + [k.value for k in node.keywords]:
                    for n in _names(a):
                        self.ok.add(n)
                        self.ok.update(self.contents(n))
        for t, v in self.binds:
            if isinstance(v, ast.Constant) and v.value is None:
                continue        # a name set to None takes no pointer
            tgts = _targets(t)
            vals = _targets(v) if isinstance(v, ast.Tuple) else None
            if isinstance(v, ast.IfExp) and isinstance(v.body, ast.Tuple):
                vals = list(v.body.elts) if self.expr_ok(v.orelse) or (
                    isinstance(v.orelse, ast.Tuple)
                    and all(self.expr_ok(x) for x in v.orelse.elts)) \
                    else None
            if vals is not None and len(vals) == len(tgts):
                for tg, val in zip(tgts, vals):
                    if isinstance(tg, ast.Name) and self.expr_ok(val):
                        self.ok.add(tg.id)
                continue
            if self.expr_ok(v):
                self.ok.update(n.id for n in tgts if isinstance(n, ast.Name))
                continue
            if isinstance(v, ast.Call):
                self._from_helper(tgts, v)

    def _from_helper(self, tgts: List[ast.AST], call: ast.Call) -> None:
        h = self._helper(call)
        if h is None:
            return
        g, params = h.fn, _params(h.fn)
        for ret in self._returns(g):
            elems = _targets(ret) if isinstance(ret, ast.Tuple) else [ret]
            if len(elems) != len(tgts):
                continue
            for tg, el in zip(tgts, elems):
                if not isinstance(tg, ast.Name):
                    continue
                if h.expr_ok(el):
                    self.ok.add(tg.id)
                # a container the helper returns: the caller's arguments
                # it holds are checked wherever the caller checks it
                if isinstance(el, ast.Name) and tg.id in self._checked():
                    held = h.contents(el.id)
                    for p, a in zip(params, call.args):
                        if p in held and isinstance(a, ast.Name):
                            self.ok.add(a.id)

    def _checked(self) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(self.fn):
            if self._checker(node):
                for a in node.args:
                    out.update(_names(a))
        return out


def _pointer_names(node: ast.Call) -> List[Tuple[str, ast.AST]]:
    """(name, node) of the tensors whose pointer this call takes."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "data_ptr" \
            and isinstance(f.value, ast.Name):
        return [(f.value.id, node)]
    if isinstance(f, ast.Name) and f.id in POINTER_HELPERS and node.args:
        out = []
        todo = [node.args[0]]
        while todo:
            e = todo.pop()
            if isinstance(e, ast.IfExp):
                todo += [e.body, e.orelse]
            elif isinstance(e, ast.Name):
                out.append((e.id, node))
        return out
    return []


def check_launch_checked(sf: SourceFile, cfg: Config) -> List[Finding]:
    if not _is_launch_file(sf, cfg):
        return []
    mod = _Module(sf, cfg)
    findings: List[Finding] = []
    for fn in ast.walk(sf.tree):
        if not isinstance(fn, ast.FunctionDef) or fn.name in POINTER_HELPERS:
            continue
        in_compare = {id(c) for cmp in ast.walk(fn)
                      if isinstance(cmp, ast.Compare)
                      for c in ast.walk(cmp) if isinstance(c, ast.Call)}
        ptrs = [(n, c) for c in ast.walk(fn) if isinstance(c, ast.Call)
                and id(c) not in in_compare for n, c in _pointer_names(c)]
        if not ptrs:
            continue
        vouch = _Vouch(fn, mod, set())
        seen: Set[Tuple[str, int]] = set()
        for name, call in ptrs:
            if name in vouch.ok or (name, call.lineno) in seen:
                continue
            seen.add((name, call.lineno))
            findings.append(Finding(
                rule=RULE_CHECKED, path=sf.path, line=call.lineno,
                message="the pointer of %r goes to a kernel launch in %r, "
                        "but %r was neither checked there (%s, "
                        ".contiguous()) nor allocated with an explicit "
                        "device= and dtype=" % (
                            name, fn.name, name,
                            ", ".join(sorted(c for c in cfg.launch_checkers
                                             if c != "contiguous")))))
    return findings


# ---------------------------------------------------------------------------
# launch-flag
# ---------------------------------------------------------------------------


def check_launch_flag(sf: SourceFile, cfg: Config) -> List[Finding]:
    norm = "/" + sf.path.replace("\\", "/")
    if not any("/" + s in norm for s in cfg.launch_flag_scope):
        return []
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg == "use_kernels" and isinstance(kw.value, ast.Constant):
                findings.append(Finding(
                    rule=RULE_FLAG, path=sf.path, line=kw.value.lineno,
                    message="use_kernels=%r hardcoded at a call site — "
                            "thread ModelConfig.use_kernels or an argument "
                            "so the card runs the kernels and the CPU "
                            "their plain versions" % kw.value.value))
    return findings
