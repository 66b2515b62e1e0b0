"""Generic hygiene + the dead/dormant module inventory (a copy of
`repro.analysis.rules_hygiene` on the port's config).

  * ``unused-import``  — an imported binding never read in the module
    (`__init__.py` files are export surfaces and exempt; `__all__`
    strings count as uses).
  * ``mutable-default``— list/dict/set literals (or constructor calls)
    as parameter defaults.
  * ``dead-module``    — a module under `src/` reachable from no entry
    point (tests/, benchmarks/, examples/, a root script such as
    chip_smoke.py, `repro_torch.launch.*`, `repro_torch.analysis.*`)
    through the static import graph. `# kvlint: dormant(<reason>)` marks
    intentional seed code: reported as an informational "dormant" note
    instead of a violation, so parked subsystems stay visible without
    failing `--check`. Dynamically imported families
    (`Config.dynamic_module_prefixes`) are treated as reachable.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.config import Config
from repro_torch.analysis.model import (Finding, SEVERITY_INFO,
                                       SourceFile, dotted_name)

RULE_UNUSED = "unused-import"
RULE_MUTABLE = "mutable-default"
RULE_DEAD = "dead-module"

_MUTABLE_CTORS = {"list", "dict", "set", "defaultdict", "deque"}


# ---------------------------------------------------------------------------
# unused-import
# ---------------------------------------------------------------------------


def _imported_bindings(tree: ast.Module) -> List[Tuple[str, int, str]]:
    """(bound name, line, display) per import; skips * and __future__."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                out.append((name, node.lineno, alias.name))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                name = alias.asname or alias.name
                out.append((name, node.lineno, alias.name))
    return out


def _used_names(tree: ast.Module) -> Set[str]:
    used: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # guards string-annotation styles where only `pkg.attr`
            # appears; roots come in via the Name branch anyway
            pass
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # `__all__` entries and string annotations
            used.add(node.value)
    return used


def check_unused_imports(sf: SourceFile, cfg: Config) -> List[Finding]:
    if cfg.unused_import_skip_init and sf.path.endswith("__init__.py"):
        return []
    used = _used_names(sf.tree)
    findings = []
    for name, line, display in _imported_bindings(sf.tree):
        if name in used:
            continue
        findings.append(Finding(
            rule=RULE_UNUSED, path=sf.path, line=line,
            message="imported name %r is never used" % display))
    return findings


# ---------------------------------------------------------------------------
# mutable-default
# ---------------------------------------------------------------------------


def check_mutable_defaults(sf: SourceFile, cfg: Config) -> List[Finding]:
    findings = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            continue
        for default in (list(node.args.defaults)
                        + [d for d in node.args.kw_defaults
                           if d is not None]):
            bad = isinstance(default, (ast.List, ast.Dict, ast.Set))
            if isinstance(default, ast.Call):
                bad = dotted_name(default.func) in _MUTABLE_CTORS
            if bad:
                name = getattr(node, "name", "<lambda>")
                findings.append(Finding(
                    rule=RULE_MUTABLE, path=sf.path, line=default.lineno,
                    message="mutable default argument in %r is shared "
                            "across calls; default to None and build "
                            "inside" % name))
    return findings


# ---------------------------------------------------------------------------
# dead-module (project rule)
# ---------------------------------------------------------------------------


def _module_name(path: str) -> Optional[str]:
    """src/repro_torch/a/b.py -> repro_torch.a.b; None for non-package
    files."""
    norm = path.replace("\\", "/")
    if "/src/" in norm:
        tail = norm.rsplit("/src/", 1)[1]
    elif norm.startswith("src/"):
        tail = norm[len("src/"):]
    else:
        return None
    if not tail.endswith(".py"):
        return None
    tail = tail[:-3]
    if tail.endswith("/__init__"):
        tail = tail[: -len("/__init__")]
    return tail.replace("/", ".")


def _imports_of(sf: SourceFile, own_module: Optional[str]) -> Set[str]:
    """Dotted module names this file imports (absolute + resolved
    relative); `from pkg import name` contributes both `pkg` and
    `pkg.name` — the driver keeps whichever exists."""
    out: Set[str] = set()
    pkg = None
    if own_module is not None:
        is_pkg = sf.path.endswith("__init__.py")
        pkg = own_module if is_pkg else own_module.rsplit(".", 1)[0] \
            if "." in own_module else None
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                if pkg is None:
                    continue
                parts = pkg.split(".")
                if node.level > 1:
                    parts = parts[: -(node.level - 1)]
                base = ".".join(parts + ([node.module]
                                         if node.module else []))
            if base:
                out.add(base)
                for alias in node.names:
                    if alias.name != "*":
                        out.add(base + "." + alias.name)
    return out


def check_dead_modules(files: Dict[str, SourceFile], cfg: Config
                       ) -> List[Finding]:
    modules: Dict[str, SourceFile] = {}
    for path, sf in files.items():
        mod = _module_name(path)
        if mod is not None:
            modules[mod] = sf

    def resolve(name: str) -> Optional[str]:
        while name:
            if name in modules:
                return name
            if "." not in name:
                return None
            name = name.rsplit(".", 1)[0]
        return None

    # roots: every analyzed file outside src/ (tests, benchmarks,
    # examples, conftest) plus entry-point packages inside src/ —
    # entry-point modules are themselves reachable by definition
    roots: List[SourceFile] = []
    reachable: Set[str] = set()
    for path, sf in files.items():
        mod = _module_name(path)
        if mod is None:
            parts = [p for p in path.replace("\\", "/").split("/")
                     if p not in (".", "..")]
            if parts[0] in cfg.entry_point_dirs or len(parts) == 1:
                roots.append(sf)
        elif any(mod == p or mod.startswith(p + ".")
                 for p in cfg.entry_point_packages):
            roots.append(sf)
            reachable.add(mod)

    for mod in modules:
        if any(mod.startswith(p) for p in cfg.dynamic_module_prefixes):
            reachable.add(mod)
    queue: List[SourceFile] = list(roots) + [modules[m] for m in reachable]
    seen_files = {id(sf) for sf in queue}
    while queue:
        sf = queue.pop()
        own = _module_name(sf.path)
        for imp in _imports_of(sf, own):
            target = resolve(imp)
            if target is None or target in reachable:
                continue
            reachable.add(target)
            tf = modules[target]
            if id(tf) not in seen_files:
                seen_files.add(id(tf))
                queue.append(tf)
            # importing a submodule executes every parent __init__
            parent = target
            while "." in parent:
                parent = parent.rsplit(".", 1)[0]
                if parent in modules and parent not in reachable:
                    reachable.add(parent)
                    pf = modules[parent]
                    if id(pf) not in seen_files:
                        seen_files.add(id(pf))
                        queue.append(pf)

    findings: List[Finding] = []
    for mod in sorted(modules):
        sf = modules[mod]
        if sf.dormant_reason is not None:
            findings.append(Finding(
                rule=RULE_DEAD, path=sf.path, line=1,
                message="dormant seed module (%s)%s"
                        % (sf.dormant_reason,
                           "" if mod in reachable
                           else "; currently reachable from no entry "
                                "point"),
                severity=SEVERITY_INFO))
            continue
        if mod in reachable:
            continue
        findings.append(Finding(
            rule=RULE_DEAD, path=sf.path, line=1,
            message="module %s is reachable from no entry point "
                    "(launch/tests/benchmarks/examples); delete it or "
                    "mark it '# kvlint: dormant(<reason>)'" % mod))
    return findings
