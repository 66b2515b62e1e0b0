"""Finding / source-file model + suppression-comment parsing (a copy of
`repro.analysis.model`: the port imports nothing of the JAX package).

A `SourceFile` owns one parsed module: text, AST, and the kvlint
comment directives extracted with `tokenize` (comments are invisible to
`ast`, so suppression handling is a separate token pass).

Directive grammar (one per comment):

  ``# kvlint: ok(<rule>: <reason>)``   suppress `<rule>` on this line
                                       (or the next, for standalone
                                       comment lines); reason required.
  ``# kvlint: dormant(<reason>)``      module-level marker: this module
                                       is intentionally unreferenced
                                       seed code — the dead-module rule
                                       reports it as "dormant" instead
                                       of a violation.

Anything starting with ``kvlint:`` that doesn't parse is reported as a
`kvlint-syntax` finding — a typoed suppression must never silently
stop suppressing.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SEVERITY_ERROR = "error"
SEVERITY_INFO = "info"

_DIRECTIVE_RE = re.compile(r"#\s*kvlint:\s*(.*)$")
_OK_RE = re.compile(r"ok\(\s*([A-Za-z0-9_-]+)\s*:\s*(.+)\)\s*$")
_OK_NO_REASON_RE = re.compile(r"ok\(\s*([A-Za-z0-9_-]+)\s*:?\s*\)\s*$")
_DORMANT_RE = re.compile(r"dormant\(\s*(.+)\)\s*$")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    severity: str = SEVERITY_ERROR
    suppressed: bool = False
    suppress_reason: Optional[str] = None

    @property
    def is_violation(self) -> bool:
        return self.severity == SEVERITY_ERROR and not self.suppressed

    def render(self) -> str:
        tag = ""
        if self.suppressed:
            tag = " [suppressed: %s]" % (self.suppress_reason or "")
        elif self.severity == SEVERITY_INFO:
            tag = " [info]"
        return "%s:%d: %s: %s%s" % (self.path, self.line, self.rule,
                                    self.message, tag)

    def as_dict(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "message": self.message, "severity": self.severity,
            "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
        }


@dataclass
class Suppression:
    rule: str
    reason: str
    line: int            # line the directive covers (code line)
    used: bool = False


@dataclass
class SourceFile:
    """One parsed module plus its kvlint directives."""

    path: str            # as reported in findings (relative if possible)
    text: str
    tree: ast.Module
    # line -> directives covering that line
    suppressions: Dict[int, List[Suppression]] = field(default_factory=dict)
    dormant_reason: Optional[str] = None
    syntax_findings: List[Finding] = field(default_factory=list)

    @classmethod
    def parse(cls, path: str, text: str) -> "SourceFile":
        tree = ast.parse(text, filename=path)
        sf = cls(path=path, text=text, tree=tree)
        sf._scan_directives()
        return sf

    def _scan_directives(self) -> None:
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except tokenize.TokenError:
            return
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _DIRECTIVE_RE.search(tok.string)
            if not m:
                continue
            body = m.group(1).strip()
            line = tok.start[0]
            # a standalone comment line covers the next code line too
            standalone = self.text.splitlines()[line - 1].lstrip() \
                .startswith("#")
            ok = _OK_RE.match(body)
            if ok:
                sup = Suppression(rule=ok.group(1),
                                  reason=ok.group(2).strip(), line=line)
                self.suppressions.setdefault(line, []).append(sup)
                if standalone:
                    self.suppressions.setdefault(line + 1, []).append(sup)
                continue
            dormant = _DORMANT_RE.match(body)
            if dormant:
                self.dormant_reason = dormant.group(1).strip()
                continue
            no_reason = _OK_NO_REASON_RE.match(body)
            if no_reason:
                self.syntax_findings.append(Finding(
                    rule="kvlint-syntax", path=self.path, line=line,
                    message="suppression for %r requires a reason: "
                            "# kvlint: ok(%s: <why this is safe>)"
                            % (no_reason.group(1), no_reason.group(1))))
                continue
            self.syntax_findings.append(Finding(
                rule="kvlint-syntax", path=self.path, line=line,
                message="unparseable kvlint directive %r — expected "
                        "ok(<rule>: <reason>) or dormant(<reason>)" % body))

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        for sup in self.suppressions.get(line, []):
            if sup.rule == rule:
                sup.used = True
                return sup
        return None

    def apply_suppressions(self, findings: List[Finding]) -> List[Finding]:
        out = []
        for f in findings:
            sup = self.suppression_for(f.rule, f.line)
            if sup is not None:
                f = Finding(rule=f.rule, path=f.path, line=f.line,
                            message=f.message, severity=f.severity,
                            suppressed=True, suppress_reason=sup.reason)
            out.append(f)
        return out


def node_source(sf: SourceFile, node: ast.AST) -> str:
    """Best-effort source text of a node (for receiver matching)."""
    try:
        return ast.get_source_segment(sf.text, node) or ""
    except Exception:
        return ""


class QualnameVisitor(ast.NodeVisitor):
    """Walk a module tracking `Class.method`-style qualified names.

    Subclasses override `visit_scoped` hooks via `handle(node, qualname,
    stack)`; nested functions extend the dotted path
    (`Engine.generate_continuous.admit_into`).
    """

    def __init__(self) -> None:
        self.stack: List[str] = []

    def qualname(self) -> str:
        return ".".join(self.stack)

    def _scoped(self, node: ast.AST, name: str) -> None:
        self.stack.append(name)
        try:
            self.generic_visit(node)
        finally:
            self.stack.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scoped(node, node.name)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._scoped(node, node.name)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._scoped(node, node.name)


def dotted_root(node: ast.AST) -> Optional[str]:
    """Root name of a Name/Attribute/Subscript/Call chain (`a.b.c` -> `a`)."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` attribute chain as a string, None for anything fancier."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
