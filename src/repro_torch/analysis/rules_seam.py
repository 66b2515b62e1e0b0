"""release-seam and duck-parity: the allocator-ownership contracts (a
copy of `repro.analysis.rules_seam` on the port's config).

release-seam — every block free goes through `Scheduler.release` (one
auditable seam); `audit_pool` catches bypasses at teardown, but only on
paths a test drives. This rule makes the seam
static: any `*.free/incref/decref(...)` call whose receiver mentions
the allocator is a violation unless its (file, enclosing-qualname) is
allowlisted in `Config.seam_allowlist`.

duck-parity — `core/cache.LayerKV` and `core/paging.PagedLayerKV`
duck-type through the eviction/flush/bias logic: every policy dispatch
reads the same metadata field names off either store. The rule strips
each NamedTuple's store-specific fields (config) and requires the
remaining metadata names to agree *in order* — a field added to one
side silently desyncs `getattr`-driven code paths long before a paged
test fails.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.config import (Config, path_matches,
                                        qualname_matches)
from repro_torch.analysis.model import (Finding, QualnameVisitor,
                                       SourceFile, node_source)

RULE_SEAM = "release-seam"
RULE_DUCK = "duck-parity"


class _SeamVisitor(QualnameVisitor):
    def __init__(self, sf: SourceFile, cfg: Config) -> None:
        super().__init__()
        self.sf = sf
        self.cfg = cfg
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (isinstance(func, ast.Attribute)
                and func.attr in self.cfg.seam_methods):
            recv = node_source(self.sf, func.value)
            if self.cfg.seam_receiver_hint in recv:
                qn = self.qualname() or "<module>"
                if not self._allowed(qn):
                    self.findings.append(Finding(
                        rule=RULE_SEAM, path=self.sf.path, line=node.lineno,
                        message="allocator.%s() outside the release seam "
                                "(from %s); route block ownership changes "
                                "through Scheduler.release / the "
                                "allowlisted modules" % (func.attr, qn)))
        self.generic_visit(node)

    def _allowed(self, qualname: str) -> bool:
        for path_pat, qn_pat in self.cfg.seam_allowlist:
            if path_matches(self.sf.path, path_pat) \
                    and qualname_matches(qualname, qn_pat):
                return True
        return False


def check_release_seam(sf: SourceFile, cfg: Config) -> List[Finding]:
    v = _SeamVisitor(sf, cfg)
    v.visit(sf.tree)
    return v.findings


# ---------------------------------------------------------------------------
# duck-parity (project-level: needs both files)
# ---------------------------------------------------------------------------


def _class_fields(sf: SourceFile, class_name: str
                  ) -> Optional[Tuple[int, List[str]]]:
    """(lineno, annotated field names in declaration order) of a
    NamedTuple-style class body, or None when the class is absent."""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            fields = [stmt.target.id for stmt in node.body
                      if isinstance(stmt, ast.AnnAssign)
                      and isinstance(stmt.target, ast.Name)]
            return node.lineno, fields
    return None


def check_duck_parity(files: Dict[str, SourceFile], cfg: Config
                      ) -> List[Finding]:
    findings: List[Finding] = []
    for a, b in cfg.duck_pairs:
        sides = []
        for side in (a, b):
            sf = next((f for p, f in files.items()
                       if path_matches(p, side.path)), None)
            if sf is None:
                continue  # pair member not in the analyzed set: skip
            got = _class_fields(sf, side.class_name)
            if got is None:
                findings.append(Finding(
                    rule=RULE_DUCK, path=sf.path, line=1,
                    message="expected class %s in %s (duck-parity config "
                            "drift?)" % (side.class_name, side.path)))
                continue
            line, fields = got
            missing_store = [s for s in side.store_fields
                             if s not in fields]
            if missing_store:
                findings.append(Finding(
                    rule=RULE_DUCK, path=sf.path, line=line,
                    message="%s no longer declares configured store "
                            "field(s) %s" % (side.class_name,
                                             ", ".join(missing_store))))
            meta = [f for f in fields if f not in side.store_fields]
            sides.append((sf, side, line, meta))
        if len(sides) != 2:
            continue
        (sf_a, side_a, line_a, meta_a), (sf_b, side_b, line_b, meta_b) = sides
        if meta_a != meta_b:
            only_a = [f for f in meta_a if f not in meta_b]
            only_b = [f for f in meta_b if f not in meta_a]
            detail = []
            if only_a:
                detail.append("only %s: %s" % (side_a.class_name,
                                               ", ".join(only_a)))
            if only_b:
                detail.append("only %s: %s" % (side_b.class_name,
                                               ", ".join(only_b)))
            if not detail:
                detail.append("order differs: %s vs %s"
                              % (meta_a, meta_b))
            findings.append(Finding(
                rule=RULE_DUCK, path=sf_b.path, line=line_b,
                message="%s/%s shared metadata fields disagree (%s) — "
                        "policy dispatch duck-types on these names"
                        % (side_a.class_name, side_b.class_name,
                           "; ".join(detail))))
    return findings
