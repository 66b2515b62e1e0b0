"""Analyzer driver: file loading, rule dispatch, suppression handling
(the counterpart of `repro.analysis.driver`, with the port's rules).

Per-file rules run on each module independently; project rules
(duck-parity, dead-module) run once over the whole analyzed set.
Suppressions (`# kvlint: ok(rule: reason)`) are applied after rule
execution so `--json` can report suppressed findings with their
reasons — the annotation inventory is part of the design record.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from repro_torch.analysis.config import Config, default_config
from repro_torch.analysis.model import Finding, SourceFile
from repro_torch.analysis import (rules_hygiene, rules_launch, rules_seam,
                                  rules_step, rules_sync)

FILE_RULES: List[Callable[[SourceFile, Config], List[Finding]]] = [
    rules_seam.check_release_seam,
    rules_sync.check_host_sync,
    rules_step.check_step_sync,
    rules_step.check_step_copy,
    rules_launch.check_launch_arity,
    rules_launch.check_launch_checked,
    rules_launch.check_launch_flag,
    rules_hygiene.check_unused_imports,
    rules_hygiene.check_mutable_defaults,
]

PROJECT_RULES: List[
    Callable[[Dict[str, SourceFile], Config], List[Finding]]] = [
    rules_seam.check_duck_parity,
    rules_hygiene.check_dead_modules,
]


class Analyzer:
    def __init__(self, config: Optional[Config] = None) -> None:
        self.config = config or default_config()
        self._load_errors: List[Finding] = []

    # -- loading -----------------------------------------------------------
    def load_paths(self, paths: Sequence[str]
                   ) -> Dict[str, SourceFile]:
        files: Dict[str, SourceFile] = {}
        errors: List[Finding] = []
        for path in paths:
            for fpath in sorted(self._expand(path)):
                rel = self._display_path(fpath)
                try:
                    with open(fpath, "r", encoding="utf-8") as fh:
                        text = fh.read()
                    files[rel] = SourceFile.parse(rel, text)
                except SyntaxError as e:
                    errors.append(Finding(
                        rule="kvlint-syntax", path=rel,
                        line=e.lineno or 1,
                        message="file does not parse: %s" % e.msg))
        self._load_errors = errors
        return files

    @staticmethod
    def _expand(path: str) -> Iterable[str]:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield path
            return
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fn in filenames:
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)

    @staticmethod
    def _display_path(path: str) -> str:
        try:
            rel = os.path.relpath(path)
        except ValueError:
            return path.replace("\\", "/")
        if not rel.startswith(".."):
            path = rel
        return path.replace("\\", "/")

    # -- running -----------------------------------------------------------
    def run(self, files: Dict[str, SourceFile]) -> List[Finding]:
        findings: List[Finding] = list(self._load_errors)
        for sf in files.values():
            per_file: List[Finding] = list(sf.syntax_findings)
            for rule in FILE_RULES:
                per_file.extend(rule(sf, self.config))
            findings.extend(sf.apply_suppressions(per_file))
        for prule in PROJECT_RULES:
            proj = prule(files, self.config)
            by_file: Dict[str, List[Finding]] = {}
            for f in proj:
                by_file.setdefault(f.path, []).append(f)
            for path, fs in by_file.items():
                sf = files.get(path)
                findings.extend(sf.apply_suppressions(fs)
                                if sf is not None else fs)
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return findings

    def analyze(self, paths: Sequence[str]) -> List[Finding]:
        return self.run(self.load_paths(paths))


def analyze_paths(paths: Sequence[str],
                  config: Optional[Config] = None) -> List[Finding]:
    return Analyzer(config).analyze(paths)


def analyze_source(text: str, path: str = "src/repro_torch/fixture.py",
                   config: Optional[Config] = None,
                   extra: Optional[Dict[str, str]] = None
                   ) -> List[Finding]:
    """Analyze in-memory sources (fixture tests). `path` chooses the
    scoping the rules see; `extra` maps additional path -> text."""
    files = {path: SourceFile.parse(path, text)}
    for p, t in (extra or {}).items():
        files[p] = SourceFile.parse(p, t)
    return Analyzer(config).run(files)
