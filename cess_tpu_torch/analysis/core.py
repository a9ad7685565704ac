"""cesslint core: findings, suppressions, baseline, and the runner.

The analysis framework behind ``python -m cess_tpu_torch.analysis``
(gated by tests/test_torch_lint.py). Three rule families plug into it:

- trace_safety.py    — side effects / host sync inside ``@jax.jit`` or
                       pallas-called bodies, dtype-literal discipline
                       (ops/, serve/);
- lock_discipline.py — guarded-attribute inference, blocking calls
                       under a held lock, lock-order cycles
                       (serve/, node/);
- determinism.py     — unordered set/dict iteration, wall-clock /
                       randomness / float arithmetic in consensus
                       state-transition modules (chain/).

Design constraints: each file is parsed ONCE and the AST is
fanned out to every applicable rule; findings carry ``file:line``, a
rule id and a fix hint; a true positive is silenced either by fixing
it, by an inline ``# cesslint: disable=<rule>`` comment on the
offending line (or the line above), or by the checked-in baseline
file (``cess_tpu_torch/analysis/cesslint_baseline.json``) for bulk
debt.

Baseline identity is LINE-NUMBER INDEPENDENT: a finding's fingerprint
is (rule, path, normalized source snippet), counted — so unrelated
edits shifting line numbers do not invalidate the baseline, while a
new instance of a baselined pattern in the same file still needs its
own entry.
"""
from __future__ import annotations

import ast
import collections
import dataclasses
import io
import json
import os
import re
import tokenize
from pathlib import PurePosixPath
from typing import Iterable, Iterator


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit: where, which rule, what, and how to fix it."""

    rule: str       # rule id, e.g. "lock-unguarded-write"
    path: str       # repo-relative posix path
    line: int       # 1-based
    col: int        # 0-based
    message: str
    fix_hint: str = ""
    snippet: str = ""   # stripped source line (fingerprint component)

    def fingerprint(self) -> str:
        """Line-number-independent identity used by the baseline."""
        return f"{self.rule}|{self.path}|{' '.join(self.snippet.split())}"

    def format(self, hints: bool = False) -> str:
        s = f"{self.path}:{self.line}:{self.col + 1}: " \
            f"[{self.rule}] {self.message}"
        if hints and self.fix_hint:
            s += f"\n    hint: {self.fix_hint}"
        return s

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """One analyzer. Subclasses set ``id``/``description``/``hint``
    and implement ``check`` (per-module) and/or ``check_project``
    (cross-module, e.g. lock-order cycles)."""

    id: str = ""
    description: str = ""
    hint: str = ""

    def applies(self, path: str) -> bool:
        return True

    def check(self, mod: "ParsedModule") -> list[Finding]:
        return []

    def check_project(self,
                      mods: "list[ParsedModule]") -> list[Finding]:
        return []

    # -- helpers shared by rule implementations -------------------------
    def finding(self, mod: "ParsedModule", node: ast.AST, message: str,
                hint: str | None = None) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=self.id, path=mod.path, line=line,
                       col=getattr(node, "col_offset", 0),
                       message=message,
                       fix_hint=self.hint if hint is None else hint,
                       snippet=mod.line(line))


_RULES: dict[str, Rule] = {}


def register(cls: type) -> type:
    """Class decorator: instantiate + add to the global rule registry."""
    rule = cls()
    if not rule.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if rule.id in _RULES:
        raise ValueError(f"duplicate rule id {rule.id}")
    _RULES[rule.id] = rule
    return cls


def all_rules() -> dict[str, Rule]:
    """The registry with every rule family imported."""
    from . import (determinism, lock_discipline, race,  # noqa: F401
                   seam_cost, sim_determinism, span_balance,
                   trace_safety, witness_purity)

    return dict(_RULES)


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def path_parts(path: str) -> tuple[str, ...]:
    return PurePosixPath(path.replace(os.sep, "/")).parts


# ---------------------------------------------------------------------------
# suppressions:  # cesslint: disable=<rule>[,<rule>...]   (or bare
# "disable" for all rules). A comment suppresses its own line; a
# comment alone on a line also suppresses the next line.
# ---------------------------------------------------------------------------
_ALL = "*"


@dataclasses.dataclass(frozen=True)
class Directive:
    """One inline ``# cesslint: disable=...`` comment — kept as an
    object (not just a line->rules map) so the stale-suppression
    audit can ask, per directive and per rule id, whether anything
    was actually silenced."""
    line: int                    # the comment's own line
    covers: tuple                # line numbers it suppresses
    rules: frozenset             # rule ids, or {_ALL}


def _parse_directives(source: str) -> list[Directive]:
    out: list[Directive] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            text = tok.string.lstrip("#").strip()
            if not text.startswith("cesslint:"):
                continue
            directive = text[len("cesslint:"):].strip()
            if not directive.startswith("disable"):
                continue
            rest = directive[len("disable"):].strip()
            if rest.startswith("="):
                # the rule list is the contiguous comma-separated ids
                # right after "="; trailing prose ("— why...") is fine
                m = re.match(r"\s*([A-Za-z0-9_\-]+"
                             r"(?:\s*,\s*[A-Za-z0-9_\-]+)*)", rest[1:])
                if not m:
                    continue
                rules = frozenset(r.strip()
                                  for r in m.group(1).split(","))
            elif rest == "":
                rules = frozenset({_ALL})
            else:
                # "disabled", "disable-next-line", ...: an unknown
                # directive must NOT silently blanket-suppress
                continue
            covers = [tok.start[0]]
            if tok.line[:tok.start[1]].strip() == "":
                covers.append(tok.start[0] + 1)   # own-line comment
            out.append(Directive(line=tok.start[0],
                                 covers=tuple(covers), rules=rules))
    except tokenize.TokenError:
        pass
    return out


def _parse_suppressions(source: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for d in _parse_directives(source):
        for ln in d.covers:
            out.setdefault(ln, set()).update(d.rules)
    return out


class ParsedModule:
    """One source file, parsed once; every rule reads the same AST."""

    def __init__(self, path: str, source: str):
        self.path = path.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self.directives = _parse_directives(source)
        self.suppressions: dict[int, set[str]] = {}
        for d in self.directives:
            for ln in d.covers:
                self.suppressions.setdefault(ln, set()).update(d.rules)

    def line(self, lineno: int) -> str:
        if 0 < lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def is_suppressed(self, finding: Finding) -> bool:
        rules = self.suppressions.get(finding.line)
        if not rules:
            return False
        return _ALL in rules or finding.rule in rules


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------
def iter_python_files(paths: Iterable[str],
                      root: str | None = None) -> Iterator[tuple[str, str]]:
    """Yield (abs_path, repo_relative_path) for every .py under paths."""
    root = os.path.abspath(root or os.getcwd())
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isfile(ap):
            files = [ap]
        else:
            files = sorted(
                os.path.join(dirpath, f)
                for dirpath, dirs, names in os.walk(ap)
                if "__pycache__" not in dirpath
                for f in names if f.endswith(".py"))
        for f in files:
            rel = os.path.relpath(f, root)
            if rel.startswith(".."):
                rel = f
            yield f, rel.replace(os.sep, "/")


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]             # active (not inline-suppressed)
    suppressed: list[Finding]           # silenced by inline comments
    errors: list[str]                   # unparseable files
    files: int = 0
    # (path, comment line, rule ids that silenced nothing) — only
    # meaningful when every rule family ran (the CLI forbids
    # --audit-suppressions on a --rule-narrowed scan)
    stale_suppressions: list = dataclasses.field(default_factory=list)


def lint_modules(mods: list[ParsedModule],
                 rules: dict[str, Rule] | None = None) -> LintResult:
    rules = rules if rules is not None else all_rules()
    by_path = {m.path: m for m in mods}
    raw: list[Finding] = []
    for mod in mods:
        for rule in rules.values():
            if rule.applies(mod.path):
                raw.extend(rule.check(mod))
    for rule in rules.values():
        applicable = [m for m in mods if rule.applies(m.path)]
        if applicable:
            raw.extend(rule.check_project(applicable))
    active, suppressed = [], []
    for f in raw:
        mod = by_path.get(f.path)
        (suppressed if mod is not None and mod.is_suppressed(f)
         else active).append(f)
    active.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    stale = []
    for mod in mods:
        for d in mod.directives:
            silenced = {f.rule for f in suppressed
                        if f.path == mod.path and f.line in d.covers
                        and (_ALL in d.rules or f.rule in d.rules)}
            if _ALL in d.rules:
                if not silenced:
                    stale.append((mod.path, d.line, (_ALL,)))
                continue
            unused = sorted(d.rules - silenced)
            if unused:
                stale.append((mod.path, d.line, tuple(unused)))
    return LintResult(findings=active, suppressed=suppressed,
                      errors=[], files=len(mods), stale_suppressions=stale)


def lint_source(source: str, path: str,
                rules: dict[str, Rule] | None = None) -> LintResult:
    """Analyze one in-memory snippet as if it lived at ``path`` (the
    path decides which rule families apply) — the fixture-test entry."""
    return lint_modules([ParsedModule(path, source)], rules)


def lint_paths(paths: Iterable[str],
               rules: dict[str, Rule] | None = None,
               root: str | None = None) -> LintResult:
    mods, errors = [], []
    for abspath, rel in iter_python_files(paths, root):
        try:
            with open(abspath, encoding="utf-8") as fh:
                mods.append(ParsedModule(rel, fh.read()))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{rel}: {e}")
    result = lint_modules(mods, rules)
    result.errors = errors
    return result


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------
def load_baseline(path: str) -> collections.Counter:
    """fingerprint -> allowed count. Missing file = empty baseline."""
    if not os.path.exists(path):
        return collections.Counter()
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return collections.Counter({e["fingerprint"]: int(e.get("count", 1))
                                for e in data.get("findings", [])})


def write_baseline(findings: list[Finding], path: str) -> None:
    counts = collections.Counter(f.fingerprint() for f in findings)
    data = {"findings": [{"fingerprint": fp, "count": n}
                         for fp, n in sorted(counts.items())]}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=1, sort_keys=True)
        fh.write("\n")


def apply_baseline(findings: list[Finding],
                   baseline: collections.Counter,
                   ) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (new, baselined)."""
    budget = collections.Counter(baseline)
    new, matched = [], []
    for f in findings:
        fp = f.fingerprint()
        if budget[fp] > 0:
            budget[fp] -= 1
            matched.append(f)
        else:
            new.append(f)
    return new, matched


# ---------------------------------------------------------------------------
# SARIF 2.1.0 export (code-review rendering: GitHub code scanning,
# VS Code SARIF viewer)
# ---------------------------------------------------------------------------
SARIF_SCHEMA_URI = ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def sarif_report(findings: list[Finding],
                 rules: dict[str, Rule] | None = None) -> dict:
    """The findings as a SARIF 2.1.0 log (one run, one driver). Rule
    metadata (description + fix hint) rides in the driver's rules
    array; each result carries ruleId, file/line/col and the
    baseline fingerprint."""
    rules = rules if rules is not None else all_rules()
    used = sorted({f.rule for f in findings})
    index = {rid: i for i, rid in enumerate(used)}
    rule_meta = []
    for rid in used:
        rule = rules.get(rid)
        entry: dict = {"id": rid}
        if rule is not None:
            entry["shortDescription"] = {"text": rule.description}
            if rule.hint:
                entry["help"] = {"text": rule.hint}
        rule_meta.append(entry)
    results = []
    for f in findings:
        message = f.message if not f.fix_hint \
            else f"{f.message} (fix: {f.fix_hint})"
        results.append({
            "ruleId": f.rule,
            "ruleIndex": index[f.rule],
            "level": "error",
            "message": {"text": message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": f.line,
                               "startColumn": f.col + 1},
                },
            }],
            "partialFingerprints": {
                "cesslint/v1": f.fingerprint(),
            },
        })
    return {
        "$schema": SARIF_SCHEMA_URI,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "cesslint",
                "informationUri":
                    "https://github.com/cess-tpu/cess-tpu",
                "rules": rule_meta,
            }},
            "results": results,
        }],
    }
