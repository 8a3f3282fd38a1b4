"""pslint engine: file walking, pragma suppression, baseline handling
(the port of lint/core.py; nothing here depends on the language the
linted code targets, so it gives the JAX package's linter's results on
the same sources).

Baseline findings are keyed on (rule, path, stripped-source-line) rather
than line numbers, so unrelated edits above a legacy finding don't
invalidate the baseline; duplicates are matched as a multiset (two
identical offending lines need two baseline entries).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .axes import discover_axes

PRAGMA_RE = re.compile(r"#\s*psl:\s*(?P<body>[^#]*)")
# tolerate a space before the bracket: without it, "ignore [PSL002]"
# would word-split to a bare "ignore" and silently blanket-suppress
_IGNORE_RULES_RE = re.compile(r"ignore\s*\[([A-Z0-9, ]+)\]")

# pragma aliases: directive -> rule ids it suppresses (None = all rules)
_PRAGMA_ALIASES = {
    "ignore": None,
    "sync-ok": ("PSL004",),
    "donate-ok": ("PSL005",),
    "diverge-ok": ("PSL006", "PSL007", "PSL008"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # POSIX-style path as given on the command line
    line: int
    col: int
    message: str
    text: str  # stripped source line, the stable part of the identity

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.text)

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "text": self.text,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Finding":
        return cls(
            rule=d["rule"],
            path=d["path"],
            line=int(d.get("line", 0)),
            col=int(d.get("col", 0)),
            message=d.get("message", ""),
            text=d.get("text", ""),
        )


def _pragmas_for(src: str) -> Dict[int, Optional[Set[str]]]:
    """line number -> set of suppressed rule ids (None = all).

    Parsed from COMMENT tokens so a ``# psl:`` inside a string literal is
    never treated as a pragma.
    """
    out: Dict[int, Optional[Set[str]]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        comments = [
            (t.start[0], t.string) for t in tokens if t.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, SyntaxError, IndentationError):
        # fall back to a line scan on files tokenize rejects
        comments = [
            (i + 1, line[line.index("#"):])
            for i, line in enumerate(src.splitlines())
            if "#" in line
        ]
    for lineno, comment in comments:
        m = PRAGMA_RE.search(comment)
        if not m:
            continue
        body = m.group("body").strip()
        rules: Optional[Set[str]] = set()
        for bracket in _IGNORE_RULES_RE.finditer(body):
            rules.update(r.strip() for r in bracket.group(1).split(",") if r.strip())
        for word in re.split(r"[,\s]+", _IGNORE_RULES_RE.sub("", body)):
            if not word:
                continue
            alias = _PRAGMA_ALIASES.get(word)
            if word in _PRAGMA_ALIASES and alias is None:
                rules = None  # blanket ignore
                break
            if alias:
                rules.update(alias)
        if rules is None or rules:
            prev = out.get(lineno, set())
            out[lineno] = (
                None if (rules is None or prev is None) else (prev | rules)
            )
    return out


_COMPOUND_STMTS = (
    ast.For, ast.AsyncFor, ast.While, ast.If, ast.With, ast.AsyncWith,
    ast.Try, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
)


def _simple_stmt_spans(tree: ast.AST) -> List[Tuple[int, int]]:
    """(start, end) line spans of every non-compound statement, sorted —
    the ranges a line-level pragma extends over.

    Decorator expressions get their own spans: they hang off a compound
    statement (the decorated def/class), so without this a pragma on the
    closing line of a formatter-wrapped ``@torch.compile(...)`` would
    not reach a finding anchored to the decorator's first line."""
    spans = [
        (n.lineno, n.end_lineno or n.lineno)
        for n in ast.walk(tree)
        if isinstance(n, ast.stmt) and not isinstance(n, _COMPOUND_STMTS)
    ]
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            for dec in n.decorator_list:
                spans.append((dec.lineno, dec.end_lineno or dec.lineno))
    spans.sort()
    return spans


def _span_for(spans: List[Tuple[int, int]], lineno: int) -> Tuple[int, int]:
    """Smallest simple-statement span containing `lineno` as a half-open
    line range (falls back to the single line)."""
    best: Optional[Tuple[int, int]] = None
    for start, end in spans:
        if start <= lineno <= end and (
            best is None or (end - start) < (best[1] - best[0])
        ):
            best = (start, end)
    if best is None:
        return (lineno, lineno + 1)
    return (best[0], best[1] + 1)


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", "node_modules")
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif p.endswith(".py"):
            yield p


def lint_source(
    src: str,
    path: str,
    axes: Dict[str, str],
    donors: Optional[Dict[str, Tuple[int, ...]]] = None,
    tree: Optional[ast.AST] = None,
    collect_donors: bool = True,
) -> List[Finding]:
    """Run every rule over one module's source. Pragma-filtered.

    `tree`/`collect_donors` let lint_paths reuse its pre-pass parse and
    module-wide donor registry instead of re-doing both per file."""
    from .rules import RULES, collect_donor_factories

    if tree is None:
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            line = e.lineno or 0
            lines = src.splitlines()
            text = lines[line - 1].strip() if 0 < line <= len(lines) else ""
            return [
                Finding("PSL000", path, line, e.offset or 0,
                        f"syntax error: {e.msg}", text)
            ]
    lines = src.splitlines()
    pragmas = _pragmas_for(src)
    spans = _simple_stmt_spans(tree)
    donors = dict(donors or {})
    if collect_donors:
        donors.update(collect_donor_factories(tree))

    def suppressed(rule_id: str, lineno: int) -> bool:
        # a pragma anywhere on the finding's (simple) statement applies,
        # so `# psl: sync-ok` after the closing paren of a wrapped call
        # keeps working when a formatter splits the line
        for ln in range(*_span_for(spans, lineno)):
            if ln not in pragmas:
                continue
            sup = pragmas[ln]
            if sup is None or rule_id in sup:  # None = blanket ignore
                return True
        return False

    def stmt_text(lineno: int) -> str:
        # the WHOLE (simple) statement, joined: a formatter-wrapped
        # `return torch.compile(` first line alone would alias every other
        # wrapped compile call in the file in the baseline's multiset key
        start, end_excl = _span_for(spans, lineno)
        start = max(start, 1)
        joined = " ".join(
            l.strip() for l in lines[start - 1:end_excl - 1] if l.strip()
        )
        return joined[:300]

    findings: List[Finding] = []
    for rule in RULES:
        for (lineno, col, message) in rule.check(tree, path=path, axes=axes,
                                                donors=donors):
            if suppressed(rule.rule_id, lineno):
                continue
            findings.append(
                Finding(rule.rule_id, path, lineno, col, message,
                        stmt_text(lineno))
            )
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def scanned_files(paths: Sequence[str]) -> List[str]:
    """The deduped file list a lint run over `paths` covers — the single
    definition of 'scanned', shared by lint_paths and the CLI's
    stale-baseline scoping."""
    return list(dict.fromkeys(iter_py_files(paths)))


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    """Lint every .py file under `paths` (two passes: donor factories for
    PSL005 are collected across the whole file set first, so a file
    calling a step factory that check/contracts.py declares consuming is
    still checked)."""
    from .rules import collect_donor_factories

    axes, _ = discover_axes(paths)
    files = scanned_files(paths)
    sources: Dict[str, str] = {}
    trees: Dict[str, ast.AST] = {}
    donors: Dict[str, Tuple[int, ...]] = {}
    for fp in files:
        try:
            with open(fp, "r", encoding="utf-8") as f:
                sources[fp] = f.read()
        except (OSError, UnicodeDecodeError):
            continue
        try:
            trees[fp] = ast.parse(sources[fp])
            donors.update(collect_donor_factories(trees[fp]))
        except SyntaxError:
            pass  # lint_source re-parses and reports PSL000
    # the port's own package declares its consumed-state factories in
    # pscheck's contract specs (check/, beside parallel/): pick them up
    # even when only tests/ or one file is being linted
    for d in _sibling_donor_dirs(paths):
        for fname in sorted(os.listdir(d)):
            if not fname.endswith(".py"):
                continue
            try:
                with open(os.path.join(d, fname), "r", encoding="utf-8") as f:
                    donors.update(collect_donor_factories(ast.parse(f.read())))
            except (OSError, SyntaxError, UnicodeDecodeError):
                continue
    findings: List[Finding] = []
    for fp in files:
        if fp in sources:
            findings.extend(
                lint_source(sources[fp], fp, axes, donors,
                            tree=trees.get(fp), collect_donors=fp not in trees)
            )
    return findings


def _sibling_donor_dirs(paths: Sequence[str]) -> List[str]:
    from .axes import _candidate_axis_dirs

    out: List[str] = []
    for d in _candidate_axis_dirs(paths):
        out.append(d)
        check = os.path.join(os.path.dirname(d), "check")
        if os.path.isdir(check):
            out.append(check)
    return out


# ------------------------------------------------------------------ baseline

def to_baseline_json(findings: Sequence[Finding]) -> dict:
    return {
        "version": 1,
        "tool": "pslint",
        "findings": [f.to_json() for f in findings],
    }


def load_baseline(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return [Finding.from_json(d) for d in data.get("findings", [])]


def baseline_counts(findings: Sequence[Finding]) -> Counter:
    return Counter(f.key for f in findings)


def apply_baseline(
    findings: Sequence[Finding],
    baseline: Sequence[Finding],
    scanned_paths: Optional[Sequence[str]] = None,
) -> Tuple[List[Finding], List[Finding], List[Finding]]:
    """Split current findings into (new, baselined); also return stale
    baseline entries that no longer match anything (safe to prune).

    `scanned_paths` (the files this run actually linted) scopes the
    staleness report: an entry for a file OUTSIDE the scanned set is
    neither matchable nor stale — linting `tools/` must not report the
    package's own baseline entries as "stale" just because their files
    were not in this run's scope. None (unit tests / full-knowledge
    callers) keeps every entry eligible."""
    budget = baseline_counts(baseline)
    new: List[Finding] = []
    matched: List[Finding] = []
    for f in findings:
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
            matched.append(f)
        else:
            new.append(f)
    scanned: Optional[Set[str]] = None
    if scanned_paths is not None:
        scanned = {os.path.normpath(p) for p in scanned_paths}
    stale: List[Finding] = []
    leftovers = Counter({k: v for k, v in budget.items() if v > 0})
    for b in baseline:
        if scanned is not None and os.path.normpath(b.path) not in scanned:
            continue
        if leftovers.get(b.key, 0) > 0:
            leftovers[b.key] -= 1
            stale.append(b)
    return new, matched, stale


def render_text(
    new: Sequence[Finding],
    baselined: Sequence[Finding],
    stale: Sequence[Finding],
    verbose: bool = False,
) -> str:
    out: List[str] = []
    for f in new:
        out.append(f"{f.path}:{f.line}:{f.col}: {f.rule} {f.message}")
        if f.text:
            out.append(f"    {f.text}")
    if new:
        out.append("")
    counts = Counter(f.rule for f in new)
    summary = ", ".join(f"{r}: {n}" for r, n in sorted(counts.items()))
    out.append(
        f"pslint: {len(new)} new finding(s)"
        + (f" ({summary})" if summary else "")
        + f", {len(baselined)} baselined, {len(stale)} stale baseline entr"
        + ("y" if len(stale) == 1 else "ies")
    )
    if verbose and stale:
        out.append("stale baseline entries (prune with --write-baseline):")
        for b in stale:
            out.append(f"    {b.rule} {b.path}: {b.text}")
    return "\n".join(out)
