"""hvdlint core: rule registry, suppression handling, baseline, CLI.

Counterpart of horovod_tpu/analysis/core.py, pointed at the port. The
engine is import-light: rules operate on ``ast`` trees plus raw text, so
``python -m horovod_tpu_torch.analysis`` runs without torch touching a
card.

Vocabulary (docs/static-analysis.md, shared with the JAX package):

- **AST rule** — per-file check over a parsed module (``AstRule``).
- **Project rule** — whole-tree parity check (``ProjectRule``), e.g. the
  metric-family↔docs table check folded in from bin/check_metrics_docs.py.
- **Suppression** — ``# hvdlint: disable=HVD001`` on the offending line,
  ``# hvdlint: disable-next-line=HVD001`` on the line above, or
  ``# hvdlint: disable-file=HVD001`` anywhere in the file. Every
  suppression should carry a justification after the rule list.
- **Baseline** — ``.hvdlint-torch-baseline`` entries ``RULE path:line
  # why`` grandfathering findings the tree has not yet paid down. The
  port's own file, so ``--write-baseline`` never touches the JAX
  package's ``.hvdlint-baseline``. None ships; keep it that way.
"""

import argparse
import ast
import json
import os
import re
import sys
from dataclasses import dataclass, field

DEFAULT_PATHS = ("horovod_tpu_torch",)
BASELINE_DEFAULT = ".hvdlint-torch-baseline"

# ``# hvdlint: disable=HVD001,HVD002 -- justification``
_SUPPRESS_RE = re.compile(
    r"#\s*hvdlint:\s*(disable|disable-next-line|disable-file)"
    r"\s*=\s*([A-Za-z0-9_,\s]+)")


@dataclass(frozen=True)
class Finding:
    """One lint hit. ``path`` is repo-relative with ``/`` separators so
    baselines and CI output are stable across machines."""
    rule: str
    path: str
    line: int
    col: int
    message: str
    hint: str = ""

    @property
    def key(self):
        return f"{self.rule} {self.path}:{self.line}"

    def render(self, with_hint=True):
        out = f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"
        if with_hint and self.hint:
            out += f"\n    hint: {self.hint}"
        return out


class AstRule:
    """Per-file rule. Subclasses set ``rule_id``/``name``/``hint`` and
    implement ``check(tree, text, path) -> iterable[Finding]``."""

    rule_id = "HVD000"
    name = "unnamed"
    hint = ""

    def finding(self, path, node, message, hint=None):
        return Finding(self.rule_id, path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0) + 1, message,
                       self.hint if hint is None else hint)

    def check(self, tree, text, path):  # pragma: no cover - interface
        raise NotImplementedError


class ProjectRule:
    """Whole-tree rule. Subclasses implement ``check(root)``."""

    rule_id = "HVD100"
    name = "unnamed"
    hint = ""

    def check(self, root):  # pragma: no cover - interface
        raise NotImplementedError


_RULES = {}


def register(rule_cls):
    """Class decorator: add a rule to the process-wide registry."""
    inst = rule_cls()
    if inst.rule_id in _RULES:
        raise ValueError(f"duplicate rule id {inst.rule_id}")
    _RULES[inst.rule_id] = inst
    return rule_cls


def all_rules():
    """Registered rules, id-sorted. Importing ``.rules`` populates the
    registry; done lazily so ``core`` stays importable standalone."""
    if not _RULES:
        from . import rules  # noqa: F401 - registration side effect
    return [_RULES[k] for k in sorted(_RULES)]


# ---------------------------------------------------------------- suppression

def parse_suppressions(text):
    """(file_wide: set[str], by_line: dict[int, set[str]]) for one file.
    ``all`` suppresses every rule."""
    file_wide = set()
    by_line = {}
    for i, raw in enumerate(text.splitlines(), start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        kind = m.group(1)
        rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
        if kind == "disable-file":
            file_wide |= rules
        elif kind == "disable-next-line":
            by_line.setdefault(i + 1, set()).update(rules)
        else:
            by_line.setdefault(i, set()).update(rules)
    return file_wide, by_line


def _suppressed(finding, file_wide, by_line):
    for rules in (file_wide, by_line.get(finding.line, ())):
        if "all" in rules or finding.rule in rules:
            return True
    return False


# ------------------------------------------------------------------ baseline

def load_baseline(path):
    """Baseline entries as a set of ``RULE path:line`` keys. Missing file
    == empty baseline. Lines are ``RULE path:line`` with an optional
    ``# justification`` tail (required by review policy, not by the
    parser)."""
    entries = set()
    if not path or not os.path.exists(path):
        return entries
    with open(path, encoding="utf-8") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 2 or ":" not in parts[1]:
                raise ValueError(
                    f"malformed baseline entry {raw.rstrip()!r} in {path} "
                    "(expected 'RULE path:line  # justification')")
            entries.add(f"{parts[0]} {parts[1]}")
    return entries


def format_baseline(findings):
    lines = ["# hvdlint baseline — grandfathered findings.",
             "# Every entry needs a justification; new code must not add",
             "# entries (fix or inline-suppress with a reason instead).", ""]
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        lines.append(f"{f.rule} {f.path}:{f.line}  # TODO justify")
    return "\n".join(lines) + "\n"


# -------------------------------------------------------------------- runner

def _iter_py_files(root, paths):
    for p in paths:
        abs_p = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(abs_p):
            yield abs_p
            continue
        for dirpath, dirnames, filenames in os.walk(abs_p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git",
                                              "build", "scratch"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def lint_file(path, root, rules=None, text=None):
    """All (unsuppressed) findings for one file."""
    rules = [r for r in (rules or all_rules()) if isinstance(r, AstRule)]
    if text is None:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    try:
        tree = ast.parse(text, filename=rel)
    except SyntaxError as e:
        return [Finding("HVD000", rel, e.lineno or 1, (e.offset or 0) + 1,
                        f"syntax-error: {e.msg}",
                        "hvdlint parses every file it lints")]
    file_wide, by_line = parse_suppressions(text)
    out = []
    for rule in rules:
        for f in rule.check(tree, text, rel):
            if not _suppressed(f, file_wide, by_line):
                out.append(f)
    return out


def lint_tree(root, paths=None, rules=None, project=True):
    """Findings for the whole tree: AST rules over ``paths`` plus the
    project (parity) rules over ``root``."""
    rules = rules or all_rules()
    findings = []
    for path in _iter_py_files(root, paths or DEFAULT_PATHS):
        findings.extend(lint_file(path, root, rules=rules))
    if project:
        for rule in rules:
            if isinstance(rule, ProjectRule):
                findings.extend(rule.check(root))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis",
        description="hvdlint: framework-invariant static analysis for the "
                    "port's collective engine (docs/static-analysis.md)")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files/dirs to lint (default: horovod_tpu_torch)")
    ap.add_argument("--root", default=os.getcwd(),
                    help="repo root (default: cwd)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {BASELINE_DEFAULT} "
                         "under --root when present)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "instead of failing")
    ap.add_argument("--select", default="",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--json", dest="json_out", default="",
                    help="also write findings as JSON to this path")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--no-project", action="store_true",
                    help="skip whole-tree parity rules")
    args = ap.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            kind = "project" if isinstance(r, ProjectRule) else "ast"
            print(f"{r.rule_id}  {r.name:24s} [{kind}]  {r.hint}")
        return 0
    if args.select:
        want = {s.strip() for s in args.select.split(",") if s.strip()}
        unknown = want - {r.rule_id for r in rules}
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.rule_id in want]

    root = os.path.abspath(args.root)
    baseline_path = args.baseline
    if baseline_path is None:
        cand = os.path.join(root, BASELINE_DEFAULT)
        baseline_path = cand if os.path.exists(cand) else ""
    findings = lint_tree(root, paths=args.paths, rules=rules,
                         project=not args.no_project)

    if args.write_baseline:
        path = baseline_path or os.path.join(root, BASELINE_DEFAULT)
        with open(path, "w", encoding="utf-8") as f:
            f.write(format_baseline(findings))
        print(f"wrote {len(findings)} baseline entr"
              f"{'y' if len(findings) == 1 else 'ies'} to {path}")
        return 0

    baseline = load_baseline(baseline_path)
    fresh = [f for f in findings if f.key not in baseline]
    stale = baseline - {f.key for f in findings}
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump([f_.__dict__ for f_ in fresh], f, indent=1)
    for f in fresh:
        print(f.render())
    if stale:
        print(f"note: {len(stale)} baseline entr"
              f"{'y is' if len(stale) == 1 else 'ies are'} stale (fixed) — "
              "prune them:", file=sys.stderr)
        for k in sorted(stale):
            print(f"  {k}", file=sys.stderr)
    if fresh:
        print(f"\nhvdlint: {len(fresh)} finding"
              f"{'' if len(fresh) == 1 else 's'} "
              f"({len(findings) - len(fresh)} baselined). "
              "See docs/static-analysis.md for the rule catalog and "
              "suppression policy.", file=sys.stderr)
        return 1
    print(f"hvdlint: clean ({len(findings)} baselined, "
          f"{len(rules)} rules)")
    return 0
