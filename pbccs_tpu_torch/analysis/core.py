"""Shared infrastructure for the port's `ccs analyze` (a port of
pbccs_tpu.analysis.core).

The analyzers (conc, registry, exsafe, leases, protolint) are pure-AST
passes: they parse the port's sources, never import them, so `ccs
analyze` runs in seconds with no device, no torch, and no side effects.
The interprocedural passes additionally share the call graph in
callgraph.py and the path walker in dataflow.py; the pass registry
itself lives in __init__.py::PASSES.  This module owns what every pass
shares:

  * Finding -- one structured result (file:line, rule id, message);
  * SourceFile -- a parsed source with its inline-suppression map
    (`# ccs-analyze: ignore[RULE,...]` on the flagged line);
  * repo scanning -- which files each pass sees (code passes scan
    pbccs_tpu_torch/ and chip_smoke.py; tests and fixtures are never
    scanned);
  * small AST helpers (dotted-name resolution, module string constants)
    used by more than one pass.

Rule ids are stable API, shared with pbccs_tpu's analyzer: the
baseline file, inline suppressions, tests, and docs/DESIGN.md ("Static
analysis") all key on them.  JAX001-JAX004 are not rules here (the port
traces nothing).
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

# rule id -> one-line description (CLI --list-rules; DESIGN.md mirrors it)
RULES = {
    "CONC001": "shared attribute written from >=2 methods without holding "
               "the class lock",
    "CONC002": "blocking call (future/queue/join/socket/sleep) inside a "
               "with-lock body",
    "CONC003": "lock-acquisition-order cycle (potential deadlock) across "
               "classes/modules",
    "REG001": "metric registered in code but missing from the DESIGN.md "
              "metrics table",
    "REG002": "metric listed in the DESIGN.md metrics table but not "
              "registered in code",
    "REG003": "fault site marked in code but missing from the DESIGN.md "
              "fault-site table",
    "REG004": "fault site listed in the DESIGN.md fault-site table but "
              "not marked in code",
    "REG005": "CLI flag referenced in README/DESIGN but defined by no "
              "argument parser",
    "REG006": "PBCCS_* env toggle read in code but missing from the "
              "DESIGN.md env-toggle table",
    "REG007": "env toggle listed in the DESIGN.md env-toggle table but "
              "read by no code",
    "REG008": "fault-kind vocabulary (faults.FAULT_KINDS) drifted from "
              "the DESIGN.md fault-kinds table",
    "REG009": "CLI flag defined by a pbccs_tpu_torch argument parser "
              "but missing from the DESIGN.md flags table",
    "REG010": "trace span name drifted from the DESIGN.md span table "
              "(recorded but undocumented, or documented but never "
              "recorded)",
    "REG011": "perf-ledger schema (obs.ledger.LEDGER_FIELDS) drifted "
              "from the DESIGN.md ledger-schema table (field or "
              "tolerance class disagrees, either direction)",
    "REG012": "tunable-knob inventory (tune.space.KNOB_TARGETS) drifted "
              "from the DESIGN.md knobs table (knob or target disagrees, "
              "either direction)",
    "EXC001": "bare `except:` clause",
    "EXC002": "silent `except Exception/BaseException: pass` without a "
              "stated reason",
    "ATM001": "user-visible output written without tmp+fsync+rename "
              "(route through resources.atomic_output or a registered "
              "journal contract)",
    "ATM002": "half an atomic publish: temp-staged write never "
              "renamed/fsynced, or a rename publish with no fsync in "
              "scope",
    "LSE001": "acquired lease/slot/fd not released on some "
              "return/fall-through path (or a scope factory called "
              "without `with`)",
    "LSE002": "acquired lease/slot/fd leaks on an exception path (no "
              "releasing finally/except in the function)",
    "PRO001": "wire-protocol drift against the serve/protocol.py "
              "WIRE_* spec tables (verbs/replies/errors/handlers)",
    "PRO002": "protocol handler completes a request zero times or "
              "more than once on some path",
    "PRO003": "`*_locked` ownership contract violated (called without "
              "the owning lock, or re-acquires it inside)",
    "ANA001": "stale baseline suppression matching no current finding",
    "ANA002": "source file fails to parse",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result, stable-keyed for baselines and tests."""

    rule: str
    path: str       # repo-relative, posix separators
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


_SUPPRESS_RE = re.compile(
    r"#\s*ccs-analyze:\s*ignore\[([A-Za-z0-9*,\s]+)\]")


@dataclasses.dataclass
class SourceFile:
    """A parsed source file plus its inline-suppression map."""

    path: pathlib.Path          # absolute
    rel: str                    # repo-relative posix path
    text: str
    tree: ast.Module
    # line -> rule ids suppressed there ("*" suppresses every rule)
    suppressions: dict[int, set[str]]

    def line_text(self, lineno: int) -> str:
        lines = self.text.splitlines()
        return lines[lineno - 1] if 0 < lineno <= len(lines) else ""


def _inline_suppressions(text: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out.setdefault(i, set()).update(rules)
            if line.strip().startswith("#"):
                # a comment-only suppression covers the NEXT line too
                out.setdefault(i + 1, set()).update(rules)
    return out


def load_source(path: pathlib.Path, root: pathlib.Path
                ) -> tuple[SourceFile | None, Finding | None]:
    """Parse one file; a syntax error becomes an ANA002 finding (the
    tier-1 compileall gate normally catches these first)."""
    rel = path.relative_to(root).as_posix()
    try:
        text = path.read_text(encoding="utf-8", errors="replace")
        tree = ast.parse(text)
    except SyntaxError as e:
        return None, Finding("ANA002", rel, e.lineno or 1,
                             f"syntax error: {e.msg}")
    return SourceFile(path, rel, text, tree,
                      _inline_suppressions(text)), None


# what the code passes scan, relative to the repo root
SCAN_ROOTS = ("pbccs_tpu_torch", "chip_smoke.py")
SKIP_DIRS = {"__pycache__", ".git", "tests", "native", "fixtures"}


def iter_code_files(root: pathlib.Path) -> list[pathlib.Path]:
    out: list[pathlib.Path] = []
    for entry in SCAN_ROOTS:
        p = root / entry
        if p.is_file():
            out.append(p)
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not SKIP_DIRS.intersection(f.relative_to(root).parts):
                    out.append(f)
    return out


def load_sources(root: pathlib.Path,
                 paths: list[pathlib.Path] | None = None
                 ) -> tuple[list[SourceFile], list[Finding]]:
    files = paths if paths is not None else iter_code_files(root)
    sources: list[SourceFile] = []
    findings: list[Finding] = []
    for f in files:
        src, err = load_source(f, root)
        if src is not None:
            sources.append(src)
        if err is not None:
            findings.append(err)
    return sources, findings


def apply_inline_suppressions(findings: list[Finding],
                              sources: list[SourceFile]) -> list[Finding]:
    by_rel = {s.rel: s for s in sources}
    kept = []
    for f in findings:
        src = by_rel.get(f.path)
        if src is not None:
            rules = src.suppressions.get(f.line, ())
            if "*" in rules or f.rule in rules:
                continue
        kept.append(f)
    return kept


# ------------------------------------------------------------- AST helpers

def dotted_name(node: ast.AST) -> tuple[str, ...] | None:
    """`a.b.c` -> ("a","b","c"); None for anything not a pure name chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def module_str_constants(tree: ast.Module) -> dict[str, str]:
    """Top-level NAME = "literal" assignments (metric-name constants)."""
    out: dict[str, str] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            out[node.targets[0].id] = node.value.value
    return out


def const_str_arg(node: ast.expr, consts: dict[str, str]) -> str | None:
    """A call argument as a string: literal, or a module constant."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None
