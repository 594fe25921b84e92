"""`ccs analyze` of the port: static analysis of pbccs_tpu_torch.

A port of pbccs_tpu.analysis that reads the port's code (the
pbccs_tpu_torch package and chip_smoke.py) instead of pbccs_tpu's.  Six
AST-based passes -- concurrency lint (lock discipline, blocking-under-
lock, lock-order cycles), cross-file registry drift (metrics, fault
sites, env toggles, flags, spans, ledger fields and tuning knobs
against docs/DESIGN.md's tables, the naming contract both packages
keep; plus the exception policy), and the interprocedural trio built on
the project call graph (callgraph.py + dataflow.py): atomic-publish
safety (exsafe), lease-release safety (leases), and wire-protocol
conformance against serve/protocol.py's machine-readable spec (proto)
-- plus a committed-baseline ratchet (analysis/baseline.toml).  The
JAX tracer-hygiene pass (JAX001-JAX004) has no counterpart: its rules
check code under jax.jit, pallas_call or shard_map tracing, and the
port traces nothing.  The rules keep pbccs_tpu's ids and messages, so
both analyzers report the same findings on the same code.  Entry
points: `ccs analyze` (pbccs_tpu_torch.analysis.cli), which imports
neither torch nor the code it reads.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable

from pbccs_tpu_torch.analysis.core import (  # noqa: F401 -- public API
    RULES,
    Finding,
    SourceFile,
    apply_inline_suppressions,
    iter_code_files,
    load_sources,
)


@dataclasses.dataclass(frozen=True)
class PassSpec:
    """One registered analyzer pass: the unit of `--pass` selection,
    per-pass baseline scoping, and the DESIGN.md pass catalogue."""

    name: str
    rules: tuple[str, ...]
    run: Callable          # (sources, root, scoped) -> list[Finding]
    repo_wide: bool = False   # needs the whole repo (+docs); skipped
    # on path-scoped runs


def _run_conc(sources, root, scoped):
    from pbccs_tpu_torch.analysis.conc import analyze_conc
    return analyze_conc(sources)


def _run_exc(sources, root, scoped):
    from pbccs_tpu_torch.analysis.registry import analyze_exceptions
    return analyze_exceptions(sources)


def _run_registry(sources, root, scoped):
    from pbccs_tpu_torch.analysis.registry import analyze_registry
    return analyze_registry(sources, root)


def _run_exsafe(sources, root, scoped):
    from pbccs_tpu_torch.analysis.exsafe import analyze_exsafe
    return analyze_exsafe(sources, scoped=scoped)


def _run_leases(sources, root, scoped):
    from pbccs_tpu_torch.analysis.leases import analyze_leases
    return analyze_leases(sources)


def _run_proto(sources, root, scoped):
    from pbccs_tpu_torch.analysis.protolint import analyze_proto
    return analyze_proto(sources, scoped=scoped)


PASSES: dict[str, PassSpec] = {p.name: p for p in (
    PassSpec("conc", ("CONC001", "CONC002", "CONC003"), _run_conc),
    PassSpec("exc", ("EXC001", "EXC002"), _run_exc),
    PassSpec("registry",
             ("REG001", "REG002", "REG003", "REG004", "REG005",
              "REG006", "REG007", "REG008", "REG009", "REG010",
              "REG011", "REG012"),
             _run_registry, repo_wide=True),
    PassSpec("exsafe", ("ATM001", "ATM002"), _run_exsafe),
    PassSpec("leases", ("LSE001", "LSE002"), _run_leases),
    PassSpec("proto", ("PRO001", "PRO002", "PRO003"), _run_proto),
)}


def pass_for_rule(rule: str) -> str | None:
    for spec in PASSES.values():
        if rule in spec.rules:
            return spec.name
    return None


def run_passes(root: pathlib.Path,
               paths: list[pathlib.Path] | None = None,
               rules: set[str] | None = None,
               passes: set[str] | None = None) -> list["Finding"]:
    """Run the registered analyzers over `root` (or just `paths`),
    returning findings with inline suppressions already applied
    (baseline filtering is the CLI's job).  `rules` filters to a subset
    of ids; `passes` to a subset of registered pass names.  Repo-wide
    passes (registry drift, protocol drift) are skipped on path-scoped
    runs -- they read docs and cross-file state a file subset cannot
    represent."""
    scoped = paths is not None
    sources, findings = load_sources(root, paths)
    for spec in PASSES.values():
        if passes is not None and spec.name not in passes:
            continue
        if rules is not None and not rules.intersection(spec.rules):
            continue
        if scoped and spec.repo_wide:
            continue
        findings += spec.run(sources, root, scoped)
    findings = apply_inline_suppressions(findings, sources)
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
