"""`ccs analyze` of the port -- the CLI front end of
pbccs_tpu_torch.analysis.

    python -m pbccs_tpu_torch.analysis.cli [--root DIR] [--format text|json]
    python -m pbccs_tpu_torch.cli analyze ...      # the same, via `ccs`
    python -m pbccs_tpu_torch.analysis.cli --emit-tables   # print tables

Exit 0 when the port's code is clean modulo the committed baseline
(pbccs_tpu_torch/analysis/baseline.toml); exit 1 on any unsuppressed
finding, including stale baseline entries (ANA001); exit 2 on a usage
error, among them a pass or rule id the port does not have (the jax
pass and JAX001-JAX004 of pbccs_tpu's analyzer).  The run is pure AST
-- no imports of the analyzed code, no torch, no jax -- so it finishes
in seconds on a machine without either.  `--emit-tables` prints the
DESIGN.md tables as the port's code would fill them, and writes
nothing: docs/DESIGN.md is the contract the port is held to.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import sys
import time

from pbccs_tpu_torch.analysis import PASSES, RULES, run_passes
from pbccs_tpu_torch.analysis.baseline import (
    BaselineError,
    apply_baseline,
    load_baseline,
)

DEFAULT_BASELINE = "pbccs_tpu_torch/analysis/baseline.toml"


def _find_root(start: pathlib.Path) -> pathlib.Path:
    """Nearest ancestor that looks like the repo root (has
    pbccs_tpu_torch/)."""
    for p in (start, *start.parents):
        if (p / "pbccs_tpu_torch").is_dir():
            return p
    return start


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ccs analyze",
        description="Static analysis of the port's code: concurrency "
                    "lint, registry drift, atomic-publish safety, "
                    "lease-release safety, wire-protocol conformance.")
    p.add_argument("--root", default=None,
                   help="Repository root to analyze (default: nearest "
                        "ancestor of CWD containing pbccs_tpu_torch/).")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help=f"Suppression file (default: {DEFAULT_BASELINE} "
                        "under the root).")
    p.add_argument("--no-baseline", action="store_true",
                   help="Report raw findings, ignoring the baseline.")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="Output format. Default = %(default)s")
    p.add_argument("--rules", default=None, metavar="IDS",
                   help="Comma-separated rule ids to run (default: all).")
    p.add_argument("--pass", dest="passes", default=None, metavar="NAMES",
                   help="Comma-separated pass names to run "
                        f"({', '.join(sorted(PASSES))}); baseline "
                        "entries of other passes are out of scope for "
                        "staleness.")
    p.add_argument("--list-rules", action="store_true",
                   help="Print the rule catalogue and exit.")
    p.add_argument("--emit-tables", action="store_true",
                   help="Print the DESIGN.md metrics/fault-site/span/"
                        "env-toggle tables as the port's code fills "
                        "them and exit (DESIGN.md is not written).")
    p.add_argument("paths", nargs="*",
                   help="Specific files to analyze (default: the whole "
                        "repo).  Path-scoped runs skip the repo-wide "
                        "drift checks (REG*).")
    return p


def _mute_stdout() -> None:
    """Point stdout at /dev/null after a BrokenPipeError so the
    interpreter-exit flush does not raise again."""
    with contextlib.suppress(Exception):
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())


def run_analyze(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _run(args)
    except BrokenPipeError:
        # only the informational modes (--list-rules/--emit-tables) can
        # reach here: finding-bearing runs settle their verdict before
        # printing (see _run), so `... | head` cannot flip them to clean
        _mute_stdout()
        return 0


def _run(args) -> int:
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    root = pathlib.Path(args.root).resolve() if args.root \
        else _find_root(pathlib.Path.cwd())
    t0 = time.perf_counter()

    if args.emit_tables:
        from pbccs_tpu_torch.analysis.core import load_sources
        from pbccs_tpu_torch.analysis.registry import (
            _table_entries,
            collect_env_reads,
            collect_fault_kinds,
            collect_fault_sites,
            collect_flag_defs,
            collect_knob_targets,
            collect_ledger_fields,
            collect_metrics,
            collect_spans,
            render_env_table,
            render_fault_kinds_table,
            render_flags_table,
            render_knobs_table,
            render_ledger_table,
            render_metrics_table,
            render_sites_table,
            render_spans_table,
        )

        sources, _ = load_sources(root)
        pkg = [s for s in sources if s.rel.startswith("pbccs_tpu_torch/")]
        design = root / "docs" / "DESIGN.md"
        design_text = design.read_text() if design.exists() else ""

        def existing(marker):
            return _table_entries(design_text, marker)

        print(render_metrics_table(collect_metrics(pkg)))
        print()
        print(render_sites_table(collect_fault_sites(pkg)))
        print()
        print(render_spans_table(collect_spans(pkg),
                                 existing("spans-table")))
        print()
        print(render_env_table(collect_env_reads(pkg),
                               existing("env-table")))
        print()
        kinds, kinds_path, _ = collect_fault_kinds(pkg)
        print(render_fault_kinds_table(kinds, kinds_path,
                                       existing("fault-kinds-table")))
        print()
        print(render_flags_table(collect_flag_defs(pkg),
                                 existing("flags-table")))
        print()
        led_fields, led_path, _ = collect_ledger_fields(pkg)
        print(render_ledger_table(led_fields, led_path))
        print()
        knob_targets, knobs_path, _ = collect_knob_targets(pkg)
        print(render_knobs_table(knob_targets, knobs_path))
        return 0

    rules = ({r.strip() for r in args.rules.split(",") if r.strip()}
             if args.rules else None)
    unknown_rules = sorted((rules or set()) - set(RULES))
    if unknown_rules:
        print(f"ccs analyze: unknown rule(s) {', '.join(unknown_rules)} "
              f"(passes: {', '.join(sorted(PASSES))}; --list-rules "
              "names their rules)", file=sys.stderr)
        return 2
    passes = None
    if args.passes:
        passes = {p.strip() for p in args.passes.split(",") if p.strip()}
        unknown = passes - set(PASSES)
        if unknown:
            print(f"ccs analyze: unknown pass(es) "
                  f"{', '.join(sorted(unknown))} (have: "
                  f"{', '.join(sorted(PASSES))})", file=sys.stderr)
            return 2
        pass_rules = {r for name in passes for r in PASSES[name].rules}
        rules = pass_rules if rules is None else rules & pass_rules
    paths = None
    if args.paths:
        paths = []
        for raw in args.paths:
            p = pathlib.Path(raw).resolve()
            try:
                p.relative_to(root)
            except ValueError:
                print(f"ccs analyze: {raw} is outside --root {root}",
                      file=sys.stderr)
                return 2
            paths.append(p)
    findings = run_passes(root, paths=paths, rules=rules, passes=passes)

    n_suppressed = 0
    if not args.no_baseline:
        baseline_path = (pathlib.Path(args.baseline) if args.baseline
                         else root / DEFAULT_BASELINE)
        try:
            suppressions = load_baseline(baseline_path)
        except BaselineError as e:
            print(f"ccs analyze: bad baseline: {e}", file=sys.stderr)
            return 2
        # a scoped run (rules subset / explicit paths) must not declare
        # out-of-scope suppressions stale: only entries the run could
        # have matched participate
        if rules is not None:
            suppressions = [s for s in suppressions if s.rule in rules]
        if paths is not None:
            scoped = {p.relative_to(root).as_posix() for p in paths}
            suppressions = [s for s in suppressions if s.path in scoped]
        rel = baseline_path.as_posix()
        if baseline_path.is_absolute():
            try:
                rel = baseline_path.relative_to(root).as_posix()
            except ValueError:
                pass
        findings, n_suppressed = apply_baseline(findings, suppressions, rel)

    dt = time.perf_counter() - t0
    rc = 1 if findings else 0
    try:
        if args.format == "json":
            print(json.dumps({
                "findings": [f.to_json() for f in findings],
                "suppressed": n_suppressed,
                "elapsed_s": round(dt, 3),
            }, indent=2))
        else:
            for f in findings:
                print(f.render())
            print(f"ccs analyze: {len(findings)} finding(s), "
                  f"{n_suppressed} suppressed by baseline, "
                  f"{dt:.2f}s", file=sys.stderr)
    except BrokenPipeError:
        # the consumer closed the pipe (`ccs analyze | head`): truncated
        # OUTPUT must not change the verdict
        _mute_stdout()
    return rc


def main() -> None:
    sys.exit(run_analyze())


if __name__ == "__main__":
    main()
