"""Cross-file drift checks: metrics <-> DESIGN.md, fault sites <->
DESIGN.md, CLI flags <-> README/DESIGN, and the exception policy.

The observability layer's metric names and the resilience layer's fault
sites are API: bench tooling, dashboards, and chaos specs key on them.
Names that drifted from the docs were caught by hand in review; this
pass does that mechanically.  In the port it holds pbccs_tpu_torch's
code to the same tables pbccs_tpu's analyzer holds pbccs_tpu to, read
only: they are the naming contract both packages keep.

The canonical inventories live in docs/DESIGN.md between marker
comments (invisible when rendered):

    <!-- ccs-analyze:metrics-table:begin -->    |`ccs_...`| ... rows
    <!-- ccs-analyze:metrics-table:end -->
    <!-- ccs-analyze:fault-sites-table:begin -->  |`site.name`| ... rows
    <!-- ccs-analyze:fault-sites-table:end -->

`python -m pbccs_tpu_torch.analysis.cli --emit-tables` regenerates both
tables from the code scan, so fixing REG001/REG003 drift is mechanical.

  REG001  code registers a metric the table does not list (or the kind
          disagrees)
  REG002  the table lists a metric no code registers
  REG003  code marks a fault site the table does not list
  REG004  the table lists a fault site no code marks
  REG005  README.md / docs/DESIGN.md references a `--flag` no argument
          parser defines
  REG006  code reads a `PBCCS_*` environment toggle the env-toggle
          table does not list (os.environ.get / os.environ[...] /
          os.getenv / os.environ.setdefault)
  REG007  the env-toggle table lists a `PBCCS_*` name no code reads
  REG008  the injectable fault-kind vocabulary (faults.FAULT_KINDS)
          and the DESIGN.md fault-kinds table disagree (chaos specs
          and runbooks key on the kind names)
  REG009  a user-facing CLI flag is defined by a pbccs_tpu argument
          parser but missing from the DESIGN.md flags table (the
          inverse of REG005: REG005 keeps docs honest about code,
          REG009 keeps code discoverable from docs)
  REG010  trace-span-name drift, both ways: a span name recorded at an
          obs.trace span site (obs_trace.span(...) / add_span(...))
          missing from the DESIGN.md span table, or a table row no
          code records -- span names are the trace schema obs_smoke,
          trace_merge, and dashboards key on, policed exactly like
          metric names
  REG011  perf-ledger schema drift, both ways: a field in
          obs.ledger.LEDGER_FIELDS missing from the DESIGN.md
          ledger-schema table, a table row no code declares, or a
          tolerance CLASS that disagrees -- the schema is what
          tools/perf_gate.py keys enforcement on, so a drifted field
          is a silently ungated (or mis-gated) metric
  REG012  tunable-knob inventory drift, both ways: a knob in
          tune.space.KNOB_TARGETS missing from the DESIGN.md knobs
          table, a table row no code declares, or a TARGET column
          (which flag/env/menu the knob drives) that disagrees --
          `ccs tune` profiles are keyed by knob name and someone
          reading only the docs must be able to map a knob to the
          flag or env it replaces
  EXC001  bare `except:`
  EXC002  `except Exception/BaseException: pass` with no stated reason
          (a `# noqa`/`# ccs-analyze` comment on the except line counts
          as a reason; better: narrow the type or log)

The PBCCS_* env toggles are API the same way metrics and fault sites
are: bench recipes, A/B instructions in the PROFILE docs, and ops
runbooks key on them -- the perf toggles in particular (PBCCS_WHOLE_ROW,
PBCCS_DENSE_CB, ...) exist precisely to be flipped by someone who has
only the docs.  Their canonical inventory lives in docs/DESIGN.md
between `<!-- ccs-analyze:env-table:{begin,end} -->` markers,
regenerated by `--emit-tables` like the other two tables.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

from pbccs_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    const_str_arg,
    dotted_name,
    module_str_constants,
)

_METRIC_KINDS = ("counter", "gauge", "histogram")
_NON_LABEL_KWARGS = {"help", "buckets"}
_FLAG_RE = re.compile(r"(?<![\w\[-])--[A-Za-z][A-Za-z0-9_-]*")
_TABLE_NAME_RE = re.compile(r"^\|\s*`([^`]+)`\s*\|([^|]*)\|")


@dataclasses.dataclass
class MetricDef:
    name: str
    kind: str
    labels: tuple[str, ...]
    help: str
    path: str
    line: int


@dataclasses.dataclass
class SiteDef:
    name: str
    kind: str            # "fail" (maybe_fail) | "corrupt"
    path: str
    line: int


@dataclasses.dataclass
class EnvDef:
    name: str
    path: str
    line: int


def collect_metrics(sources: list[SourceFile]) -> list[MetricDef]:
    out: dict[tuple[str, str], MetricDef] = {}
    for src in sources:
        consts = module_str_constants(src.tree)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            d = dotted_name(node.func)
            if d is None or d[-1] not in _METRIC_KINDS:
                continue
            name = const_str_arg(node.args[0], consts)
            if name is None or not name.startswith("ccs_"):
                continue
            labels = tuple(sorted(
                kw.arg for kw in node.keywords
                if kw.arg and kw.arg not in _NON_LABEL_KWARGS))
            help_s = ""
            if len(node.args) > 1:
                help_s = const_str_arg(node.args[1], consts) or ""
            key = (name, d[-1])
            if key not in out:
                out[key] = MetricDef(name, d[-1], labels, help_s,
                                     src.rel, node.lineno)
            elif labels and not out[key].labels:
                out[key] = dataclasses.replace(out[key], labels=labels)
    return sorted(out.values(), key=lambda m: m.name)


def collect_fault_sites(sources: list[SourceFile]) -> list[SiteDef]:
    out: dict[str, SiteDef] = {}
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            d = dotted_name(node.func)
            if d is None or d[-1] not in ("maybe_fail", "corrupt"):
                continue
            # faults.corrupt(site, data) vs e.g. bytes corruption helpers:
            # require a dotted `faults.` receiver or a bare name import
            if len(d) > 1 and d[-2] not in ("faults", "self"):
                continue
            name = const_str_arg(node.args[0], {})
            if name is None or "." not in name:
                continue
            kind = "corrupt" if d[-1] == "corrupt" else "fail"
            out.setdefault(name, SiteDef(name, kind, src.rel, node.lineno))
    return sorted(out.values(), key=lambda s: s.name)


_ENV_CALLS = {"get", "getenv", "setdefault"}


def _is_environ(node: ast.expr) -> bool:
    """`os.environ` / bare `environ` receivers."""
    d = dotted_name(node)
    return d is not None and d[-1] == "environ"


def collect_env_reads(sources: list[SourceFile]) -> list[EnvDef]:
    """Every PBCCS_* environment-variable read: os.environ.get(...),
    os.environ[...], os.environ.setdefault(...), os.getenv(...)."""
    out: dict[str, EnvDef] = {}

    def record(name_node, consts, src, lineno):
        name = const_str_arg(name_node, consts)
        if name is not None and name.startswith("PBCCS_"):
            out.setdefault(name, EnvDef(name, src.rel, lineno))

    for src in sources:
        consts = module_str_constants(src.tree)
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call) and node.args:
                d = dotted_name(node.func)
                if d is None:
                    continue
                is_env_method = (len(d) >= 2 and d[-1] in _ENV_CALLS
                                 and d[-2] == "environ")
                is_getenv = d[-1] == "getenv"
                if is_env_method or is_getenv:
                    record(node.args[0], consts, src, node.lineno)
            elif isinstance(node, ast.Subscript) \
                    and _is_environ(node.value):
                record(node.slice, consts, src, node.lineno)
    return sorted(out.values(), key=lambda e: e.name)


@dataclasses.dataclass
class SpanDef:
    name: str
    path: str
    line: int


# span() receivers that mark a TRACE span site (obs.trace's module
# helper or an aliased import); tracer-method calls (`t.span`,
# `self.span`) pass variables and are filtered by the const-arg rule
_SPAN_RECEIVERS = {"obs_trace", "trace"}


def collect_spans(sources: list[SourceFile]) -> list[SpanDef]:
    """Every constant span NAME used at an obs.trace span site:
    `obs_trace.span("name", ...)` / `trace.span(...)` / bare
    `span(...)`, plus retroactive `*.add_span("name", ...)` calls.
    These names are the trace schema later tooling (obs_smoke,
    trace_merge, dashboards) keys on -- the REG010 inventory."""
    out: dict[str, SpanDef] = {}
    for src in sources:
        consts = module_str_constants(src.tree)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            d = dotted_name(node.func)
            if d is None:
                continue
            if d[-1] == "span":
                if len(d) > 1 and d[-2] not in _SPAN_RECEIVERS:
                    continue
            elif d[-1] != "add_span":
                continue
            name = const_str_arg(node.args[0], consts)
            if name is None:
                continue
            out.setdefault(name, SpanDef(name, src.rel, node.lineno))
    return sorted(out.values(), key=lambda s: s.name)


def render_spans_table(spans: list[SpanDef],
                       existing: dict[str, tuple[str, int]] | None = None
                       ) -> str:
    """Regenerate the trace-span table; the free-text purpose column of
    existing rows is PRESERVED (names are pinned, humans own the
    descriptions)."""
    existing = existing or {}
    lines = ["| span | purpose | source |",
             "|---|---|---|"]
    for s in spans:
        purpose = (existing.get(s.name) or ("", 0))[0] or "(document me)"
        lines.append(f"| `{s.name}` | {purpose} | `{s.path}` |")
    return "\n".join(lines)


@dataclasses.dataclass
class FlagDef:
    name: str
    path: str
    line: int


def collect_flag_defs(sources: list[SourceFile]) -> list[FlagDef]:
    """Every --flag an argument parser in the package defines, with
    its definition site (first definition wins for shared flags)."""
    out: dict[str, FlagDef] = {}
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if d is None or d[-1] != "add_argument":
                continue
            for arg in node.args:
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str) \
                        and arg.value.startswith("--"):
                    out.setdefault(arg.value, FlagDef(
                        arg.value, src.rel, node.lineno))
    return sorted(out.values(), key=lambda f: f.name)


def collect_ledger_fields(sources: list[SourceFile]
                          ) -> tuple[dict[str, str], str, int]:
    """The perf-ledger schema mapping LEDGER_FIELDS = {field: class}:
    (fields, path, line); empty when no module declares one."""
    for src in sources:
        for node in src.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "LEDGER_FIELDS"
                    and isinstance(node.value, ast.Dict)):
                fields = {
                    k.value: v.value
                    for k, v in zip(node.value.keys, node.value.values)
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)}
                return fields, src.rel, node.lineno
    return {}, "", 0


def render_ledger_table(fields: dict[str, str], path: str) -> str:
    """Regenerate the ledger-schema table.  The class column is MACHINE
    owned (it comes from LEDGER_FIELDS, the enforcement key), unlike
    the human-owned purpose columns of the other tables."""
    lines = ["| field | class | source |",
             "|---|---|---|"]
    for name in sorted(fields):
        lines.append(f"| `{name}` | {fields[name]} | `{path}` |")
    return "\n".join(lines)


def collect_knob_targets(sources: list[SourceFile]
                         ) -> tuple[dict[str, str], str, int]:
    """The tunable-knob inventory KNOB_TARGETS = {knob: target}:
    (knobs, path, line); empty when no module declares one."""
    for src in sources:
        for node in src.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "KNOB_TARGETS"
                    and isinstance(node.value, ast.Dict)):
                knobs = {
                    k.value: v.value
                    for k, v in zip(node.value.keys, node.value.values)
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)}
                return knobs, src.rel, node.lineno
    return {}, "", 0


def render_knobs_table(knobs: dict[str, str], path: str) -> str:
    """Regenerate the tunable-knob table.  Like the ledger table, the
    target column is MACHINE owned: it comes from KNOB_TARGETS, the
    mapping tune profiles are keyed on."""
    lines = ["| knob | target | source |",
             "|---|---|---|"]
    for name in sorted(knobs):
        lines.append(f"| `{name}` | {knobs[name]} | `{path}` |")
    return "\n".join(lines)


def collect_fault_kinds(sources: list[SourceFile]
                        ) -> tuple[tuple[str, ...], str, int]:
    """The FAULT_KINDS vocabulary tuple: (kinds, path, line); empty
    when no module declares one."""
    for src in sources:
        for node in src.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "FAULT_KINDS"
                    and isinstance(node.value, (ast.Tuple, ast.List))):
                kinds = tuple(
                    e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))
                return kinds, src.rel, node.lineno
    return (), "", 0


# -------------------------------------------------------- DESIGN.md tables

def _table_entries(doc_text: str, marker: str) -> dict[str, tuple[str, int]]:
    """{name: (second column, lineno)} for rows between the markers."""
    out: dict[str, tuple[str, int]] = {}
    inside = False
    for i, line in enumerate(doc_text.splitlines(), start=1):
        if f"ccs-analyze:{marker}:begin" in line:
            inside = True
            continue
        if f"ccs-analyze:{marker}:end" in line:
            inside = False
            continue
        if inside:
            m = _TABLE_NAME_RE.match(line.strip())
            # skip separator-ish rows but keep `--flag` names
            if m and set(m.group(1)) != {"-"}:
                out[m.group(1)] = (m.group(2).strip(), i)
    return out


def render_metrics_table(metrics: list[MetricDef]) -> str:
    lines = ["| metric | kind | labels | source |",
             "|---|---|---|---|"]
    for m in metrics:
        labels = ", ".join(f"`{la}`" for la in m.labels) or "—"
        lines.append(f"| `{m.name}` | {m.kind} | {labels} | `{m.path}` |")
    return "\n".join(lines)


def render_sites_table(sites: list[SiteDef]) -> str:
    lines = ["| fault site | marker | source |",
             "|---|---|---|"]
    for s in sites:
        marker = "corrupt()" if s.kind == "corrupt" else "maybe_fail()"
        lines.append(f"| `{s.name}` | {marker} | `{s.path}` |")
    return "\n".join(lines)


def render_flags_table(flags: list[FlagDef],
                       existing: dict[str, tuple[str, int]] | None = None
                       ) -> str:
    """Regenerate the CLI-flags table; the free-text purpose column of
    existing rows is PRESERVED (names are pinned, humans own the
    descriptions)."""
    existing = existing or {}
    lines = ["| flag | purpose | defined in |",
             "|---|---|---|"]
    for f in flags:
        purpose = (existing.get(f.name) or ("", 0))[0] or "(document me)"
        lines.append(f"| `{f.name}` | {purpose} | `{f.path}` |")
    return "\n".join(lines)


def render_fault_kinds_table(kinds: tuple[str, ...], path: str,
                             existing: dict[str, tuple[str, int]]
                             | None = None) -> str:
    existing = existing or {}
    lines = ["| fault kind | behavior | source |",
             "|---|---|---|"]
    for k in kinds:
        purpose = (existing.get(k) or ("", 0))[0] or "(document me)"
        lines.append(f"| `{k}` | {purpose} | `{path}` |")
    return "\n".join(lines)


def render_env_table(envs: list[EnvDef],
                     existing: dict[str, tuple[str, int]] | None = None
                     ) -> str:
    """Regenerate the env-toggle table; the free-text purpose column of
    rows that already exist is PRESERVED (the drift check pins names,
    humans own the descriptions)."""
    existing = existing or {}
    lines = ["| env toggle | purpose | source |",
             "|---|---|---|"]
    for e in envs:
        purpose = (existing.get(e.name) or ("", 0))[0] or "(document me)"
        lines.append(f"| `{e.name}` | {purpose} | `{e.path}` |")
    return "\n".join(lines)


# --------------------------------------------------------------- the pass

def analyze_registry(sources: list[SourceFile],
                     root: pathlib.Path) -> list[Finding]:
    findings: list[Finding] = []
    design_path = root / "docs" / "DESIGN.md"
    design_rel = "docs/DESIGN.md"
    design = design_path.read_text() if design_path.exists() else ""

    pkg_sources = [s for s in sources if s.rel.startswith("pbccs_tpu_torch/")]
    metrics = collect_metrics(pkg_sources)
    sites = collect_fault_sites(pkg_sources)

    doc_metrics = _table_entries(design, "metrics-table")
    doc_sites = _table_entries(design, "fault-sites-table")

    if not design:
        findings.append(Finding("REG002", design_rel, 1,
                                "docs/DESIGN.md is missing"))
        return findings

    for m in metrics:
        entry = doc_metrics.get(m.name)
        if entry is None:
            findings.append(Finding(
                "REG001", m.path, m.line,
                f"metric `{m.name}` ({m.kind}) is not in the DESIGN.md "
                "metrics table (run `python -m pbccs_tpu_torch.analysis.cli "
                "--emit-tables` to regenerate)"))
        elif entry[0] and entry[0] != m.kind:
            findings.append(Finding(
                "REG001", m.path, m.line,
                f"metric `{m.name}` is a {m.kind} in code but listed as "
                f"`{entry[0]}` in the DESIGN.md metrics table"))
    code_metric_names = {m.name for m in metrics}
    for name, (_, lineno) in sorted(doc_metrics.items()):
        if name not in code_metric_names:
            findings.append(Finding(
                "REG002", design_rel, lineno,
                f"DESIGN.md metrics table lists `{name}` but no code "
                "registers it"))

    code_site_names = {s.name for s in sites}
    for s in sites:
        if s.name not in doc_sites:
            findings.append(Finding(
                "REG003", s.path, s.line,
                f"fault site `{s.name}` is not in the DESIGN.md "
                "fault-site table"))
    for name, (_, lineno) in sorted(doc_sites.items()):
        if name not in code_site_names:
            findings.append(Finding(
                "REG004", design_rel, lineno,
                f"DESIGN.md fault-site table lists `{name}` but no code "
                "marks it"))

    # PBCCS_* env toggles <-> env-toggle table (the REG005 flag check
    # covers only --flags; the perf/A-B toggles drifted undocumented)
    envs = collect_env_reads(pkg_sources)
    doc_envs = _table_entries(design, "env-table")
    for e in envs:
        if e.name not in doc_envs:
            findings.append(Finding(
                "REG006", e.path, e.line,
                f"env toggle `{e.name}` is read here but missing from "
                "the DESIGN.md env-toggle table (run `python -m "
                "pbccs_tpu_torch.analysis.cli --emit-tables` to regenerate)"))
    code_env_names = {e.name for e in envs}
    for name, (_, lineno) in sorted(doc_envs.items()):
        if name.startswith("PBCCS_") and name not in code_env_names:
            findings.append(Finding(
                "REG007", design_rel, lineno,
                f"DESIGN.md env-toggle table lists `{name}` but no code "
                "reads it"))

    # fault-kind vocabulary <-> fault-kinds table (REG008): the kinds
    # are the chaos-spec grammar; a kind the docs do not name is
    # unusable from a runbook, a documented kind the parser rejects is
    # a lying runbook
    kinds, kinds_path, kinds_line = collect_fault_kinds(pkg_sources)
    doc_kinds = _table_entries(design, "fault-kinds-table")
    for k in kinds:
        if k not in doc_kinds:
            findings.append(Finding(
                "REG008", kinds_path, kinds_line,
                f"fault kind `{k}` is injectable but missing from the "
                "DESIGN.md fault-kinds table (run `python -m "
                "pbccs_tpu_torch.analysis.cli --emit-tables`)"))
    for name, (_, lineno) in sorted(doc_kinds.items()):
        if name not in kinds:
            findings.append(Finding(
                "REG008", design_rel, lineno,
                f"DESIGN.md fault-kinds table lists `{name}` but "
                "faults.FAULT_KINDS does not define it"))

    # trace-span names <-> spans table (REG010, both ways): the span
    # names are the trace schema obs_smoke / trace_merge / dashboards
    # key on, exactly as metric names are the scrape schema
    spans = collect_spans(pkg_sources)
    doc_spans = _table_entries(design, "spans-table")
    for s in spans:
        if s.name not in doc_spans:
            findings.append(Finding(
                "REG010", s.path, s.line,
                f"trace span `{s.name}` is recorded here but missing "
                "from the DESIGN.md span table (run `python -m "
                "pbccs_tpu_torch.analysis.cli --emit-tables` to regenerate)"))
    code_span_names = {s.name for s in spans}
    for name, (_, lineno) in sorted(doc_spans.items()):
        if name not in code_span_names:
            findings.append(Finding(
                "REG010", design_rel, lineno,
                f"DESIGN.md span table lists `{name}` but no code "
                "records it"))

    # perf-ledger schema <-> ledger-schema table (REG011, both ways plus
    # class agreement): the schema is the gate's enforcement key --
    # tools/perf_gate.py decides strictness from the CLASS column, so a
    # drifted class silently changes what CI defends
    ledger_fields, ledger_path, ledger_line = \
        collect_ledger_fields(pkg_sources)
    doc_ledger = _table_entries(design, "ledger-schema-table")
    for name in sorted(ledger_fields):
        entry = doc_ledger.get(name)
        if entry is None:
            findings.append(Finding(
                "REG011", ledger_path, ledger_line,
                f"ledger field `{name}` is declared in LEDGER_FIELDS "
                "but missing from the DESIGN.md ledger-schema table "
                "(run `python -m pbccs_tpu_torch.analysis.cli --emit-tables` "
                "to regenerate)"))
        elif entry[0] and entry[0] != ledger_fields[name]:
            findings.append(Finding(
                "REG011", ledger_path, ledger_line,
                f"ledger field `{name}` is class "
                f"`{ledger_fields[name]}` in code but `{entry[0]}` in "
                "the DESIGN.md ledger-schema table"))
    for name, (_, lineno) in sorted(doc_ledger.items()):
        if name not in ledger_fields:
            findings.append(Finding(
                "REG011", design_rel, lineno,
                f"DESIGN.md ledger-schema table lists `{name}` but "
                "LEDGER_FIELDS does not declare it"))

    # tunable-knob inventory <-> knobs table (REG012, both ways plus
    # target agreement): tune profiles are keyed by knob name and the
    # TARGET column is the only doc-side map from a knob to the flag /
    # env / menu it replaces -- a drifted row sends an operator to the
    # wrong switch
    knob_targets, knobs_path, knobs_line = collect_knob_targets(pkg_sources)
    doc_knobs = _table_entries(design, "knobs-table")
    for name in sorted(knob_targets):
        entry = doc_knobs.get(name)
        if entry is None:
            findings.append(Finding(
                "REG012", knobs_path, knobs_line,
                f"tunable knob `{name}` is declared in KNOB_TARGETS but "
                "missing from the DESIGN.md knobs table (run `python -m "
                "pbccs_tpu_torch.analysis.cli --emit-tables` to regenerate)"))
        elif entry[0] and entry[0].strip("`") != knob_targets[name]:
            findings.append(Finding(
                "REG012", knobs_path, knobs_line,
                f"tunable knob `{name}` has target "
                f"`{knob_targets[name]}` in code but `{entry[0]}` in "
                "the DESIGN.md knobs table"))
    for name, (_, lineno) in sorted(doc_knobs.items()):
        if name not in knob_targets:
            findings.append(Finding(
                "REG012", design_rel, lineno,
                f"DESIGN.md knobs table lists `{name}` but "
                "KNOB_TARGETS does not declare it"))

    # defined flags <-> flags table (REG009; REG005 already fails any
    # documented flag no parser defines, including ghost table rows)
    flag_defs = collect_flag_defs(pkg_sources)
    doc_flags = _table_entries(design, "flags-table")
    for f in flag_defs:
        if f.name not in doc_flags:
            findings.append(Finding(
                "REG009", f.path, f.line,
                f"flag `{f.name}` is defined here but missing from the "
                "DESIGN.md flags table (run `python -m "
                "pbccs_tpu_torch.analysis.cli --emit-tables`)"))

    findings.extend(_check_flags(sources, root))
    return findings


def _defined_flags(sources: list[SourceFile]) -> set[str]:
    flags: set[str] = set()
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if d is None or d[-1] != "add_argument":
                continue
            for arg in node.args:
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str) \
                        and arg.value.startswith("--"):
                    flags.add(arg.value)
    return flags


def _check_flags(sources: list[SourceFile],
                 root: pathlib.Path) -> list[Finding]:
    defined = _defined_flags(sources)
    findings: list[Finding] = []
    for doc_name in ("README.md", "docs/DESIGN.md"):
        doc = root / doc_name
        if not doc.exists():
            continue
        for lineno, line in enumerate(doc.read_text().splitlines(),
                                      start=1):
            if "XLA_FLAGS" in line or "--xla" in line:
                continue   # XLA's own flags, not ours
            for m in _FLAG_RE.finditer(line):
                flag = m.group(0)
                if flag not in defined:
                    findings.append(Finding(
                        "REG005", doc_name, lineno,
                        f"{flag} is referenced here but defined by no "
                        "argument parser in pbccs_tpu_torch/ or "
                        "chip_smoke.py"))
    return findings


# ------------------------------------------------------- exception policy

def analyze_exceptions(sources: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(Finding(
                    "EXC001", src.rel, node.lineno,
                    "bare `except:` catches SystemExit/KeyboardInterrupt "
                    "too; catch a concrete type (or `Exception` with a "
                    "stated reason)"))
                continue
            d = dotted_name(node.type)
            broad = d is not None and d[-1] in ("Exception",
                                                "BaseException")
            silent = (len(node.body) == 1
                      and isinstance(node.body[0], ast.Pass))
            if broad and silent:
                line = src.line_text(node.lineno)
                if "noqa" in line or "ccs-analyze" in line:
                    continue
                findings.append(Finding(
                    "EXC002", src.rel, node.lineno,
                    f"silent `except {d[-1]}: pass` swallows every error "
                    "with no stated reason (narrow the type, log it, or "
                    "annotate why)"))
    return findings
