"""The port's `ccs analyze` (pbccs_tpu_torch/analysis) against
pbccs_tpu's, and the port's own gate.

Mirrors tests/test_analysis.py for the port: one positive and one
negative fixture per AST rule (tests/fixtures/analysis/, every rule but
JAX001-JAX004, which the port does not have), the registry drift rules
over a constructed mini-repo (its package under pbccs_tpu_torch/),
baseline mechanics, the clean-port gate, and the regressions the
analyzer pins in the port's serve engine, session and timing windows.

Differential contract: on each fixture file, and on each mirrored
registry tree (the same files under pbccs_tpu/ for pbccs_tpu's analyzer
and under pbccs_tpu_torch/ for the port's), both analyzers give the
same (rule, path, line, message) findings once the JAX rules are
dropped and the port's names are mapped to pbccs_tpu's (`port_names`:
the package, and the scan roots REG005 names)."""

from __future__ import annotations

import importlib.util
import os
import pathlib
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from pbccs_tpu.analysis import run_passes as jrun_passes

from pbccs_tpu_torch.analysis import PASSES, RULES, run_passes
from pbccs_tpu_torch.analysis.baseline import (
    BaselineError,
    Suppression,
    apply_baseline,
    load_baseline,
)
from pbccs_tpu_torch.analysis.core import Finding, load_source

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
BASELINE = REPO / "pbccs_tpu_torch" / "analysis" / "baseline.toml"

_spec = importlib.util.spec_from_file_location("cases", FIXTURES / "cases.py")
_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_cases)
JAX_RULES = {"JAX001", "JAX002", "JAX003", "JAX004"}
AST_CASES = {r: c for r, c in _cases.AST_CASES.items() if r not in JAX_RULES}
REPO_CASES = _cases.REPO_CASES
FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("*.py")
                       if p.name != "cases.py")


def rules_in(name: str) -> set[str]:
    findings = run_passes(FIXTURES, paths=[FIXTURES / name])
    return {f.rule for f in findings}


def port_names(text: str) -> str:
    """The port's names in a finding, mapped to pbccs_tpu's."""
    return (text.replace("pbccs_tpu_torch/ or chip_smoke.py",
                         "pbccs_tpu/ or tools/")
            .replace("pbccs_tpu_torch", "pbccs_tpu"))


def keyed(findings, port: bool) -> set[tuple]:
    fix = port_names if port else (lambda s: s)
    return {(f.rule, fix(f.path), f.line, fix(f.message))
            for f in findings if f.rule not in JAX_RULES}


# ---------------------------------------------------------- rule fixtures

@pytest.mark.parametrize("rule", sorted(AST_CASES))
def test_rule_fires_on_positive_fixture(rule):
    pos, _ = AST_CASES[rule]
    assert rule in rules_in(pos), f"{rule} must fire on {pos}"


@pytest.mark.parametrize("rule", sorted(r for r, (_, neg) in AST_CASES.items()
                                        if neg is not None))
def test_rule_quiet_on_negative_fixture(rule):
    _, neg = AST_CASES[rule]
    found = rules_in(neg)
    assert rule not in found, f"{rule} must not fire on {neg}: {found}"


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_findings_match_jax_analyzer(name):
    """Both analyzers, path-scoped on one fixture file: the same
    findings of every rule but JAX001-JAX004."""
    mine = run_passes(FIXTURES, paths=[FIXTURES / name])
    ref = jrun_passes(FIXTURES, paths=[FIXTURES / name])
    assert keyed(mine, True) == keyed(ref, False)


def test_every_ast_rule_has_fixtures():
    """Every rule of the port is covered by a fixture pair, a repo case
    or a constructed-repo test; the JAX rules are not the port's."""
    constructed = {"REG001", "REG002", "REG003", "REG004", "REG005",
                   "REG006", "REG007", "REG008", "REG009", "PRO001",
                   "ANA001"}
    missing = set(RULES) - set(AST_CASES) - set(REPO_CASES) - constructed
    assert not missing, f"rules without fixture coverage: {missing}"
    assert not JAX_RULES & set(RULES)
    assert "jax" not in PASSES


def test_negative_fixtures_fully_clean():
    for rule, (_, neg) in sorted(AST_CASES.items()):
        if neg is None:
            continue
        findings = run_passes(FIXTURES, paths=[FIXTURES / neg])
        assert not findings, f"{neg} must be clean, got {findings}"


def test_ana002_syntax_error_reports_not_raises():
    src, err = load_source(FIXTURES / "ana002_pos.py", FIXTURES)
    assert src is None
    assert err is not None and err.rule == "ANA002"


# ------------------------------------------------------- registry drift

MOD = textwrap.dedent("""\
    import argparse
    import os


    def setup(reg, faults):
        reg.counter("ccs_real_total", "a real metric")
        faults.maybe_fail("real.site")
        if os.environ.get("PBCCS_REAL_TOGGLE"):
            pass
        p = argparse.ArgumentParser()
        p.add_argument("--real")
        return p
""")

DESIGN = textwrap.dedent("""\
    # mini design
    <!-- ccs-analyze:metrics-table:begin -->
    | metric | kind | labels | source |
    |---|---|---|---|
    | `ccs_ghost_total` | counter | — | `gone.py` |
    <!-- ccs-analyze:metrics-table:end -->
    <!-- ccs-analyze:fault-sites-table:begin -->
    | fault site | marker | source |
    |---|---|---|
    | `ghost.site` | maybe_fail() | `gone.py` |
    <!-- ccs-analyze:fault-sites-table:end -->
    <!-- ccs-analyze:env-table:begin -->
    | env toggle | purpose | source |
    |---|---|---|
    | `PBCCS_GHOST_TOGGLE` | gone | `gone.py` |
    <!-- ccs-analyze:env-table:end -->
""")

GREEN_DESIGN = textwrap.dedent("""\
    <!-- ccs-analyze:metrics-table:begin -->
    | `ccs_real_total` | counter | — | `pbccs_tpu/mod.py` |
    <!-- ccs-analyze:metrics-table:end -->
    <!-- ccs-analyze:fault-sites-table:begin -->
    | `real.site` | maybe_fail() | `pbccs_tpu/mod.py` |
    <!-- ccs-analyze:fault-sites-table:end -->
    <!-- ccs-analyze:env-table:begin -->
    | `PBCCS_REAL_TOGGLE` | a real toggle | `pbccs_tpu/mod.py` |
    <!-- ccs-analyze:env-table:end -->
    <!-- ccs-analyze:flags-table:begin -->
    | `--real` | a real flag | `pbccs_tpu/mod.py` |
    <!-- ccs-analyze:flags-table:end -->
""")

SPAN_DESIGN = textwrap.dedent("""\
    <!-- ccs-analyze:spans-table:begin -->
    | span | purpose | source |
    |---|---|---|
    | `reg010.documented` | a documented span | `pbccs_tpu/mod.py` |
    <!-- ccs-analyze:spans-table:end -->
""")

LEDGER_DESIGN = textwrap.dedent("""\
    <!-- ccs-analyze:ledger-schema-table:begin -->
    | field | class | source |
    |---|---|---|
    | `reg011_documented` | meta | `pbccs_tpu/mod.py` |
    | `reg011_shifty` | wall | `pbccs_tpu/mod.py` |
    <!-- ccs-analyze:ledger-schema-table:end -->
""")

KNOBS_DESIGN = textwrap.dedent("""\
    <!-- ccs-analyze:knobs-table:begin -->
    | knob | target | source |
    |---|---|---|
    | `reg012_documented` | env:PBCCS_DOCUMENTED | `pbccs_tpu/mod.py` |
    | `reg012_shifty` | flag:--shifty | `pbccs_tpu/mod.py` |
    <!-- ccs-analyze:knobs-table:end -->
""")


def make_tree(root: pathlib.Path, pkg: str, files: dict[str, str],
              design: str | None, readme: str | None = None
              ) -> pathlib.Path:
    """A mini repo: `files` (paths under the package, text) under `pkg`/,
    docs/DESIGN.md and README.md."""
    for rel, text in files.items():
        path = root / pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text.replace("pbccs_tpu.", f"{pkg}."))
    if design is not None:
        (root / "docs").mkdir(parents=True, exist_ok=True)
        (root / "docs" / "DESIGN.md").write_text(design)
    if readme is not None:
        (root / "README.md").write_text(readme)
    return root


def both_trees(tmp_path, files, design, readme=None):
    """The port's findings on the tree under pbccs_tpu_torch/, after
    asserting that pbccs_tpu's analyzer finds the same on the tree under
    pbccs_tpu/."""
    mine = run_passes(make_tree(tmp_path / "port", "pbccs_tpu_torch", files,
                                design, readme))
    ref = jrun_passes(make_tree(tmp_path / "jax", "pbccs_tpu", files,
                                design, readme))
    assert keyed(mine, True) == keyed(ref, False)
    return mine


README = "Run with `--real` or the removed `--ghost`.\n"


def test_registry_drift_rules(tmp_path):
    found = {f.rule: f for f in both_trees(tmp_path, {"mod.py": MOD},
                                           DESIGN, README)}
    assert "REG001" in found
    assert "ccs_real_total" in found["REG001"].message
    assert "REG002" in found
    assert "ccs_ghost_total" in found["REG002"].message
    assert "REG003" in found and "real.site" in found["REG003"].message
    assert "REG004" in found and "ghost.site" in found["REG004"].message
    assert "REG005" in found and "--ghost" in found["REG005"].message
    assert all("--real " not in f.message
               for f in found.values() if f.rule == "REG005")
    assert "REG006" in found
    assert "PBCCS_REAL_TOGGLE" in found["REG006"].message
    assert "REG007" in found
    assert "PBCCS_GHOST_TOGGLE" in found["REG007"].message


def test_registry_green_when_tables_match(tmp_path):
    found = both_trees(tmp_path, {"mod.py": MOD}, GREEN_DESIGN,
                       "Run with `--real`.\n")
    assert [f for f in found if f.rule.startswith("REG")] == []


def test_env_toggle_read_forms_and_scope(tmp_path):
    envs = textwrap.dedent("""\
        import os


        def toggles():
            a = os.environ.get("PBCCS_FORM_GET")
            b = os.environ["PBCCS_FORM_SUBSCRIPT"]
            c = os.environ.setdefault("PBCCS_FORM_SETDEFAULT", "0")
            d = os.getenv("PBCCS_FORM_GETENV")
            e = os.environ.get("CUDA_VISIBLE_DEVICES")     # not ours
            return a, b, c, d, e
    """)
    found = both_trees(tmp_path, {"mod.py": MOD, "envs.py": envs}, DESIGN,
                       README)
    msgs = [f.message for f in found if f.rule == "REG006"]
    for name in ("PBCCS_FORM_GET", "PBCCS_FORM_SUBSCRIPT",
                 "PBCCS_FORM_SETDEFAULT", "PBCCS_FORM_GETENV"):
        assert any(name in m for m in msgs), (name, msgs)
    assert not any("CUDA_VISIBLE_DEVICES" in m for m in msgs)


@pytest.mark.parametrize("rule,design", [("REG010", SPAN_DESIGN),
                                         ("REG011", LEDGER_DESIGN),
                                         ("REG012", KNOBS_DESIGN)])
def test_repo_case_fixtures_match_jax(tmp_path, rule, design):
    """Each REPO_CASES pair in its mini repo: the positive fires, the
    negative is quiet, and both analyzers agree on each."""
    pos, neg = REPO_CASES[rule]
    hit = both_trees(tmp_path / "pos", {"mod.py": (FIXTURES / pos)
                                        .read_text()}, design)
    assert any(f.rule == rule for f in hit), hit
    quiet = both_trees(tmp_path / "neg", {"mod.py": (FIXTURES / neg)
                                          .read_text()}, design)
    assert [f for f in quiet if f.rule == rule] == [], quiet


def test_reg010_fires_both_directions(tmp_path):
    pos, _neg = REPO_CASES["REG010"]
    found = [f for f in both_trees(tmp_path, {"mod.py": (FIXTURES / pos)
                                              .read_text()}, SPAN_DESIGN)
             if f.rule == "REG010"]
    assert any("reg010.undocumented" in f.message for f in found), found
    assert any("reg010.documented" in f.message
               and f.path == "docs/DESIGN.md" for f in found), found


def test_reg011_fires_on_positive_fixture(tmp_path):
    pos, _neg = REPO_CASES["REG011"]
    found = [f for f in both_trees(tmp_path, {"mod.py": (FIXTURES / pos)
                                              .read_text()}, LEDGER_DESIGN)
             if f.rule == "REG011"]
    assert any("reg011_alien" in f.message for f in found), found
    assert any("reg011_shifty" in f.message and "class" in f.message
               for f in found), found


def test_reg011_table_side_ghost_row_fires(tmp_path):
    _pos, neg = REPO_CASES["REG011"]
    design = LEDGER_DESIGN.replace(
        "<!-- ccs-analyze:ledger-schema-table:end -->",
        "| `reg011_ghost` | counter | `pbccs_tpu/mod.py` |\n"
        "<!-- ccs-analyze:ledger-schema-table:end -->")
    found = [f for f in both_trees(tmp_path, {"mod.py": (FIXTURES / neg)
                                              .read_text()}, design)
             if f.rule == "REG011"]
    assert any("reg011_ghost" in f.message
               and f.path == "docs/DESIGN.md" for f in found), found


def test_reg012_fires_on_positive_fixture(tmp_path):
    pos, _neg = REPO_CASES["REG012"]
    found = [f for f in both_trees(tmp_path, {"mod.py": (FIXTURES / pos)
                                              .read_text()}, KNOBS_DESIGN)
             if f.rule == "REG012"]
    assert any("reg012_alien" in f.message for f in found), found
    assert any("reg012_shifty" in f.message and "target" in f.message
               for f in found), found


def test_reg012_table_side_ghost_row_fires(tmp_path):
    _pos, neg = REPO_CASES["REG012"]
    design = KNOBS_DESIGN.replace(
        "<!-- ccs-analyze:knobs-table:end -->",
        "| `reg012_ghost` | env:PBCCS_GHOST | `pbccs_tpu/mod.py` |\n"
        "<!-- ccs-analyze:knobs-table:end -->")
    found = [f for f in both_trees(tmp_path, {"mod.py": (FIXTURES / neg)
                                              .read_text()}, design)
             if f.rule == "REG012"]
    assert any("reg012_ghost" in f.message
               and f.path == "docs/DESIGN.md" for f in found), found


def test_metric_kind_mismatch_is_drift(tmp_path):
    design = GREEN_DESIGN.replace("| `ccs_real_total` | counter |",
                                  "| `ccs_real_total` | gauge |")
    reg1 = [f for f in both_trees(tmp_path, {"mod.py": MOD}, design,
                                  "plain\n") if f.rule == "REG001"]
    assert reg1 and "listed as `gauge`" in reg1[0].message


def test_registry_reads_only_the_port(tmp_path):
    """The port's registry pass holds pbccs_tpu_torch/ to the tables:
    pbccs_tpu/ beside it is not read (and tools/ defines no flag)."""
    root = make_tree(tmp_path, "pbccs_tpu_torch", {"mod.py": MOD},
                     GREEN_DESIGN, "Run with `--real` or `--tooled`.\n")
    make_tree(root, "pbccs_tpu", {"other.py": MOD.replace(
        "ccs_real_total", "ccs_jax_only_total")}, None)
    (root / "tools").mkdir()
    (root / "tools" / "t.py").write_text(
        "import argparse\nargparse.ArgumentParser()"
        ".add_argument('--tooled')\n")
    found = run_passes(root)
    assert not any("ccs_jax_only_total" in f.message for f in found)
    assert [f.message.split()[0] for f in found
            if f.rule == "REG005"] == ["--tooled"]


# ------------------------------------------------------------- baseline

def _findings():
    return [Finding("CONC002", "pbccs_tpu_torch/x.py", 10,
                    "sendall under lock")]


def test_baseline_suppresses_matching_finding():
    sup = [Suppression("CONC002", "pbccs_tpu_torch/x.py", match="sendall")]
    kept, n = apply_baseline(_findings(), sup, "baseline.toml")
    assert kept == [] and n == 1


def test_stale_baseline_entry_reported_as_ana001():
    sup = [
        Suppression("CONC002", "pbccs_tpu_torch/x.py", match="sendall"),
        Suppression("EXC001", "pbccs_tpu_torch/gone.py",
                    reason="code was deleted"),
    ]
    kept, n = apply_baseline(_findings(), sup, "baseline.toml")
    assert n == 1
    assert [f.rule for f in kept] == ["ANA001"]
    assert "pbccs_tpu_torch/gone.py" in kept[0].message


def test_baseline_never_matches_by_line():
    sup = [Suppression("CONC002", "pbccs_tpu_torch/x.py")]
    moved = [Finding("CONC002", "pbccs_tpu_torch/x.py", 999,
                     "sendall moved")]
    kept, n = apply_baseline(moved, sup, "baseline.toml")
    assert kept == [] and n == 1


def test_malformed_baseline_raises(tmp_path):
    bad = tmp_path / "baseline.toml"
    bad.write_text("[[suppress]]\nrule = \n")
    with pytest.raises(BaselineError):
        load_baseline(bad)


def test_baseline_rejects_jax_rules(tmp_path):
    bad = tmp_path / "baseline.toml"
    bad.write_text('[[suppress]]\nrule = "JAX001"\npath = "x.py"\n')
    with pytest.raises(BaselineError):
        load_baseline(bad)


#: the CONC002 entries of pbccs_tpu's baseline, at the port's paths
SENDALL = {("pbccs_tpu_torch/serve/server.py", "self.conn.sendall()"),
           ("pbccs_tpu_torch/serve/client.py", "sock.sendall()"),
           ("pbccs_tpu_torch/serve/router.py", "self._sock.sendall()")}


def test_committed_baseline_parses_and_is_small():
    """Every entry is one of the three kinds: pbccs_tpu's three CONC002
    sendall entries at the port's paths, a difference by design, or an
    open port fault naming its ROADMAP Queue 3 entry."""
    sups = load_baseline(BASELINE)
    assert len(sups) <= 30, "baseline must stay a short, justified list"
    roadmap = (REPO / "ROADMAP.md").read_text()
    sendall = {(s.path, s.match) for s in sups if s.rule == "CONC002"}
    assert sendall == SENDALL
    for s in sups:
        assert s.reason, s
        if s.rule == "CONC002":
            continue
        if s.reason.startswith("Open port fault"):
            entry = s.reason.split("ROADMAP Queue 3:", 1)[1].split(".")[0]
            assert entry.strip() and entry.strip() in roadmap, s
        else:
            assert s.reason.startswith("Difference by design: "), s


def test_inline_suppression_silences_finding(tmp_path):
    f = tmp_path / "sup.py"
    f.write_text(textwrap.dedent("""\
        def risky(fn):
            try:
                return fn()
            except:  # ccs-analyze: ignore[EXC001]
                return None


        def risky2(fn):
            try:
                return fn()
            # ccs-analyze: ignore[EXC001] -- comment-line form
            except:
                return None
    """))
    assert run_passes(tmp_path, paths=[f]) == []


def test_inline_suppressions_restored_where_pbccs_tpu_has_them():
    """pbccs_tpu's inline suppression on the router's failover total sits
    on the same code in the port."""
    text = (REPO / "pbccs_tpu_torch" / "serve" / "router.py").read_text()
    lines = text.splitlines()
    i = next(n for n, ln in enumerate(lines)
             if "self._failover_total += len(moved)" in ln)
    assert "ccs-analyze: ignore[CONC001]" in lines[i - 1]


# ------------------------------------------------------ clean-port gate

def test_port_is_clean_under_committed_baseline():
    """The port's gate: the full run over pbccs_tpu_torch and
    chip_smoke.py exits 0 under its baseline, in under 60 s."""
    from pbccs_tpu_torch.analysis.cli import run_analyze

    t0 = time.monotonic()
    assert run_analyze(["--root", str(REPO)]) == 0
    assert time.monotonic() - t0 < 60.0


def test_scoped_runs_do_not_report_out_of_scope_suppressions_stale():
    from pbccs_tpu_torch.analysis.cli import run_analyze

    assert run_analyze(["--root", str(REPO),
                        "--rules", "EXC001,EXC002"]) == 0
    assert run_analyze(["--root", str(REPO),
                        str(REPO / "pbccs_tpu_torch" / "runtime"
                            / "timing.py")]) == 0


def test_jax_pass_and_rules_are_usage_errors(capsys):
    from pbccs_tpu_torch.analysis.cli import run_analyze

    assert run_analyze(["--root", str(REPO), "--pass", "jax"]) == 2
    assert "conc, exc, exsafe, leases, proto, registry" in \
        capsys.readouterr().err
    assert run_analyze(["--root", str(REPO), "--rules", "JAX001"]) == 2
    assert "conc, exc, exsafe, leases, proto, registry" in \
        capsys.readouterr().err
    assert run_analyze(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert "JAX" not in listed and "CONC001" in listed


def test_ccs_analyze_subcommand_gives_the_same_result(capsys):
    """`ccs analyze` through the port's CLI is the analyzer's CLI."""
    from pbccs_tpu_torch.analysis.cli import run_analyze
    from pbccs_tpu_torch.cli import run

    assert run(["analyze", "--root", str(REPO), "--format", "json"]) == 0
    via_ccs = capsys.readouterr().out
    assert run_analyze(["--root", str(REPO), "--format", "json"]) == 0
    direct = capsys.readouterr().out
    strip = lambda s: s.split('"elapsed_s"')[0]  # noqa: E731
    assert strip(via_ccs) == strip(direct)


def test_emit_tables_prints_and_writes_nothing(capsys):
    from pbccs_tpu_torch.analysis.cli import run_analyze

    design = REPO / "docs" / "DESIGN.md"
    before = design.stat().st_mtime_ns
    assert run_analyze(["--root", str(REPO), "--emit-tables"]) == 0
    out = capsys.readouterr().out
    assert "| `ccs_compiles_total` | counter |" in out
    assert "`pbccs_tpu_torch/ops/cuda_lib.py`" in out
    assert design.stat().st_mtime_ns == before


def test_analyzer_runs_without_torch_jax_or_pbccs_tpu():
    """`python -m pbccs_tpu_torch.analysis.cli` with torch, jax and
    pbccs_tpu poisoned in sys.modules: exit 0, none of them imported."""
    code = textwrap.dedent("""\
        import runpy, sys
        for name in ("torch", "jax", "pbccs_tpu"):
            sys.modules[name] = None
        sys.argv = ["ccs analyze"]
        try:
            runpy.run_module("pbccs_tpu_torch.analysis.cli",
                             run_name="__main__")
        except SystemExit as e:
            loaded = [m for m in sys.modules
                      if m.split(".")[0] in ("torch", "jax", "pbccs_tpu")
                      and sys.modules[m] is not None]
            print("EXIT", e.code, loaded)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert "EXIT 0 []" in proc.stdout, (proc.stdout, proc.stderr)


def test_broken_pipe_keeps_failure_exit_code(tmp_path, monkeypatch):
    from pbccs_tpu_torch.analysis.cli import run_analyze

    (tmp_path / "bad.py").write_text(
        "def f(fn):\n    try:\n        return fn()\n"
        "    except:\n        return None\n")

    class _ClosedPipe:
        def write(self, s):
            raise BrokenPipeError

        def flush(self):
            pass

    monkeypatch.setattr(sys, "stdout", _ClosedPipe())
    assert run_analyze(["--root", str(tmp_path), "--no-baseline"]) == 1


# ----------------------------------- regressions pinned by analyzer fixes

def test_session_teardown_not_blocked_by_wedged_writer():
    """serve/server.py: the reader's teardown flips `alive` under the
    dedicated state lock, never `_wlock`."""
    from types import SimpleNamespace

    from pbccs_tpu_torch.serve.server import _Session

    class _Conn:
        def settimeout(self, t):
            pass

        def recv(self, n):
            return b""

        def close(self):
            pass

    log = SimpleNamespace(debug=lambda *a, **k: None)
    server = SimpleNamespace(
        log=log,
        engine=SimpleNamespace(config=SimpleNamespace(
            idle_timeout_s=0, max_line_bytes=1024)),
        _forget=lambda s: None)
    sess = _Session(server, _Conn(), ("test", 0))
    with sess._wlock:
        t = threading.Thread(target=sess.run)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive(), "teardown must not wait on _wlock"
    assert sess.alive is False


def test_timing_windows_race_with_stage_adds():
    """runtime/timing.py: windows opened and read while another thread
    adds stage time never raise."""
    from pbccs_tpu_torch.runtime import timing

    stop = threading.Event()
    errors: list[BaseException] = []

    def hammer(fn):
        try:
            while not stop.is_set():
                fn()
        except BaseException as e:  # noqa: BLE001 -- surfaced below
            errors.append(e)

    def read():
        win = timing.window()
        timing.stage_seconds(win)
        timing.device_wait_seconds(win)
        timing.fetch_count(win)

    threads = [threading.Thread(target=hammer, args=(f,)) for f in
               (read, read, lambda: timing.add_stage("x", 0.0))]
    for t in threads:
        t.start()
    stop.wait(0.2)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert not errors


def test_engine_status_during_close_race():
    """serve/engine.py: _pool/_complete_thread publication is
    lock-guarded, so status() racing close() sees coherent state."""
    from pbccs_tpu_torch.pipeline import Failure
    from pbccs_tpu_torch.serve.engine import CcsEngine, ServeConfig

    def prep_fn(chunk, settings):
        return Failure.SUCCESS, None

    def polish_fn(preps, settings, **kw):
        return [(Failure.SUCCESS, None) for _ in preps]

    for _ in range(3):
        eng = CcsEngine(config=ServeConfig(prep_workers=1), device="cpu",
                        prep_fn=prep_fn, polish_fn=polish_fn).start()
        errors: list[BaseException] = []
        stop = threading.Event()

        def poll():
            try:
                while not stop.is_set():
                    eng.status()
            except BaseException as e:  # noqa: BLE001 -- surfaced below
                errors.append(e)

        t = threading.Thread(target=poll)
        t.start()
        eng.close()
        stop.set()
        t.join(timeout=5)
        assert not errors
