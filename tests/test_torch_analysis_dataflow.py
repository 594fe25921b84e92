"""The port's interprocedural analyzer core (callgraph + dataflow) and
the three passes built on it -- atomic-publish (exsafe), lease-release
(leases), protocol conformance (protolint) -- against pbccs_tpu's.

Mirrors tests/test_analysis_dataflow.py for the port: the seeded
known-bad shapes, the interprocedural semantics (callback transfer,
transitive release, inheritance resolution), the constructed-repo
protocol and registry drift checks (the serve tier under
pbccs_tpu_torch/serve/), and the zero-findings contract on the port's
own tree.  Every snippet and constructed tree also goes through
pbccs_tpu's analyzer (its tree under pbccs_tpu/), which must report the
same findings once the port's names are mapped to pbccs_tpu's
(tests/test_torch_analysis.py `keyed`)."""

from __future__ import annotations

import pathlib
import textwrap

import pytest

from pbccs_tpu.analysis import run_passes as jrun_passes

from pbccs_tpu_torch.analysis import PASSES, run_passes
from pbccs_tpu_torch.analysis.baseline import BaselineError, load_baseline
from pbccs_tpu_torch.analysis.callgraph import build_graph
from pbccs_tpu_torch.analysis.core import load_sources

from test_torch_analysis import keyed

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "analysis"

NEW_RULES = {"ATM001", "ATM002", "LSE001", "LSE002",
             "PRO001", "PRO002", "PRO003"}


def rules_for(tmp_path, name: str, text: str) -> list:
    """The port's findings on one snippet, after asserting pbccs_tpu's
    analyzer finds the same."""
    f = tmp_path / name
    f.write_text(textwrap.dedent(text))
    mine = run_passes(tmp_path, paths=[f])
    assert keyed(mine, True) == keyed(jrun_passes(tmp_path, paths=[f]),
                                      False)
    return mine


def both_runs(root_of) -> list:
    """The port's findings on the tree `root_of("pbccs_tpu_torch")`
    builds, after asserting pbccs_tpu's analyzer finds the same on
    `root_of("pbccs_tpu")`."""
    mine = run_passes(root_of("pbccs_tpu_torch"))
    ref = jrun_passes(root_of("pbccs_tpu"))
    assert keyed(mine, True) == keyed(ref, False)
    return mine


def rule_ids(findings) -> set[str]:
    return {f.rule for f in findings}


# --------------------------------------------------- seeded known-bad shapes

@pytest.mark.parametrize("fixture,rule", [
    ("lse001_pos.py", "LSE001"),          # leaked lease
    ("atm001_pos.py", "ATM001"),          # non-atomic publish
    ("pro002_pos.py", "PRO002"),          # double-complete
    ("pro003_pos.py", "PRO003"),          # completion without ownership
])
def test_seeded_bad_fixture_fires(fixture, rule):
    findings = run_passes(FIXTURES, paths=[FIXTURES / fixture])
    assert rule in rule_ids(findings), (fixture, findings)


def test_live_tree_clean_for_new_passes():
    """The three interprocedural passes report zero findings on the
    port's tree (its baseline holds no entry for any of their rules:
    their findings are repaired, not kept)."""
    findings = [f for f in run_passes(REPO) if f.rule in NEW_RULES]
    assert findings == [], [f.render() for f in findings]
    baseline = load_baseline(REPO / "pbccs_tpu_torch/analysis/baseline.toml")
    assert not [s for s in baseline if s.rule in NEW_RULES], \
        "new-pass findings must be fixed, not baselined"


# ------------------------------------------------------------- call graph

def _graph(tmp_path, text):
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent(text))
    sources, _ = load_sources(tmp_path, [f])
    return build_graph(sources), sources[0]


def test_callgraph_inheritance_and_reaches(tmp_path):
    graph, src = _graph(tmp_path, """\
        class Base:
            def helper(self):
                self.emit()

            def emit(self):
                transport.send_bytes()


        class Child(Base):
            def run(self):
                self.helper()
    """)
    run = graph.method("Child", "run")
    assert run is not None
    # run -> helper (inherited) -> emit -> send_bytes, transitively
    assert "send_bytes" in graph.reaches(run)


def test_callgraph_typed_attribute_resolution(tmp_path):
    graph, src = _graph(tmp_path, """\
        class Budget:
            def free(self):
                ledger.settle()


        class Engine:
            def __init__(self):
                self.budget = Budget()

            def teardown(self):
                self.budget.free()
    """)
    td = graph.method("Engine", "teardown")
    assert "settle" in graph.reaches(td)


# ------------------------------------------------------- lease semantics

def test_lease_transfer_to_callback_is_release(tmp_path):
    findings = rules_for(tmp_path, "m.py", """\
        def go(budget, pool, batch):
            lease = budget.admit(batch.nbytes)
            pool.submit(batch, callback=lambda fut: finish(fut, lease))
    """)
    assert "LSE001" not in rule_ids(findings)
    assert "LSE002" not in rule_ids(findings)


def test_lease_transitive_release_through_helper(tmp_path):
    findings = rules_for(tmp_path, "m.py", """\
        class Driver:
            def _settle(self, lease):
                lease.release()

            def go(self, budget, batch):
                lease = budget.admit(batch.nbytes)
                if batch.empty:
                    self._settle(lease)
                    return
                lease.release()
    """)
    assert "LSE001" not in rule_ids(findings)


def test_bool_slot_acquire_if_not_return_pattern(tmp_path):
    clean = rules_for(tmp_path, "ok.py", """\
        class S:
            def _on_load(self, msg):
                if not self._try_acquire_slot(msg):
                    return
                self._release_slot()
    """)
    assert "LSE001" not in rule_ids(clean)
    leak = rules_for(tmp_path, "bad.py", """\
        class S:
            def _on_load(self, msg):
                if not self._try_acquire_slot(msg):
                    return
                if msg.get("bad"):
                    return
                self._release_slot()
    """)
    assert "LSE001" in rule_ids(leak)


def test_fd_lease_with_statement_safe_assignment_leaks(tmp_path):
    clean = rules_for(tmp_path, "ok.py", """\
        def read(path):
            with open(path) as fh:
                return fh.read()
    """)
    assert rule_ids(clean) == set()
    leak = rules_for(tmp_path, "bad.py", """\
        def read(path, want):
            fh = open(path)
            if not want:
                return None
            data = fh.read()
            fh.close()
            return data
    """)
    assert "LSE001" in rule_ids(leak)


def test_fd_escape_to_attribute_is_owned_elsewhere(tmp_path):
    findings = rules_for(tmp_path, "m.py", """\
        class W:
            def __init__(self, path):
                self._fh = open(path, "rb")

            def close(self):
                self._fh.close()
    """)
    assert "LSE001" not in rule_ids(findings)
    assert "LSE002" not in rule_ids(findings)


def test_finally_release_survives_return_inside_try(tmp_path):
    findings = rules_for(tmp_path, "m.py", """\
        def go(budget, batch, polish):
            lease = budget.admit(batch.nbytes)
            try:
                return polish(batch)
            finally:
                lease.release()
    """)
    assert rule_ids(findings) == set()


def test_raise_while_holding_unprotected_lease_fires(tmp_path):
    findings = rules_for(tmp_path, "m.py", """\
        def go(budget, batch):
            lease = budget.admit(batch.nbytes)
            if batch.poisoned:
                raise ValueError(batch.id)
            lease.release()
    """)
    assert "LSE002" in rule_ids(findings)


def test_best_effort_close_in_cleanup_counts_as_release(tmp_path):
    findings = rules_for(tmp_path, "m.py", """\
        def salvage(path, decode):
            fh = open(path)
            try:
                return decode(fh)
            except ValueError:
                try:
                    fh.close()
                except OSError:
                    pass
                raise
            finally:
                try:
                    fh.close()
                except OSError:
                    pass
    """)
    assert "LSE002" not in rule_ids(findings)
    assert "LSE001" not in rule_ids(findings)


def test_scope_factory_called_without_with(tmp_path):
    findings = rules_for(tmp_path, "m.py", """\
        def go(path, emit):
            atomic_output(path, "report")
            emit(path)
    """)
    assert "LSE001" in rule_ids(findings)


# ------------------------------------------------------ exsafe semantics

def test_exsafe_mode_variable_resolution(tmp_path):
    findings = rules_for(tmp_path, "m.py", """\
        class J:
            def start(self, resume):
                mode = "ab" if resume else "wb"
                self._fh = open(self.path, mode)
    """)
    assert "ATM001" in rule_ids(findings)


def test_exsafe_journal_writer_registered_exempt():
    sources, _ = load_sources(
        REPO, [REPO / "pbccs_tpu_torch" / "resilience" / "checkpoint.py"])
    from pbccs_tpu_torch.analysis.exsafe import analyze_exsafe

    assert [f for f in analyze_exsafe(sources, scoped=True)
            if f.rule == "ATM001"] == []


def test_exsafe_replace_without_fsync_in_function(tmp_path):
    findings = rules_for(tmp_path, "m.py", """\
        import os


        def promote(tmp, final):
            os.replace(tmp, final)
    """)
    assert "ATM002" in rule_ids(findings)


# ---------------------------------------------------- protolint semantics

def test_pro002_callback_registration_counts_once(tmp_path):
    findings = rules_for(tmp_path, "m.py", """\
        class S:
            def send(self, msg):
                self.transport.write(msg)

            def _on_work(self, msg):
                def on_done(result):
                    self.send({"type": "result"})

                try:
                    self.engine.submit(msg, callback=on_done)
                except RuntimeError:
                    self.send({"type": "error"})
    """)
    assert "PRO002" not in rule_ids(findings)


def test_pro003_accepts_class_body_lock_attribute(tmp_path):
    """Locks declared as class attributes (not in __init__) count as
    owning locks -- a `with self._lock:` over one must not fire."""
    findings = rules_for(tmp_path, "m.py", """\
        import threading


        class R:
            _lock = threading.Lock()

            def _complete_locked(self, rid):
                self.done = rid

            def finish(self, rid):
                with self._lock:
                    self._complete_locked(rid)
    """)
    assert "PRO003" not in rule_ids(findings)


def test_pro003_locked_function_reacquiring_lock_fires(tmp_path):
    findings = rules_for(tmp_path, "m.py", """\
        import threading


        class R:
            def __init__(self):
                self._lock = threading.Lock()
                self.done = {}

            def _finish_locked(self, rid):
                with self._lock:
                    self.done[rid] = True
    """)
    assert "PRO003" in rule_ids(findings)


def _mini_serve_repo(tmp_path, server_extra="", spec_errors="",
                     pkg_name="pbccs_tpu_torch"):
    root = tmp_path / pkg_name
    pkg = root / pkg_name / "serve"
    pkg.mkdir(parents=True)
    (root / "docs").mkdir()
    (root / "docs" / "DESIGN.md").write_text("# mini\n")
    (pkg / "protocol.py").write_text(textwrap.dedent(f"""\
        VERB_PING = "ping"
        TYPE_PONG = "pong"
        TYPE_ERROR = "error"
        ERR_BAD = "bad_request"
        {spec_errors}

        WIRE_VERBS = {{
            VERB_PING: {{"handler": "_on_ping",
                         "replies": (TYPE_PONG,)}},
        }}
        WIRE_REPLIES = (TYPE_PONG, TYPE_ERROR)
        WIRE_ERRORS = (ERR_BAD,)


        def error_to_wire(rid, code, message):
            return {{"type": TYPE_ERROR, "id": rid, "code": code,
                     "error": message}}
    """))
    server_text = textwrap.dedent(f"""\
        from {pkg_name}.serve import protocol


        class Session:
            def send(self, msg):
                self.conn.sendall(msg)

            def _on_ping(self, msg):
                self.send({{"type": protocol.TYPE_PONG}})

            def _dispatch(self, msg):
                verb = msg.get("verb")
                if verb == protocol.VERB_PING:
                    self._on_ping(msg)
                else:
                    self.send(protocol.error_to_wire(
                        msg.get("id"), protocol.ERR_BAD, "?"))
    """)
    if server_extra:
        server_text += "\n" + textwrap.indent(
            textwrap.dedent(server_extra), "    ")
    (pkg / "server.py").write_text(server_text)
    return root


def _serve_runs(tmp_path, **kw):
    return both_runs(lambda pkg: _mini_serve_repo(tmp_path, pkg_name=pkg,
                                                  **kw))


def test_pro001_clean_mini_repo(tmp_path):
    assert [f for f in _serve_runs(tmp_path) if f.rule == "PRO001"] == []


def test_pro001_undeclared_reply_and_error(tmp_path):
    found = _serve_runs(tmp_path, server_extra="""\
        def _on_extra(self, msg):
            self.send({"type": "mystery"})
            self.send(protocol.error_to_wire(1, "not_a_code", "x"))
    """)
    msgs = [f.message for f in found if f.rule == "PRO001"]
    assert any("'mystery'" in m for m in msgs), msgs
    assert any("'not_a_code'" in m for m in msgs), msgs


def test_pro001_spec_constant_drift(tmp_path):
    found = _serve_runs(tmp_path, spec_errors='VERB_GHOST = "ghost"')
    msgs = [f.message for f in found if f.rule == "PRO001"]
    assert any("'ghost'" in m and "missing from the wire spec" in m
               for m in msgs), msgs


def test_pro001_missing_handler(tmp_path):
    def root_of(pkg):
        root = _mini_serve_repo(tmp_path, pkg_name=pkg)
        server = root / pkg / "serve" / "server.py"
        server.write_text(server.read_text().replace(
            "def _on_ping", "def _on_gone"))
        return root

    msgs = [f.message for f in both_runs(root_of) if f.rule == "PRO001"]
    assert any("_on_ping" in m for m in msgs), msgs


def test_pro001_reads_the_ports_serve_tier(tmp_path):
    """The port's spec module is pbccs_tpu_torch/serve/protocol.py: a
    spec under pbccs_tpu/serve/ is not the port's."""
    from pbccs_tpu_torch.analysis.protolint import SPEC_MODULE, \
        TIER_MODULES

    assert SPEC_MODULE == "pbccs_tpu_torch/serve/protocol.py"
    assert all(m.startswith("pbccs_tpu_torch/serve/")
               for m in TIER_MODULES)
    root = _mini_serve_repo(tmp_path, pkg_name="pbccs_tpu",
                            server_extra="""\
        def _on_extra(self, msg):
            self.send({"type": "mystery"})
    """)
    assert [f for f in run_passes(root) if f.rule == "PRO001"] == []


# ------------------------------------------------ registry drift additions

def test_reg008_fault_kind_drift(tmp_path):
    def root_of(pkg_name):
        root = tmp_path / pkg_name
        pkg = root / pkg_name
        pkg.mkdir(parents=True)
        (pkg / "faults.py").write_text(
            'FAULT_KINDS = ("error", "novel")\n')
        (root / "docs").mkdir()
        (root / "docs" / "DESIGN.md").write_text(textwrap.dedent("""\
            <!-- ccs-analyze:fault-kinds-table:begin -->
            | `error` | raises | `pbccs_tpu/faults.py` |
            | `ghost` | gone | `pbccs_tpu/faults.py` |
            <!-- ccs-analyze:fault-kinds-table:end -->
        """))
        return root

    msgs = [f.message for f in both_runs(root_of) if f.rule == "REG008"]
    assert any("`novel`" in m for m in msgs), msgs
    assert any("`ghost`" in m for m in msgs), msgs


def test_reg009_undocumented_flag(tmp_path):
    def root_of(pkg_name):
        root = tmp_path / pkg_name
        pkg = root / pkg_name
        pkg.mkdir(parents=True)
        (pkg / "cli.py").write_text(textwrap.dedent("""\
            import argparse


            def build():
                p = argparse.ArgumentParser()
                p.add_argument("--documented")
                p.add_argument("--undocumented")
                return p
        """))
        (root / "docs").mkdir()
        (root / "docs" / "DESIGN.md").write_text(textwrap.dedent("""\
            <!-- ccs-analyze:flags-table:begin -->
            | `--documented` | fine | `pbccs_tpu/cli.py` |
            <!-- ccs-analyze:flags-table:end -->
        """))
        return root

    found = [f for f in both_runs(root_of) if f.rule == "REG009"]
    assert len(found) == 1 and "--undocumented" in found[0].message


# ---------------------------------------------- pass registry + baselines

def test_pass_registry_covers_every_rule():
    from pbccs_tpu_torch.analysis import RULES, pass_for_rule

    uncovered = {r for r in RULES
                 if r not in ("ANA001", "ANA002")
                 and pass_for_rule(r) is None}
    assert not uncovered, f"rules owned by no pass: {uncovered}"


def test_passes_are_pbccs_tpus_without_jax():
    from pbccs_tpu.analysis import PASSES as JPASSES

    assert set(PASSES) == set(JPASSES) - {"jax"}
    for name, spec in PASSES.items():
        assert spec.rules == JPASSES[name].rules, name
        assert spec.repo_wide == JPASSES[name].repo_wide, name


def test_baseline_rejects_unknown_rule(tmp_path):
    bad = tmp_path / "baseline.toml"
    bad.write_text('[[suppress]]\nrule = "ZZZ999"\npath = "x.py"\n')
    with pytest.raises(BaselineError):
        load_baseline(bad)


def test_baseline_rejects_wrong_pass_for_rule(tmp_path):
    bad = tmp_path / "baseline.toml"
    bad.write_text('[[suppress]]\nrule = "CONC002"\npath = "x.py"\n'
                   'pass = "leases"\n')
    with pytest.raises(BaselineError):
        load_baseline(bad)


def test_pass_scoped_cli_run_is_clean_and_scopes_staleness():
    from pbccs_tpu_torch.analysis.cli import run_analyze

    # the conc baseline entries are in scope here and must match
    assert run_analyze(["--root", str(REPO), "--pass", "conc"]) == 0
    # ...and OUT of scope here: no ANA001 for the unmatched entries
    assert run_analyze(["--root", str(REPO),
                        "--pass", "leases,exsafe,proto"]) == 0
    assert run_analyze(["--root", str(REPO), "--pass", "nope"]) == 2
    assert run_analyze(["--root", str(REPO), "--pass", "jax"]) == 2


def test_wire_spec_parses_from_live_protocol():
    from pbccs_tpu_torch.analysis.protolint import SPEC_MODULE, parse_spec

    sources, _ = load_sources(REPO)
    proto = next(s for s in sources if s.rel == SPEC_MODULE)
    spec, err = parse_spec(proto)
    assert err is None
    assert set(spec.verbs) == {"submit", "status", "metrics", "trace",
                               "ping", "fleet"}
    assert "closed" in spec.replies
    assert spec.errors == {"bad_request", "overloaded", "closed",
                           "internal", "unauthorized"}


def test_passes_registry_names_match_design_doc():
    design = (REPO / "docs" / "DESIGN.md").read_text()
    for name in PASSES:
        assert name in design, f"pass {name!r} undocumented in DESIGN.md"
