"""The port's `ccs tune` batch leg (pbccs_tpu_torch/tune and
runtime/tuning.py) and its serve leg (`--serveLeg`, a `ccs serve`
subprocess per candidate, here a scripted stand-in) on the CPU, against
pbccs_tpu's.

Counterparts of tests/test_tune.py's non-serve cases: profiles (round
trip, fail-open on a missing, corrupt or torn file, fingerprint
mismatches -- a pbccs_tpu profile among them), the resolution ladder,
the knob space and candidate invocation, the objective, journal resume,
the search driver with a scripted candidate runner, and the port's
referee (pbccs_tpu_torch/tools/perf_gate.py) giving tools/perf_gate.py's
verdict on the same records.  The band-width ladder: with PBCCS_BAND_W
set, and again with a tuned band_w, the port's effective_band_width is
pbccs_tpu's on the same bucket."""

import dataclasses
import importlib.util
import json
import os
import sys
import time

import pytest
import torch

from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.runtime import tuning
from pbccs_tpu_torch.tune import driver, objective, space
from pbccs_tpu_torch.tune.profile import (PROFILE_SCHEMA_VERSION,
                                          HostProfile, discover_profile,
                                          fingerprint_mismatch,
                                          host_fingerprint, load_profile,
                                          save_profile)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_tuning_state(monkeypatch):
    """Every test starts and ends on hand-tuned defaults in both
    packages, with no ambient knob envs."""
    from pbccs_tpu.runtime import tuning as jtuning

    for var in ("PBCCS_BAND_W", "PBCCS_DENSE_CB", "PBCCS_TUNE_PROFILE",
                "PBCCS_TUNE_PROFILE_DIR"):
        monkeypatch.delenv(var, raising=False)
    tuning.reset()
    jtuning.reset()
    yield
    tuning.reset()
    jtuning.reset()


def host():
    return host_fingerprint("cpu")


def make_profile(knobs, fingerprint=None):
    return HostProfile(fingerprint=fingerprint or host(), knobs=knobs)


def write_profile(tmp_path, knobs, fingerprint=None, name="prof.json"):
    path = str(tmp_path / name)
    save_profile(make_profile(knobs, fingerprint), path)
    return path


def configure(spec, **kw):
    return tuning.configure(spec, device="cpu", **kw)


class RecordingLog:
    def __init__(self):
        self.lines = []

    def notice(self, msg):
        self.lines.append(msg)

    info = warn = notice

    def text(self):
        return "\n".join(self.lines)


# ---------------------------------------------------------------- profiles

def test_cpu_fingerprint_names_torch():
    fp = host()
    assert fp == {"platform": "cpu", "device_kind": "cpu",
                  "device_count": 1, "torch_version": torch.__version__}


def test_card_fingerprint_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        host_fingerprint()


def test_round_trip(tmp_path):
    path = write_profile(tmp_path, {"band_w": 96, "dense_cb": 2,
                                    "warmup_buckets": ["8x3x120"]})
    prof, note = load_profile(path)
    assert note is None and prof.schema_version == PROFILE_SCHEMA_VERSION
    assert prof.knobs == {"band_w": 96, "dense_cb": 2,
                          "warmup_buckets": ["8x3x120"]}
    assert not os.path.exists(path + ".tmp")


def test_profile_id_tracks_content_as_pbccs_tpu():
    """The id is pbccs_tpu's hash of the same fingerprint and knobs."""
    from pbccs_tpu.tune.profile import HostProfile as JProfile

    fp = {"platform": "cpu", "device_kind": "cpu", "device_count": 1,
          "torch_version": "1"}
    a = HostProfile(fingerprint=fp, knobs={"band_w": 64})
    assert a.profile_id == HostProfile(fingerprint=fp,
                                       knobs={"band_w": 64}).profile_id
    assert a.profile_id != HostProfile(fingerprint=fp,
                                       knobs={"band_w": 96}).profile_id
    assert a.profile_id == JProfile(fingerprint=fp,
                                    knobs={"band_w": 64}).profile_id
    assert len(a.profile_id) == 12


def test_missing_file_degrades(tmp_path):
    prof, note = load_profile(str(tmp_path / "nope.json"))
    assert prof is None and "cannot read" in note


@pytest.mark.parametrize("content", [
    "{torn",
    "[]",
    json.dumps({"profile_schema_version": 99, "fingerprint": {},
                "knobs": {}}),
    json.dumps({"profile_schema_version": 1,
                "fingerprint": {"platform": "cpu"}, "knobs": {}}),
    json.dumps({"profile_schema_version": 1,
                "fingerprint": {"platform": "cpu", "device_kind": "c",
                                "device_count": 1, "torch_version": "1"},
                "knobs": {"band_w": True}}),
], ids=["torn", "alien", "future", "incomplete", "bool_knob"])
def test_corrupt_profiles_degrade(tmp_path, content):
    p = tmp_path / "bad.json"
    p.write_text(content)
    prof, note = load_profile(str(p))
    assert prof is None and note


def test_fingerprint_mismatch_names_field():
    other = dict(host(), device_kind="NVIDIA H100 80GB HBM3")
    assert "device_kind" in fingerprint_mismatch(other, host())
    assert fingerprint_mismatch(dict(host()), host()) is None


def test_pbccs_tpu_profile_never_applies(tmp_path):
    """The committed pbccs_tpu profile and one pbccs_tpu writes now name
    jax_version: the port reads neither, with a logged note, and runs
    on its defaults."""
    from pbccs_tpu.tune.profile import HostProfile as JProfile
    from pbccs_tpu.tune.profile import host_fingerprint as jhost
    from pbccs_tpu.tune.profile import save_profile as jsave

    jpath = str(tmp_path / "jax.json")
    jsave(JProfile(fingerprint=jhost(), knobs={"band_w": 96}), jpath)
    for path in (jpath, os.path.join(REPO, "profiles", "cpu-cpu.json")):
        log = RecordingLog()
        assert configure(path, logger=log) is False
        assert tuning.active_profile() is None
        assert tuning.ledger_tag() == "none"
        assert "hand-tuned defaults" in log.text()
    # a port-schema profile carrying pbccs_tpu's fingerprint values
    fp = dict(host(), torch_version="0.0.1")
    log = RecordingLog()
    assert configure(write_profile(tmp_path, {"band_w": 96}, fp),
                     logger=log) is False
    assert "torch_version" in log.text()


def test_discover_picks_matching_skips_alien(tmp_path):
    write_profile(tmp_path, {"band_w": 64},
                  fingerprint=dict(host(), torch_version="0.0.1"),
                  name="a-othergen.json")
    write_profile(tmp_path, {"band_w": 128}, name="b-this.json")
    (tmp_path / "0-junk.json").write_text("{torn")
    prof, notes = discover_profile(str(tmp_path), host())
    assert prof is not None and prof.knobs["band_w"] == 128
    assert any("torch_version" in n for n in notes)
    assert any("0-junk" in n for n in notes)


def test_discover_empty_dir(tmp_path):
    prof, notes = discover_profile(str(tmp_path), host())
    assert prof is None and any("no profile" in n for n in notes)


# ------------------------------------------------------- resolution ladder

def test_opt_in_only():
    assert configure(None) is False
    assert tuning.active_profile() is None
    assert tuning.knob_int("band_w") is None
    assert tuning.ledger_tag() == "none"
    for off in ("", "off", "none", "OFF"):
        assert configure(off) is False


def test_profile_applies_and_attributes(tmp_path):
    path = write_profile(tmp_path, {"band_w": 96, "prepare_workers": 2})
    log = RecordingLog()
    assert configure(path, logger=log) is True
    prof = tuning.active_profile()
    assert tuning.knob_int("band_w") == 96
    assert tuning.knob_int("prepare_workers") == 2
    assert tuning.ledger_tag() == prof.profile_id
    assert "applied host profile" in log.text()
    text = default_registry().render_prometheus()
    assert "ccs_tune_profile_applied" in text and prof.profile_id in text


def test_env_spec_equivalent_to_flag(tmp_path, monkeypatch):
    monkeypatch.setenv("PBCCS_TUNE_PROFILE",
                       write_profile(tmp_path, {"band_w": 128}))
    assert configure(None) is True
    assert tuning.knob_int("band_w") == 128


def test_auto_discovery_scans_profile_dir(tmp_path, monkeypatch):
    write_profile(tmp_path, {"band_w": 96})
    monkeypatch.setenv("PBCCS_TUNE_PROFILE_DIR", str(tmp_path))
    assert configure("auto") is True
    assert tuning.knob_int("band_w") == 96


def test_corrupt_profile_degrades_without_crashing(tmp_path):
    p = tmp_path / "torn.json"
    p.write_text('{"profile_schema_version": 1, "knobs": {"ban')
    log = RecordingLog()
    assert configure(str(p), logger=log) is False
    assert tuning.knob_int("band_w") is None
    assert "not valid JSON" in log.text()


def test_knob_type_guards(tmp_path):
    configure(write_profile(tmp_path, {"band_w": 96,
                                       "warmup_buckets": ["8x3x120"],
                                       "label": "text"}))
    assert tuning.knob_int("warmup_buckets") is None
    assert tuning.knob_float("label") is None
    assert tuning.knob_str_list("band_w") is None


def test_warmup_bucket_menu_from_profile(tmp_path, capsys):
    from pbccs_tpu_torch.cli import run
    from pbccs_tpu_torch.sched.warmup import build_parser

    assert build_parser().parse_args([]).bucket is None
    path = write_profile(tmp_path, {"warmup_buckets": ["2x3x40"]})
    assert run(["warmup", "--tuneProfile", path, "--logLevel", "WARN"],
               device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [e["bucket"] for e in out["warmed"]] == ["2x3x40"]


def _jax_band_width(jmax):
    from pbccs_tpu.models.arrow.params import (BandingOptions,
                                               effective_band_width)

    return effective_band_width(BandingOptions(), jmax)


@pytest.mark.parametrize("source", ["env", "profile"])
@pytest.mark.parametrize("jmax", [256, 2112])
def test_band_width_ladder_matches_pbccs_tpu(tmp_path, monkeypatch, source,
                                             jmax):
    """Explicit width > PBCCS_BAND_W > tuned band_w > schedule, in both
    packages: with the env var set, and again with a tuned profile
    applied in each, the port's width is pbccs_tpu's on the bucket."""
    from pbccs_tpu.runtime import tuning as jtuning
    from pbccs_tpu.tune.profile import HostProfile as JProfile
    from pbccs_tpu.tune.profile import host_fingerprint as jhost
    from pbccs_tpu.tune.profile import save_profile as jsave

    from pbccs_tpu_torch.models.arrow.params import (BandingOptions,
                                                     effective_band_width)

    def port(jmax, width=None):
        return effective_band_width(BandingOptions(band_width=width), jmax)

    assert port(jmax) == _jax_band_width(jmax)     # the schedule
    if source == "env":
        monkeypatch.setenv("PBCCS_BAND_W", "128")
    else:
        configure(write_profile(tmp_path, {"band_w": 128}))
        jpath = str(tmp_path / "jax.json")
        jsave(JProfile(fingerprint=jhost(), knobs={"band_w": 128}), jpath)
        assert jtuning.configure(jpath) is True
    assert port(jmax) == _jax_band_width(jmax) == 128
    if source == "profile":
        # the env var beats the profile, in both
        monkeypatch.setenv("PBCCS_BAND_W", "64")
        assert port(jmax) == _jax_band_width(jmax) == 64
    assert port(jmax, width=192) == 192           # explicit beats all


def test_cli_tune_profile_stamps_ledger_and_is_scoped(tmp_path):
    """--tuneProfile on `ccs`: the profile's prepare_workers and band_w
    apply to the run, its id lands in the ledger record, and the profile
    is gone from the process when run() returns."""
    from pbccs_tpu_torch import pipeline as tp
    from pbccs_tpu_torch.cli import run
    from pbccs_tpu_torch.io.fasta import write_fasta
    from pbccs_tpu_torch.models.arrow.params import decode_bases
    from pbccs_tpu_torch.simulate import simulate_zmw
    import numpy as np

    rng = np.random.default_rng(7)
    recs = []
    for z in range(2):
        _, reads, _, _ = simulate_zmw(rng, 60, 4)
        recs += [(f"m/{z}/{i * 100}_{i * 100 + len(r)}", decode_bases(r))
                 for i, r in enumerate(reads)]
    fasta = str(tmp_path / "in.fasta")
    write_fasta(fasta, recs)
    path = write_profile(tmp_path, {"prepare_workers": 3, "band_w": 96})
    widths = []
    real = tp._polish_batch_arrow

    def spy(preps, settings, device, *, buckets=None, **kw):
        from pbccs_tpu_torch.models.arrow.params import (
            BandingOptions, effective_band_width)

        widths.append(effective_band_width(BandingOptions(), 256))
        return real(preps, settings, device, buckets=buckets, **kw)

    ledger = str(tmp_path / "l.ndjson")
    mp = pytest.MonkeyPatch()
    mp.setattr(tp, "_polish_batch_arrow", spy)
    try:
        assert run([str(tmp_path / "o.fasta"), fasta, "--skipChemistryCheck",
                    "--devices", "2", "--tuneProfile", path,
                    "--reportFile", str(tmp_path / "r.csv"),
                    "--perfLedger", ledger, "--logLevel", "WARN"],
                   device="cpu") == 0
    finally:
        mp.undo()
    (rec,) = [json.loads(line) for line in open(ledger)]
    assert rec["tuned_profile"] == load_profile(path)[0].profile_id
    assert widths and set(widths) == {96}
    assert tuning.active_profile() is None


# ------------------------------------------------------------- knob space

def test_targets_cover_every_declared_knob_as_pbccs_tpu():
    from pbccs_tpu.tune import space as jspace

    declared = {k.name for k in (*space.BATCH_KNOBS, *space.SERVE_KNOBS)}
    declared.update(space.PROFILE_ONLY_KNOBS, {"dense_cb"})   # unswept
    assert declared == set(space.KNOB_TARGETS)
    assert space.KNOB_TARGETS == jspace.KNOB_TARGETS


def test_band_w_grid_is_the_built_widths():
    from pbccs_tpu_torch.ops.dense_score_cuda import K3_WIDTHS
    from pbccs_tpu_torch.ops.fwdbwd_cuda import K1_WIDTHS

    grid = space.knob_by_name("band_w").candidates
    assert grid == (64, 96, 128)
    # the 2x mating retry runs at twice the width: both must be built
    assert all(w in K1_WIDTHS and 2 * w in K1_WIDTHS for w in grid)
    assert all(w in K3_WIDTHS and 2 * w in K3_WIDTHS for w in grid)
    assert space.knob_by_name("dense_cb") is None


def test_candidate_invocation_env_and_cli(tmp_path):
    argv, env = space.candidate_invocation({"band_w": 96,
                                            "prepare_workers": 2})
    assert env == {"PBCCS_BAND_W": "96"}
    assert argv == ["--prepareWorkers", "2"]
    cfg = driver.TuneConfig(workdir=str(tmp_path), out_path="p.json",
                            devices=0, chunk_size=8)
    cmd = driver.candidate_command(cfg, "calib.fasta", str(tmp_path), argv)
    assert cmd[1:3] == ["-m", "pbccs_tpu_torch.cli"]
    assert cmd[cmd.index("--devices") + 1] == "0"
    assert cmd[cmd.index("--chunkSize") + 1] == "8"
    assert "--perfLedger" in cmd and cmd[-2:] == ["--prepareWorkers", "2"]


def test_hung_candidate_run_is_killed_and_fails(tmp_path, monkeypatch):
    """A calibration run past its time is killed; the candidate fails
    with the reason and the journal records it as failed."""
    cfg = tune_cfg(tmp_path, [])
    monkeypatch.setattr(driver, "candidate_command", lambda *a: [
        sys.executable, "-c", "import time; time.sleep(60)"])
    t0 = time.monotonic()
    res = driver._run_candidate(cfg, {"prepare_workers": 2},
                                os.path.join(cfg.workdir,
                                             "calibration.fasta"),
                                timeout_s=0.5)
    assert time.monotonic() - t0 < 30
    assert not res.ok and "timed out after 0.5 s" in res.reason
    journal = driver.Journal(os.path.join(cfg.workdir, "j.ndjson"), False)
    journal.put(res)
    back = driver.Journal(journal.path, True).get(res.key)
    assert back is not None and not back.ok and back.reason == res.reason


@pytest.mark.parametrize("budget_s", [0.0, 30.0, 600.0])
def test_candidate_timeout_follows_the_budget(tmp_path, monkeypatch,
                                              one_knob, budget_s):
    """Each candidate's runs are bounded by what is left of --tuneBudget
    (never below the floor); an unbounded budget bounds nothing."""
    runner = FakeRunner({
        driver.assignment_key({}): {"zps": 10.0},
        driver.assignment_key({"band_w": 96}): {"zps": 10.0},
        driver.assignment_key({"band_w": 128}): {"zps": 10.0},
    })
    monkeypatch.setattr(driver, "_run_candidate", runner)
    driver.run_search(tune_cfg(tmp_path, one_knob, budget_s=budget_s))
    assert len(runner.timeouts) == 3
    for t in runner.timeouts:
        if budget_s == 0:
            assert t is None
        else:
            assert driver.CANDIDATE_TIMEOUT_FLOOR_S <= t <= max(
                budget_s, driver.CANDIDATE_TIMEOUT_FLOOR_S)


def test_candidate_invocation_rejects_unsweepable_knobs():
    for knob in ("serve_max_batch", "dense_cb", "mystery"):
        with pytest.raises(ValueError, match="not batch-sweepable"):
            space.candidate_invocation({knob: 8})


def test_candidate_env_drops_ambient_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("PBCCS_BAND_W", "128")
    monkeypatch.setenv("PBCCS_DENSE_CB", "2")
    monkeypatch.setenv("PBCCS_TUNE_PROFILE", "auto")
    env = driver._base_env(driver.TuneConfig(workdir=str(tmp_path),
                                             out_path="p.json"))
    assert not {"PBCCS_BAND_W", "PBCCS_DENSE_CB",
                "PBCCS_TUNE_PROFILE"} & set(env)


def test_affected_fields_union():
    assert space.affected_fields(
        {"band_w": 96, "mem_budget_bytes": 1 << 28}) == {
            "roofline_flops", "roofline_bytes", "budget_throttles"}
    assert space.affected_fields({"prepare_workers": 2}) == set()


def test_batch_space_restrict_and_override():
    knobs = space.batch_space(["band_w"], {"band_w": (64, 128)})
    assert [k.name for k in knobs] == ["band_w"]
    assert knobs[0].candidates == (64, 128)
    assert space.knob_by_name("band_w").candidates == (64, 96, 128)


# -------------------------------------------------------------- objective

def meas(zps, wall=10.0, **kw):
    return objective.Measurement(zmws_per_sec=zps, wall_s=wall, **kw)


def test_objective_is_pbccs_tpus():
    from pbccs_tpu.tune import objective as jobjective

    records = [
        {"kind": "batch_run", "zmws_per_sec": 10.0, "wall_s": 6.4,
         "padding_waste": 0.25, "peak_rss_bytes": 100},
        {"kind": "batch_run", "zmws_per_sec": 30.0, "wall_s": 2.1,
         "padding_waste": 0.25, "peak_rss_bytes": 300},
        {"kind": "batch_run", "zmws_per_sec": 20.0, "wall_s": 3.2,
         "padding_waste": 0.25, "peak_rss_bytes": 200},
    ]
    m = objective.measure(records)
    assert m.to_doc() == jobjective.measure(records).to_doc()
    assert m.zmws_per_sec == 20.0 and m.repeats == 3
    assert objective.measure([{"kind": "batch_run"}]) is None
    base = meas(100.0, padding_waste=0.2, peak_rss_bytes=100)
    for cand in (meas(110.0), meas(90.0),
                 meas(101.0, padding_waste=0.1, peak_rss_bytes=100),
                 meas(101.0, padding_waste=0.3, peak_rss_bytes=50),
                 meas(100.0, padding_waste=0.2, peak_rss_bytes=100)):
        jc = jobjective.Measurement(**dataclasses.asdict(cand))
        jb = jobjective.Measurement(**dataclasses.asdict(base))
        assert objective.better(cand, base) == jobjective.better(jc, jb)


# ---------------------------------------------------------------- journal

def test_journal_round_trip_and_resume(tmp_path):
    path = str(tmp_path / "journal.ndjson")
    j = driver.Journal(path, resume=False)
    j.put(driver.CandidateResult({"band_w": 96}, ok=True, digest="d1",
                                 measurement=meas(10.0),
                                 records=[{"kind": "batch_run"}]))
    j.put(driver.CandidateResult({"band_w": 128}, ok=False, reason="boom"))
    j2 = driver.Journal(path, resume=True)
    back = j2.get(driver.assignment_key({"band_w": 96}))
    assert back.ok and back.digest == "d1"
    assert back.measurement.zmws_per_sec == 10.0
    bad = j2.get(driver.assignment_key({"band_w": 128}))
    assert not bad.ok and bad.reason == "boom"


def test_journal_torn_tail_tolerated(tmp_path):
    path = str(tmp_path / "journal.ndjson")
    driver.Journal(path, resume=False).put(driver.CandidateResult(
        {"band_w": 96}, ok=True, digest="d", measurement=meas(10.0)))
    with open(path, "a") as fh:
        fh.write('{"tune_journal": 1, "assignment": {"band_')
    assert driver.Journal(path, resume=True).get(
        driver.assignment_key({"band_w": 96})) is not None


def test_journal_fresh_run_truncates(tmp_path):
    path = str(tmp_path / "journal.ndjson")
    driver.Journal(path, resume=False).put(driver.CandidateResult(
        {}, ok=True, digest="d", measurement=meas(10.0)))
    assert driver.Journal(path, resume=False).get(
        driver.assignment_key({})) is None


# ------------------------------------------------------------ search driver

def batch_record(zps, *, dispatches=5, flops=1000, torch_v="t", wall=None):
    return {"kind": "batch_run", "schema_version": 1,
            "torch_version": torch_v, "platform": "cpu",
            "zmws_per_sec": zps, "wall_s": wall or round(64.0 / zps, 4),
            "polish_dispatches": dispatches, "roofline_flops": flops,
            "padding_waste": 0.1}


class FakeRunner:
    """Stands in for driver._run_candidate: a scripted candidate table
    keyed by assignment, counting invocations."""

    def __init__(self, table):
        self.table = table
        self.calls = []
        self.timeouts = []

    def __call__(self, cfg, assignment, calib, timeout_s=None):
        self.calls.append(dict(assignment))
        self.timeouts.append(timeout_s)
        spec = self.table[driver.assignment_key(assignment)]
        if "reason" in spec:
            return driver.CandidateResult(assignment, ok=False,
                                          reason=spec["reason"])
        records = [batch_record(spec["zps"], **spec.get("rec", {}))
                   for _ in range(3)]
        return driver.CandidateResult(
            assignment, ok=True, digest=spec.get("digest", "base"),
            measurement=objective.measure(records), records=records)


def tune_cfg(tmp_path, knobs, **kw):
    cfg = driver.TuneConfig(
        workdir=str(tmp_path / "work"), out_path=str(tmp_path / "prof.json"),
        zmws=8, passes=3, tpl_len=120, chunk_size=8, repeat=3,
        knobs=knobs, device="cpu", **kw)
    os.makedirs(cfg.workdir, exist_ok=True)
    open(os.path.join(cfg.workdir, "calibration.fasta"), "w").close()
    return cfg


@pytest.fixture
def one_knob():
    return [dataclasses.replace(space.knob_by_name("band_w"),
                                candidates=(96, 128))]


def test_search_winner_ships_profile_loader_applies_it(tmp_path, monkeypatch,
                                                       one_knob):
    monkeypatch.setattr(driver, "_run_candidate", FakeRunner({
        driver.assignment_key({}): {"zps": 10.0},
        # faster, and perturbs only its declared side-effect field
        driver.assignment_key({"band_w": 96}):
            {"zps": 14.0, "rec": {"flops": 1500}},
        driver.assignment_key({"band_w": 128}): {"zps": 9.0},
    }))
    summary = driver.run_search(tune_cfg(tmp_path, one_knob))
    assert summary["shipped"] is True
    assert summary["winner"]["assignment"] == {"band_w": 96}
    assert summary["winner"]["gain"] == pytest.approx(0.4)
    assert summary["referee"]["violations"] == []
    prof, _ = load_profile(summary["profile"])
    assert prof.fingerprint == host()
    assert configure(summary["profile"]) is True
    assert tuning.knob_int("band_w") == 96
    assert tuning.knob_str_list("warmup_buckets") == ["8x3x120"]
    assert tuning.ledger_tag() == summary["profile_id"]


@pytest.mark.parametrize("case", ["output_change", "counter_drift",
                                  "min_gain", "no_winner"])
def test_search_does_not_ship(tmp_path, monkeypatch, one_knob, case):
    spec = {"output_change": {"zps": 50.0, "digest": "DIFFERENT"},
            "counter_drift": {"zps": 14.0, "rec": {"dispatches": 9}},
            "min_gain": {"zps": 10.5},
            "no_winner": {"zps": 8.0}}[case]
    monkeypatch.setattr(driver, "_run_candidate", FakeRunner({
        driver.assignment_key({}): {"zps": 10.0},
        driver.assignment_key({"band_w": 96}): spec,
        driver.assignment_key({"band_w": 128}): {"zps": 9.0},
    }))
    summary = driver.run_search(tune_cfg(
        tmp_path, one_knob, min_gain=0.10 if case == "min_gain" else 0.0))
    assert summary["shipped"] is False
    assert not os.path.exists(str(tmp_path / "prof.json"))
    if case == "output_change":
        assert any("output differs" in r["reason"]
                   for r in summary["rejected"])
    elif case == "counter_drift":
        assert any(v["metric"] == "polish_dispatches"
                   for v in summary["referee"]["violations"])
        assert "NOT shipped" in summary["note"]
    elif case == "min_gain":
        assert "--minGain" in summary["note"]
        assert driver.run_search(tune_cfg(tmp_path, one_knob,
                                          min_gain=-1.0))["shipped"]
    else:
        assert "nothing to ship" in summary["note"]


def test_search_joint_refine_and_resume(tmp_path, monkeypatch):
    knobs = [dataclasses.replace(space.knob_by_name("band_w"),
                                 candidates=(96,)),
             dataclasses.replace(space.knob_by_name("prepare_workers"),
                                 candidates=(2,))]
    runner = FakeRunner({
        driver.assignment_key({}): {"zps": 10.0},
        driver.assignment_key({"band_w": 96}): {"zps": 12.0},
        driver.assignment_key({"prepare_workers": 2}): {"zps": 11.0},
        driver.assignment_key({"band_w": 96, "prepare_workers": 2}):
            {"zps": 13.0},
    })
    monkeypatch.setattr(driver, "_run_candidate", runner)
    summary = driver.run_search(tune_cfg(tmp_path, knobs))
    assert summary["shipped"] is True
    assert summary["winner"]["assignment"] == {"band_w": 96,
                                               "prepare_workers": 2}
    measured = len(runner.calls)
    summary2 = driver.run_search(tune_cfg(tmp_path, knobs, resume=True))
    assert summary2["winner"] == summary["winner"]
    assert len(runner.calls) == measured


def test_search_defaults_run_failure_is_an_error(tmp_path, monkeypatch,
                                                 one_knob):
    monkeypatch.setattr(driver, "_run_candidate", FakeRunner({
        driver.assignment_key({}): {"reason": "exploded"}}))
    summary = driver.run_search(tune_cfg(tmp_path, one_knob))
    assert "error" in summary and "exploded" in summary["error"]


@pytest.mark.parametrize("argv", [["--serveLeg", "--candidates",
                                   "serve_max_batch=eight"],
                                  ["--knobs", "mystery"],
                                  ["--candidates", "band_w"],
                                  ["--set", "mystery=1"]],
                         ids=["serveLeg", "knobs", "candidates", "set"])
def test_tune_cli_usage_errors_exit_2(argv, capsys):
    """Usage errors exit 2 before any candidate runs, a serve-leg knob's
    value that does not parse among them."""
    from pbccs_tpu_torch.cli import run

    assert run(["tune", *argv, "--logLevel", "WARN"], device="cpu") == 2
    err = capsys.readouterr().err
    assert ("serve_max_batch=eight" in err) == (argv[0] == "--serveLeg")


def test_tune_cli_prints_one_summary(tmp_path, monkeypatch, capsys):
    from pbccs_tpu_torch.cli import run

    monkeypatch.setattr(driver, "_run_candidate", FakeRunner({
        driver.assignment_key({}): {"zps": 10.0},
        driver.assignment_key({"prepare_workers": 1}): {"zps": 10.0},
        driver.assignment_key({"prepare_workers": 2}): {"zps": 13.0}}))
    out = str(tmp_path / "p.json")
    assert run(["tune", "--out", out, "--workdir", str(tmp_path / "w"),
                "--zmws", "2", "--passes", "3", "--tplLen", "40",
                "--knobs", "prepare_workers", "--candidates",
                "prepare_workers=1,2", "--set", "dense_cb=2",
                "--logLevel", "WARN"], device="cpu") == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["shipped"] and summary["profile"] == out
    prof, _ = load_profile(out)
    assert prof.knobs == {"prepare_workers": 2, "dense_cb": 2,
                          "warmup_buckets": ["2x3x40"]}
    assert os.path.getsize(str(tmp_path / "w" / "calibration.fasta")) > 0


# ---------------------------------------------------------------- referee

def _tools_gate():
    spec = importlib.util.spec_from_file_location(
        "_tools_perf_gate", os.path.join(REPO, "tools", "perf_gate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("drift,ignore,expected", [
    ({}, None, set()),
    ({"flops": 7}, None, {"roofline_flops"}),
    ({"flops": 7}, {"roofline_flops"}, set()),
    ({"flops": 7, "dispatches": 8}, {"roofline_flops"},
     {"polish_dispatches"}),
    ({"torch_v": "u"}, None, set()),
], ids=["clean", "drift", "ignored", "ignore_keeps_other", "other_torch"])
def test_referee_gives_the_gates_verdict(drift, ignore, expected):
    from pbccs_tpu_torch.tools import perf_gate as mine

    pg = _tools_gate()
    base = [batch_record(10.0)]
    obs = [batch_record(10.0, **drift)]
    want = pg.compare(pg.build_baseline(base, select={"kind": "batch_run"}),
                      obs, counters_only=True, ignore=ignore)
    got = mine.compare(mine.build_baseline(base,
                                           select={"kind": "batch_run"}),
                       obs, counters_only=True, ignore=ignore)
    assert got[0] == want[0]
    assert {v["metric"] for v in got[0]} == expected
    if ignore:
        assert any("exempted" in n for n in got[1])


# ------------------------------------------------------------- serve leg

class FakeServe:
    """Stands in for driver._serve_candidate: (digest, wall s, p99 ms)
    or a failure string per serve-knob assignment."""

    def __init__(self, table):
        self.table = table
        self.calls = []

    def __call__(self, cfg, assignment, calib):
        self.calls.append(dict(assignment))
        return self.table.get(driver.assignment_key(assignment),
                              self.table.get("*"))


def test_serve_leg_picks_the_fastest_identical_candidate(tmp_path,
                                                         monkeypatch):
    fake = FakeServe({
        driver.assignment_key({}): ("d", 10.0, 500.0),
        driver.assignment_key({"serve_max_batch": 8}): ("d", 8.0, 300.0),
        driver.assignment_key({"serve_max_batch": 16}): ("d", 10.0, 400.0),
        driver.assignment_key({"serve_max_batch": 32}): ("d", 6.0, 900.0),
        driver.assignment_key({"serve_max_wait_ms": 100.0}):
            ("OTHER", 1.0, 1.0),
        driver.assignment_key({"serve_max_wait_ms": 250.0}):
            "serve exited or never printed CCS-SERVE-READY"})
    monkeypatch.setattr(driver, "_serve_candidate", fake)
    won: dict = {}
    res = driver.run_serve_leg(tune_cfg(tmp_path, []), won)
    # the whole serve grid, the defaults first
    assert fake.calls == [{}, {"serve_max_batch": 8},
                          {"serve_max_batch": 16},
                          {"serve_max_batch": 32},
                          {"serve_max_wait_ms": 100.0},
                          {"serve_max_wait_ms": 250.0}]
    assert won == {"serve_max_batch": 32}
    assert res["winner"]["assignment"] == {"serve_max_batch": 32}
    assert res["baseline"] == {"wall_s": 10.0, "p99_ms": 500.0}
    reasons = {json.dumps(r["assignment"]): r["reason"]
               for r in res["rejected"]}
    assert reasons == {
        '{"serve_max_wait_ms": 100.0}': "served output differs from "
                                        "defaults",
        '{"serve_max_wait_ms": 250.0}': "serve exited or never printed "
                                        "CCS-SERVE-READY"}


def test_serve_leg_defaults_failure_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(driver, "_serve_candidate",
                        FakeServe({driver.assignment_key({}): "boom"}))
    won: dict = {}
    res = driver.run_serve_leg(tune_cfg(tmp_path, []), won)
    assert res["error"] == "serve defaults run failed: boom" and not won


def test_serve_command_maps_knobs_to_serve_flags():
    cmd = driver.serve_command({"serve_max_wait_ms": 100.0,
                                "serve_max_batch": 8})
    assert cmd[1:4] == ["-m", "pbccs_tpu_torch.cli", "serve"]
    assert cmd[-4:] == ["--maxBatch", "8", "--maxWaitMs", "100.0"]
    assert [k.target for k in space.SERVE_KNOBS] == \
        ["--maxBatch", "--maxWaitMs"]


def test_tune_cli_serve_leg_merges_its_winner(tmp_path, monkeypatch,
                                               capsys):
    """`ccs tune --serveLeg`: the batch leg ships, then the serve leg's
    winner is merged into the shipped profile."""
    from pbccs_tpu_torch.cli import run

    monkeypatch.setattr(driver, "_run_candidate", FakeRunner({
        driver.assignment_key({}): {"zps": 10.0},
        driver.assignment_key({"prepare_workers": 2}): {"zps": 13.0}}))
    monkeypatch.setattr(driver, "_serve_candidate", FakeServe({
        driver.assignment_key({}): ("d", 10.0, 500.0),
        driver.assignment_key({"serve_max_batch": 8}): ("d", 7.0, 400.0),
        "*": ("d", 9.0, 400.0)}))
    out = str(tmp_path / "p.json")
    assert run(["tune", "--out", out, "--workdir", str(tmp_path / "w"),
                "--zmws", "2", "--passes", "3", "--tplLen", "40",
                "--knobs", "prepare_workers",
                "--candidates", "prepare_workers=2", "--serveLeg",
                "--logLevel", "WARN"], device="cpu") == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["serve_leg"]["winner"]["assignment"] == \
        {"serve_max_batch": 8}
    prof, _ = load_profile(out)
    assert prof.knobs == {"prepare_workers": 2, "serve_max_batch": 8,
                          "warmup_buckets": ["2x3x40"]}
    assert summary["profile_id"] == prof.profile_id
