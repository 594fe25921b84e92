"""The port's batch `ccs` CLI against pbccs_tpu.cli.run on the same
inputs, on the CPU (`run(argv, device="cpu")`).

Inputs: a FASTA of three simulated ZMWs and a P6-C4 subread BAM of two
(tests/test_cli.py's fixture shape).  Contract: the same records (names,
sequences; QVs within 1; integer tags equal, float tags within 1e-3),
identical report text, a .pbi that reads back to the same holes; plus
the CLI gates and usage errors, the flags of the resilience and
observability tiers accepted and acting, bad values of the device
fleet's and the tuner's flags and the unported parts of the CLI
rejected with exit 2, the batch-failure recovery modes (the fleet
itself: tests/test_torch_sched.py), and the band widths the card cannot
polish at refused with exit 2 by every entry point (checked before a
card is needed, so device="cuda" runs here) while the CPU polishes at
any width."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from pbccs_tpu.cli import run as jrun

import pbccs_tpu_torch.pipeline as tp
from pbccs_tpu_torch.cli import run
from pbccs_tpu_torch.io.bam import (BamHeader, BamReader, BamRecord,
                                    BamWriter, ReadGroupInfo,
                                    make_read_group_id)
from pbccs_tpu_torch.io.fasta import read_fasta, write_fasta
from pbccs_tpu_torch.io.pbi import PbiIndex
from pbccs_tpu_torch.models.arrow.params import decode_bases
from pbccs_tpu_torch.obs.metrics import default_registry
from pbccs_tpu_torch.resilience import faults, quarantine, watchdog
from pbccs_tpu_torch.simulate import simulate_zmw

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOVIE = "m140905_042212_sidney_c100564852550000001823085912221377_s1_X0"
QV_ATOL = 1
COMMON = ["--numThreads", "2", "--logLevel", "WARN"]


def _zmw_records(rng, movie, hole, tpl_len, n_passes):
    _, reads, _, snr = simulate_zmw(rng, tpl_len, n_passes)
    return [(f"{movie}/{hole}/{i * 100}_{i * 100 + len(r)}", decode_bases(r))
            for i, r in enumerate(reads)], snr


def _fasta_input(d):
    rng = np.random.default_rng(5)
    recs = []
    for hole in (1, 2, 3):
        recs += _zmw_records(rng, "movie1", hole, 80, 4)[0]
    path = os.path.join(d, "in.fasta")
    write_fasta(path, recs)
    return path


def _bam_input(d):
    rng = np.random.default_rng(6)
    header = BamHeader(read_groups=[
        ReadGroupInfo(MOVIE, "SUBREAD", binding_kit="100356300",
                      sequencing_kit="100356200", basecaller_version="2.3.0")])
    rg = make_read_group_id(MOVIE, "SUBREAD")
    path = os.path.join(d, "in.bam")
    with BamWriter(path, header) as bw:
        for hole in (42, 43):
            recs, snr = _zmw_records(rng, MOVIE, hole, 70, 4)
            for name, seq in recs:
                bw.write(BamRecord(name=name, seq=seq, tags={
                    "RG": rg, "zm": hole, "cx": 3, "rq": 0.85,
                    "sn": [float(s) for s in snr]}))
    return path


def _run_both(d, inp, extra):
    out = {}
    for who, fn, kw in (("jax", jrun, {}), ("port", run, {"device": "cpu"})):
        bam = os.path.join(d, f"{who}.bam")
        rep = os.path.join(d, f"{who}.csv")
        assert fn([bam, inp, "--reportFile", rep, *extra, *COMMON],
                  **kw) == 0
        out[who] = (bam, rep)
    return out


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli"))
    fd, bd = os.path.join(d, "fasta"), os.path.join(d, "bam")
    os.makedirs(fd)
    os.makedirs(bd)
    quarantine.reset_event_counts()
    out = {"fasta": _run_both(fd, _fasta_input(fd), ["--skipChemistryCheck"]),
           "bam": _run_both(bd, _bam_input(bd), [])}
    out["events"] = quarantine.event_counts()
    out["inputs"] = {"fasta": os.path.join(fd, "in.fasta"),
                     "bam": os.path.join(bd, "in.bam")}
    return out


def _records(path):
    with BamReader(path) as r:
        return list(r)


INT_TAGS = ("RG", "zm", "np", "rs", "sn", "df")


@pytest.mark.parametrize("kind", ["fasta", "bam"])
def test_records_match_jax(cases, kind):
    (jbam, _), (tbam, _) = cases[kind]["jax"], cases[kind]["port"]
    ref, mine = _records(jbam), _records(tbam)
    assert [r.name for r in mine] == [r.name for r in ref] and ref
    for a, b in zip(ref, mine):
        assert b.seq == a.seq
        assert len(b.qual) == len(a.qual)
        assert max(abs(ord(x) - ord(y)) for x, y in zip(a.qual, b.qual)) \
            <= QV_ATOL
        assert {k: b.tags.get(k) for k in INT_TAGS} == \
            {k: a.tags.get(k) for k in INT_TAGS}
        assert abs(b.tags["rq"] - a.tags["rq"]) <= 1
        np.testing.assert_allclose(b.tags["pq"], a.tags["pq"], atol=1e-3)
        np.testing.assert_allclose(b.tags["za"], a.tags["za"], atol=1e-3)
        np.testing.assert_allclose(b.tags["zs"], a.tags["zs"], atol=1e-3)
    assert cases["events"] == dict.fromkeys(cases["events"], 0)


@pytest.mark.parametrize("kind", ["fasta", "bam"])
def test_report_text_matches_jax(cases, kind):
    (_, jrep), (_, trep) = cases[kind]["jax"], cases[kind]["port"]
    text = open(trep).read()
    assert text == open(jrep).read()
    assert "Failed -- Exception thrown" not in text


@pytest.mark.parametrize("kind", ["fasta", "bam"])
def test_pbi_reads_back(cases, kind):
    (jbam, _), (tbam, _) = cases[kind]["jax"], cases[kind]["port"]
    mine, ref = PbiIndex(tbam + ".pbi"), PbiIndex(jbam + ".pbi")
    np.testing.assert_array_equal(mine.holes, ref.holes)
    np.testing.assert_array_equal(mine.rg_ids, ref.rg_ids)
    assert mine.n_reads == len(_records(tbam))
    assert list(mine.holes) == [r.tags["zm"] for r in _records(tbam)]
    if open(tbam, "rb").read() == open(jbam, "rb").read():
        np.testing.assert_array_equal(mine.offsets, ref.offsets)
    assert (np.diff(mine.offsets.astype(np.int64)) > 0).all()


def test_zmws_filter(cases, tmp_path):
    out = str(tmp_path / "o.bam")
    assert run([out, cases["inputs"]["fasta"], "--zmws", "2,3",
                "--reportFile", str(tmp_path / "r.csv"),
                "--skipChemistryCheck", *COMMON], device="cpu") == 0
    got = _records(out)
    assert [r.tags["zm"] for r in got] == [2, 3]
    full = {r.name: r for r in _records(cases["fasta"]["port"][0])}
    for r in got:
        assert (r.seq, r.qual) == (full[r.name].seq, full[r.name].qual)


def test_fasta_output(cases, tmp_path):
    out = str(tmp_path / "o.fasta")
    assert run([out, cases["inputs"]["fasta"], "--reportFile",
                str(tmp_path / "r.csv"), "--skipChemistryCheck", *COMMON],
               device="cpu") == 0
    assert list(read_fasta(out)) == [
        (r.name, r.seq) for r in _records(cases["fasta"]["port"][0])]


def test_chemistry_gate_skips_fasta_without_flag(cases, tmp_path):
    out = str(tmp_path / "o.bam")
    rep = str(tmp_path / "r.csv")
    assert run([out, cases["inputs"]["fasta"], "--reportFile", rep,
                *COMMON], device="cpu") == 0
    assert _records(out) == []


def test_bad_zmws_exits_2(cases, tmp_path):
    assert run([str(tmp_path / "o.bam"), cases["inputs"]["fasta"],
                "--zmws", "all;1-3"], device="cpu") == 2


def test_missing_input_exits_2(tmp_path):
    assert run([str(tmp_path / "o.bam"), str(tmp_path / "missing.bam"),
                "--skipChemistryCheck"], device="cpu") == 2


# The device fleet's and the tuner's flags were rejected until they were
# ported; each now exits 2 on a bad value, as in pbccs_tpu.
UNPORTED = [["--devices", "-1"], ["--prepareWorkers", "two"],
            ["--schedPolicy", "busiest"], ["--tuneProfile"]]


@pytest.mark.parametrize("flag", UNPORTED, ids=lambda f: f[0])
def test_unported_flags_exit_2(tmp_path, flag, capsys):
    try:
        rc = run([str(tmp_path / "o.bam"), str(tmp_path / "in.fasta"),
                  *flag] if flag[0] == "--devices" else
                 [str(tmp_path / "o.bam"), str(tmp_path / "in.fasta"),
                  "--skipChemistryCheck", *flag], device="cpu")
    except SystemExit as e:
        rc = e.code
    assert rc == 2
    assert flag[0] in capsys.readouterr().err


PORTED = ["--checkpoint", "--resume", "--memBudget", "--faults",
          "--faultSeed", "--polishTimeout", "--trace-out", "--profile-dir"]


def _fired(spec, seed, n):
    """How many of n calls a FaultInjector(spec, seed) fires on."""
    inj = faults.FaultInjector(spec, seed=seed)
    for _ in range(n):
        try:
            inj.maybe_fail("prep.zmw")
        except faults.InjectedFault:
            pass
    return inj.fired()


@pytest.mark.parametrize("flag", PORTED)
def test_ported_flags_are_accepted_and_act(cases, tmp_path, monkeypatch,
                                           flag):
    """Each flag of the resilience and observability tiers is accepted
    and does what it does in pbccs_tpu, on the BAM input; the injector
    and deadline a run arms are gone after it."""
    out, rep = str(tmp_path / "o.bam"), str(tmp_path / "r.csv")
    log = tmp_path / "log.txt"
    clean = open(cases["bam"]["port"][0], "rb").read()
    argv = [out, cases["inputs"]["bam"], "--reportFile", rep,
            "--numThreads", "2", "--logFile", str(log)]
    threads = []
    if flag == "--polishTimeout":
        real = tp._polish_batch_arrow

        def spy(preps, settings, device, *, buckets=None):
            threads.append(threading.current_thread().name)
            return real(preps, settings, device, buckets=buckets)

        monkeypatch.setattr(tp, "_polish_batch_arrow", spy)
    extra = {
        "--checkpoint": ["--checkpoint", str(tmp_path / "c.ckpt")],
        "--resume": ["--resume"],
        "--memBudget": ["--memBudget", "8G"],
        "--faults": ["--faults", f"polish.dispatch:error~{MOVIE}/43"],
        "--faultSeed": ["--faults", "prep.zmw:error%0.5", "--faultSeed"],
        "--polishTimeout": ["--polishTimeout", "300"],
        "--trace-out": ["--trace-out", str(tmp_path / "t.json")],
        "--profile-dir": ["--profile-dir", str(tmp_path / "prof")],
    }[flag]
    if flag == "--faultSeed":
        # a seed that fires on the two ZMWs otherwise than seed 0 does
        spec = "prep.zmw:error%0.5"
        seed = next(s for s in range(1, 64)
                    if 0 < _fired(spec, s, 2) != _fired(spec, 0, 2))
        extra = [*extra, str(seed)]
        want = _fired(spec, seed, 2)
    scope = default_registry().scope()
    assert run(argv + extra, device="cpu") == 0
    assert faults.get() is None and watchdog.default_deadline_s() == 0
    assert "run metrics:" in log.read_text()
    text = open(rep).read()
    got = open(out, "rb").read()
    if flag == "--checkpoint":
        assert got == clean and not (tmp_path / "c.ckpt").exists()
        assert scope.counter_value("ccs_checkpoint_records_total",
                                   kind="written") == 1
    elif flag == "--resume":
        assert got == clean and not os.path.exists(out + ".ckpt")
        assert "resume: no journal at" in log.read_text()
    elif flag == "--memBudget":
        assert got == clean
        assert "--memBudget gates" in log.read_text()
        for bad in ("lots", "0.5"):
            assert run(argv + ["--memBudget", bad], device="cpu") == 2
    elif flag == "--faults":
        assert "Failed -- Exception thrown,1," in text
        assert [r.tags["zm"] for r in _records(out)] == [42]
        assert scope.counter_value("ccs_quarantined_zmws_total") == 1
    elif flag == "--faultSeed":
        assert scope.counter_value("ccs_faults_injected_total",
                                   site="prep.zmw", kind="error") == want
        assert f"Failed -- Exception thrown,{want}," in text
    elif flag == "--polishTimeout":
        assert got == clean
        assert threads == ["pbccs-watchdog-polish.dispatch"]
    elif flag == "--trace-out":
        names = {e["name"] for e in json.load(open(tmp_path / "t.json"))[
            "traceEvents"]}
        assert {"filter", "draft", "polish", "polish.setup",
                "polish.refine", "polish.qv", "emit"} <= names
    else:
        (trace,) = os.listdir(tmp_path / "prof")
        assert json.load(open(tmp_path / "prof" / trace))["traceEvents"]


#: usage errors of the subcommands tune, router and top, which
#: pbccs_tpu's parsers reject too (a tune serve-leg grid value that does
#: not parse, a router with no --replica, a top frame format that does
#: not exist).  Every subcommand is ported; serve, warmup, fleet and
#: analyze are tested as they run (tests/test_torch_cache.py and
#: tests/test_torch_analysis.py)
UNPORTED_SUB = {"tune": ["--serveLeg", "--candidates",
                         "serve_max_batch=eight"],
                "router": ["--port", "0"],
                "top": ["127.0.0.1:1", "--once", "--format", "xml"]}


@pytest.mark.parametrize("sub", ["router", "tune", "top"])
def test_subcommands_are_not_ported(sub):
    try:
        rc = run([sub, *UNPORTED_SUB[sub]], device="cpu")
    except SystemExit as e:
        rc = e.code
    assert rc == 2
    if sub in ("router", "top"):
        # a usage error of pbccs_tpu's own parser too
        from pbccs_tpu.obs.console import build_top_parser
        from pbccs_tpu.serve.router import build_router_parser

        parser = build_router_parser() if sub == "router" \
            else build_top_parser()
        with pytest.raises(SystemExit) as e:
            parser.parse_args(UNPORTED_SUB[sub])
        assert e.value.code == 2


def test_roofline_target_exits_2(capsys):
    """`ccs roofline --target` is ported (tests/test_torch_console.py
    reads a live replica's roofline block through it); a --target with
    no address is a usage error of both packages' parsers."""
    from pbccs_tpu.obs.roofline import run_roofline as jrun_roofline

    for entry in (lambda a: run(["roofline", *a], device="cpu"),
                  jrun_roofline):
        with pytest.raises(SystemExit) as e:
            entry(["--target"])
        assert e.value.code == 2
        assert "--target" in capsys.readouterr().err


def test_router_tier_subcommands_run(capsys):
    """`ccs top` against an address nothing answers on exits 1 with its
    unreachable frame, `ccs router` with a replica spec that is no
    HOST:PORT exits 2 before it binds, and `ccs fleet list` with no
    --target exits 2 -- pbccs_tpu's answers, through the port's CLI."""
    assert run(["top", "127.0.0.1:1", "--once", "--format", "json",
                "--timeout", "1.0"], device="cpu") == 1
    assert json.loads(capsys.readouterr().out)["error"] == \
        "target unreachable"
    assert run(["router", "--replica", "nohost", "--port", "0"],
               device="cpu") == 2
    assert "want HOST:PORT" in capsys.readouterr().err
    assert run(["fleet", "list"], device="cpu") == 2
    assert "--target" in capsys.readouterr().err


def test_module_entry_point():
    """`python -m pbccs_tpu_torch.cli`: --version, and a rejected flag
    value."""
    cmd = [sys.executable, "-m", "pbccs_tpu_torch.cli"]
    ok = subprocess.run(cmd + ["--version"], cwd=REPO, capture_output=True,
                        text=True, timeout=300)
    assert ok.returncode == 0 and ok.stdout.strip() == "0.1.0"
    bad = subprocess.run(cmd + ["--devices", "-1", "o.bam", "i.bam"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert bad.returncode == 2 and "--devices" in bad.stderr


def test_batch_fallback_modes_agree_on_healthy_input(cases, tmp_path):
    outs = []
    quarantine.reset_event_counts()
    for mode in ("bisect", "serial"):
        out = str(tmp_path / f"{mode}.bam")
        assert run([out, cases["inputs"]["bam"], "--batchFallback", mode,
                    "--reportFile", str(tmp_path / f"{mode}.csv"), *COMMON],
                   device="cpu") == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] == open(cases["bam"]["port"][0], "rb").read()
    assert quarantine.event_counts() == dict.fromkeys(
        quarantine.event_counts(), 0)


@pytest.mark.parametrize("degrade", [False, True])
def test_quarantined_zmw_through_the_cli(cases, tmp_path, monkeypatch,
                                         degrade):
    """A poison ZMW (batch and serial polish both fail) is dropped as
    Other, or with --degradeQuarantined written as its draft with `df`
    and QVs capped; the other ZMW's record is unchanged."""
    poison = f"{MOVIE}/43"
    real = tp._polish_batch_arrow

    def dispatch(preps, settings, device, *, buckets=None):
        if any(p.chunk.id == poison for p in preps):
            raise ValueError("poison ZMW")
        return real(preps, settings, device, buckets=buckets)

    def serial(prep, settings, *, device=None):
        raise ValueError("poison ZMW, serially too")

    monkeypatch.setattr(tp, "_polish_batch_arrow", dispatch)
    monkeypatch.setattr(tp, "polish_prepared", serial)
    out, rep = str(tmp_path / "o.bam"), str(tmp_path / "r.csv")
    flags = ["--degradeQuarantined"] if degrade else []
    assert run([out, cases["inputs"]["bam"], "--reportFile", rep, *flags,
                *COMMON], device="cpu") == 0
    got = {r.tags["zm"]: r for r in _records(out)}
    clean = {r.tags["zm"]: r for r in _records(cases["bam"]["port"][0])}
    assert (got[42].seq, got[42].qual, got[42].tags) == \
        (clean[42].seq, clean[42].qual, clean[42].tags)
    text = open(rep).read()
    if degrade:
        assert got[43].tags["df"] == 1
        assert set(got[43].qual) == {chr(33 + quarantine.DRAFT_QV_CAP)}
        assert "Success -- CCS generated,2," in text
    else:
        assert 43 not in got
        assert "Failed -- Exception thrown,1," in text


def test_launch_counts_survive_concurrent_workers():
    """The CLI's worker threads launch kernels at once: count_launch
    loses no update with more threads than cores and a shortened switch
    interval."""
    import threading

    from pbccs_tpu_torch.ops.cuda_lib import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, per_thread = 4 * (os.cpu_count() or 1), 2000

    def work():
        for _ in range(per_thread):
            count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * per_thread


# ------------------------------------------------------------ band width


@pytest.mark.parametrize("device", ["cuda", "cuda:1", "cpu"])
@pytest.mark.parametrize("width", [16, 32, 48, 64, 80, 96, 128, 160, 192,
                                   224, 256])
def test_band_width_check(width, device):
    """On a CUDA device W and 2W must be K1/K3 widths (32, 64, 96, 128
    allowed); every width passes on the CPU.  A pure function: no card
    is needed to ask."""
    from pbccs_tpu_torch.ops.fwdbwd_cuda import (K1_WIDTHS, RUN_WIDTHS,
                                                 check_band_width)

    assert RUN_WIDTHS == (32, 64, 96, 128)
    refused = device != "cpu" and not (width in K1_WIDTHS
                                       and 2 * width in K1_WIDTHS)
    if refused:
        with pytest.raises(ValueError, match="32, 64, 96, 128"):
            check_band_width(width, device)
    else:
        check_band_width(width, device)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("width", [48, 80, 160, 192, 256, 320])
def test_polisher_width_check(width, device):
    """One polisher launches at W alone: on a CUDA device W must be a
    K1/K3 width, refused with LaunchRefused (a ValueError the pipeline
    does not bisect); every width passes on the CPU."""
    from pbccs_tpu_torch.device import is_device_error
    from pbccs_tpu_torch.ops.fwdbwd_cuda import (K1_WIDTHS,
                                                 check_polisher_width)

    if device == "cuda" and width not in K1_WIDTHS:
        with pytest.raises(ValueError, match=f"band width {width}") as e:
            check_polisher_width(width, device)
        assert is_device_error(e.value)
    else:
        check_polisher_width(width, device)


@pytest.mark.parametrize("sub", ["ccs", "serve", "warmup", "tune"])
def test_refused_band_width_exits_2_before_anything(tmp_path, monkeypatch,
                                                    capsys, sub):
    """PBCCS_BAND_W=80 (a tune candidate band_w=80 for `ccs tune`) on the
    card: exit 2 naming the allowed widths, before any record is
    written."""
    out = tmp_path / "o.bam"
    argv = {"ccs": [str(out), str(tmp_path / "missing.fasta")],
            "serve": ["serve", "--port", "0"],
            "warmup": ["warmup", "--bucket", "2x3x40"],
            "tune": ["tune", "--workdir", str(tmp_path / "w"),
                     "--knobs", "band_w", "--candidates", "band_w=64,80"]}
    if sub == "tune":
        monkeypatch.setattr(
            "pbccs_tpu_torch.tune.driver._run_candidate",
            lambda *a, **k: pytest.fail("a candidate ran"))
    else:
        monkeypatch.setenv("PBCCS_BAND_W", "80")
    assert run([*argv[sub], "--logLevel", "WARN"], device="cuda") == 2
    assert "32, 64, 96, 128" in capsys.readouterr().err
    assert not out.exists() and not (tmp_path / "w").exists()


def test_cpu_polishes_at_any_band_width(cases, tmp_path, monkeypatch):
    """PBCCS_BAND_W=80 is refused on the card only: the CPU run polishes
    (the plain versions take any W) and writes its records."""
    monkeypatch.setenv("PBCCS_BAND_W", "80")
    out = str(tmp_path / "w80.bam")
    assert run([out, cases["inputs"]["fasta"], "--skipChemistryCheck",
                "--reportFile", str(tmp_path / "w80.csv"), *COMMON],
               device="cpu") == 0
    recs = _records(out)
    assert recs and all(len(r.seq) > 0 for r in recs)
