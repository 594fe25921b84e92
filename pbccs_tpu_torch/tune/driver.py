"""The `ccs tune` search driver (port of pbccs_tpu.tune.driver, batch leg).

Per candidate: run the FIXED calibration workload in a fresh
subprocess of the port's `ccs` (`python -m pbccs_tpu_torch.cli`, on the
card; a knob must be measured in a fresh process, exactly how a run
resolves it), read the
perf-ledger records back as the objective, and gate on BYTE-IDENTITY --
the knobs here are performance-only, so a candidate whose output FASTA
digest differs from the defaults run is rejected and reported, never
ranked.  The port's copy of tools/perf_gate.py (pbccs_tpu_torch/tools/
perf_gate.py; the gate itself imports pbccs_tpu) referees the final
winner: the profile ships only when the tuned run's gated counters match
the defaults run within the gate's tolerance classes (minus each knob's
DECLARED side-effect fields, e.g. band width's roofline work), so a
profile can never silently regress what a baseline defends.

Search shape: coarse-to-fine under a wall-clock budget.  Phase 1
screens each knob independently against the defaults; phase 2 joins the
per-knob winners and keeps the joint assignment only if it still beats
the best single (greedy fallback otherwise).  Every candidate lands in
a journal (NDJSON, read back through the ledger's torn-tail-tolerant
reader) keyed by its canonical assignment, so a killed `ccs tune
--resume` re-uses finished candidates instead of re-measuring them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Any

import numpy as np

from pbccs_tpu_torch.obs.ledger import read_ledger
from pbccs_tpu_torch.tune import objective, space
from pbccs_tpu_torch.tune.profile import (
    HostProfile,
    host_fingerprint,
    save_profile,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

#: the least time a candidate's calibration runs get under a --tuneBudget
#: (the first one may build the kernels); a run past its time is killed
CANDIDATE_TIMEOUT_FLOOR_S = 120.0


@dataclasses.dataclass
class TuneConfig:
    """One `ccs tune` invocation's settings."""

    workdir: str
    out_path: str
    zmws: int = 64
    passes: int = 6
    tpl_len: int = 300
    chunk_size: int = 64
    seed: int = 20260807
    repeat: int = 3
    budget_s: float = 0.0          # wall cap; 0 = unbounded
    min_gain: float = 0.0          # ship iff gain > min_gain
    devices: int = 0               # forwarded to the calibration `ccs`
    knobs: list[space.Knob] = dataclasses.field(default_factory=list)
    forced: dict[str, Any] = dataclasses.field(default_factory=dict)
    resume: bool = False
    #: the device whose fingerprint a shipped profile carries (None: the
    #: card the calibration runs polish on; the CPU tests pass "cpu")
    device: Any = None
    log: Any = None

    def note(self, msg: str) -> None:
        if self.log is not None:
            self.log.info(f"tune: {msg}")

    def warn(self, msg: str) -> None:
        if self.log is not None:
            self.log.warn(f"tune: {msg}")


@dataclasses.dataclass
class CandidateResult:
    """One measured candidate (possibly restored from the journal)."""

    assignment: dict[str, Any]
    ok: bool
    reason: str | None = None
    digest: str | None = None
    measurement: objective.Measurement | None = None
    records: list[dict] = dataclasses.field(default_factory=list)

    @property
    def key(self) -> str:
        return assignment_key(self.assignment)


def assignment_key(assignment: dict[str, Any]) -> str:
    """Canonical journal key for one candidate assignment."""
    return json.dumps(assignment, sort_keys=True, separators=(",", ":"))


# ------------------------------------------------------------ calibration

def write_calibration(cfg: TuneConfig) -> str:
    """The fixed calibration workload: a deterministic synthetic FASTA
    (simulate.simulate_zmw geometry, the warmup/test idiom) every
    candidate and the defaults run read bit-for-bit identically."""
    from pbccs_tpu_torch.io.fasta import write_fasta
    from pbccs_tpu_torch.models.arrow.params import decode_bases
    from pbccs_tpu_torch.simulate import simulate_zmw

    path = os.path.join(cfg.workdir, "calibration.fasta")
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(cfg.seed)
    records = []
    for z in range(cfg.zmws):
        _tpl, reads, _strands, _snr = simulate_zmw(
            rng, cfg.tpl_len, cfg.passes)
        start = 0
        for read in reads:
            seq = decode_bases(read)
            records.append((f"tune/{z}/{start}_{start + len(seq)}", seq))
            start += len(seq)
    write_fasta(path, records)
    return path


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _base_env(cfg: TuneConfig) -> dict[str, str]:
    """The candidate subprocess environment: inherit the host env minus
    any ambient knob overrides (an operator's PBCCS_BAND_W must not
    contaminate every candidate) and minus any active profile.  The
    kernels' build cache (build/kernels/ of the checkout) is shared by
    every candidate, so each builds nothing after the first."""
    env = dict(os.environ)
    for name, target in space.KNOB_TARGETS.items():
        if target.startswith("env:"):
            env.pop(target[4:], None)
    env.pop("PBCCS_TUNE_PROFILE", None)
    return env


def candidate_command(cfg: TuneConfig, calib: str, cand_dir: str,
                      argv_extra: list[str]) -> list[str]:
    """The calibration `ccs` command of one candidate run."""
    return [sys.executable, "-m", "pbccs_tpu_torch.cli",
            os.path.join(cand_dir, "out.fasta"), calib,
            "--skipChemistryCheck",
            "--devices", str(cfg.devices),
            "--chunkSize", str(cfg.chunk_size),
            "--reportFile", os.path.join(cand_dir, "report.csv"),
            "--perfLedger", os.path.join(cand_dir, "ledger.ndjson"),
            "--logLevel", "WARN", *argv_extra]


def _run_candidate(cfg: TuneConfig, assignment: dict[str, Any],
                   calib: str, timeout_s: float | None = None
                   ) -> CandidateResult:
    """Measure one candidate: ``cfg.repeat`` fresh-subprocess runs of
    the calibration workload, digests compared across repeats (a
    nondeterministic candidate is as rejected as an output-changing
    one) and ledger records pooled into one Measurement.  A run that
    outlasts `timeout_s` is killed and the candidate fails."""
    argv_extra, env_extra = space.candidate_invocation(assignment)
    tag = hashlib.sha256(
        assignment_key(assignment).encode()).hexdigest()[:10]
    cand_dir = os.path.join(cfg.workdir, f"cand_{tag}")
    os.makedirs(cand_dir, exist_ok=True)
    ledger_path = os.path.join(cand_dir, "ledger.ndjson")
    if os.path.exists(ledger_path):
        os.unlink(ledger_path)
    env = _base_env(cfg)
    env.update(env_extra)
    digests: list[str] = []
    out = os.path.join(cand_dir, "out.fasta")
    cmd = candidate_command(cfg, calib, cand_dir, argv_extra)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    for rep in range(max(1, cfg.repeat)):
        left = None if deadline is None else max(
            deadline - time.monotonic(), 0.0)
        try:
            proc = subprocess.run(cmd, env=env, cwd=_REPO_ROOT,
                                  capture_output=True, text=True,
                                  timeout=left)
        except subprocess.TimeoutExpired:
            return CandidateResult(
                assignment, ok=False,
                reason=f"calibration run timed out after {timeout_s:g} s")
        if proc.returncode != 0:
            tail = (proc.stderr or proc.stdout or "").strip()[-400:]
            return CandidateResult(
                assignment, ok=False,
                reason=f"calibration run exited "
                       f"{proc.returncode}: {tail}")
        digests.append(_sha256(out))
    if len(set(digests)) > 1:
        return CandidateResult(
            assignment, ok=False,
            reason="nondeterministic output across repeats")
    records, _skipped = read_ledger(ledger_path)
    records = [r for r in records if r.get("kind") == "batch_run"]
    meas = objective.measure(records)
    if meas is None:
        return CandidateResult(
            assignment, ok=False,
            reason="calibration ledger carries no throughput record")
    return CandidateResult(assignment, ok=True, digest=digests[0],
                           measurement=meas, records=records)


# ---------------------------------------------------------------- journal

class Journal:
    """Resumable candidate log: one NDJSON line per finished candidate,
    read back through obs.ledger.read_ledger (torn-tail-tolerant, so a
    `ccs tune` killed mid-append resumes cleanly past the torn line)."""

    def __init__(self, path: str, resume: bool):
        self.path = path
        self._cache: dict[str, CandidateResult] = {}
        if resume:
            records, skipped = read_ledger(path)
            for rec in records:
                res = self._from_doc(rec)
                if res is not None:
                    self._cache[res.key] = res
            if skipped:
                pass  # torn tail: the in-flight candidate re-measures
        elif os.path.exists(path):
            os.unlink(path)

    @staticmethod
    def _from_doc(doc: dict) -> CandidateResult | None:
        if doc.get("tune_journal") != 1 \
                or not isinstance(doc.get("assignment"), dict):
            return None
        meas_doc = doc.get("measurement")
        meas = None
        if isinstance(meas_doc, dict):
            try:
                meas = objective.Measurement(
                    zmws_per_sec=float(meas_doc["zmws_per_sec"]),
                    wall_s=float(meas_doc["wall_s"]),
                    padding_waste=meas_doc.get("padding_waste"),
                    peak_rss_bytes=meas_doc.get("peak_rss_bytes"),
                    p99_ms=meas_doc.get("p99_ms"),
                    repeats=int(meas_doc.get("repeats", 1)))
            except (KeyError, TypeError, ValueError):
                return None
        recs = doc.get("records")
        return CandidateResult(
            assignment=doc["assignment"], ok=bool(doc.get("ok")),
            reason=doc.get("reason"), digest=doc.get("digest"),
            measurement=meas,
            records=recs if isinstance(recs, list) else [])

    def get(self, key: str) -> CandidateResult | None:
        return self._cache.get(key)

    def put(self, res: CandidateResult) -> None:
        self._cache[res.key] = res
        doc = {"tune_journal": 1, "assignment": res.assignment,
               "ok": res.ok, "reason": res.reason, "digest": res.digest,
               "measurement": (res.measurement.to_doc()
                               if res.measurement else None),
               "records": res.records}
        try:
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(doc, sort_keys=True,
                                    separators=(",", ":")) + "\n")
                fh.flush()
        except OSError:
            pass  # the journal is an accelerator, never a dependency


# ---------------------------------------------------------------- referee

def referee(baseline: CandidateResult, winner: CandidateResult
            ) -> tuple[list[dict], list[str]]:
    """The gate's verdict on the winner vs the defaults run: counters
    compared exactly (the CI mode), minus each winner knob's DECLARED
    side-effect fields.  Any violation blocks the ship."""
    from pbccs_tpu_torch.tools import perf_gate as pg

    base_doc = pg.build_baseline(baseline.records,
                                 select={"kind": "batch_run"})
    exempt = space.affected_fields(winner.assignment)
    return pg.compare(base_doc, winner.records, counters_only=True,
                      ignore=exempt)


# ----------------------------------------------------------------- search

def run_search(cfg: TuneConfig) -> dict[str, Any]:
    """The whole tune pass; returns the machine-readable summary the
    CLI prints (shipped?, winner, rejected candidates, referee notes)."""
    t0 = time.monotonic()
    os.makedirs(cfg.workdir, exist_ok=True)
    journal = Journal(os.path.join(cfg.workdir, "journal.ndjson"),
                      resume=cfg.resume)
    calib = write_calibration(cfg)
    rejected: list[dict] = []
    budget_hit = False

    def out_of_budget() -> bool:
        nonlocal budget_hit
        if cfg.budget_s > 0 and time.monotonic() - t0 > cfg.budget_s:
            budget_hit = True
        return budget_hit

    def evaluate(assignment: dict[str, Any]) -> CandidateResult:
        key = assignment_key(assignment)
        cached = journal.get(key)
        if cached is not None:
            cfg.note(f"resume: candidate {key} from journal")
            return cached
        cfg.note(f"measuring candidate {key} "
                 f"(repeat={cfg.repeat})")
        # a hung calibration run must not hold the card past the budget:
        # each candidate gets what is left of it, never less than a floor
        timeout_s = None
        if cfg.budget_s > 0:
            timeout_s = max(CANDIDATE_TIMEOUT_FLOOR_S,
                            cfg.budget_s - (time.monotonic() - t0))
        res = _run_candidate(cfg, assignment, calib, timeout_s=timeout_s)
        journal.put(res)
        return res

    baseline = evaluate({})
    if not baseline.ok:
        return {"shipped": False,
                "error": f"defaults run failed: {baseline.reason}"}

    def accept(res: CandidateResult) -> bool:
        """Byte-identity + objective gate for one screened candidate;
        rejections are reported, never silently dropped."""
        if not res.ok:
            rejected.append({"assignment": res.assignment,
                             "reason": res.reason})
            return False
        if res.digest != baseline.digest:
            rejected.append({
                "assignment": res.assignment,
                "reason": "output differs from defaults "
                          "(knobs are performance-only; rejected)"})
            return False
        return objective.better(res.measurement, baseline.measurement)

    # phase 1: screen each knob independently against the defaults
    per_knob_best: dict[str, CandidateResult] = {}
    for knob in cfg.knobs:
        for value in knob.candidates:
            if out_of_budget():
                cfg.warn(f"--tuneBudget {cfg.budget_s:g}s exhausted "
                         "during screening; refining what we have")
                break
            res = evaluate({knob.name: value})
            if not accept(res):
                continue
            best = per_knob_best.get(knob.name)
            if best is None or objective.better(res.measurement,
                                                best.measurement):
                per_knob_best[knob.name] = res
        if budget_hit:
            break

    # phase 2: join the survivors; keep the joint assignment only if it
    # still beats the best single (greedy fallback otherwise)
    winner = baseline
    singles = sorted(per_knob_best.values(),
                     key=lambda r: -r.measurement.zmws_per_sec)
    if singles:
        winner = singles[0]
    if len(singles) > 1 and not out_of_budget():
        joint_assignment: dict[str, Any] = {}
        for res in singles:
            joint_assignment.update(res.assignment)
        joint = evaluate(joint_assignment)
        if accept(joint) and objective.better(joint.measurement,
                                              winner.measurement):
            winner = joint
        else:
            # greedy: grow the best single one surviving knob at a time
            grown = winner
            for res in singles[1:]:
                if out_of_budget():
                    break
                trial_assignment = {**grown.assignment,
                                    **res.assignment}
                if trial_assignment == joint_assignment:
                    continue  # already measured above
                trial = evaluate(trial_assignment)
                if accept(trial) and objective.better(
                        trial.measurement, grown.measurement):
                    grown = trial
            winner = grown

    win_gain = objective.gain(winner.measurement, baseline.measurement)
    violations, notes = ([], [])
    if winner.assignment or cfg.forced:
        violations, notes = referee(baseline, winner)

    summary: dict[str, Any] = {
        "shipped": False,
        "baseline": baseline.measurement.to_doc(),
        "winner": {"assignment": winner.assignment,
                   "measurement": winner.measurement.to_doc(),
                   "gain": round(win_gain, 4)},
        "rejected": rejected,
        "referee": {"violations": violations, "notes": notes},
        "budget_hit": budget_hit,
        "elapsed_s": round(time.monotonic() - t0, 1),
    }
    knobs = {**cfg.forced, **winner.assignment}
    if not knobs:
        summary["note"] = ("no candidate beat the hand-tuned defaults; "
                           "nothing to ship")
        return summary
    if violations:
        summary["note"] = ("perf_gate referee found violations; "
                           "profile NOT shipped")
        return summary
    if win_gain <= cfg.min_gain and not (cfg.min_gain < 0):
        summary["note"] = (f"winner gain {win_gain:.4f} <= --minGain "
                           f"{cfg.min_gain:g}; profile NOT shipped")
        return summary

    # ship: the calibration geometry doubles as the warmup bucket menu
    # (`ccs warmup --tuneProfile` compiles exactly what was measured)
    menu = [f"{min(cfg.zmws, cfg.chunk_size)}x{cfg.passes}"
            f"x{cfg.tpl_len}"]
    profile = HostProfile(
        fingerprint=host_fingerprint(cfg.device),
        knobs={**knobs, "warmup_buckets": menu},
        calibration={"zmws": cfg.zmws, "passes": cfg.passes,
                     "tpl_len": cfg.tpl_len,
                     "chunk_size": cfg.chunk_size, "seed": cfg.seed,
                     "repeat": cfg.repeat, "devices": cfg.devices,
                     "output_sha256": baseline.digest},
        objective={"baseline": baseline.measurement.to_doc(),
                   "tuned": winner.measurement.to_doc(),
                   "gain": round(win_gain, 4)},
        created_unix=time.time())
    save_profile(profile, cfg.out_path)
    summary["shipped"] = True
    summary["profile"] = cfg.out_path
    summary["profile_id"] = profile.profile_id
    return summary


# --------------------------------------------------------------- serve leg

#: bounds of one serve-leg candidate: the server's start (a fresh
#: process, the card's lazy start) and each reply
SERVE_READY_TIMEOUT_S = 180.0
SERVE_REPLY_TIMEOUT_S = 300.0


def serve_command(assignment: dict[str, Any]) -> list[str]:
    """The `ccs serve` command of one serve-leg candidate."""
    argv = [sys.executable, "-m", "pbccs_tpu_torch.cli", "serve",
            "--port", "0", "--logLevel", "WARN"]
    for name, value in sorted(assignment.items()):
        argv += [space.knob_by_name(name).target, str(value)]
    return argv


def _serve_candidate(cfg: TuneConfig, assignment: dict[str, Any],
                     calib: str) -> tuple[str, float, float] | str:
    """One serve-leg candidate: a fresh `ccs serve` subprocess with the
    assignment's flags, the calibration ZMWs submitted at once through
    CcsClient.  (digest of the returned sequences, wall s, p99 ms), or
    the reason it failed."""
    import statistics

    from pbccs_tpu_torch.io.fasta import read_fasta
    from pbccs_tpu_torch.serve.client import CcsClient, wait_for_ready

    proc = subprocess.Popen(serve_command(assignment), env=_base_env(cfg),
                            cwd=_REPO_ROOT, stdout=subprocess.PIPE,
                            text=True)
    try:
        ready = wait_for_ready(proc, SERVE_READY_TIMEOUT_S)
        if ready is None:
            return "serve exited or never printed CCS-SERVE-READY"
        addr = ready["CCS-SERVE-READY"]
        by_zmw: dict[str, list[str]] = {}
        for name, seq in read_fasta(calib):
            by_zmw.setdefault("/".join(name.split("/")[:2]), []).append(seq)
        t0 = time.monotonic()
        lat: list[float] = []
        replies = {}
        with CcsClient(*addr, timeout=SERVE_REPLY_TIMEOUT_S) as client:
            handles = [(zid, time.monotonic(), client.submit(zid, reads))
                       for zid, reads in by_zmw.items()]
            for zid, t_sub, handle in handles:
                replies[zid] = handle.reply(SERVE_REPLY_TIMEOUT_S,
                                            check=False)
                lat.append((time.monotonic() - t_sub) * 1e3)
        wall = time.monotonic() - t0
        digest = hashlib.sha256()
        for zid in sorted(replies):
            r = replies[zid]
            digest.update(zid.encode())
            digest.update(str(r.get("sequence", r.get("error"))).encode())
        p99 = (statistics.quantiles(lat, n=100)[98]
               if len(lat) >= 2 else (lat[0] if lat else 0.0))
        return digest.hexdigest(), wall, p99
    except (OSError, TimeoutError) as e:
        return f"serve candidate failed: {e!r}"
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30.0)


def run_serve_leg(cfg: TuneConfig, profile_knobs: dict[str, Any]
                  ) -> dict[str, Any]:
    """The serve-knob sweep (`ccs tune --serveLeg`, pbccs_tpu's): a
    fresh `ccs serve` subprocess per candidate over the calibration
    ZMWs, the returned consensus set byte-compared with the defaults',
    flush thresholds picked by wall clock with p99 as tie-breaker.  The
    winning knobs are merged into ``profile_knobs`` for the caller to
    ship."""
    calib = write_calibration(cfg)
    results: dict[str, Any] = {"candidates": [], "rejected": []}
    best: tuple[dict[str, Any], float, float] | None = None
    base = _serve_candidate(cfg, {}, calib)
    if isinstance(base, str):
        results["error"] = f"serve defaults run failed: {base}"
        return results
    baseline_digest, base_wall, base_p99 = base
    results["baseline"] = {"wall_s": round(base_wall, 3),
                           "p99_ms": round(base_p99, 2)}
    for knob in space.SERVE_KNOBS:
        for value in knob.candidates:
            assignment = {knob.name: value}
            out = _serve_candidate(cfg, assignment, calib)
            if isinstance(out, str):
                results["rejected"].append(
                    {"assignment": assignment, "reason": out})
                continue
            digest, wall, p99 = out
            if digest != baseline_digest:
                results["rejected"].append(
                    {"assignment": assignment,
                     "reason": "served output differs from defaults"})
                continue
            results["candidates"].append(
                {"assignment": assignment, "wall_s": round(wall, 3),
                 "p99_ms": round(p99, 2)})
            better = wall < base_wall * (1 - objective.REL_TIE_EPS) \
                or (wall < base_wall * (1 + objective.REL_TIE_EPS)
                    and p99 < base_p99)
            if better and (best is None or wall < best[1]):
                best = (assignment, wall, p99)
    if best is not None:
        profile_knobs.update(best[0])
        results["winner"] = {"assignment": best[0],
                             "wall_s": round(best[1], 3),
                             "p99_ms": round(best[2], 2)}
    return results
