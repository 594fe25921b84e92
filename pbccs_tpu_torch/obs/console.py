"""`ccs top`: a live plain-terminal console over a serve/router fleet.

The observability plane is scrape-shaped (Prometheus exposition, status
verb) which is perfect for machines and useless at 2 a.m.; `ccs top` is
the operator view: point it at a `ccs router` (or a single `ccs serve`)
and it polls the NDJSON ``status`` + ``metrics`` verbs at ``--interval``
and renders per-replica throughput, queue depth, in-flight work, SLO
burn rate, refine convergence/slot occupancy, and padding waste.

Data sources (nothing new is invented server-side):

  * the target's ``status`` verb: router replica roster (connected /
    healthy / draining), pending totals, engine identity;
  * the target's ``metrics`` verb: for a router this is the FEDERATED
    fleet exposition, so per-replica engine figures arrive under their
    ``replica="host:port"`` labels; for a bare serve engine the same
    names arrive unlabeled and render as one replica.

Curses-free on purpose: a tty gets an ANSI home+clear between frames,
a pipe gets plain appended frames, and ``--once --format json`` emits
one machine-readable snapshot for scripts.  Unreachable replicas are
ABSENCE (a row marked absent), never a crash; an unreachable target is
a retried note in loop mode and exit 1 under ``--once``.

Throughput is a real rate, not a guess: every frame (including
``--once``) is the delta between two samples of the monotone
``ccs_serve_completed_total`` counters divided by the sample gap.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any

from pbccs_tpu_torch.obs.metrics import parse_exposition


def build_top_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ccs top",
        description="Live fleet console over a ccs router (or a single "
                    "ccs serve): per-replica throughput, queue depth, "
                    "SLO burn, refine occupancy, padding waste.")
    p.add_argument("target", help="Router or serve endpoint HOST:PORT.")
    p.add_argument("--interval", type=float, default=2.0,
                   help="Seconds between polls (also the throughput "
                        "window). Default = %(default)s")
    p.add_argument("--once", action="store_true",
                   help="Render one frame (two quick samples for a real "
                        "throughput rate) and exit.")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="Frame rendering. Default = %(default)s")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="Per-poll reply timeout; an unanswered poll "
                        "marks the target unreachable for that frame. "
                        "Default = %(default)s")
    # multi-tenant edge: reach a TLS'd / token-guarded fleet
    p.add_argument("--tlsCa", default=None, metavar="PEM",
                   help="CA bundle verifying the target's certificate; "
                        "also switches the poll connection to TLS.")
    p.add_argument("--tls", action="store_true",
                   help="TLS without CA pinning (encrypted, "
                        "unauthenticated; prefer --tlsCa).")
    p.add_argument("--authToken", default=None, metavar="TOKEN",
                   help="Bearer token for a token-guarded target.")
    return p


# ------------------------------------------------------------- sampling

def _parse_target(target: str) -> tuple[str, int]:
    host, _, port_s = target.rpartition(":")
    try:
        return host or "127.0.0.1", int(port_s)
    except ValueError:
        raise ValueError(f"target {target!r}: want HOST:PORT") from None


def sample(host: str, port: int, timeout: float = 5.0,
           tls_ca: str | None = None, tls: bool = False,
           auth_token: str | None = None) -> dict[str, Any] | None:
    """One poll: the target's status verb + parsed metrics exposition,
    or None when the target is unreachable (absence, not crash)."""
    from pbccs_tpu_torch.serve.client import CcsClient

    try:
        with CcsClient(host, port, timeout=timeout, tls_ca=tls_ca,
                       tls=tls, auth_token=auth_token) as cli:
            status = cli.status(timeout=timeout)
            metrics = parse_exposition(cli.metrics(timeout=timeout))
    except (OSError, TimeoutError, RuntimeError):
        return None
    return {"t": time.monotonic(), "status": status, "metrics": metrics}


def _metric(metrics: dict, name: str, replica: str | None) -> float | None:
    """Sum of `name` samples for one replica: labeled `replica=...` in a
    federated exposition, unlabeled for a bare serve target.  None when
    the series is absent (a dead replica contributes nothing)."""
    total, seen = 0.0, False
    for (mname, labels), val in metrics.items():
        if mname != name:
            continue
        lab = dict(labels)
        if "le" in lab:
            continue   # histogram bucket lines are not scalars
        if replica is None:
            if "replica" in lab:
                continue
            total, seen = total + val, True
        elif lab.get("replica") == replica:
            total, seen = total + val, True
    return total if seen else None


def _replica_row(name: str | None, metrics: dict, prev: dict | None,
                 dt: float | None, roster: dict | None = None
                 ) -> dict[str, Any]:
    """One replica's figures from the (federated) exposition; `roster`
    is the router-status row when the target is a router."""
    completed = _metric(metrics, "ccs_serve_completed_total", name)
    row: dict[str, Any] = {
        "replica": name or "self",
        "absent": completed is None,
    }
    if roster is not None:
        row.update(connected=bool(roster.get("connected")),
                   healthy=bool(roster.get("healthy")),
                   draining=bool(roster.get("draining")),
                   router_inflight=roster.get("inflight"))
        if not roster.get("connected"):
            row["absent"] = True
    if row["absent"]:
        return row
    pending = _metric(metrics, "ccs_serve_pending", name) or 0.0
    in_flight = _metric(metrics, "ccs_serve_in_flight_zmws", name) or 0.0
    slo_req = _metric(metrics, "ccs_slo_requests_total", name) or 0.0
    slo_vio = _metric(metrics, "ccs_slo_violations_total", name) or 0.0
    row.update(
        completed=int(completed),
        pending=int(pending),
        in_flight_zmws=int(in_flight),
        queue_depth=max(0, int(pending - in_flight)),
        slo={
            "requests": int(slo_req),
            "violations": int(slo_vio),
            "violation_rate": round(slo_vio / slo_req, 6)
            if slo_req else 0.0,
        },
        refine={
            "converged_fraction": _metric(
                metrics, "ccs_refine_converged_fraction", name),
            "slot_occupancy": _metric(
                metrics, "ccs_refine_slot_occupancy", name),
            "padding_waste": _metric(
                metrics, "ccs_refine_padding_waste", name),
        },
        roofline={
            "efficiency": _metric(
                metrics, "ccs_roofline_efficiency_overall", name),
            "achieved_tflops": _metric(
                metrics, "ccs_roofline_achieved_tflops_overall", name),
        },
    )
    # window figures need a previous sample of the same replica
    throughput = None
    if prev is not None and dt and dt > 0:
        prev_completed = _metric(prev["metrics"],
                                 "ccs_serve_completed_total", name)
        if prev_completed is not None:
            throughput = max(0.0, (completed - prev_completed) / dt)
        prev_vio = _metric(prev["metrics"],
                           "ccs_slo_violations_total", name)
        prev_req = _metric(prev["metrics"], "ccs_slo_requests_total", name)
        if prev_req is not None and slo_req - prev_req > 0:
            row["slo"]["window_burn_rate"] = round(
                max(0.0, slo_vio - (prev_vio or 0.0))
                / (slo_req - prev_req), 6)
    row["throughput_zmws_per_sec"] = (round(throughput, 4)
                                      if throughput is not None else None)
    return row


def fleet_view(cur: dict, prev: dict | None, target: str
               ) -> dict[str, Any]:
    """Assemble one frame from the current (and optional previous)
    sample: target identity, per-replica rows, fleet totals."""
    status = cur["status"]
    metrics = cur["metrics"]
    dt = (cur["t"] - prev["t"]) if prev is not None else None
    engine = status.get("engine", "unknown")
    replicas: list[dict[str, Any]] = []
    if engine == "ccs-router":
        for roster in status.get("replicas", ()):
            replicas.append(_replica_row(roster.get("replica"), metrics,
                                         prev, dt, roster=roster))
        fleet = {k: status.get(k) for k in
                 ("accepting", "pending", "routed", "completed",
                  "failovers", "deduped", "shed", "uptime_s")}
        supervisor = status.get("supervisor")
        if supervisor:
            _merge_supervisor(replicas, supervisor, fleet)
        tenancy = status.get("tenancy")
        if tenancy:
            # the router's per-tenant fair-queue accounting, verbatim
            fleet["tenancy"] = tenancy
    else:
        replicas.append(_replica_row(None, metrics, prev, dt))
        fleet = {k: status.get(k) for k in
                 ("accepting", "pending", "completed", "errors",
                  "queue_depth", "uptime_s")}
    return {
        "t_unix": round(time.time(), 3),
        "target": target,
        "engine": engine,
        "interval_s": round(dt, 3) if dt is not None else None,
        "replicas": replicas,
        "fleet": fleet,
    }


def _merge_supervisor(replicas: list[dict], supervisor: dict,
                      fleet: dict) -> None:
    """Fold the `ccs fleet` supervisor status block into the frame:
    roster rows gain their slot identity/state, and slots with NO roster
    presence (quarantined dead, restarting pre-join, retiring) become
    synthetic absent rows -- so a missing replica reads as *restarting in
    2s* or *dead: crash-loop*, never as a silently shorter table."""
    named = {}
    for row in replicas:
        named[row.get("replica")] = row
    for slot in supervisor.get("slots", ()):
        row = named.get(slot.get("replica"))
        if row is None:
            row = {"replica": slot.get("replica")
                   or f"slot/{slot.get('slot')}",
                   "absent": True}
            replicas.append(row)
        row["slot"] = slot.get("slot")
        row["slot_state"] = slot.get("state")
        if slot.get("reason"):
            row["slot_reason"] = slot["reason"]
        if slot.get("backoff_s"):
            row["backoff_s"] = slot["backoff_s"]
    fleet["supervisor_events"] = list(supervisor.get("events", ()))[-5:]
    if supervisor.get("rolling_restart"):
        fleet["rolling_restart"] = supervisor["rolling_restart"]


# ------------------------------------------------------------ rendering

def _fmt(v, width: int, prec: int | None = None) -> str:
    if v is None:
        return "-".rjust(width)
    if prec is not None and isinstance(v, float):
        return f"{v:.{prec}f}".rjust(width)
    return str(v).rjust(width)


def render_text(view: dict[str, Any]) -> str:
    lines = [
        f"ccs top — {view['target']} ({view['engine']})  "
        f"pending={view['fleet'].get('pending')} "
        f"completed={view['fleet'].get('completed')} "
        + (f"failovers={view['fleet'].get('failovers')} "
           if view["engine"] == "ccs-router" else "")
        + ("" if view["fleet"].get("accepting", True) else "[DRAINING] "),
        f"{'REPLICA':<22} {'UP':>3} {'ZMW/S':>8} {'QDEPTH':>6} "
        f"{'INFLT':>6} {'SLO-BURN':>9} {'CONV':>6} {'OCC':>6} "
        f"{'PADW':>6} {'EFF':>9}",
    ]
    for r in view["replicas"]:
        if r.get("absent"):
            # with a supervisor in the loop an absent row has a CAUSE:
            # restarting (with its backoff), draining out, or dead
            # (crash-loop quarantined) -- plain (absent) otherwise
            state = r.get("slot_state")
            label = f"({state})" if state and state not in ("up",) \
                else "(absent)"
            if state == "restarting" and r.get("backoff_s"):
                label += f" backoff {r['backoff_s']:g}s"
            if r.get("slot_reason"):
                label += f"  {r['slot_reason']}"
            lines.append(f"{r['replica']:<22} {'n':>3}  {label}")
            continue
        slo = r.get("slo", {})
        burn = slo.get("window_burn_rate",
                       slo.get("violation_rate"))
        ref = r.get("refine", {})
        rl = r.get("roofline", {})
        lines.append(
            f"{r['replica']:<22} {'y':>3} "
            f"{_fmt(r.get('throughput_zmws_per_sec'), 8, 2)} "
            f"{_fmt(r.get('queue_depth'), 6)} "
            f"{_fmt(r.get('in_flight_zmws'), 6)} "
            f"{_fmt(burn, 9, 4)} "
            f"{_fmt(ref.get('converged_fraction'), 6, 3)} "
            f"{_fmt(ref.get('slot_occupancy'), 6, 3)} "
            f"{_fmt(ref.get('padding_waste'), 6, 3)} "
            f"{_fmt(rl.get('efficiency'), 9, 6)}")
    tenancy = view["fleet"].get("tenancy")
    if tenancy:
        shedding = " [SHEDDING]" if tenancy.get("shedding") else ""
        lines.append(
            f"tenants  burn={_fmt(tenancy.get('burn_rate'), 0, 4).strip()}"
            f"{shedding}")
        lines.append(
            f"  {'TENANT':<16} {'PRI':>3} {'WT':>3} {'INFLT':>6} "
            f"{'QUEUED':>6} {'DONE':>8} {'REJ':>6} {'SHED':>6}")
        for t in tenancy.get("tenants", ()):
            lines.append(
                f"  {t.get('name', '?'):<16} {_fmt(t.get('priority'), 3)} "
                f"{_fmt(t.get('weight'), 3)} {_fmt(t.get('inflight'), 6)} "
                f"{_fmt(t.get('queued'), 6)} {_fmt(t.get('completed'), 8)} "
                f"{_fmt(t.get('rejected'), 6)} {_fmt(t.get('shed'), 6)}")
    rolling = view["fleet"].get("rolling_restart")
    if rolling:
        lines.append(
            f"rolling restart: {rolling.get('state')} "
            f"current={rolling.get('current')} "
            f"done={rolling.get('done')}/{rolling.get('plan')}")
    events = view["fleet"].get("supervisor_events") or ()
    for ev in list(events)[-3:]:
        slot = ev.get("slot")
        lines.append(
            f"fleet: {ev.get('event')}"
            + (f" slot={slot}" if slot is not None else "")
            + (f"  {ev.get('reason')}" if ev.get("reason") else ""))
    return "\n".join(lines)


def top_frame(host: str, port: int, target: str, prev: dict | None,
              timeout: float, tls_ca: str | None = None,
              tls: bool = False, auth_token: str | None = None
              ) -> tuple[dict | None, dict | None]:
    """One console frame: (view, sample) — view None when the target is
    unreachable (the sample is then also None, and the next frame
    restarts its throughput window)."""
    cur = sample(host, port, timeout=timeout, tls_ca=tls_ca, tls=tls,
                 auth_token=auth_token)
    if cur is None:
        return None, None
    return fleet_view(cur, prev, target), cur


def run_top(argv: list[str] | None = None) -> int:
    """`ccs top` entry point (dispatched from pbccs_tpu_torch.cli)."""
    args = build_top_parser().parse_args(argv)
    try:
        host, port = _parse_target(args.target)
    except ValueError as e:
        print(f"ccs top: {e}", file=sys.stderr)
        return 2
    interval = max(args.interval, 0.1)

    edge = {"tls_ca": args.tlsCa, "tls": args.tls,
            "auth_token": args.authToken}
    if args.once:
        # two quick samples so throughput is a measured rate, not null
        prev = sample(host, port, timeout=args.timeout, **edge)
        if prev is not None:
            time.sleep(min(interval, 1.0))
        view, _cur = top_frame(host, port, args.target, prev,
                               args.timeout, **edge)
        if view is None:
            msg = {"target": args.target,
                   "error": "target unreachable"}
            print(json.dumps(msg) if args.format == "json"
                  else f"ccs top: {args.target} unreachable",
                  file=sys.stdout if args.format == "json"
                  else sys.stderr)
            return 1
        print(json.dumps(view) if args.format == "json"
              else render_text(view))
        return 0

    prev = None
    is_tty = sys.stdout.isatty()
    try:
        while True:
            view, cur = top_frame(host, port, args.target, prev,
                                  args.timeout, **edge)
            prev = cur
            if args.format == "json":
                out = json.dumps(view if view is not None else
                                 {"target": args.target,
                                  "error": "target unreachable"})
            elif view is None:
                out = (f"ccs top: {args.target} unreachable; "
                       "retrying")
            else:
                out = render_text(view)
            if is_tty and args.format == "text":
                sys.stdout.write("\x1b[2J\x1b[H")
            print(out, flush=True)
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0
