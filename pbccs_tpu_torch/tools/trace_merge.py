#!/usr/bin/env python
"""Merge per-process Chrome-trace dumps into ONE fleet Perfetto timeline.

The port's copy of tools/trace_merge.py (same document, same report);
it publishes through the port's resilience.resources.atomic_output.

Each process in the serving fleet (router, every `ccs serve` replica, a
traced client) captures its own span tree (pbccs_tpu_torch/obs/trace.py).
The router's `trace` verb (action=stop) returns them all in one bundle:

    {"type": "trace", "state": "stopped",
     "trace": {..router chrome..},
     "replicas": {"host:port": {..replica chrome..}, ...}}

This tool assembles the bundle (or any set of chrome dumps) into a
single Chrome-trace JSON that ui.perfetto.dev renders as one timeline:

  * every input process gets its own pid + process_name metadata row;
  * timelines are REBASED onto one axis using each tracer's wall-clock
    origin (`meta.origin_unix`) -- perf_counter origins are per-process
    arbitrary, the wall clock is shared (sub-ms skew on one host);
  * cross-process parent links (args.remote_parent naming another
    process's args.span_id, the wire trace-context contract) become
    Chrome flow events, so a request's client -> router -> replica
    chain draws as connected arrows;
  * `meta` totals dropped/open spans across the fleet so a truncated
    capture is visible in the artifact itself.

`request_trees()` / `trace_connected()` are the assertions chip_smoke.py's
router phase holds the fleet to: every request's spans must form ONE
connected tree under its trace_id.

Usage:
    python pbccs_tpu_torch/tools/trace_merge.py bundle.json -o merged.json
    python -m pbccs_tpu_torch.tools.trace_merge router.json replica1.json \
        -o merged.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _span_args(ev: Any) -> dict:
    """An event's args as a dict, {} for anything malformed -- the
    merge must degrade on alien events, never KeyError mid-merge."""
    args = ev.get("args") if isinstance(ev, dict) else None
    return args if isinstance(args, dict) else {}


def merge_docs(docs: list[tuple[str, dict]]) -> dict[str, Any]:
    """Merge (process_name, chrome_doc) pairs into one Chrome-trace
    object (see module docstring for the semantics).

    Degrades, never crashes: a non-dict chrome doc (a replica whose
    trace-stop reply was malformed) is SKIPPED and named in
    ``meta.skipped_processes``; a doc whose ``meta.origin_unix`` is
    missing or non-numeric stays on its own (unshifted) timebase and is
    named in ``meta.unrebased_processes``; a replica with zero spans
    merges as an empty process row.  An empty bundle yields an empty
    (but valid) merged doc."""
    usable: list[tuple[str, dict]] = []
    skipped: list[str] = []
    unrebased: list[str] = []
    for name, doc in docs:
        if isinstance(doc, dict):
            usable.append((name, doc))
        else:
            skipped.append(str(name))

    def doc_meta(doc: dict) -> dict:
        meta = doc.get("meta")
        return meta if isinstance(meta, dict) else {}

    origins = [doc_meta(d).get("origin_unix") for _, d in usable]
    known = [o for o in origins if isinstance(o, (int, float))
             and not isinstance(o, bool)]
    base = min(known) if known else 0.0

    events: list[dict] = []
    processes: dict[str, int] = {}
    dropped = open_spans = 0
    by_span_id: dict[str, dict] = {}
    for i, (name, doc) in enumerate(usable):
        pid = i + 1
        processes[name] = pid
        meta = doc_meta(doc)
        try:
            dropped += int(meta.get("dropped_spans", 0) or 0)
            open_spans += int(meta.get("open_spans", 0) or 0)
        except (TypeError, ValueError):
            pass  # alien meta counts; the span data still merges
        origin = meta.get("origin_unix")
        if isinstance(origin, (int, float)) and not isinstance(origin,
                                                               bool):
            shift_us = (origin - base) * 1e6
        else:
            shift_us = 0.0
            unrebased.append(str(name))
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": name}})
        raw = doc.get("traceEvents")
        for ev in (raw if isinstance(raw, list) else []):
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            ev["pid"] = pid
            if isinstance(ev.get("ts"), (int, float)):
                ev["ts"] = round(ev["ts"] + shift_us, 1)
            events.append(ev)
            sid = _span_args(ev).get("span_id")
            if isinstance(sid, str):
                by_span_id.setdefault(sid, ev)

    # cross-process parent links -> Chrome flow events (drawn as arrows)
    flow_seq = 0
    flows: list[dict] = []
    for ev in events:
        rp = _span_args(ev).get("remote_parent")
        if not isinstance(rp, str):
            continue
        parent = by_span_id.get(rp)
        if parent is None or parent is ev:
            continue
        flow_seq += 1
        common = {"cat": "trace-context", "name": "trace", "id": flow_seq}
        flows.append({**common, "ph": "s", "pid": parent["pid"],
                      "tid": parent.get("tid", 0),
                      "ts": parent.get("ts", 0)})
        flows.append({**common, "ph": "f", "bp": "e", "pid": ev["pid"],
                      "tid": ev.get("tid", 0), "ts": ev.get("ts", 0)})
    meta: dict[str, Any] = {"processes": processes,
                            "dropped_spans": dropped,
                            "open_spans": open_spans}
    if skipped:
        meta["skipped_processes"] = sorted(skipped)
    if unrebased:
        meta["unrebased_processes"] = sorted(unrebased)
    return {
        "traceEvents": events + flows,
        "displayTimeUnit": "ms",
        "meta": meta,
    }


def expand_bundle(obj: dict, router_name: str = "router"
                  ) -> list[tuple[str, dict]]:
    """(name, chrome) pairs from a router trace-stop reply bundle, or
    from a bare chrome doc (single-process input)."""
    if "replicas" in obj or ("trace" in obj
                             and "traceEvents" not in obj):
        trace = obj.get("trace")
        docs = [(router_name,
                 trace if isinstance(trace, dict) else {"traceEvents": []})]
        replicas = obj.get("replicas")
        if isinstance(replicas, dict):
            for name, chrome in sorted(replicas.items()):
                # a malformed per-replica chrome rides through as-is:
                # merge_docs skips it with a meta.skipped_processes note
                docs.append((f"replica {name}", chrome))
        return docs
    meta = obj.get("meta")
    process = meta.get("process") if isinstance(meta, dict) else None
    return [(process or router_name, obj)]


# ------------------------------------------------------- tree assertions

def request_trees(merged: dict) -> dict[str, dict[str, Any]]:
    """Per-trace_id connectivity report over a merged doc:
    {trace_id: {"events": n, "components": k, "processes": [...]}} --
    a request whose spans crossed the fleet under one trace shows
    components == 1 and len(processes) >= 2."""
    def hashable(v) -> bool:
        try:
            hash(v)
        except TypeError:
            return False
        return True

    events = [ev for ev in merged.get("traceEvents", [])
              if isinstance(ev, dict) and ev.get("ph") == "X"
              and "pid" in ev]
    by_span_id = {_span_args(ev)["span_id"]: ev for ev in events
                  if isinstance(_span_args(ev).get("span_id"), str)}
    by_pid_index = {(ev["pid"], ev.get("id")): ev for ev in events
                    if hashable(ev.get("id"))}

    parent: dict[int, int] = {}

    def find(x: int) -> int:
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        parent[find(a)] = find(b)

    ids = {id(ev): ev for ev in events}
    for ev in events:
        args = _span_args(ev)
        rp = args.get("remote_parent")
        if isinstance(rp, str) and rp in by_span_id:
            union(id(ev), id(by_span_id[rp]))
        p = args.get("parent")
        if p is not None and hashable(p) \
                and (ev["pid"], p) in by_pid_index:
            union(id(ev), id(by_pid_index[(ev["pid"], p)]))

    out: dict[str, dict[str, Any]] = {}
    # only STRING trace ids participate: an alien-typed id (an int a
    # malformed replica minted) must be skipped like every other alien
    # shape, not crash the sort with a mixed-type comparison
    tids = {_span_args(ev).get("trace_id") for ev in events}
    for tid in sorted(t for t in tids if isinstance(t, str) and t):
        mine = [ev for ev in events
                if _span_args(ev).get("trace_id") == tid]
        roots = {find(id(ev)) for ev in mine}
        out[tid] = {
            "events": len(mine),
            "components": len(roots),
            "processes": sorted({ev["pid"] for ev in mine}),
            "spans": sorted({str(ev.get("name", "?")) for ev in mine}),
        }
    del ids
    return out


def trace_connected(merged: dict, trace_id: str) -> bool:
    """True when trace_id's spans form ONE connected tree."""
    report = request_trees(merged).get(trace_id)
    return report is not None and report["components"] == 1


# ------------------------------------------------------------------- CLI

def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="trace_merge",
        description="Merge per-process CCS trace dumps (a router trace "
                    "bundle or chrome JSON files) into one Perfetto "
                    "timeline.")
    p.add_argument("inputs", nargs="+",
                   help="Router trace-stop bundle JSON and/or chrome "
                        "trace JSON files.")
    p.add_argument("-o", "--output", required=True,
                   help="Merged Chrome-trace JSON output path.")
    p.add_argument("--report", action="store_true",
                   help="Print the per-trace connectivity report.")
    args = p.parse_args(argv)

    docs: list[tuple[str, dict]] = []
    for path in args.inputs:
        with open(path) as f:
            obj = json.load(f)
        base = os.path.splitext(os.path.basename(path))[0]
        docs.extend(expand_bundle(obj, router_name=base))
    merged = merge_docs(docs)

    from pbccs_tpu_torch.resilience.resources import atomic_output

    with atomic_output(args.output, "trace") as f:
        json.dump(merged, f)
    report = request_trees(merged)
    if args.report:
        print(json.dumps(report, indent=2))
    connected = sum(1 for r in report.values() if r["components"] == 1)
    print(f"trace_merge: {len(docs)} process(es), "
          f"{len(merged['traceEvents'])} event(s), "
          f"{len(report)} trace(s) ({connected} connected) "
          f"-> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
