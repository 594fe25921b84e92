"""Wire protocol of the online CCS serving engine: newline-delimited JSON.

Port of pbccs_tpu.serve.protocol: the same wire, byte for byte (verbs,
reply types, error codes, optional fields and the ZMW/result layout),
so each package's client completes against the other's server.  The
router and fleet names below are part of that wire even though the
port serves no router yet: a `fleet` verb gets a structured error.

One JSON object per line, UTF-8, over a byte stream (TCP).  Client
messages carry a `verb`; server messages carry a `type`.  Every client
message may carry an `id` (any JSON string) which the server echoes on
the reply, so concurrent requests on one session stream back
out-of-order and the client re-associates them.  This module is
transport-free -- encode/decode plus the ZMW/result wire layout -- so
protocol tests never open a socket (server.py and client.py own the
sockets).

Request-id plumbing through the router tier (serve/router.py): `ccs
router` rewrites the id on BOTH hops -- a client submit's id maps to a
router-assigned `q<N>` toward the replica, and the replica's reply maps
back before emission.  The router id is the failover/dedup key: after a
replica failure the same `q<N>` may be resubmitted to another replica,
and the first reply bearing it wins (later duplicates are dropped), so
a client sees exactly one reply per id it sent.  Ids beginning `hc` on
a replica link are the router's own status-verb health probes, and ids
beginning `fl` its fleet-introspection calls (metrics federation, trace
fan-out).  All of this is invisible at both edges; no wire shape
changes.

Trace context (the fleet observability plane): a submit frame MAY carry
a `trace` object -- {"trace_id": <hex string>, "span_id": <string>} --
naming the distributed trace the request belongs to and the sender-side
span it continues.  Each tier propagates it inward (client -> router ->
replica session -> engine prep/polish spans -> sched dispatch) and the
router REWRITES span_id on the replica hop to its own per-request span,
exactly as it rewrites the request id; trace_id is never rewritten, so
one id names the request across every process.  The field is pure
observability: it changes no consensus, no routing, no admission.  A
malformed `trace` object is rejected `bad_request` like any other
malformed field (the armor validates everything it forwards).

Client verbs:
  submit  {"verb": "submit", "id": ..., "zmw": <zmw>, "deadline_ms": ...,
           "trace": {"trace_id": ..., "span_id": ...}}   # trace optional
  status  {"verb": "status", "id": ...}
  metrics {"verb": "metrics", "id": ...}
  trace   {"verb": "trace", "id": ..., "action": "start" | "stop"}
  fleet   {"verb": "fleet", "id": ..., "action": "list" | "add" |
           "remove" | "restart" | "readmit", "replica": "host:port",
           "timeout_s": ...}   # replica/timeout_s action-dependent
  ping    {"verb": "ping", "id": ...}

Server replies:
  result  {"type": "result", "id": ..., "status": "<Failure name>",
           "zmw": ..., "latency_ms": ...,  # + on Success:
           "sequence": ..., "qual": <phred+33>, "num_passes": ...,
           "predicted_accuracy": ..., "avg_zscore": ...}
  error   {"type": "error", "id": ..., "code": "<machine code>",
           "error": "<human message>"}
  status  {"type": "status", "id": ..., ...engine.status()...}
          -- includes a `perf` block (schema_version, records,
          last_record: the newest performance-ledger record) when the
          process writes a perf ledger (--perfLedger)
  metrics {"type": "metrics", "id": ...,
           "content_type": "text/plain; version=0.0.4",
           "body": "<Prometheus text exposition>"}
  trace   {"type": "trace", "id": ..., "state": "started" |
           "already_running" | "stopped" | "not_running",
           "trace": {..Chrome-trace JSON..}}  # on state "stopped" only
  fleet   {"type": "fleet", "id": ..., "action": <echoed>, "ok": true,
           ...action-specific fields (replicas roster for list, the
           member name for add/remove, drain outcome for remove)...}
  pong    {"type": "pong", "id": ...}
  closed  {"type": "closed", "reason": "draining" | "idle_timeout"}
          -- unsolicited: the server is about to close this session
          (graceful drain, or the idle-session reaper fired)

Error codes: bad_request (unparseable/invalid message -- the session
stays open unless the frame itself broke framing, e.g. oversized),
overloaded (admission queue full OR the per-session in-flight cap OR a
tenant's fair-queue bound OR SLO-burn shedding: backpressure, retry
later -- shed/over-quota rejections additionally carry a
`retry_after_ms` hint the client backoff honors), closed (engine
shutting down), internal (the request raised inside the engine; the
SERVER stays up, only this request fails), unauthorized (an
authenticated front door -- `--authTokens` -- saw a frame whose `auth`
bearer token is missing or unknown; the session stays open, nothing
else in the frame was parsed).

Multi-tenant edge (serve/tenancy.py): with a token file configured,
every frame must carry `auth: "<token>"`; the token maps to a tenant
(quota, priority class, DRR weight) and IS the identity.  A submit MAY
carry a `tenant` object -- {"name": <tenant>} -- but it is honored only
from a `trusted` token (the router forwarding the original submitter to
a replica); from anyone else it is ignored, so tenants cannot spoof
each other's accounting or quotas.

Protocol armor (ServeConfig limits, enforced by server._Session): frames
longer than max_line_bytes get `bad_request` and the session closes;
sessions idle past idle_timeout_s with nothing in flight are reaped with
a `closed` notice; submits past max_inflight_per_session are rejected
`overloaded` without touching the engine.  The `zmw` payload passes the
same io.validate.validate_chunk contract the offline CLI reader applies,
so both front doors reject garbage identically.

The ZMW wire layout mirrors pipeline.Chunk:
  {"id": "movie/hole", "snr": [A, C, G, T],
   "reads": [{"id": ..., "seq": "ACGT...", "flags": 3,
              "accuracy": 0.8}, ...]}
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from pbccs_tpu_torch.models.arrow.params import decode_bases, encode_bases
from pbccs_tpu_torch.pipeline import Chunk, ConsensusResult, Failure, Subread

PROTOCOL_VERSION = 1

# client verbs
VERB_SUBMIT = "submit"
VERB_STATUS = "status"
VERB_METRICS = "metrics"
VERB_TRACE = "trace"
VERB_FLEET = "fleet"
VERB_PING = "ping"

# server reply types
TYPE_RESULT = "result"
TYPE_ERROR = "error"
TYPE_STATUS = "status"
TYPE_METRICS = "metrics"
TYPE_TRACE = "trace"
TYPE_FLEET = "fleet"
TYPE_PONG = "pong"
TYPE_CLOSED = "closed"

# the Prometheus text exposition format version the metrics verb speaks
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4"

# error codes
ERR_BAD_REQUEST = "bad_request"
ERR_OVERLOADED = "overloaded"
ERR_CLOSED = "closed"
ERR_INTERNAL = "internal"
ERR_UNAUTHORIZED = "unauthorized"

# optional wire fields (cross-cutting objects that may ride a verb frame)
FIELD_TRACE = "trace"
# the trace-context object's keys
KEY_TRACE_ID = "trace_id"
KEY_SPAN_ID = "span_id"
# the status reply's performance-ledger block (obs.ledger.perf_block):
# schema version, records appended by this process, most recent record.
# Declared here (and in WIRE_FIELDS below) so protolint polices the
# status addition like every other wire name.
FIELD_PERF = "perf"
KEY_PERF_SCHEMA = "schema_version"
KEY_PERF_RECORDS = "records"
KEY_PERF_LAST = "last_record"

# status-verb roofline block (obs/roofline.py status_block): per-bucket
# CostCard bound + measured achieved/efficiency.
FIELD_ROOFLINE = "roofline"
KEY_ROOFLINE_SCHEMA = "schema_version"
KEY_ROOFLINE_PEAK = "peak_tflops"
KEY_ROOFLINE_BUCKETS = "buckets"

# status-verb supervisor block (serve/supervisor.py status_block): the
# fleet autopilot's slot table (state machine per managed replica
# process), its recent fleet events, and rolling-restart progress.
# Present only when a supervisor controls the answering router.
FIELD_SUPERVISOR = "supervisor"
KEY_SUP_SLOTS = "slots"
KEY_SUP_EVENTS = "events"
KEY_SUP_ROLLING = "rolling_restart"

# multi-tenant edge (serve/tenancy.py).  `auth` is the bearer token an
# authenticated front door (--authTokens) requires on EVERY verb frame;
# a frame without a known token gets ERR_UNAUTHORIZED.  `tenant` is the
# identity object the router forwards on the replica hop -- the token,
# not this field, is the identity at the edge (a non-trusted session's
# tenant field is ignored; see tenancy.resolve_tenant).
FIELD_AUTH = "auth"
FIELD_TENANT = "tenant"
KEY_TENANT_NAME = "name"
# error replies answering a shed/over-quota submit carry a client
# backoff hint in milliseconds (client.submit_with_retry honors it,
# capped + jittered); rides reply frames, so it has no carrier verb.
FIELD_RETRY_AFTER = "retry_after_ms"
# status-verb tenancy block (tenancy.FairQueue.rows + shed state):
# per-tenant admission accounting rendered by `ccs top`.
FIELD_TENANCY = "tenancy"
KEY_TEN_TENANTS = "tenants"
KEY_TEN_BURN = "burn_rate"
KEY_TEN_SHEDDING = "shedding"


# ------------------------------------------------------------------ wire spec
#
# Machine-readable protocol state machine.  `ccs analyze`'s protolint
# pass (pbccs_tpu/analysis/protolint.py) parses these tables from the
# AST -- never importing this module -- and statically checks
# server.py / router.py / client.py against them: every verb a client
# tier can send has a registered handler on the serving tier's
# dispatch, every reply type and error code that reaches a wire is
# declared here, and every handler completes-or-fails a request
# exactly once, only while owning it.  Values resolve through the
# VERB_*/TYPE_*/ERR_* constants above, so the spec cannot drift from
# the names the code ships (drift either way is a PRO001 finding).
#
# Per-verb fields:
#   handler  the session method that serves the verb (None = handled
#            inline by the dispatch loop itself, e.g. ping/pong);
#   replies  reply types the verb may terminate with (any verb may
#            additionally fail with TYPE_ERROR);
#   ownership "callback" marks the ownership-transfer rule: the handler
#            acquires the session in-flight slot and hands completion
#            (reply + slot release) to a registered callback -- the
#            exactly-once and lease obligations move with it.

WIRE_VERBS = {
    VERB_SUBMIT: {"handler": "_on_submit",
                  "replies": (TYPE_RESULT, TYPE_ERROR),
                  "ownership": "callback"},
    VERB_STATUS: {"handler": "_on_status", "replies": (TYPE_STATUS,)},
    VERB_METRICS: {"handler": "_on_metrics", "replies": (TYPE_METRICS,)},
    VERB_TRACE: {"handler": "_on_trace",
                 "replies": (TYPE_TRACE, TYPE_ERROR)},
    VERB_FLEET: {"handler": "_on_fleet",
                 "replies": (TYPE_FLEET, TYPE_ERROR)},
    VERB_PING: {"handler": None, "replies": (TYPE_PONG,)},
}

WIRE_REPLIES = (TYPE_RESULT, TYPE_ERROR, TYPE_STATUS, TYPE_METRICS,
                TYPE_TRACE, TYPE_FLEET, TYPE_PONG, TYPE_CLOSED)

# server->client types no verb elicits (drain / idle-reap notices)
WIRE_UNSOLICITED = (TYPE_CLOSED,)

WIRE_ERRORS = (ERR_BAD_REQUEST, ERR_OVERLOADED, ERR_CLOSED, ERR_INTERNAL,
               ERR_UNAUTHORIZED)

# optional cross-cutting wire FIELDS: {field: {"keys": (...), "verbs":
# (carrier verbs...)}}.  protolint's PRO001 checks the FIELD_*/KEY_*
# constants against this table both ways (the same membership rule as
# verbs/replies/errors), so the trace-context contract cannot drift
# from the names the code ships.
WIRE_FIELDS = {
    FIELD_TRACE: {"keys": (KEY_TRACE_ID, KEY_SPAN_ID),
                  "verbs": (VERB_SUBMIT,)},
    # rides the STATUS exchange: the reply to a `status` verb carries a
    # `perf` block when the serving process writes a performance ledger
    # (--perfLedger); absent otherwise.  The router federates these
    # blocks fleet-wide into its own ledger.
    FIELD_PERF: {"keys": (KEY_PERF_SCHEMA, KEY_PERF_RECORDS,
                          KEY_PERF_LAST),
                 "verbs": (VERB_STATUS,)},
    # rides the STATUS exchange: present once the roofline plane holds a
    # CostCard or a charge for any bucket; absent on cold replicas or
    # under PBCCS_ROOFLINE=0.
    FIELD_ROOFLINE: {"keys": (KEY_ROOFLINE_SCHEMA, KEY_ROOFLINE_PEAK,
                              KEY_ROOFLINE_BUCKETS),
                     "verbs": (VERB_STATUS,)},
    # rides the STATUS exchange: present when a fleet supervisor
    # (serve/supervisor.py) controls the answering router -- the slot
    # table `ccs top` renders restarting/dead/draining states from,
    # plus the recent fleet events and rolling-restart progress.
    FIELD_SUPERVISOR: {"keys": (KEY_SUP_SLOTS, KEY_SUP_EVENTS,
                                KEY_SUP_ROLLING),
                       "verbs": (VERB_STATUS,)},
    # may ride EVERY verb frame: the bearer token an authenticated front
    # door (--authTokens) requires before dispatching the verb at all; a
    # missing/unknown token answers ERR_UNAUTHORIZED and the frame is
    # never parsed further.
    FIELD_AUTH: {"keys": (),
                 "verbs": (VERB_SUBMIT, VERB_STATUS, VERB_METRICS,
                           VERB_TRACE, VERB_FLEET, VERB_PING)},
    # rides the SUBMIT frame on the router->replica hop: the router
    # (whose link token is `trusted`) forwards the ORIGINAL submitter's
    # identity so replica-side accounting stays per-tenant.  From a
    # non-trusted session the field is ignored (spoofing defense).
    FIELD_TENANT: {"keys": (KEY_TENANT_NAME,),
                   "verbs": (VERB_SUBMIT,)},
    # rides error REPLIES (shed / over-quota): no carrier verb.
    FIELD_RETRY_AFTER: {"keys": (), "verbs": ()},
    # rides the STATUS exchange: present when the answering router runs
    # with a token file -- per-tenant admission rows (FairQueue.rows),
    # the fleet burn rate, and whether shedding is engaged.
    FIELD_TENANCY: {"keys": (KEY_TEN_TENANTS, KEY_TEN_BURN,
                             KEY_TEN_SHEDDING),
                    "verbs": (VERB_STATUS,)},
}


class ProtocolError(ValueError):
    """A message violates the wire contract (bad JSON, wrong field types,
    missing required fields)."""


def encode_msg(msg: dict[str, Any]) -> bytes:
    """One NDJSON frame: compact JSON + newline."""
    return json.dumps(msg, separators=(",", ":")).encode() + b"\n"


def decode_line(line: bytes | str) -> dict[str, Any]:
    """Parse one NDJSON frame; raises ProtocolError on anything that is
    not a JSON object."""
    if isinstance(line, bytes):
        try:
            line = line.decode()
        except UnicodeDecodeError as e:
            raise ProtocolError(f"frame is not UTF-8: {e}") from None
    try:
        msg = json.loads(line)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"frame is not JSON: {e}") from None
    if not isinstance(msg, dict):
        raise ProtocolError("frame is not a JSON object")
    return msg


# ---------------------------------------------------------------- trace wire

# armor bound: trace ids/span ids are opaque strings, but the session
# must not carry arbitrarily large attacker-chosen payloads into every
# span/export downstream
_TRACE_VALUE_MAX = 128


def trace_from_wire(obj: Any) -> dict[str, Any] | None:
    """Validate + normalize a frame's optional `trace` field.  Returns
    {"trace_id": str, "span_id": str | None}, or None when absent;
    raises ProtocolError (-> bad_request) on malformed input."""
    if obj is None:
        return None
    if not isinstance(obj, dict):
        raise ProtocolError("trace must be an object")
    trace_id = obj.get(KEY_TRACE_ID)
    if not isinstance(trace_id, str) or not trace_id \
            or len(trace_id) > _TRACE_VALUE_MAX:
        raise ProtocolError(
            f"trace.{KEY_TRACE_ID} must be a non-empty string "
            f"(<= {_TRACE_VALUE_MAX} chars)")
    span_id = obj.get(KEY_SPAN_ID)
    if span_id is not None and (not isinstance(span_id, str)
                                or len(span_id) > _TRACE_VALUE_MAX):
        raise ProtocolError(
            f"trace.{KEY_SPAN_ID} must be a string "
            f"(<= {_TRACE_VALUE_MAX} chars)")
    return {KEY_TRACE_ID: trace_id, KEY_SPAN_ID: span_id}


# --------------------------------------------------------------- tenant wire

def tenant_from_wire(obj: Any) -> dict[str, Any] | None:
    """Validate + normalize a frame's optional `tenant` field (the
    identity object a trusted router forwards on the replica hop).
    Returns {"name": str}, or None when absent; raises ProtocolError
    (-> bad_request) on malformed input -- the same armor contract as
    trace_from_wire, and the same size bound."""
    if obj is None:
        return None
    if not isinstance(obj, dict):
        raise ProtocolError("tenant must be an object")
    name = obj.get(KEY_TENANT_NAME)
    if not isinstance(name, str) or not name \
            or len(name) > _TRACE_VALUE_MAX:
        raise ProtocolError(
            f"tenant.{KEY_TENANT_NAME} must be a non-empty string "
            f"(<= {_TRACE_VALUE_MAX} chars)")
    return {KEY_TENANT_NAME: name}


# ------------------------------------------------------------------ ZMW wire

def chunk_to_wire(chunk: Chunk) -> dict[str, Any]:
    return {
        "id": chunk.id,
        "snr": [float(s) for s in np.asarray(chunk.snr)],
        "reads": [{"id": r.id, "seq": decode_bases(r.seq),
                   "flags": int(r.flags),
                   "accuracy": float(r.read_accuracy)}
                  for r in chunk.reads],
    }


def chunk_from_wire(zmw: Any) -> Chunk:
    """Validate + decode a submit message's `zmw` field; raises
    ProtocolError with a client-actionable message on malformed input."""
    if not isinstance(zmw, dict):
        raise ProtocolError("zmw must be an object")
    zid = zmw.get("id")
    if not isinstance(zid, str) or not zid:
        raise ProtocolError("zmw.id must be a non-empty string")
    snr = zmw.get("snr", [8.0] * 4)
    if (not isinstance(snr, list) or len(snr) != 4
            or not all(isinstance(s, (int, float))
                       and not isinstance(s, bool) for s in snr)):
        raise ProtocolError("zmw.snr must be 4 numbers (ACGT)")
    reads = zmw.get("reads")
    if not isinstance(reads, list) or not reads:
        raise ProtocolError("zmw.reads must be a non-empty array")
    subreads = []
    for i, r in enumerate(reads):
        if not isinstance(r, dict) or not isinstance(r.get("seq"), str):
            raise ProtocolError(f"zmw.reads[{i}].seq must be a string")
        try:
            seq = encode_bases(r["seq"])
        except UnicodeEncodeError:
            raise ProtocolError(
                f"zmw.reads[{i}].seq must be ASCII base characters"
            ) from None
        if isinstance(r.get("flags"), bool) \
                or isinstance(r.get("accuracy"), bool):
            raise ProtocolError(
                f"zmw.reads[{i}] flags/accuracy must be numeric")
        try:
            flags = int(r.get("flags", 3))
            accuracy = float(r.get("accuracy", 0.8))
        except (TypeError, ValueError):
            raise ProtocolError(
                f"zmw.reads[{i}] flags/accuracy must be numeric") from None
        subreads.append(Subread(id=str(r.get("id", f"{zid}/{i}")), seq=seq,
                                flags=flags, read_accuracy=accuracy))
    chunk = Chunk(zid, subreads, np.asarray(snr, np.float64))
    from pbccs_tpu_torch.io.validate import ChunkValidationError, validate_chunk

    try:
        # the same contract the offline CLI reader enforces (io.validate):
        # counts ccs_input_invalid_records_total{reason} and gives the
        # client the structured reason
        validate_chunk(chunk)
    except ChunkValidationError as e:
        raise ProtocolError(f"zmw rejected ({e.reason}): {e}") from None
    return chunk


# --------------------------------------------------------------- result wire

def result_to_wire(request_id: Any, zmw_id: str, failure: Failure,
                   result: ConsensusResult | None,
                   latency_ms: float) -> dict[str, Any]:
    """One streamed per-ZMW result (Success carries the consensus; any
    other status is a structured yield-gate outcome, not an error)."""
    msg: dict[str, Any] = {
        "type": TYPE_RESULT,
        "id": request_id,
        "zmw": zmw_id,
        "status": failure.value,
        "latency_ms": round(float(latency_ms), 3),
    }
    if result is not None:
        msg.update(
            sequence=result.sequence,
            qual=result.qualities,
            num_passes=int(result.num_passes),
            predicted_accuracy=round(float(result.predicted_accuracy), 6),
            avg_zscore=(float(result.avg_zscore)
                        if np.isfinite(result.avg_zscore) else None),
        )
        if result.draft_only:
            # quarantine degradation: the sequence is the unpolished POA
            # draft with capped QVs (resilience.quarantine)
            msg["draft_only"] = True
    return msg


def error_to_wire(request_id: Any, code: str, message: str,
                  retry_after_ms: float | None = None) -> dict[str, Any]:
    """One structured error reply.  `retry_after_ms` (shed / over-quota
    rejections) tells the client WHEN to retry -- submit_with_retry
    honors it over its own exponential schedule, so a shedding fleet
    paces its retry storm instead of amplifying it."""
    msg = {"type": TYPE_ERROR, "id": request_id, "code": code,
           "error": message}
    if retry_after_ms is not None:
        msg[FIELD_RETRY_AFTER] = round(float(retry_after_ms), 3)
    return msg
