"""Host performance profiles: the artifact `ccs tune` emits (port of
pbccs_tpu.tune.profile).

A profile is a small JSON document keyed by a HARDWARE FINGERPRINT --
platform, device kind, device count, torch version -- holding only the
knobs whose tuned values beat the hand-tuned defaults on the
calibration workload (byte-identical output, perf_gate-refereed).  The
loader (runtime/tuning.py) applies a profile only when every
fingerprint field matches the running host: a profile tuned on one
accelerator generation must never leak onto another, and a torch
upgrade may move what was measured.  The port fingerprints
``torch_version`` where pbccs_tpu fingerprints ``jax_version``, so a
pbccs_tpu profile never applies here (it fails the schema check: its
fingerprint lacks torch_version).

Publish/load discipline mirrors the rest of the repo's artifacts:
atomic publish (tmp + fsync + rename, resilience.resources) so a crash
mid-write never leaves a torn profile, and a corrupt/torn/alien file
DEGRADES to (None, note) -- a bad profile costs the tuned speedup,
never the run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any

PROFILE_SCHEMA_VERSION = 1

#: Every field must match the running host for a profile to apply.
FINGERPRINT_FIELDS = ("platform", "device_kind", "device_count",
                      "torch_version")

#: Knob value types a profile may carry (lists hold str bucket specs).
_SCALAR = (int, float, str)


@dataclasses.dataclass(frozen=True)
class HostProfile:
    """One committed per-host tuning profile."""

    fingerprint: dict[str, Any]
    knobs: dict[str, Any]
    schema_version: int = PROFILE_SCHEMA_VERSION
    #: calibration workload descriptor + search provenance (free-form,
    #: recorded for humans and for `ccs tune --resume` sanity checks)
    calibration: dict[str, Any] = dataclasses.field(default_factory=dict)
    #: objective figures the ship decision was made on (gain, repeats,
    #: baseline/tuned ZMW/s) -- documentation, never re-enforced at load
    objective: dict[str, Any] = dataclasses.field(default_factory=dict)
    created_unix: float | None = None

    @property
    def profile_id(self) -> str:
        """Stable content id: sha256 over the canonical fingerprint +
        knobs (the parts that change behavior), truncated for display.
        This is what perf-ledger `tuned_profile` fields and bench rows
        carry, so a row is attributable to the exact knob set."""
        canon = json.dumps({"fingerprint": self.fingerprint,
                            "knobs": self.knobs},
                           sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:12]

    def to_doc(self) -> dict[str, Any]:
        doc = {
            "profile_schema_version": self.schema_version,
            "profile_id": self.profile_id,
            "fingerprint": dict(self.fingerprint),
            "knobs": dict(self.knobs),
            "calibration": dict(self.calibration),
            "objective": dict(self.objective),
        }
        if self.created_unix is not None:
            doc["created_unix"] = round(self.created_unix, 3)
        return doc


def host_fingerprint(device=None) -> dict[str, Any]:
    """The fingerprint of the device a process runs on (None: the card,
    as the port's entry points default to; "cpu": the CPU).  Reading the
    card's name creates a CUDA context -- only the OPT-IN paths call this
    (configure with --tuneProfile, or the tune driver itself), never a
    passive ledger append."""
    import torch

    cuda = device is None or torch.device(device).type == "cuda"
    if cuda and torch.cuda.is_available():
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(0),
                "device_count": torch.cuda.device_count(),
                "torch_version": torch.__version__}
    if cuda:
        raise RuntimeError("no CUDA device to fingerprint; pass "
                           "device='cpu' for the CPU")
    return {"platform": "cpu", "device_kind": "cpu", "device_count": 1,
            "torch_version": torch.__version__}


def fingerprint_mismatch(profile_fp: dict[str, Any],
                         host_fp: dict[str, Any]) -> str | None:
    """None when the profile applies to this host, else a human-readable
    note naming the first mismatching field."""
    for field in FINGERPRINT_FIELDS:
        if profile_fp.get(field) != host_fp.get(field):
            return (f"fingerprint mismatch on {field}: profile "
                    f"{profile_fp.get(field)!r} != host "
                    f"{host_fp.get(field)!r}")
    return None


def save_profile(profile: HostProfile, path: str) -> None:
    """Atomic publish (tmp + fsync + rename): a crash mid-save never
    leaves a torn profile where the loader would find it."""
    from pbccs_tpu_torch.resilience.resources import atomic_output

    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with atomic_output(path, "tune_profile") as fh:
        json.dump(profile.to_doc(), fh, indent=2, sort_keys=True)
        fh.write("\n")


def _validate_doc(doc: Any) -> HostProfile | None:
    if not isinstance(doc, dict):
        return None
    if doc.get("profile_schema_version") != PROFILE_SCHEMA_VERSION:
        return None
    fp = doc.get("fingerprint")
    knobs = doc.get("knobs")
    if not isinstance(fp, dict) or not isinstance(knobs, dict):
        return None
    if not all(f in fp for f in FINGERPRINT_FIELDS):
        return None
    for name, val in knobs.items():
        if not isinstance(name, str):
            return None
        if isinstance(val, bool):
            return None
        if isinstance(val, list):
            if not all(isinstance(v, str) for v in val):
                return None
        elif not isinstance(val, _SCALAR):
            return None
    calib = doc.get("calibration")
    obj = doc.get("objective")
    created = doc.get("created_unix")
    return HostProfile(
        fingerprint=dict(fp), knobs=dict(knobs),
        calibration=dict(calib) if isinstance(calib, dict) else {},
        objective=dict(obj) if isinstance(obj, dict) else {},
        created_unix=float(created)
        if isinstance(created, (int, float)) else None)


def load_profile(path: str) -> tuple[HostProfile | None, str | None]:
    """(profile, note): a missing, torn, corrupt, or schema-alien file
    is (None, why) -- the loader degrades to hand-tuned defaults with a
    logged note, never a crash (the resolution-ladder contract)."""
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except OSError as e:
        return None, f"cannot read tune profile {path}: {e}"
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        return None, f"tune profile {path} is not valid JSON: {e}"
    prof = _validate_doc(doc)
    if prof is None:
        return None, (f"tune profile {path} does not match profile "
                      f"schema v{PROFILE_SCHEMA_VERSION}; ignoring it")
    return prof, None


def discover_profile(directory: str, host_fp: dict[str, Any]
                     ) -> tuple[HostProfile | None, list[str]]:
    """Auto-discovery (`--tuneProfile auto`): scan ``directory`` for
    the first committed profile whose fingerprint matches this host.
    Returns (profile | None, notes) -- one note per file skipped and
    why, so a near-miss (wrong torch version) is visible in the log."""
    notes: list[str] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError as e:
        return None, [f"tune profile dir {directory}: {e}"]
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(directory, name)
        prof, note = load_profile(path)
        if prof is None:
            notes.append(note or f"{path}: unreadable")
            continue
        mismatch = fingerprint_mismatch(prof.fingerprint, host_fp)
        if mismatch is not None:
            notes.append(f"{path}: {mismatch}")
            continue
        return prof, notes
    notes.append(f"no profile in {directory} matches this host")
    return None, notes
