"""Tuned-knob resolution: the consumer half of `ccs tune` (port of
pbccs_tpu.runtime.tuning).

One process-wide resolution ladder, consulted by every knob site:

    explicit flag / env  >  matching host profile  >  hand-tuned default

Profiles are OPT-IN: nothing is loaded unless `--tuneProfile PATH`,
`--tuneProfile auto`, or the `PBCCS_TUNE_PROFILE` env equivalent asks
for it (``auto`` scans the committed ``profiles/`` directory --
override with ``PBCCS_TUNE_PROFILE_DIR`` -- for the first fingerprint
match).  The default-off posture keeps every existing workflow
byte-for-byte on the hand-tuned constants; a profile only changes
behavior on the host class it was measured on.

Application is fail-open by design (the satellite-3 contract):

  * a missing/corrupt/torn profile file degrades to defaults with a
    logged note, never a crash;
  * a fingerprint mismatch (wrong device kind, different torch version,
    or a pbccs_tpu profile, which names jax_version) falls through to
    defaults with a logged note;
  * an applied profile is attributed everywhere: the
    ``ccs_tune_profile_applied`` gauge carries its id as a label, and
    obs/ledger.py stamps every record's ``tuned_profile`` field via
    :func:`ledger_tag` (``"none"`` when running on defaults), so any
    ledger record is traceable to the exact knob set.

Knob *reads* (:func:`knob_int` etc.) are dict lookups on module state --
cheap enough for per-batch call sites like
``models/arrow/params.effective_band_width``.  This module stays
import-light: params.py imports it at module load, and a ledger append
must never create a CUDA context (fingerprinting only happens inside
the opt-in :func:`configure`).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any

_lock = threading.Lock()
# the active profile (a tune.profile.HostProfile) and how it got here
_state: dict[str, Any] = {"profile": None, "source": None}


def _default_profile_dir() -> str:
    env = os.environ.get("PBCCS_TUNE_PROFILE_DIR")
    if env:
        return env
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo_root, "profiles")


def configure(spec: str | None, logger=None, device=None) -> bool:
    """Resolve and apply a host profile; returns True when one applied.

    ``spec`` is the --tuneProfile value: a path, ``"auto"``, or None
    (consult PBCCS_TUNE_PROFILE; unset/empty/"off" means defaults).
    Every degradation path logs a note and leaves the process on the
    hand-tuned constants -- configure never raises on bad input.
    ``device`` is the device the process runs on (None: the card), whose
    fingerprint a profile must match."""
    if spec is None:
        spec = os.environ.get("PBCCS_TUNE_PROFILE") or None
    if spec is None or spec.strip().lower() in ("", "off", "none"):
        return False

    from pbccs_tpu_torch.tune import profile as profile_mod

    def _note(msg: str) -> None:
        if logger is not None:
            logger.notice(f"tune: {msg}")

    try:
        host_fp = profile_mod.host_fingerprint(device)
    except Exception as e:  # noqa: BLE001 -- fail-open by contract
        _note(f"cannot fingerprint this host ({e}); running on "
              "hand-tuned defaults")
        return False

    if spec.strip().lower() == "auto":
        prof, notes = profile_mod.discover_profile(
            _default_profile_dir(), host_fp)
        for n in notes:
            _note(n)
        if prof is None:
            return False
    else:
        prof, note = profile_mod.load_profile(spec)
        if prof is None:
            _note(f"{note}; running on hand-tuned defaults")
            return False
        mismatch = profile_mod.fingerprint_mismatch(
            prof.fingerprint, host_fp)
        if mismatch is not None:
            _note(f"profile {spec} not applied: {mismatch}; running "
                  "on hand-tuned defaults")
            return False

    with _lock:
        _state["profile"] = prof
        _state["source"] = spec
    from pbccs_tpu_torch.obs.metrics import default_registry

    registry = default_registry()
    registry.gauge(
        "ccs_tune_profile_applied",
        "1 when a ccs-tune host profile is active (label = profile id)",
        profile=prof.profile_id).set(1)
    if logger is not None:
        logger.info(f"tune: applied host profile {prof.profile_id} "
                    f"({spec}): knobs {sorted(prof.knobs)}")
    return True


def reset() -> None:
    """Drop the active profile (tests)."""
    with _lock:
        _state["profile"] = None
        _state["source"] = None


@contextlib.contextmanager
def scope():
    """Put back the process's active profile when the enclosed run ends,
    so an in-process `ccs` run's --tuneProfile does not outlive it."""
    with _lock:
        saved = dict(_state)
    try:
        yield
    finally:
        with _lock:
            _state.update(saved)


def active_profile():
    """The applied tune.profile.HostProfile, or None on defaults."""
    return _state["profile"]


def ledger_tag() -> str:
    """What every perf-ledger record's ``tuned_profile`` field carries:
    the applied profile id, or ``"none"`` on hand-tuned defaults."""
    prof = _state["profile"]
    return prof.profile_id if prof is not None else "none"


def knob(name: str) -> Any:
    """Raw profile knob value, or None (no profile / knob absent)."""
    prof = _state["profile"]
    if prof is None:
        return None
    return prof.knobs.get(name)


def knob_int(name: str) -> int | None:
    v = knob(name)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return int(v)


def knob_float(name: str) -> float | None:
    v = knob(name)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def knob_str_list(name: str) -> list[str] | None:
    v = knob(name)
    if isinstance(v, list) and v and all(isinstance(s, str) for s in v):
        return list(v)
    return None
