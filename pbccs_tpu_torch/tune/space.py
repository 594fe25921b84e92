"""The declared knob space `ccs tune` searches (port of
pbccs_tpu.tune.space).

``KNOB_TARGETS`` is the canonical inventory -- knob name -> how the
resolution ladder applies it (env var, CLI flag, or a warmup menu) --
with pbccs_tpu's names, so profiles round-trip between the packages'
schemas (though a profile applies only on its own fingerprint).

Each swept knob also declares which perf-ledger fields its variation
LEGITIMATELY changes (``affects``): the referee (tools/perf_gate.py of
the port) exempts exactly those fields when comparing a tuned candidate
against the defaults run, while any OTHER counter drift still
disqualifies it.

Where the port differs by design: the ``band_w`` grid holds the widths
the kernels are built for (ops/fwdbwd_cuda.K1_WIDTHS; pbccs_tpu's 48 and
80 are widths K1 and K3 refuse with LaunchRefused), and a width changes
the roofline work the ledger charges, not the builds; ``dense_cb`` is
the Pallas dense kernel's blocking, which nothing in the port reads, so
it stays in KNOB_TARGETS (profiles carry it) but leaves the sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# knob name -> the surface the loader resolves it through.  Kept as a
# flat literal dict so the REG012 AST collector (analysis/registry.py)
# can read it without importing the package.
KNOB_TARGETS = {
    "band_w": "env:PBCCS_BAND_W",
    "dense_cb": "env:PBCCS_DENSE_CB",
    "prepare_workers": "flag:--prepareWorkers",
    "mem_budget_bytes": "flag:--memBudget",
    "serve_max_batch": "flag:--maxBatch",
    "serve_max_wait_ms": "flag:--maxWaitMs",
    "router_spill_depth": "flag:--routerSpillDepth",
    "warmup_buckets": "menu:ccs warmup --bucket",
}


@dataclasses.dataclass(frozen=True)
class Knob:
    """One swept knob: where it applies and what to try."""

    name: str
    #: "env" (exported into the candidate subprocess), "cli" (appended
    #: to the candidate's `ccs` argv), or "profile" (not swept by the
    #: batch driver -- written into the profile via --set / serve leg)
    apply: str
    #: env var name or flag name (matches KNOB_TARGETS)
    target: str
    #: candidate values the screening phase tries (defaults run is the
    #: implicit extra candidate)
    candidates: tuple[Any, ...]
    #: ledger fields this knob legitimately perturbs -- exempted from
    #: the perf_gate referee for candidates that set it
    affects: tuple[str, ...] = ()
    description: str = ""


# The batch-leg sweep space.  Candidate grids are deliberately small:
# the screening phase is per-knob (coarse), the refine phase joins the
# survivors, and --candidates on `ccs tune` overrides any grid.
BATCH_KNOBS = (
    Knob("band_w", "env", "PBCCS_BAND_W", (64, 96, 128),
         # a different band width changes per-column band work, so the
         # roofline charge moves; byte-identity on the calibration
         # workload is the accept gate, these fields the expected
         # side-effects
         affects=("roofline_flops", "roofline_bytes"),
         description="banded-DP rows per column "
                     "(models/arrow/params.effective_band_width; widths "
                     "the kernels are built for)"),
    Knob("prepare_workers", "cli", "--prepareWorkers", (1, 2, 4),
         description="host prepare (POA draft) threads overlapping "
                     "device polishes (fleet driver, --devices != 1)"),
    Knob("mem_budget_bytes", "cli", "--memBudget", (1 << 28, 1 << 31),
         affects=("budget_throttles",),
         description="prepared-batch backlog byte budget; throttling "
                     "is its intended effect, not a regression"),
)

# Serve-leg knobs (swept only with `ccs tune --serveLeg`, which drives a
# real `ccs serve` subprocess per candidate); router_spill_depth and
# warmup_buckets are profile-carried, not swept.
SERVE_KNOBS = (
    Knob("serve_max_batch", "profile", "--maxBatch", (8, 16, 32),
         description="serve bucket fill-flush size (ZMWs per batch)"),
    Knob("serve_max_wait_ms", "profile", "--maxWaitMs",
         (100.0, 250.0),
         description="max ms a request waits to be batched"),
)

PROFILE_ONLY_KNOBS = ("router_spill_depth", "warmup_buckets")


def knob_by_name(name: str) -> Knob | None:
    for k in (*BATCH_KNOBS, *SERVE_KNOBS):
        if k.name == name:
            return k
    return None


def batch_space(names: list[str] | None = None,
                overrides: dict[str, tuple] | None = None) -> list[Knob]:
    """The knobs one `ccs tune` batch run sweeps: the default grid,
    optionally restricted to ``names`` and/or with candidate grids
    replaced by ``overrides`` (the --knobs / --candidates flags)."""
    overrides = overrides or {}
    out = []
    for k in BATCH_KNOBS:
        if names is not None and k.name not in names:
            continue
        if k.name in overrides:
            k = dataclasses.replace(
                k, candidates=tuple(overrides[k.name]))
        out.append(k)
    return out


def candidate_invocation(assignment: dict[str, Any]
                         ) -> tuple[list[str], dict[str, str]]:
    """(extra argv, extra env) that applies ``assignment`` to one
    calibration `ccs` subprocess.  Unknown knob names raise -- the
    journal must never cache a result under a key the loader cannot
    honor."""
    argv: list[str] = []
    env: dict[str, str] = {}
    for name, value in sorted(assignment.items()):
        k = knob_by_name(name)
        if k is None or k.apply == "profile":
            raise ValueError(f"knob {name!r} is not batch-sweepable")
        if k.apply == "env":
            env[k.target] = str(value)
        else:
            argv += [k.target, str(value)]
    return argv, env


def affected_fields(assignment: dict[str, Any]) -> set[str]:
    """Union of ledger fields the assignment's knobs declare as their
    legitimate side-effects (the referee's exemption set)."""
    out: set[str] = set()
    for name in assignment:
        k = knob_by_name(name)
        if k is not None:
            out.update(k.affects)
    return out
