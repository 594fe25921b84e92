"""Device cost model and roofline attribution plane.

Port of pbccs_tpu.obs.roofline, redesigned for the card.  The JAX
package reads a bucket's cost bound from XLA (`cost_analysis()` /
`memory_analysis()` of its compiled canonical program); PyTorch has no
such analysis, so here a card is COUNTED FROM THE SHAPES: the work the
hand-written kernels of the same canonical program must do, whatever
implements them.

  * Work counts -- `k1_work`, `k3_work` and `k2_work` count one launch
    of K1 (csrc/arrow_fill.cu), K3 (csrc/dense_score.cu) and K2
    (csrc/quiver_fill.cu) as (bytes, integer ops, float32 ops): each
    input read once and each output written once, and per lane the
    operations the function needs, by type (the integer counts come from
    the kernel bodies; see K1_INT_OPS, K3_INT_OPS, K2_INT_OPS).
    `bound_seconds` turns a count into the least time the card could
    take.  chip_smoke.py's kernel table takes its bounds from here, so
    one count serves the table and the cards.
  * CostCard -- per shape bucket, the work of one execution of the
    canonical program, parallel.batch._batch_setup at the polisher's
    shapes: one fused K1 launch over the Z*R reads at (Imax, Jmax, W),
    or with guided passes (models.arrow.scorer.guided_fill_passes) one
    forward launch per pass plus the first and one backward launch.
    The torch glue around the fills is not counted.  Cards carry no
    timestamps, so the file is byte-deterministic for a shape set; they
    persist at PBCCS_ROOFLINE_CARDS, else build/roofline_cards.json.
  * Charging -- every execution of the canonical program
    (BatchPolisher._setup) charges card.flops * Z // card.z to
    per-bucket counters (integer math: deterministic), and refine-level
    and dispatch-level scopes attribute wall and device-wait seconds.
  * Gauges -- achieved TFLOP/s, efficiency against the card's peak and
    kernel_fraction per bucket plus overall aggregates, in the obs
    registry under pbccs_tpu's names, in the perf ledger (roofline_*
    fields, obs/ledger.py) and in the `ccs roofline` report below.

Degradation contract: a card failure leaves the bucket without a card
and never raises on the polish path.  PBCCS_ROOFLINE=0 disables the
whole plane.

Achieved TFLOP/s is flops-charged / refine WALL seconds -- a lower bound
on the device's rate; kernel_fraction (device wait / wall) says how much
of the gap is host overhead.  Efficiency divides by the float32 peak of
the card the polish ran on (SMs x 128 operations per clock x 1.98 GHz on
an sm_90 card; PBCCS_ROOFLINE_PEAK_TFLOPS overrides), or by a nominal
0.1 TFLOP/s on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from dataclasses import asdict, dataclass

import torch

from pbccs_tpu_torch.obs import metrics as _metrics

ROOFLINE_SCHEMA_VERSION = 1
CARDS_BASENAME = "roofline_cards.json"
_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CARDS_PATH = os.path.join(_REPO_DIR, "build", CARDS_BASENAME)

# ---------------------------------------------------------------- the card

#: published peak of one H100 SXM (NVIDIA H100 data sheet): HBM bytes/s
PEAK_BYTES = 3.35e12
#: its SMs and the data sheet's boost clock
H100_SMS = 132
SM_CLOCK_HZ = 1.98e9
#: results per clock per SM of compute capability 9.0 (CUDA C++
#: Programming Guide, throughput of native arithmetic instructions):
#: float32 adds or multiplies (the kernels build with -fmad=false, so
#: each is one instruction; the data sheet's 67 TFLOP/s counts a fused
#: multiply-add as two), and 32-bit integer adds, compares, min/max and
#: logic operations (selects counted with them)
F32_OPS_PER_CLOCK = 128
INT_OPS_PER_CLOCK = 64
SM_CLOCKS = H100_SMS * SM_CLOCK_HZ
RATE_F32_OP = F32_OPS_PER_CLOCK * SM_CLOCKS
RATE_INT_OP = INT_OPS_PER_CLOCK * SM_CLOCKS
#: efficiency denominator off the card: a nominal single CPU core
CPU_PEAK_TFLOPS = 0.1

#: per lane and column of csrc/arrow_fill.cu, its integer, compare,
#: select and logic operations, counted in the kernel body per held slot
#: (forward, backward): the valid row 3, the emission and insertion
#: selects 4, the match factor 2 / 5, the match gate (source row and
#: band test) 6, the deletion gate 5, the insertion gate and scan cut 5,
#: the dead / pinned-column selects 3, the seed-lane test 2 and the
#: output select 1.  The layout's shuffles, roll selects and read-base
#: reload tests are not counted.
K1_INT_OPS = {False: 31, True: 34}
#: per lane and position of csrc/dense_score.cu, the integer, compare,
#: select and logic operations the function needs, counted in the kernel
#: body per held slot: the band rows of columns p-1, p, p+1 (3 x 4); the
#: read codes of the one new column (its band row 4, range tests and
#: selects 6); the first columns (the shared one's operand band tests and
#: selects 8, emission 2, ext_b's gates 8, insertion mask 5, per base its
#: test and selects 3 x 4; the deletion's 26); the second columns' b
#: terms (shared band tests 6, per base operand selects, emission and
#: gates 12 x 4; the deletion's 26) and insertion coefficients (mask 5,
#: 8 x 3); the three link operand pairs (3 x 12).  What only this
#: kernel's layout needs is not counted: the shuffles and roll selects,
#: the packing of three columns' read codes into one register, its slide
#: and the codes' extraction (15 more), and the output lane select.
K3_INT_OPS = 12 + 10 + 61 + 80 + 29 + 36
#: template positions per K3 block (ops.dense_score_cuda.PB)
K3_BLOCK = 64
#: per lane and column of csrc/quiver_fill.cu, its integer, compare,
#: select and logic operations, counted in the kernel body per held slot:
#: the operand build (valid row 3, source row 1, step and scan-cut tests
#: 2, Incorporate 2, tagged Delete 4, Extra 3, Merge 6, the four
#: band-gated operand selects 7 + 6 + 7 + 4), the seed-lane and
#: final-cell tests and the output select (3).  The layout's shuffles,
#: roll selects and table-row reload tests are not counted.
K2_INT_OPS = 45 + 3
#: columns of K2's per-read-position move-score tables
#: (ops.quiver_fill_cuda.N_COLS)
K2_TABLE_COLS = 12


def _scan_steps(width: int) -> int:
    return math.ceil(math.log2(width))


def k1_work(R: int, Imax: int, Jmax: int, W: int,
            dirs=(False, True)) -> tuple[int, int, int]:
    """(bytes, integer ops, float32 ops) of one K1 launch over R reads
    (Imax read columns, Jmax template columns, band width W) in the
    directions `dirs` (False forward, True backward): each input read
    once (reads, template windows, transitions, lengths, band offsets),
    each output written once (band values and log-scales per direction);
    per lane of every column K1_INT_OPS and 6 + 3 ceil(log2 W) float32
    operations (the emission product, the match and deletion products
    and their sum, 3 per scan step, the column max, the scaling
    divide)."""
    nc = Jmax + 1
    n_bytes = (R * Imax + R * Jmax + 16 * R * Jmax + 4 * (2 * R + R * nc)
               + 4 * len(dirs) * (R * nc * W + R * nc))
    cells = R * nc * W
    n_int = cells * sum(K1_INT_OPS[d] for d in dirs)
    n_f32 = cells * len(dirs) * (6 + 3 * _scan_steps(W))
    return n_bytes, n_int, n_f32


def k3_work(R: int, nc: int, Imax: int, Jm: int, W: int,
            positions: int | None = None,
            blocks: int | None = None) -> tuple[int, int, int]:
    """(bytes, integer ops, float32 ops) of K3 over `positions` scored
    (read, position) cells in `blocks` live (read, 64-position) blocks
    (default all R x Jm in all blocks): each input read once -- the alpha
    and beta columns of the scored positions (a block's positions and two
    columns more of each), band offsets, scale prefix and suffix, reads,
    window templates and transitions, tables, lengths and live flags --
    and the (R, Jm, 9) scores written once; per lane of every scored
    position K3_INT_OPS and 71 + 42 ceil(log2 W) float32 operations
    (ext_b's 4 per first and second column, 8 + 20; 3 per scan step of
    the 14 scans less the unread last c product; the three link operand
    products; the nine links' 4 products, sum and band-sum add; stick / 3
    is divided once per table row and window row, not per lane)."""
    NB = -(-Jm // K3_BLOCK)
    n = R * Jm if positions is None else positions
    blocks = R * NB if blocks is None else blocks
    n_bytes = (4 * (2 * W * min(n + 2 * blocks, R * nc) + R * nc
                    + 2 * R * (nc + 1) + 2 * R + R * NB + 9 * R * Jm)
               + R * Imax + R * Jm + 16 * R * Jm + 128 * R)
    n_int = n * W * K3_INT_OPS
    n_f32 = n * W * (71 + 42 * _scan_steps(W))
    return n_bytes, n_int, n_f32


def k2_work(R: int, M: int, Jmax: int, W: int, n_tables: int, P: int,
            cols: int, vals: bool) -> tuple[int, int, int]:
    """(bytes, integer ops, float32 ops) of one K2 launch over R rows
    (read, window) against M windows of Jmax columns at band width W:
    each input read once (the n_tables per-read tables of P positions
    the rows name, read lengths, windows, window lengths, row indices,
    band offsets), each output written once (band values in the
    band-value mode, log-scales, final cells); per lane of every column
    run (`cols`: all R x (Jmax + 1) in the band-value mode, J + 1 per row
    in the log-likelihood-only mode) K2_INT_OPS and the float32
    operations (the Incorporate/Delete products and sum 3, the Merge
    quotient, product and sum 3, 3 per scan step, the column max and the
    scaling divide 2)."""
    nc = Jmax + 1
    n_bytes = (4 * (R * nc * W * vals + 2 * R * nc + R + 2 * R
                    + n_tables * P * K2_TABLE_COLS + n_tables + M)
               + M * Jmax)
    n_int = cols * W * K2_INT_OPS
    n_f32 = cols * W * (3 + 3 + 3 * _scan_steps(W) + 2)
    return n_bytes, n_int, n_f32


def bound_seconds(n_bytes: float, n_int: float,
                  n_f32: float) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations") of a work count on the
    card: bytes at PEAK_BYTES against the operations, whose integer and
    float32 pipes issue side by side (the longer of their two times)."""
    t_b = n_bytes / PEAK_BYTES
    t_o = max(n_int / RATE_INT_OP, n_f32 / RATE_F32_OP)
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def setup_work(*, imax: int, jmax: int, r: int, z: int, width: int,
               guided_passes: int) -> tuple[int, int, int]:
    """(bytes, integer ops, float32 ops) of the fills of one
    parallel.batch._batch_setup at these shapes: one fused K1 launch over
    the Z*R reads, or with guided passes a forward launch per pass plus
    the first and one backward launch (scorer.fill_alpha_beta_batch)."""
    R = int(z) * int(r)
    if not guided_passes:
        return k1_work(R, imax, jmax, width, (False, True))
    fwd = k1_work(R, imax, jmax, width, (False,))
    bwd = k1_work(R, imax, jmax, width, (True,))
    return tuple((1 + int(guided_passes)) * f + b for f, b in zip(fwd, bwd))


def setup_peak_bytes(*, imax: int, jmax: int, r: int, z: int,
                     width: int) -> int:
    """Bytes the setup's inputs and both band planes hold, counted from
    the shapes (not read from the allocator): templates (Z, Jmax) int8,
    template lengths (Z,) int32, the read planes (Z, R) int32 (lengths,
    strands, starts, ends), tables (Z, 8, 4) float32, reads (Z, R, Imax)
    int8; per direction the band values (Z*R, nc, W) and log-scales
    (Z*R, nc) float32, and the band offsets (Z*R, nc) int32 both
    directions share."""
    z, r, nc = int(z), int(r), int(jmax) + 1
    inputs = z * jmax + 4 * z + 4 * 4 * z * r + 4 * 32 * z + z * r * imax
    planes = 2 * 4 * (z * r * nc * width + z * r * nc) + 4 * z * r * nc
    return inputs + planes


# metric names, pbccs_tpu's
BOUND_FLOPS = "ccs_roofline_bound_flops"
BOUND_BYTES = "ccs_roofline_bound_bytes"
BOUND_INTENSITY = "ccs_roofline_intensity"
FLOPS_TOTAL = "ccs_roofline_flops_total"
BYTES_TOTAL = "ccs_roofline_bytes_total"
REFINE_SECONDS = "ccs_roofline_refine_seconds_total"
DEVICE_SECONDS = "ccs_roofline_device_seconds_total"
DISPATCHES = "ccs_roofline_dispatches_total"
DISPATCH_SECONDS = "ccs_roofline_dispatch_seconds_total"
DISPATCH_DEVICE_SECONDS = "ccs_roofline_dispatch_device_seconds_total"
ACHIEVED_TFLOPS = "ccs_roofline_achieved_tflops"
EFFICIENCY = "ccs_roofline_efficiency"
KERNEL_FRACTION = "ccs_roofline_kernel_fraction"
ACHIEVED_OVERALL = "ccs_roofline_achieved_tflops_overall"
EFFICIENCY_OVERALL = "ccs_roofline_efficiency_overall"


def enabled() -> bool:
    return os.environ.get("PBCCS_ROOFLINE", "1") != "0"


def _sig(v: float) -> float:
    """6 significant figures (NOT decimal places: CPU achieved-TFLOP/s
    values live around 1e-7 and must not round to zero)."""
    return float(f"{v:.6g}") if v else 0.0


def bucket_label(imax: int, jmax: int, r: int) -> str:
    """Human-stable label for a resources.shape_bucket (Z excluded --
    the card normalizes per ZMW slot)."""
    return f"I{int(imax)}xJ{int(jmax)}xR{int(r)}"


def label_from_capacity_bucket(bucket) -> str | None:
    """('shape', imax, jmax, r) -> label, else None."""
    try:
        kind, imax, jmax, r = bucket
    except (TypeError, ValueError):
        return None
    if kind != "shape":
        return None
    return bucket_label(imax, jmax, r)


@dataclass(frozen=True)
class CostCard:
    """Counted cost bound of one canonical bucket program.

    flops (float32 operations), int_ops, bytes_accessed and
    peak_hbm_bytes are for ONE execution of _batch_setup at the card's
    geometry (z slots); charge for a dispatch at Z slots with
    ``flops * Z // z`` (integer: deterministic).  optimal_seconds is the
    count's bound on an H100 (bound_seconds)."""
    label: str
    imax: int
    jmax: int
    r: int
    z: int
    width: int
    flops: int
    int_ops: int
    bytes_accessed: int
    peak_hbm_bytes: int
    intensity: float | None
    optimal_seconds: float | None
    platform: str
    torch_version: str
    schema_version: int = ROOFLINE_SCHEMA_VERSION

    def flops_for(self, z: int) -> int:
        return self.flops * int(z) // max(1, self.z)

    def bytes_for(self, z: int) -> int:
        return self.bytes_accessed * int(z) // max(1, self.z)


def card_from_shapes(*, imax: int, jmax: int, r: int, z: int, width: int,
                     guided_passes: int, platform: str) -> CostCard:
    """The counted card of one bucket (setup_work, setup_peak_bytes)."""
    geo = dict(imax=int(imax), jmax=int(jmax), r=int(r), z=int(z),
               width=int(width))
    n_bytes, n_int, n_f32 = setup_work(guided_passes=guided_passes, **geo)
    seconds, _ = bound_seconds(n_bytes, n_int, n_f32)
    return CostCard(label=bucket_label(imax, jmax, r), **geo,
                    flops=int(n_f32), int_ops=int(n_int),
                    bytes_accessed=int(n_bytes),
                    peak_hbm_bytes=setup_peak_bytes(**geo),
                    intensity=round(n_f32 / n_bytes, 6) if n_bytes else None,
                    optimal_seconds=float(f"{seconds:.6g}"),
                    platform=platform, torch_version=torch.__version__)


def device_platform(device) -> str:
    """The ledger's platform word of a torch device: gpu or cpu."""
    return "gpu" if getattr(device, "type", str(device)) == "cuda" else "cpu"


# ----------------------------------------------------------- persistence

def cards_path() -> str:
    """Where the card cache lives: PBCCS_ROOFLINE_CARDS wins, else
    build/roofline_cards.json at the repository root (git-ignored)."""
    return os.environ.get("PBCCS_ROOFLINE_CARDS") or DEFAULT_CARDS_PATH


def cards_to_doc(cards: dict[str, CostCard]) -> str:
    """Canonical serialized form -- sorted keys, no timestamps, so two
    identical card sets produce byte-identical files."""
    doc = {"schema_version": ROOFLINE_SCHEMA_VERSION,
           "cards": {label: asdict(card)
                     for label, card in sorted(cards.items())}}
    return json.dumps(doc, sort_keys=True, indent=1) + "\n"


def load_cards(path: str) -> dict[str, CostCard]:
    """Best-effort load; unreadable/alien files yield {}."""
    out: dict[str, CostCard] = {}
    try:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("schema_version") != ROOFLINE_SCHEMA_VERSION:
            return {}
        for label, raw in (doc.get("cards") or {}).items():
            try:
                out[label] = CostCard(**raw)
            except TypeError:
                continue
    except Exception:
        return {}
    return out


def save_cards(path: str, cards: dict[str, CostCard]) -> bool:
    """Merge-and-write (atomic).  Swallows IO errors: persistence is an
    optimization, never a polish-path failure."""
    try:
        from pbccs_tpu_torch.resilience.resources import atomic_output
        merged = load_cards(path)
        merged.update(cards)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with atomic_output(path, "roofline_cards") as f:
            f.write(cards_to_doc(merged))
        return True
    except Exception:
        return False


# ------------------------------------------------------------- the plane

class _Bucket:
    """Cumulative per-bucket attribution (process-local)."""

    __slots__ = ("card", "flops", "bytes", "refine_s", "device_s",
                 "dispatches", "dispatch_s", "dispatch_device_s")

    def __init__(self):
        self.card: CostCard | None = None
        self.flops = 0
        self.bytes = 0
        self.refine_s = 0.0
        self.device_s = 0.0
        self.dispatches = 0
        self.dispatch_s = 0.0
        self.dispatch_device_s = 0.0


def _device_peak_tflops(device) -> float:
    """The float32 peak of a torch device: SMs x 128 per clock x 1.98 GHz
    on an sm_90 card, the nominal CPU figure on the CPU, 1.0 otherwise."""
    if device is None or getattr(device, "type", "cpu") != "cuda":
        return CPU_PEAK_TFLOPS
    props = torch.cuda.get_device_properties(device)
    if props.major != 9:
        return 1.0
    return (props.multi_processor_count * F32_OPS_PER_CLOCK
            * SM_CLOCK_HZ / 1e12)


class RooflineTracker:
    """Process-wide card store + charge/measure surface behind the
    module-level helpers.  All mutation under one lock; the hot charge
    path is a dict hit + a few adds."""

    def __init__(self, registry: _metrics.MetricsRegistry | None = None):
        self._registry = registry or _metrics.default_registry()
        self._lock = threading.Lock()
        self._buckets: dict[str, _Bucket] = {}
        self._loaded_from: str | None = None
        self._peaks: dict[str, float] = {}
        self._device = None       # the device of the latest noted bucket

    # -- cards ---------------------------------------------------------

    def _bucket(self, label: str) -> _Bucket:
        b = self._buckets.get(label)
        if b is None:
            b = self._buckets[label] = _Bucket()
        return b

    def register_card(self, card: CostCard, *, persist: bool = True) -> None:
        with self._lock:
            self._bucket(card.label).card = card
        gauge = self._registry.gauge
        gauge(BOUND_FLOPS, "Counted float32 operations of one canonical "
              "bucket program (CostCard bound)",
              bucket=card.label).set(card.flops)
        gauge(BOUND_BYTES, "Counted bytes accessed per canonical bucket "
              "program", bucket=card.label).set(card.bytes_accessed)
        if card.intensity is not None:
            gauge(BOUND_INTENSITY, "Arithmetic intensity (flops/byte) of "
                  "the bucket program",
                  bucket=card.label).set(card.intensity)
        if persist:
            save_cards(cards_path(), {card.label: card})

    def card(self, label: str) -> CostCard | None:
        with self._lock:
            b = self._buckets.get(label)
            return b.card if b else None

    def load_persisted(self) -> int:
        """Pick up cards written by earlier processes -- idempotent,
        best-effort."""
        path = cards_path()
        with self._lock:
            if path == self._loaded_from:
                return 0
            self._loaded_from = path
        cards = load_cards(path)
        for card in cards.values():
            self.register_card(card, persist=False)
        return len(cards)

    def ensure_card(self, *, imax: int, jmax: int, r: int, z: int,
                    width: int, guided_passes: int,
                    device=None) -> CostCard | None:
        """Memoized per-bucket card: disk cards first, else counted from
        the shapes once per process.  Never raises."""
        if not enabled():
            return None
        label = bucket_label(imax, jmax, r)
        with self._lock:
            self._device = device
            b = self._buckets.get(label)
            if b is not None and b.card is not None:
                return b.card
        self.load_persisted()
        with self._lock:
            b = self._buckets.get(label)
            if b is not None and b.card is not None:
                return b.card
        try:
            card = card_from_shapes(
                imax=imax, jmax=jmax, r=r, z=z, width=width,
                guided_passes=guided_passes,
                platform=device_platform(device))
        except Exception:  # noqa: BLE001 -- an absent card, never a raise
            return None
        self.register_card(card)
        return card

    # -- charging ------------------------------------------------------

    def charge_execution(self, *, imax: int, jmax: int, r: int,
                         z: int) -> None:
        """One execution of the canonical program at Z slots: charge the
        bound (integer-scaled from the card)."""
        if not enabled():
            return
        label = bucket_label(imax, jmax, r)
        with self._lock:
            b = self._buckets.get(label)
            card = b.card if b else None
            if card is None:
                return
            flops = card.flops_for(z)
            nbytes = card.bytes_for(z)
            b.flops += flops
            b.bytes += nbytes
        counter = self._registry.counter
        counter(FLOPS_TOTAL, "CostCard-bound flops charged for executed "
                "canonical bucket programs", bucket=label).inc(flops)
        counter(BYTES_TOTAL, "CostCard-bound bytes charged for executed "
                "canonical bucket programs", bucket=label).inc(nbytes)

    @contextlib.contextmanager
    def refine_scope(self, *, imax: int, jmax: int, r: int):
        """Measure one refine pass: wall + device-wait seconds, then
        refresh the per-bucket achieved/efficiency/kernel gauges."""
        if not enabled():
            yield
            return
        from pbccs_tpu_torch.runtime import timing
        label = bucket_label(imax, jmax, r)
        win = timing.window()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            wall = time.perf_counter() - t0
            dev = timing.device_wait_seconds(win)
            with self._lock:
                b = self._bucket(label)
                b.refine_s += wall
                b.device_s += dev
            counter = self._registry.counter
            counter(REFINE_SECONDS, "Wall seconds inside refine passes, "
                    "per bucket", bucket=label).inc(wall)
            counter(DEVICE_SECONDS, "Device-wait seconds attributed to "
                    "refine passes, per bucket", bucket=label).inc(dev)
            self._refresh_gauges(label)

    _dispatch_depth = threading.local()

    @contextlib.contextmanager
    def dispatch_scope(self, label: str | None, *, zmws: int = 0):
        """Per-dispatch device-timing scope (for the scheduler and the
        serving tier).  Reentrancy-guarded: only the OUTERMOST scope
        counts."""
        depth = getattr(self._dispatch_depth, "v", 0)
        if not enabled() or label is None or depth > 0:
            yield
            return
        from pbccs_tpu_torch.runtime import timing
        self._dispatch_depth.v = depth + 1
        win = timing.window()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._dispatch_depth.v = depth
            wall = time.perf_counter() - t0
            dev = timing.device_wait_seconds(win)
            with self._lock:
                b = self._bucket(label)
                b.dispatches += 1
                b.dispatch_s += wall
                b.dispatch_device_s += dev
            counter = self._registry.counter
            counter(DISPATCHES, "Device dispatches measured by the roofline "
                    "plane, per bucket", bucket=label).inc()
            counter(DISPATCH_SECONDS, "Wall seconds inside measured "
                    "dispatches, per bucket", bucket=label).inc(wall)
            counter(DISPATCH_DEVICE_SECONDS, "Device-wait seconds inside "
                    "measured dispatches, per bucket", bucket=label).inc(dev)
            self._refresh_gauges(label)

    # -- derived gauges / reporting -----------------------------------

    def peak_tflops(self, device=None) -> float:
        """The efficiency denominator: PBCCS_ROOFLINE_PEAK_TFLOPS, else
        the float32 peak of `device` (default: the device of the latest
        noted bucket; the CPU before any)."""
        env = os.environ.get("PBCCS_ROOFLINE_PEAK_TFLOPS")
        if env:
            try:
                return float(env)
            except ValueError:
                pass
        with self._lock:
            device = device if device is not None else self._device
            key = str(device)
            peak = self._peaks.get(key)
        if peak is None:
            try:
                peak = _device_peak_tflops(device)
            except Exception:  # noqa: BLE001 -- reporting is best-effort
                peak = CPU_PEAK_TFLOPS
            with self._lock:
                self._peaks[key] = peak
        return peak

    def _refresh_gauges(self, label: str) -> None:
        peak = self.peak_tflops()
        with self._lock:
            b = self._buckets.get(label)
            if b is None:
                return
            achieved = (b.flops / 1e12 / b.refine_s) if b.refine_s > 0 \
                else 0.0
            kfrac = (b.dispatch_device_s / b.dispatch_s) \
                if b.dispatch_s > 0 else (
                    b.device_s / b.refine_s if b.refine_s > 0 else 0.0)
            tot_flops = sum(x.flops for x in self._buckets.values())
            tot_wall = sum(x.refine_s for x in self._buckets.values())
        gauge = self._registry.gauge
        gauge(ACHIEVED_TFLOPS, "Achieved TFLOP/s vs the CostCard bound "
              "(flops charged / refine wall; a lower bound on device "
              "rate)", bucket=label).set(_sig(achieved))
        gauge(EFFICIENCY, "Achieved TFLOP/s over the device's float32 peak",
              bucket=label).set(_sig(achieved / peak) if peak > 0 else 0.0)
        gauge(KERNEL_FRACTION, "Device-wait share of measured wall per "
              "bucket (roofline plane)", bucket=label).set(_sig(kfrac))
        overall = (tot_flops / 1e12 / tot_wall) if tot_wall > 0 else 0.0
        gauge(ACHIEVED_OVERALL, "Achieved TFLOP/s across all buckets "
              "(roofline plane)").set(_sig(overall))
        gauge(EFFICIENCY_OVERALL, "Achieved/peak efficiency across all "
              "buckets (roofline plane)").set(
                  _sig(overall / peak) if peak > 0 else 0.0)

    def status_block(self) -> dict | None:
        """The status verb's `roofline` block; None when the plane has
        nothing to report."""
        peak = self.peak_tflops()
        with self._lock:
            if not self._buckets:
                return None
            buckets = {}
            for label, b in sorted(self._buckets.items()):
                entry: dict = {}
                if b.card is not None:
                    entry.update(flops=b.card.flops,
                                 bytes=b.card.bytes_accessed,
                                 intensity=b.card.intensity,
                                 card_z=b.card.z)
                achieved = (b.flops / 1e12 / b.refine_s) \
                    if b.refine_s > 0 else 0.0
                entry.update(
                    flops_charged=b.flops,
                    refine_s=round(b.refine_s, 4),
                    device_s=round(b.device_s, 4),
                    dispatches=b.dispatches,
                    dispatch_s=round(b.dispatch_s, 4),
                    achieved_tflops=_sig(achieved),
                    efficiency=_sig(achieved / peak) if peak > 0 else 0.0)
                buckets[label] = entry
        return {"schema_version": ROOFLINE_SCHEMA_VERSION,
                "peak_tflops": peak, "buckets": buckets}

    def reset_for_tests(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._loaded_from = None
            self._peaks.clear()
            self._device = None


_tracker = RooflineTracker()


def tracker() -> RooflineTracker:
    return _tracker


# convenience passthroughs used on the polish/dispatch paths
def note_bucket(**kw) -> CostCard | None:
    return _tracker.ensure_card(**kw)


def charge_execution(**kw) -> None:
    _tracker.charge_execution(**kw)


def refine_scope(**kw):
    return _tracker.refine_scope(**kw)


def dispatch_scope(label, **kw):
    return _tracker.dispatch_scope(label, **kw)


# -------------------------------------------------------- ccs roofline

def _rows_from_block(block: dict) -> list[dict]:
    peak = block.get("peak_tflops")
    rows = []
    for label, e in sorted((block.get("buckets") or {}).items()):
        rows.append({"bucket": label, "flops": e.get("flops"),
                     "bytes": e.get("bytes"),
                     "intensity": e.get("intensity"),
                     "dispatches": e.get("dispatches", 0),
                     "refine_s": e.get("refine_s", 0.0),
                     "achieved_tflops": e.get("achieved_tflops", 0.0),
                     "efficiency": e.get("efficiency", 0.0),
                     "peak_tflops": peak})
    return rows


def _rows_from_cards(cards: dict[str, CostCard]) -> list[dict]:
    rows = []
    for label, c in sorted(cards.items()):
        rows.append({"bucket": label, "flops": c.flops,
                     "int_ops": c.int_ops,
                     "bytes": c.bytes_accessed, "intensity": c.intensity,
                     "optimal_seconds": c.optimal_seconds,
                     "card_z": c.z, "width": c.width,
                     "peak_hbm_bytes": c.peak_hbm_bytes,
                     "platform": c.platform,
                     "torch_version": c.torch_version})
    return rows


def _fmt_num(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    if isinstance(v, int) and abs(v) >= 10_000:
        return f"{v:.3e}"
    return str(v)


def render_rows_text(rows: list[dict]) -> str:
    if not rows:
        return "(no roofline data)"
    cols = ["bucket", "flops", "int_ops", "bytes", "intensity",
            "optimal_seconds", "dispatches", "refine_s", "achieved_tflops",
            "efficiency"]
    cols = [c for c in cols if any(c in r for r in rows)]
    table = [[_fmt_num(r.get(c)) for c in cols] for r in rows]
    widths = [max(len(c.upper()), *(len(row[i]) for row in table))
              for i, c in enumerate(cols)]
    out = ["  ".join(c.upper().ljust(w) for c, w in zip(cols, widths))]
    for row in table:
        out.append("  ".join(v.ljust(w) for v, w in zip(row, widths)))
    return "\n".join(out)


def _block_from_ledger(path: str) -> dict | None:
    """Synthesize a report block from the LAST ledger record carrying
    roofline fields (batch runs)."""
    from pbccs_tpu_torch.obs.ledger import read_ledger
    records, _ = read_ledger(path)
    rec = next((r for r in reversed(records)
                if r.get("roofline_flops")), None)
    if rec is None:
        return None
    return {"schema_version": ROOFLINE_SCHEMA_VERSION,
            "peak_tflops": None,
            "buckets": {"(run total)": {
                "flops": rec.get("roofline_flops"),
                "bytes": rec.get("roofline_bytes"),
                "achieved_tflops": rec.get("roofline_achieved_tflops"),
                "efficiency": rec.get("roofline_efficiency"),
                "dispatches": rec.get("polish_dispatches")}}}


def _block_from_target(target: str, timeout: float) -> dict:
    from pbccs_tpu_torch.serve.client import CcsClient
    host, _, port = target.rpartition(":")
    with CcsClient(host or "127.0.0.1", int(port),
                   timeout=timeout) as client:
        status = client.status(timeout=timeout)
    block = status.get("roofline")
    if not block:
        raise SystemExit(
            f"ccs roofline: {target} reports no roofline block (no "
            "polished buckets yet, or PBCCS_ROOFLINE=0 on the replica)")
    return block


def run_roofline(argv: list[str] | None = None) -> int:
    """`ccs roofline`: per-bucket bound/measured/efficiency report for a
    live fleet (--target status verb), a batch run (--ledger), or the
    card cache itself (--cards, default cards_path())."""
    import argparse
    p = argparse.ArgumentParser(
        prog="ccs roofline",
        description="Render the per-bucket roofline table: counted "
                    "CostCard bound, measured refine time, achieved "
                    "TFLOP/s and efficiency against the card's peak.")
    p.add_argument("--target", metavar="HOST:PORT", default=None,
                   help="Live serve/router replica: read the status-verb "
                        "roofline block.")
    p.add_argument("--ledger", metavar="PATH", default=None,
                   help="Perf-ledger NDJSON: summarize the last record "
                        "carrying roofline_* fields (batch runs).")
    p.add_argument("--cards", metavar="PATH", default=None,
                   help="CostCard cache file (default: "
                        "PBCCS_ROOFLINE_CARDS, else "
                        "build/roofline_cards.json).")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--timeout", type=float, default=5.0)
    args = p.parse_args(argv)

    doc: dict = {"schema_version": ROOFLINE_SCHEMA_VERSION}
    if args.target:
        block = _block_from_target(args.target, args.timeout)
        doc.update(source="status", target=args.target, block=block,
                   rows=_rows_from_block(block))
    elif args.ledger:
        block = _block_from_ledger(args.ledger)
        if block is None:
            raise SystemExit(f"ccs roofline: {args.ledger} has no "
                             "record with roofline fields")
        doc.update(source="ledger", ledger=args.ledger, block=block,
                   rows=_rows_from_block(block))
    else:
        path = args.cards or cards_path()
        cards = load_cards(path)
        if not cards:
            raise SystemExit(f"ccs roofline: no cards at {path} (run a "
                             "batch polish first)")
        doc.update(source="cards", cards_path=path,
                   rows=_rows_from_cards(cards))

    if args.format == "json":
        print(json.dumps(doc, sort_keys=True))
    else:
        print(render_rows_text(doc["rows"]))
    return 0
