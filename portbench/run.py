#!/usr/bin/env python3
"""One run of one benchmark cell of pbccs_tpu_torch's batch polish.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout, on a machine with the CUDA cards the
cell asks for.  The cell (an entry of BENCHMARK.json's `workloads`)
names a configuration, portbench/configs/<config>.json, and a traffic
mix, portbench/traffic/<mix>.json; its correctness limits are
portbench/limits/<config>.json and each per-layer metric is read by
portbench/metrics/<metric>.py.

- Set-up (setup_s, from the start of the process): torch and the card;
  K1 and K3 loaded from a fixed build cache in the checkout
  (build/portbench/kernels, the port's --compileCache route) and the
  native POA library built there; the cell's pool of simulated ZMWs
  drawn from the seed; the pool drafted through the port's
  pipeline.prepare_batch on a few threads; one batch polished to warm
  every shape up.
- Window: batches of the traffic's Z prepared ZMWs, cycling the pool,
  through pipeline.polish_prepared_batch back to back until `--seconds`
  have passed (the batch in flight finishes).  With `--trace 1` the
  window is the traffic's `trace_batches` batches under torch.profiler,
  with the program's spans on and K1 and K3 wrapped to record their
  shapes.
- After it: one check batch at the cell's Z over a pool whose content
  the seed draws (the window's pool is the traffic's, in the seed's
  order); the outcomes of the window and of the check batch judged
  against the plain reference (judge.py, arrow_ref.py), and the
  window's consensus against the truths (edit_qv.py); then the result
  line.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the compared
numbers with their limits under "checks"); the last lines of standard
error give the same numbers.  Exits non-zero without printing a result
when there is no CUDA card or too few, or when JAX or the JAX package
was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import concurrent.futures  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import bench_sim  # noqa: E402
import edit_qv  # noqa: E402
import judge  # noqa: E402

#: top-level modules no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "pbccs_tpu")
#: threads that draft the pool in set-up (the native POA drops the GIL)
DRAFT_THREADS = 4
#: fixed cache directories inside the checkout
BUILD = os.path.join(ROOT, "build", "portbench")


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic,
    limits and metric lists, all found by name."""

    def __init__(self, name: str, root: str = ROOT):
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            bench = json.load(fh)
        wl = [w for w in bench["workloads"] if w["name"] == name]
        if not wl:
            raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")
        self.name, self.workload = name, wl[0]
        self.base = base = os.path.join(root, "portbench")
        self.config = _json(base, "configs", self.workload["config"])
        self.traffic = _json(base, "traffic", self.workload["traffic"])
        self.limits = _json(base, "limits", self.workload["config"])
        self.chips = int(self.workload["chips"])

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def _json(base, kind, name):
    with open(os.path.join(base, kind, f"{name}.json")) as fh:
        return json.load(fh)


def forbidden_modules() -> list[str]:
    """The forbidden top-level modules this process holds, by whole
    top-level name (pbccs_tpu_torch is not pbccs_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def prepare_env() -> None:
    """No PBCCS_* switch may change what the program computes, and every
    cache the program or torch keeps lies at a fixed path inside the
    checkout."""
    for k in [k for k in os.environ if k.startswith("PBCCS_")]:
        print(f"run.py: ignoring {k}", file=sys.stderr)
        del os.environ[k]
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "extensions")
    os.environ["USE_FLAX"] = "0"


class Program:
    """The system under test: pbccs_tpu_torch's modules the run drives."""

    def __init__(self, device):
        if ROOT not in sys.path:
            sys.path.insert(0, ROOT)
        imp = importlib.import_module
        self.pipeline = imp("pbccs_tpu_torch.pipeline")
        self.cache = imp("pbccs_tpu_torch.runtime.cache")
        self.cuda_lib = imp("pbccs_tpu_torch.ops.cuda_lib")
        self.native = imp("pbccs_tpu_torch.native")
        self.metrics = imp("pbccs_tpu_torch.obs.metrics")
        self.trace = imp("pbccs_tpu_torch.obs.trace")
        self.fwdbwd_cuda = imp("pbccs_tpu_torch.ops.fwdbwd_cuda")
        self.dense_score_cuda = imp("pbccs_tpu_torch.ops.dense_score_cuda")
        self.cache.enable_compilation_cache(os.path.join(BUILD, "kernels"))
        if device.type == "cuda":
            self.cuda_lib.load_all(["arrow_fill", "dense_score"])
        self.native._load()

    def settings(self, cfg: dict):
        kw = {k: (float(v) if k == "min_zscore" else v)
              for k, v in cfg["settings"].items()}
        return self.pipeline.ConsensusSettings(**kw)

    def chunks(self, pool):
        p = self.pipeline
        return [p.Chunk(z.id, [p.Subread(f"{z.id}/{i}", r)
                               for i, r in enumerate(z.reads)], z.snr)
                for z in pool]


def open_device(chips: int, allow_cpu: bool = False):
    import torch

    if allow_cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA device(s), the "
                     f"cell needs {chips}")
    return torch.device("cuda", 0)


class NoCard(RuntimeError):
    pass


def draft(prog: Program, pool, settings):
    """The pool through the port's filter -> POA -> mapping, on a few
    threads; returns the prepared ZMWs with their pool indices, in pool
    order."""
    chunks = prog.chunks(pool)
    step = -(-len(chunks) // DRAFT_THREADS)
    parts = [chunks[i:i + step] for i in range(0, len(chunks), step)]
    with concurrent.futures.ThreadPoolExecutor(len(parts)) as ex:
        done = list(ex.map(lambda c: prog.pipeline.prepare_batch(c, settings),
                           parts))
    index = {z.id: i for i, z in enumerate(pool)}
    return [(index[p.chunk.id], p) for _, preps in done for p in preps]


def batches_of(prepared, z: int):
    """The window's batch sequence: batch b holds the next z prepared
    ZMWs of the pool, cycling."""
    n = len(prepared)
    b = 0
    while True:
        yield [prepared[(b * z + i) % n] for i in range(min(z, n))]
        b += 1


def records(batch, out) -> list:
    """(pool index, status, id, sequence, QVs) of each ZMW dispatched, the
    status judge.MISSING where the polish returned no outcome."""
    rec = []
    for (zi, _), (failure, res) in zip(batch, out):
        if res is None:
            rec.append((zi, failure.value, None, "", []))
        else:
            rec.append((zi, failure.value, res.id, res.sequence, res.qvs))
    rec += [(zi, judge.MISSING, None, "", []) for zi, _ in batch[len(rec):]]
    return rec


def setup(cell: Cell, seed: int, device):
    """Everything before the window: returns (program, settings, pool,
    batch iterator)."""
    import torch

    prog = Program(device)
    settings = prog.settings(cell.config)
    pool = bench_sim.make_pool(cell.config, int(cell.traffic["pool"]), seed,
                               int(cell.traffic["content_seed"]))
    prepared = draft(prog, pool, settings)
    if not prepared:
        raise RuntimeError("no ZMW of the pool survived the draft")
    batches = batches_of(prepared, int(cell.traffic["batch"]))
    warm = next(batches)
    prog.pipeline.polish_prepared_batch([p for _, p in warm], settings,
                                        device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return prog, settings, pool, batches


def window(prog, settings, batches, device, seconds: float, n_batches=None,
           polish=None):
    """Polish batches back to back until `seconds` have passed or
    `n_batches` are done; returns (per-batch records, seconds)."""
    import torch

    polish = polish or prog.pipeline.polish_prepared_batch
    out, t0 = [], time.perf_counter()
    while True:
        batch = next(batches)
        res = polish([p for _, p in batch], settings, device=device)
        out.append(records(batch, res))
        if n_batches is not None:
            if len(out) >= n_batches:
                break
        elif time.perf_counter() - t0 >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def traced_window(prog, settings, batches, device, n_batches, polish=None):
    """The traced window: returns (records, seconds, devtrace.Reading)."""
    import torch

    import devtrace

    scope = prog.metrics.default_registry().scope()
    tracer = prog.trace.Tracer()
    prog.trace.set_tracer(tracer)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        with devtrace.LaunchRecorder(prog.fwdbwd_cuda,
                                     prog.dense_score_cuda) as rec, \
                torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(devtrace.WINDOW):
                out, secs = window(prog, settings, batches, device, 0.0,
                                   n_batches, polish)
    finally:
        prog.trace.set_tracer(None)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    kernels, host, t0, t1 = [], [], None, None
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, *rng))
        else:
            host.append((e.name, *rng))
            if e.name == devtrace.WINDOW:
                t0, t1 = rng
    counters = {k: v for k, v in scope.delta().items()
                if isinstance(v, float)}
    spans = [(s.name, s.duration_s, dict(s.args))
             for s in tracer.finished_spans() if not s.open]
    reading = devtrace.Reading(kernels, host, t0, t1, spans, counters,
                               rec.resolved(), sum(len(b) for b in out),
                               peak)
    return out, secs, reading


def check_batch(prog, settings, cell: Cell, seed: int, device, polish=None):
    """One batch of the timed polish over a pool whose content the seed
    draws (bench_sim.check_pool), at the cell's Z, after the window:
    returns ([its records], its pool)."""
    prepared, pool = check_prepared(prog, settings, cell, seed)
    out, _ = window(prog, settings, batches_of(prepared,
                                               int(cell.traffic["batch"])),
                    device, 0.0, 1, polish)
    return out, pool


def check_prepared(prog, settings, cell: Cell, seed: int):
    """The check batch's pool, drawn from the seed, and its ZMWs drafted:
    returns (prepared, pool)."""
    pool = bench_sim.check_pool(cell.config, int(cell.traffic["batch"]),
                                seed)
    return draft(prog, pool, settings), pool


def judged(cell: Cell, seed: int, device, sets, **kw) -> dict:
    """The numbers judge.py compares, over each (batches, pool) of `sets`
    and merged; `kw` goes to judge.sample_numbers."""
    numbers = None
    for batches, pool in sets:
        nums = judge.outcome_numbers(batches, pool)
        sample = [batches[b][k] for b, k in judge.draw_sample(
            batches, int(cell.traffic["check_zmws"]), seed)]
        nums.update(judge.sample_numbers(sample, pool, cell.config, device,
                                         **kw))
        numbers = nums if numbers is None else judge.merged(numbers, nums)
    return numbers


def per_layer(cell: Cell, reading) -> dict:
    """Each per-layer metric of the cell from its reader,
    metrics/<name>.py; a reader that finds nothing to read returns None
    and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        path = os.path.join(cell.base, "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(reading)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def consensus_qv(batches, pool) -> float:
    """-10 log10 of the edits per truth base over the window's distinct
    emitted reads."""
    seen = {(r[0], r[3]) for b in batches for r in b if r[1] == "Success"}
    errors = bases = 0
    for zi, seq in sorted(seen):
        truth = edit_qv.decode(pool[zi].truth)
        errors += edit_qv.errors_against_truth(seq, truth)
        bases += len(truth)
    return edit_qv.phred(errors, bases)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        allow_cpu: bool = False, polish=None, t_start: float = T_START):
    """One run; returns (result, lines for standard error).  `allow_cpu`
    and `polish` (a stand-in for polish_prepared_batch) are for tests."""
    import torch

    device = open_device(cell.chips, allow_cpu)
    prog, settings, pool, batches = setup(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reading = None
    if trace:
        out, secs, reading = traced_window(
            prog, settings, batches, device,
            int(cell.traffic.get("trace_batches", 1)), polish)
    else:
        out, secs = window(prog, settings, batches, device, seconds,
                           polish=polish)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    lines = [f"card {card_line()}" if device.type == "cuda" else "card cpu"]
    metrics = per_layer(cell, reading) if trace else {}
    t_check = time.perf_counter()
    check, check_zmws = check_batch(prog, settings, cell, seed, device,
                                    polish)
    del prog, batches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = judged(cell, seed, device, [(out, pool), (check, check_zmws)])
    for what, b in (("window", out), ("check batch", check)):
        kinds = collections.Counter(r[1] for x in b for r in x)
        lines.append(f"{what} outcomes {dict(sorted(kinds.items()))}")
    lines.append(f"check batch and reference "
                 f"{time.perf_counter() - t_check:.3f} s")
    correct, checks = judge.verdict(numbers, cell.limits)
    attempted = sum(len(b) for b in out)
    success = sum(r[1] == "Success" for b in out for r in b)
    if not trace:
        e2e = {"zmws_per_s": attempted / secs,
               "yield_pct": 100.0 * success / max(attempted, 1),
               "consensus_qv": consensus_qv(out, pool),
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": int(numbers["bad_outcomes"]), "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = reading.busy_s
        dev["window_s"] = reading.window_s
        result["breakdown"] = reading.breakdown()
    lines.append(f"window {secs:.3f} s, {len(out)} batches, {attempted} "
                 f"ZMWs, {success} Success; set-up {setup_s:.3f} s")
    lines += checks
    result["checks"] = {k: {"value": numbers[k],
                            "limit": float(cell.limits[k])}
                        for k in judge.NUMBERS}
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env()
    cell = Cell(args.workload)
    try:
        result, lines = run(cell, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"run.py: {e}; the benchmark measures the card only",
              file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"run.py: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    for ln in lines:
        print(ln, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
