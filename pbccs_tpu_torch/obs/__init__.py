"""Observability of the port: metrics, trace spans, profiling hooks, the
perf ledger, the flight recorder and the roofline plane.

Ports of pbccs_tpu.obs's modules, host-side and with the same metric,
span and ledger field names:

  * obs.metrics -- a thread-safe MetricsRegistry (counters, gauges,
    histograms with fixed log-scale buckets) with Prometheus text
    exposition, MeasurementScope windows and the end-of-run summary
    table the CLI prints;
  * obs.trace -- per-ZMW span trees (filter -> draft -> polish ->
    emit) with wall vs device-wait attribution, exported as
    Chrome-trace/Perfetto JSON (`--trace-out`);
  * obs.profiling -- the opt-in torch.profiler capture
    (`--profile-dir`);
  * obs.ledger -- the schema-versioned NDJSON per-run record
    (`--perfLedger`) that tools/perf_gate.py reads;
  * obs.flight -- the refine loop's per-round flight recorder, dumped
    on a quarantine and on a memory-governor ceiling;
  * obs.roofline -- kernel work counted from the shapes, per-bucket
    cost cards, charging and efficiency gauges (`ccs roofline`);
  * obs.httpexp -- the HTTP /metrics and /healthz endpoint of `ccs
    serve` (`--metricsPort`).

Not ported yet (they serve the router tier): the fleet console and the
metrics federation helpers.
"""
