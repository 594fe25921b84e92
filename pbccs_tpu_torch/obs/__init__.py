"""Observability of the port: metrics, trace spans and profiling hooks.

Ports of pbccs_tpu.obs's metrics, trace and profiling modules, host-side
and with the same metric and span names:

  * obs.metrics -- a thread-safe MetricsRegistry (counters, gauges,
    histograms with fixed log-scale buckets) with Prometheus text
    exposition, MeasurementScope windows and the end-of-run summary
    table the CLI prints;
  * obs.trace -- per-ZMW span trees (filter -> draft -> polish ->
    emit) with wall vs device-wait attribution, exported as
    Chrome-trace/Perfetto JSON (`--trace-out`);
  * obs.profiling -- the opt-in torch.profiler capture
    (`--profile-dir`).

Not ported yet: the perf ledger, the flight recorder, the HTTP scrape
endpoint, the fleet console, the roofline report and the metrics
federation helpers.
"""
