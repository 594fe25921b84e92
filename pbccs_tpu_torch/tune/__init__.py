"""`ccs tune` of the port: the autotuner's batch leg (port of
pbccs_tpu.tune).

  space.py      the declared knob inventory and candidate grids;
  profile.py    the schema-versioned host profile: knobs keyed by a
                hardware fingerprint (platform, device kind, device
                count, torch version), atomically published, loaded
                corrupt-tolerantly;
  objective.py  perf-ledger rows -> one Measurement (ZMW/s primary,
                padding_waste / peak RSS tie-breakers);
  driver.py     the search: a fixed calibration workload per candidate
                in a fresh `ccs` subprocess, byte-identity vs defaults as
                the accept gate, the port's perf-gate copy as referee,
                a torn-tail-tolerant NDJSON journal for resume,
                --tuneBudget as wall cap;
  cli.py        the `ccs tune` subcommand (`--serveLeg` exits 2).

The consumer half lives in pbccs_tpu_torch/runtime/tuning.py: `ccs` and
`ccs warmup` resolve knobs as explicit flag/env > matching host profile
(--tuneProfile PATH|auto) > hand-tuned constants and record the applied
profile id in every perf-ledger record (`tuned_profile`).
"""
