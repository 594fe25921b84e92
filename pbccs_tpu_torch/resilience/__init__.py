"""Fault handling of the port (ports of pbccs_tpu.resilience's modules,
with the same metric names, fault sites and journal schema):

  * `faults`     -- seedable site-based fault injection (PBCCS_FAULTS,
                    --faults);
  * `retry`      -- RetryPolicy for transient errors (no CUDA error is
                    transient);
  * `watchdog`   -- a deadline around a device dispatch (--polishTimeout);
  * `quarantine` -- bisection of a failed batch down to its poison
                    ZMW(s), serial rescue, draft-only degradation;
  * `resources`  -- capacity classification (a CUDA OOM splits the
                    batch), the MemoryGovernor's shape ceilings, the
                    host budget and disk-full-safe output;
  * `checkpoint` -- the per-chunk journal behind --checkpoint/--resume.
"""
