"""Host runtime of the port's CLI: logging, the ZMW whitelist, the
chemistry gate, the ordered work queue, read ids, and the stage and
device-fetch timers over the metrics registry (ports of pbccs_tpu.runtime's
modules)."""
