"""Host runtime of the port's CLI: logging, the ZMW whitelist, the
chemistry gate and the ordered work queue (copies of pbccs_tpu.runtime's
modules, without the metric registry)."""
