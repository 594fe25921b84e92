"""Host draft-stage alignment helpers (numpy copies of pbccs_tpu.align)."""
