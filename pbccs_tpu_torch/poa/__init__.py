"""Partial-order alignment draft stage (numpy copies of pbccs_tpu.poa)."""
