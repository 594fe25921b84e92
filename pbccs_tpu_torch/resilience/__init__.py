"""Fault handling of the port (the quarantine bisection)."""
