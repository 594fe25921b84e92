"""Lockstep batched polishing of many ZMWs on one device."""
