"""Utilities of the port: the engine and device-plane microbenchmarks
(perf.py)."""
