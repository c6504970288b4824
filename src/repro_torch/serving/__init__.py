"""Serving (port of ``repro.serving``): the real-execution engine, and
the simulator and workload generators copied from ``repro``."""
