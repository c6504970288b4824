"""Serving (port of ``repro.serving``): the real-execution engine."""
