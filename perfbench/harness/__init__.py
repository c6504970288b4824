"""General code of the benchmark; see ``perfbench/__init__.py``."""
