"""Data pipeline (port of ``repro.data``): a verbatim copy of the seeded
synthetic LM stream and its prefetcher."""
