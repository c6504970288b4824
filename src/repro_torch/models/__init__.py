"""Models (port of ``repro.models``): dense decoder LM, decode mode."""
