"""Launchers (port of ``repro.launch``): the single-device train loop."""
