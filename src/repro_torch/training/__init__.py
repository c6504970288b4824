"""Optimizers and gradient compression (port of ``repro.training``)."""
