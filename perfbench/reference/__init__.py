"""Plain float32 PyTorch references of the served models. They import
nothing of the port (``repro_torch``) nor of the JAX package, and take
only the weights and inputs the benchmark drew: every layout conversion
the port makes (``port_layout``'s OIHW/channels_last, its (C, 1, 1) BN
vectors, its padded vocabulary) is worked out again here."""
