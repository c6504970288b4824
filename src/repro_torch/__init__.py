"""PyTorch/CUDA port of the Clockwork reproduction (``repro``).

Module paths mirror ``repro``'s. The framework-free control plane
(``core``, ``telemetry``) is a verbatim copy with the package prefix
changed; the model, kernel and engine modules are ported to PyTorch, and
the decode attention runs through a hand-written CUDA kernel on the card
(``kernels/csrc/flash_decode.cu``). The package imports neither ``jax``
nor any module of ``repro``.
"""
