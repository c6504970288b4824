"""PyTorch/CUDA port of the Clockwork reproduction (``repro``).

Module paths mirror ``repro``'s. The framework-free control plane
(``core``, ``runtime``, ``serving.simulator``, ``serving.workload`` and
the telemetry records) is a verbatim copy with the package prefix
changed; the model, kernel, engine and profiler modules are ported to
PyTorch, and the attention and SSD kernels run as hand-written CUDA on the
card (``kernels/csrc/``). The package imports neither ``jax`` nor any
module of ``repro``.
"""
