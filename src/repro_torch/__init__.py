"""PyTorch/CUDA port of the Clockwork reproduction (``repro``).

Module paths mirror ``repro``'s. The framework-free control plane
(``core``, ``runtime``, ``serving.simulator``, ``serving.workload`` and
the telemetry records) is a copy with the package prefix changed, verbatim
except for the seven files that carry the port's in-program timing of each
INFER (``core/actions.py``, ``core/worker.py``, ``core/controller.py``,
``core/predictor.py``, ``telemetry/events.py``, ``telemetry/recorder.py``,
``runtime/protocol.py``): ``tests/test_torch_tracing.py`` holds their
decisions equal to the reference's. The model, kernel, engine and profiler
modules are ported to PyTorch, and the attention and SSD kernels run as
hand-written CUDA on the card (``kernels/csrc/``). The package imports
neither ``jax`` nor any module of ``repro``.
"""
