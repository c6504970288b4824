"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one CUDA card and
prints one JSON line. Everything that belongs to one configuration, traffic
mix or metric is a file of its own, found by its name:

* ``configs/<config>.json``  sizes as served, the comparison's limits, and
  the adapter that builds the served models (``configs/<config>.py``);
* ``cells/<workload>.json``  the traffic mix and deployment of one cell;
* ``metrics/<metric>.py``    one reader per metric (``read(run)``);
* ``reference/``             plain f32 PyTorch references of each model.

``harness/`` holds the general code: traffic generation, the serving
stack's wrappers, the trace reduction, the roofline formulas and the output
comparison. Nothing here imports JAX or the JAX package.
"""
