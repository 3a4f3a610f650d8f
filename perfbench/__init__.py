"""The benchmark of the PyTorch and CUDA port (``matchering_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that belongs to one configuration, traffic mix, cell,
entry or metric sits in a file of its own, found by the name
``BENCHMARK.json`` gives it (``harness.py``).  Nothing here imports JAX or
the JAX package; ``reference/`` imports nothing of the port either.
"""
