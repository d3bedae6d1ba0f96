"""The H100 benchmark of ``gulon_tpu_torch``: a harness driven by data.

``run.py`` runs one cell of ``BENCHMARK.json``; every configuration,
traffic mix, per-layer metric and limit sits in a file of its own under
this folder, found by the name ``BENCHMARK.json`` gives it.
"""
