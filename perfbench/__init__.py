"""The port's benchmark: ``run.py`` runs one cell of ``BENCHMARK.json``
once (``harness/``), the cells' kinds, configurations, traffic mixes and
metric readers are files found by name (``kinds/``, ``configs/``,
``traffic/``, ``metrics/``), and ``reference/`` holds the plain
references that decide ``correct``."""
