"""End-to-end metrics, one module each, found by the name in
``BENCHMARK.json``: ``read(run)`` takes the run's ``grid``, ``steps`` and
``elapsed`` (the measured window), ``setup_s`` and ``peak`` (bytes)."""
