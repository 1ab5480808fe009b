"""One module per per-layer metric, named as in ``BENCHMARK.json``: its
``UNIT``, ``LAYER`` (as ``PERF.md``'s list of layers names it), ``MOVES``
(the end-to-end metric it should move) and ``read(view)``, which takes a
``harness.RunView`` and returns the value, or ``None`` where the run holds
nothing to read it from."""
