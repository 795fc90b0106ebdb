"""The benchmark of maniac_tpu_torch on one H100: ``python -m portbench.run``.

Driven by data: BENCHMARK.json names the cells; each configuration is
``configs/<name>.json`` (its writer in ``writers/``), each traffic mix
``traffic/<name>.json`` (its driver in ``drivers/``), each per-layer metric
``metrics/<name>.py`` and each cell's limits ``limits/<cell>.json``. The
comparison is ``compare.py``, against the energy oracle ``oracle.py`` and
the frozen plain path ``ref/`` (the stream and the replay); the counting
of the least time a kernel call could take is ``bounds.py``.
"""
