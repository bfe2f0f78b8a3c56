"""The perf linter's checked-in graph corpus.

The port's copies of the reference's graph builders
(``examples/job_graph.py:build_graphs`` and
``benchmarks/dag_bench.py:bench_graphs``): the same jobs, sizes, node
names and cluster windows, built from ``repro_torch.core`` with numpy
operands.  ``python -m repro_torch.lint`` reports their graphs under the
reference's ``<source>:<graph>`` names, so one ``LINT_baseline.json``
gates both packages.  One module per reference source, because a
``# repro: allow(...)`` comment suppresses its codes for every graph of
its file.
"""
