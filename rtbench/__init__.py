"""The benchmark of ``nanort_tpu_torch`` on one NVIDIA H100 (see
``rtbench/README.md`` and ``BENCHMARK.json`` at the root)."""
