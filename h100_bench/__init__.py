"""The benchmark of ``ppt_torch`` on one NVIDIA H100: cells named in
``BENCHMARK.json``, run by ``python3 -m h100_bench.run`` (see README.md)."""
