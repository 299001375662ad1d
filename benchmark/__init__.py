"""The benchmark of rayz_tpu_torch: one command runs one cell of
BENCHMARK.json once (`python3 -m benchmark.run`); see harness.py."""
