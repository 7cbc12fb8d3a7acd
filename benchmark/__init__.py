"""Benchmark harness of mcqueens_torch: the cells of BENCHMARK.json."""
