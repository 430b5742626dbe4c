"""Utilities: seeded test-input generators (``generators``), min-of-k and
amortized timing (``timing``, ``bench_utils``), and traces with the
program's spans and its sync counter (``profiling``)."""
