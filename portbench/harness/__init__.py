"""The benchmark's harness: cells read from ``BENCHMARK.json`` and the
data files under ``portbench/``, set-up, the measured window, the traced
run and the check of what the window produced."""
