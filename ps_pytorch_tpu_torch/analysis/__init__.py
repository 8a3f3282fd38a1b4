"""Analyses of the port's runs: speedup tables from training logs
(``speedup``) and the PS step's throughput against the worker count
(``scaling_bench``)."""
