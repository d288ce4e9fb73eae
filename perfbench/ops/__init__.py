"""What each op of the engine asks of the benchmark, one module per op,
found by the configuration's ``op``."""
