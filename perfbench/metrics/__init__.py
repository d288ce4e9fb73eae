"""Per-layer metric readers, one module per metric, found by name."""
