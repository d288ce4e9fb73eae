"""repro_torch.data — deterministic synthetic token pipeline."""
