"""repro_torch.train — optimizer, loss, train-step builder."""
