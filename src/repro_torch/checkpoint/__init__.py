"""repro_torch.checkpoint — npz-shard checkpointer."""
