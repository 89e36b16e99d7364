"""Multi-device scaling on torch.distributed (one process per device)."""
