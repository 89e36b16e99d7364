"""Host-side utilities: metrics tables, trajectory evaluation, timing, checkpoints, dump writers."""
