"""Host-side data sources (numpy)."""
