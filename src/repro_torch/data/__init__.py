"""Host-side data sources for training."""
