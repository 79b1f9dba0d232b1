"""Host utilities: image IO and metrics."""
