"""Training step (one device)."""
