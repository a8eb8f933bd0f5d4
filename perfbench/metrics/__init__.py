"""Per-layer metric readers, one file per metric, each with read(ctx)."""
