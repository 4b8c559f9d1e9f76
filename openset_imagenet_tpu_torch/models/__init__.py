"""Model definitions (two-head ResNet family, batch-norm)."""
