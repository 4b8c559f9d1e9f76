"""Losses, fused loss kernels and confidence metrics."""
