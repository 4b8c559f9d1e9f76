"""Losses, fused loss kernels, the fused bottleneck's site kernel (K5) and
confidence metrics."""
