"""Default-off model options of the JAX package's ``experimental`` package:
the fused-backward bottleneck and the int8 boundary gate
(:mod:`.fused_block`)."""
