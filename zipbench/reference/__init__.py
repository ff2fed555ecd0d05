"""Plain float32 PyTorch references of the benchmark's configurations.

Nothing here imports the port, the JAX package or JAX: each model is written
out from its equations and reads weights as a nested dict of tensors (the
benchmark's own seeded values, never the program's).  Matrix products run
in float32 with TF32 off; ``prec="fp8"`` is the control, every weight
product's operands rounded to float8 e4m3 (per-row and per-column scales).
"""
