"""Plain PyTorch references that decide a benchmark run's ``correct``.

Written from the formulas alone and frozen here: nothing in this package
imports the program under test (``psa_tpu_torch``), the JAX package or JAX.
Each function takes the inputs the harness made (sites, trajectories,
k-sets) and computes in float64, or, with ``tf32=True``, in the precision
below the configuration's (float32 operands, TF32 products): the control
that the comparison has to reject.
"""
