"""GP numerics of the port: kernels, mixed-precision factorisation,
conditioning and prediction."""
