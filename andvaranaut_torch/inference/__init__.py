"""Inference machinery of the port: the unconstrained-space
reparameterisation of the hyperpriors."""
