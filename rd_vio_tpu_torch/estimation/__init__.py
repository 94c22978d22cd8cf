"""Estimation layer: window states, factors, the batched LM solver and
marginalization (port of the JAX package's estimation/).

Fixed-shape struct-of-arrays tensors throughout: the residual and Jacobian
assembly and the landmark Schur reduction are batched tensor operations,
and a window solve reads one value back to the host per LM iteration.
"""
