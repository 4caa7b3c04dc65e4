"""PyTorch port of the sdpb solve (CUDA kernels on Hopper), in the classic
float64 and the scaled float32 MP representations.

The JAX package `sdpb_tpu` is the reference this package is checked
against.  This package imports `torch` and never `jax`, and nothing of
`sdpb_tpu`: it keeps its own copy of what it needs (input reading, string
conversions, solver parameters, CLI option parsing).  Every public
function takes its device from its tensors or from an explicit `device`
argument — there is no device fallback.
"""
