"""PyTorch/CUDA port of the repro workload zoo, for one NVIDIA H100 (sm_90a).

The JAX package ``repro`` is the reference; this package imports nothing of
it and keeps its own copy of what it needs. Subpackages mirror the JAX
package's names (configs, models, kernels, train, launch) so that each module
has an obvious counterpart. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
