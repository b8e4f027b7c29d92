"""goldfish_tpu_torch: the PyTorch + CUDA port of goldfish_tpu.

Isogeometric Kirchhoff-Love shell thickness optimization on non-matching
multi-patch NURBS geometry, with implicit-function adjoint gradients
through the nonlinear shell solve. The JAX package `goldfish_tpu` is the
reference; this package keeps its layout and module names.

Every tensor lives on the device the caller asks for (an explicit
`device` argument); everything is float64. On CUDA tensors the physics,
assembly and tangent-product kernels are hand-written CUDA
(`csrc/`, built with nvcc at first use); on CPU tensors their plain
PyTorch versions run instead.

Importing this package imports neither JAX nor `goldfish_tpu`.
"""

__all__ = ["config"]
