"""PyTorch/CUDA port of the ionospheric tomography engine.

The JAX package ``ionotomo_tpu`` is the reference; this package keeps its
layout (``core/``, ``models/``, ``geometry/``, ``forward/``) and its
function names and signatures, with torch tensors in and out, so every
counterpart is found by path. Nothing here imports ``jax``.

The hot primitives are hand-written CUDA kernels for Hopper
(``kernels/csrc``), built from the sources at first use. Each sits beside
its plain PyTorch version: a tensor on the CPU takes the plain version, a
tensor on a CUDA device launches the kernel or raises.

Float32 matmuls stay full f32, as the reference pins
``Precision.HIGHEST``: importing the package turns TF32 off for cuBLAS and
cuDNN, and every ``einsum`` site checks it (``core.precision``).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
