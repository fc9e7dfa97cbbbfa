"""MCBRaT3D on PyTorch and CUDA: the port of ``mcbrat3d_tpu`` to NVIDIA GPUs.

The JAX package ``mcbrat3d_tpu`` stays the reference; this package keeps its
module names and paths so each counterpart is easy to find. Host setup code
is NumPy/SciPy, transport runs on torch tensors, and the record kernel
(flux path and in-kernel radiance) is a hand-written CUDA kernel
(``csrc/record_kernel.cu``) with a plain PyTorch twin that the CPU uses.
Nothing here imports JAX.
"""

__version__ = "0.1.0"
