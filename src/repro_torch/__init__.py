"""EmuGEMM in PyTorch: the port of the JAX package ``repro`` to PyTorch
and hand-written CUDA kernels for NVIDIA Hopper.

It imports torch and never jax, nor anything of ``repro``. Module paths
mirror the reference's, so each counterpart is easy to find.
"""
