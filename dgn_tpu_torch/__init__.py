"""dgn_tpu_torch: Directional Graph Networks in PyTorch for NVIDIA Hopper.

The port of `dgn_tpu` (JAX/Flax/Pallas) that runs on one H100.  It keeps the
reference package's module layout and names; the one TPU kernel on its path,
the adjacency-block build, is a hand-written CUDA kernel
(`ops/csrc/adjacency.cu`).  Entry point: `python -m dgn_tpu_torch.run`.
Importing the package builds nothing and touches no device.
"""
