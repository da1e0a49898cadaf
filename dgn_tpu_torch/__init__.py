"""dgn_tpu_torch: Directional Graph Networks in PyTorch for NVIDIA Hopper.

The port of `dgn_tpu` (JAX/Flax/Pallas) that runs on one H100.  It keeps the
reference package's module layout and names, and trains the five benchmark
configs (ZINC, SBM PATTERN, CIFAR10 superpixels, HIV, PCBA) on the block
or the flat layout, and COLLAB link prediction; the TPU kernels on the
block layout's paths are hand-written CUDA kernels: the adjacency-block
build (`ops/csrc/adjacency.cu`) and the per-destination max/min with its
backward (`ops/csrc/extremes.cu`).  It trains data-parallel or
edge-partitioned over torch.distributed (`parallel/`, `--n_devices`,
`--partition`, `--multihost`) and carries the dense research path
(`dense/`).  Entry point: `python -m
dgn_tpu_torch.run`.
Importing the package builds nothing and touches no device.
"""
