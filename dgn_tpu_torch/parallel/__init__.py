"""Data and edge parallelism over torch.distributed (counterpart of
`dgn_tpu/parallel/`): dp.py shards the batch axis, halo.py one batch's
node and edge axes."""
from .mesh import Mesh, init_multihost, make_mesh
from .dp import DataParallelTrainer, StackedLoader
from .halo import (EdgeParallelTrainer, PartitionedLoader, partition_batch,
                   partition_shards)

__all__ = ["Mesh", "init_multihost", "make_mesh", "DataParallelTrainer",
           "StackedLoader", "EdgeParallelTrainer", "PartitionedLoader",
           "partition_batch", "partition_shards"]
