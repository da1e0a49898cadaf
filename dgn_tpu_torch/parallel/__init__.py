"""Data parallelism over torch.distributed (counterpart of
`dgn_tpu/parallel/`, its dp half; edge parallelism, `halo.py`, is not
ported: ROADMAP A11b)."""
from .mesh import Mesh, init_multihost, make_mesh
from .dp import DataParallelTrainer, StackedLoader

__all__ = ["Mesh", "init_multihost", "make_mesh", "DataParallelTrainer",
           "StackedLoader"]
