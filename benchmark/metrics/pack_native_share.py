"""Share of the traced stretch's block-layout batches that the program's
native packer packed, in %: 100 x its `pack.native` counter over
`pack.native` + `pack.numpy` (dgn_tpu_torch/graph.py pack_graphs, one
count per packed block batch).  Nothing where it recorded no span or
counts neither (a program without the native block pack;
benchmark/spans.py)."""
from benchmark import spans


def read(run):
    s = spans.recorded(run)
    if s is None:
        return None
    c = s["counters"]
    native, numpy = c.get("pack.native", 0), c.get("pack.numpy", 0)
    if not native + numpy:
        return None
    return 100.0 * native / (native + numpy)
