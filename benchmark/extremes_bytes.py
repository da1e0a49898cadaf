"""HBM bytes of one launch of each kernel of the segment_extremes pair
(dgn_tpu_torch/ops/csrc/extremes.cu extremes_fwd_kernel and
extremes_bwd_kernel), as chip_smoke.py's kernel phase counts the bytes
behind its bound: the real edges' values read once, the layout's index
and mask arrays (4 + 1 bytes an edge slot, 4 a chunk), and the outputs
(forward: max and min [N, F] written; backward: max, min and both
cotangents read at the N_dst nodes real edges reach, d_ge [E, F]
written whole).  extremes_roofline reads the pair's share of the HBM
rate from these counts."""
from __future__ import annotations

from typing import Tuple

TILE = 128


def extremes_bytes(e_pad: int, n_real: int, n_chunks: int, n: int,
                   n_dst: int, f: int) -> Tuple[int, int]:
    """(forward, backward) bytes at E = e_pad edge slots (n_real real),
    C = n_chunks chunks, N = n node rows (n_dst reached by a real edge)
    and F = f features."""
    index_bytes = e_pad * 4 + e_pad + n_chunks * 4
    fwd = n_real * f * 4 + index_bytes + 2 * n * f * 4
    bwd = n_real * f * 4 + index_bytes + 4 * n_dst * f * 4 + e_pad * f * 4
    return fwd, bwd


def real_bytes(nodes: int, edges: int, f: int) -> Tuple[int, int]:
    """extremes_bytes of a micro-batch at its real counts, so that padding
    counts nothing (as counts.adjacency_bytes): its real edges stand for
    the edge slots, the chunks they fill for C, its real nodes for N and
    for the nodes reached (every atom of a molecule of two or more has a
    bond into it)."""
    return extremes_bytes(edges, edges, -(-edges // TILE), nodes, nodes, f)
