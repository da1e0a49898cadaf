"""ctypes loader for the native packer (runtime/packer.cpp), the port's
counterpart of `dgn_tpu/runtime/native.py`: `pack_edges` (dgn_pack) packs
the flat layout's edges, `pack_block` (dgn_pack_block) a whole batch under
the block layout.

The shared library is built at first use with `g++ -O3 -std=c++17 -shared
-fPIC` into the package's `_build/` directory, and rebuilt when the source
is newer.  A failed build logs one warning naming the compiler's error,
and `available()` then answers False, so `graph.pack_graphs(native=None)`
packs with numpy; `native=True` raises instead.
"""
from __future__ import annotations

import ctypes
import functools
import logging
import math
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "packer.cpp")
_LIB = os.path.join(os.path.dirname(_HERE), "_build", "libdgnpack.so")

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_lib = None
_tried = False

_i32 = ctypes.POINTER(ctypes.c_int32)
_u8 = ctypes.POINTER(ctypes.c_uint8)
_f32 = ctypes.POINTER(ctypes.c_float)


def _build() -> bool:
    """Compile into a private file, then rename it over the library, so a
    process that loads the library never reads a half-written one."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=120)
    except subprocess.CalledProcessError as e:
        lines = (e.stderr or "").strip().splitlines()
        _log.warning("native packer: %s failed (exit %d): %s", " ".join(cmd),
                     e.returncode, lines[0] if lines else "no output")
        return False
    except (OSError, subprocess.SubprocessError) as e:
        _log.warning("native packer: %s could not run: %s", cmd[0], e)
        return False
    os.replace(tmp, _LIB)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:
            _log.warning("native packer: cannot load %s: %s", _LIB, e)
            return None
        lib.dgn_pack.restype = ctypes.c_int
        lib.dgn_pack.argtypes = [
            ctypes.c_int32, _i32, _i32, _i32, _i32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _i32, _i32, _i32, _u8, _f32, _i32, _u8, _f32, _i32]
        lib.dgn_pack_block.restype = ctypes.c_int
        lib.dgn_pack_block.argtypes = (
            [ctypes.c_int32] + [ctypes.c_void_p] * 6
            + [ctypes.c_int64] * 5 + [ctypes.c_void_p] * len(_BLOCK_OUT))
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (building it on the first call)."""
    return _load() is not None


def _p(a, typ):
    return a.ctypes.data_as(typ)


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native packer is not built (see the warning "
                           "logged by dgn_tpu_torch.runtime.native)")
    return lib


def pack_edges(n_nodes: np.ndarray, n_edges: np.ndarray,
               src_cat: np.ndarray, dst_cat: np.ndarray,
               n_pad: int, e_pad: int, g_pad: int) -> dict:
    """The flat layout's edge and node arrays of one batch, by dgn_pack.

    n_nodes/n_edges: per-graph sizes [g]; src_cat/dst_cat: each graph's
    local endpoints, concatenated [E].  Returns src, dst (global, sorted by
    (dst, src), pads last at 0), perm (output edge slot -> input edge, -1
    for pads, so edge features follow with one gather), edge_mask,
    snorm_e [e_pad, 1], node_graph, node_mask, snorm_n [n_pad, 1] and
    in_degree.  Raises ValueError when the batch overflows the pads or an
    endpoint lies outside its graph."""
    lib = _require()
    n_nodes = np.ascontiguousarray(n_nodes, np.int32)
    n_edges = np.ascontiguousarray(n_edges, np.int32)
    src_cat = np.ascontiguousarray(src_cat, np.int32)
    dst_cat = np.ascontiguousarray(dst_cat, np.int32)
    if len(src_cat) != n_edges.sum() or len(dst_cat) != len(src_cat):
        raise ValueError("edge arrays do not match the per-graph edge counts")
    limit = np.repeat(n_nodes, n_edges)
    if ((src_cat < 0) | (src_cat >= limit) | (dst_cat < 0)
            | (dst_cat >= limit)).any():
        raise ValueError("an edge endpoint lies outside its graph")
    src = np.empty(e_pad, np.int32)
    dst = np.empty(e_pad, np.int32)
    perm = np.empty(e_pad, np.int32)
    edge_mask = np.empty(e_pad, np.uint8)
    snorm_e = np.empty(e_pad, np.float32)
    node_graph = np.empty(n_pad, np.int32)
    node_mask = np.empty(n_pad, np.uint8)
    snorm_n = np.empty(n_pad, np.float32)
    in_degree = np.empty(n_pad, np.int32)
    rc = lib.dgn_pack(
        len(n_nodes), _p(n_nodes, _i32), _p(n_edges, _i32),
        _p(src_cat, _i32), _p(dst_cat, _i32), n_pad, e_pad, g_pad, 1,
        _p(src, _i32), _p(dst, _i32), _p(perm, _i32),
        _p(edge_mask, _u8), _p(snorm_e, _f32), _p(node_graph, _i32),
        _p(node_mask, _u8), _p(snorm_n, _f32), _p(in_degree, _i32))
    if rc != 0:
        raise ValueError(f"pack overflow (native): need (n={n_nodes.sum()}, "
                         f"e={len(src_cat)}, g={len(n_nodes)}) but pad sizes "
                         f"are (n={n_pad}, e={e_pad}, g={g_pad})")
    return dict(src=src, dst=dst, perm=perm,
                edge_mask=edge_mask.astype(bool), snorm_e=snorm_e[:, None],
                node_graph=node_graph, node_mask=node_mask.astype(bool),
                snorm_n=snorm_n[:, None], in_degree=in_degree)


# dgn_pack_block's outputs in argument order: (name, dtype, shape), the
# shape in node slots "n", node blocks "b", edge slots "e", chunks "c",
# pair slots "p" (and one more, "p1"), or a number; node_slot and node_row
# hold the batch's nodes, at most n
_BLOCK_OUT = (
    ("need", np.int64, 4), ("node_slot", np.int64, "n"),
    ("node_row", np.int64, "n"),
    ("node_mask", np.bool_, "n"), ("node_graph", np.int32, "n"),
    ("snorm_n", np.float32, ("n", 1)), ("in_degree", np.int32, "n"),
    ("local_graph", np.int32, "n"), ("node_chunk_graph", np.int32, "b"),
    ("src", np.int32, "e"), ("dst", np.int32, "e"), ("perm", np.int64, "e"),
    ("edge_mask", np.bool_, "e"), ("snorm_e", np.float32, ("e", 1)),
    ("local_src", np.int32, "e"), ("local_dst", np.int32, "e"),
    ("edge_chunk_src", np.int32, "c"), ("edge_chunk_dst", np.int32, "c"),
    ("chunk_pair", np.int32, "c"), ("pair_chunk_order", np.int32, "c"),
    ("pair_sorted_ids", np.int32, "c"),
    ("pair_real_chunk_order", np.int32, "c"),
    ("pair_src", np.int32, "p"), ("pair_dst", np.int32, "p"),
    ("pair_covered", np.bool_, "p"), ("pair_chunk_start", np.int32, "p1"))


@functools.lru_cache(maxsize=32)
def _block_plan(n_pad: int, e_pad: int, pair_cap: int):
    """Where each output of _BLOCK_OUT lies at these pads: one buffer per
    dtype ({dtype: length}) and, per output, (name, dtype, start, end,
    shape, byte offset)."""
    size = {"n": n_pad, "b": n_pad // 128, "e": e_pad, "c": e_pad // 128,
            "p": pair_cap, "p1": pair_cap + 1}
    total, plan = {}, []
    for name, dtype, shape in _BLOCK_OUT:
        shape = tuple(size.get(d, d) for d in
                      (shape if isinstance(shape, tuple) else (shape,)))
        at = total.get(dtype, 0)
        total[dtype] = at + math.prod(shape)
        plan.append((name, dtype, at, total[dtype], shape,
                     at * np.dtype(dtype).itemsize))
    return total, tuple(plan)


def _block_arrays(n_pad: int, e_pad: int, pair_cap: int):
    """The arrays of _BLOCK_OUT and their addresses in argument order, cut
    from one buffer per dtype (an address costs microseconds to look up, a
    slice far less)."""
    total, plan = _block_plan(n_pad, e_pad, pair_cap)
    buf = {dtype: np.empty(n, dtype) for dtype, n in total.items()}
    base = {dtype: b.ctypes.data for dtype, b in buf.items()}
    out = {name: buf[dtype][at:end] if len(shape) == 1
           else buf[dtype][at:end].reshape(shape)
           for name, dtype, at, end, shape, _ in plan}
    return out, [base[dtype] + off for _, dtype, _, _, _, off in plan]


def _block_error(rc, need, n_nodes, g, n_pad, e_pad, g_pad, n_pairs_pad):
    n_used, e_used, n_real, n_pairs = (int(x) for x in need)
    return ValueError({
        1: f"mxu pack overflow: need (n={n_used}, g={g}) but pad sizes are "
           f"(n={n_pad}, g={g_pad})",
        2: f"mxu pack overflow: need (n={n_used}, g={g}) but pad sizes are "
           f"(n={n_pad}, g={g_pad})",
        3: f"mxu pack overflow: need e={e_used} but e_pad={e_pad}",
        4: f"mxu pair overflow: {n_real} > n_pairs_pad={n_pairs}",
        5: f"the batch breaks the block layout's invariants (native): "
           f"{int(n_nodes.sum())} real nodes, e_pad={e_pad}",
        6: "an edge endpoint lies outside its graph",
        7: f"mxu pads must be multiples of 128: (n={n_pad}, e={e_pad}, "
           f"g={g_pad})",
    }.get(rc, f"native block pack failed with code {rc}"))


def pack_block(n_nodes: np.ndarray, n_edges: np.ndarray,
               node_first: np.ndarray, edge_first: np.ndarray,
               src: np.ndarray, dst: np.ndarray,
               n_pad: Optional[int], e_pad: Optional[int], g_pad: int,
               n_pairs_pad: Optional[int]) -> dict:
    """One batch under the block layout, by dgn_pack_block.

    n_nodes/n_edges: per-graph sizes [g] in the order of placement;
    node_first/edge_first: each graph's first node and first edge row in
    a table of graphs [g]; src/dst: the table's graph-local endpoints.
    n_pad / e_pad None take what the batch uses (the edge slots at least
    128), n_pairs_pad None the real pairs rounded up to 64; g_pad is a
    multiple of 128.  Returns the arrays of _BLOCK_OUT by name, with the
    pair arrays cut to the pair slots, and n_pad, e_pad and n_pairs.
    node_slot and node_row give each of the batch's nodes its slot and its
    table row, perm each edge slot its table row (-1 for pads), so the
    features follow by index.  Raises ValueError where graph.py's numpy
    path raises (overflow of nodes, graphs, edges or pairs, a broken block
    invariant) and where an endpoint lies outside its graph."""
    lib = _require()
    n_nodes = np.ascontiguousarray(n_nodes, np.int32)
    n_edges = np.ascontiguousarray(n_edges, np.int32)
    node_first = np.ascontiguousarray(node_first, np.int64)
    edge_first = np.ascontiguousarray(edge_first, np.int64)
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    g = len(n_nodes)
    if not (len(n_edges) == len(node_first) == len(edge_first) == g) \
            or len(src) != len(dst):
        raise ValueError("per-graph arrays of different lengths")
    if g and (n_nodes.min() < 0 or n_edges.min() < 0 or edge_first.min() < 0
              or (edge_first + n_edges).max() > len(src)):
        raise ValueError("a graph's sizes are negative or its edges lie "
                         "outside the edge arrays")
    head = [g] + [a.ctypes.data for a in
                  (n_nodes, n_edges, node_first, edge_first, src, dst)]
    if n_pad is None or e_pad is None:
        need = np.zeros(4, np.int64)
        rc = lib.dgn_pack_block(*head, -1, -1, g_pad, -1, 0, need.ctypes.data,
                                *[None] * (len(_BLOCK_OUT) - 1))
        if rc:
            raise _block_error(rc, need, n_nodes, g, n_pad, e_pad, g_pad,
                               n_pairs_pad)
        n_pad = int(need[0]) if n_pad is None else n_pad
        e_pad = max(int(need[1]), 128) if e_pad is None else e_pad
    n_pad, e_pad = int(n_pad), int(e_pad)
    pair_cap = (int(n_pairs_pad) if n_pairs_pad is not None
                else -(-max(e_pad // 128, 1) // 64) * 64)
    out, addresses = _block_arrays(n_pad, e_pad, pair_cap)
    need = out["need"]
    rc = lib.dgn_pack_block(
        *head, n_pad, e_pad, g_pad,
        -1 if n_pairs_pad is None else int(n_pairs_pad), pair_cap,
        *addresses)
    if rc:
        raise _block_error(rc, need, n_nodes, g, n_pad, e_pad, g_pad,
                           n_pairs_pad)
    n_pairs, n_real_nodes = int(need[3]), int(n_nodes.sum())
    for name in ("pair_src", "pair_dst", "pair_covered"):
        out[name] = out[name][:n_pairs]
    out["pair_chunk_start"] = out["pair_chunk_start"][:n_pairs + 1]
    out["node_slot"] = out["node_slot"][:n_real_nodes]
    out["node_row"] = out["node_row"][:n_real_nodes]
    out.update(n_pad=n_pad, e_pad=e_pad, n_pairs=n_pairs)
    return out
