"""ctypes loader for the native packer (runtime/packer.cpp), the port's
counterpart of `dgn_tpu/runtime/native.py`.

The shared library is built at first use with `g++ -O3 -std=c++17 -shared
-fPIC` into the package's `_build/` directory, and rebuilt when the source
is newer.  A failed build logs one warning naming the compiler's error,
and `available()` then answers False, so `graph.pack_graphs(native=None)`
packs with numpy; `native=True` raises instead.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

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
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (building it on the first call)."""
    return _load() is not None


def _p(a, typ):
    return a.ctypes.data_as(typ)


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
    lib = _load()
    if lib is None:
        raise RuntimeError("the native packer is not built (see the warning "
                           "logged by dgn_tpu_torch.runtime.native)")
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
