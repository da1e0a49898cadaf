"""Native (C++) runtime of the port: the batch packer of both layouts.

packer.cpp is the component (dgn_pack for the flat layout's edges,
dgn_pack_block for a whole block-layout batch), native.py its ctypes
binding; graph.pack_graphs(native=...) is where packing uses it.
"""
from .native import available, pack_block, pack_edges

__all__ = ["available", "pack_block", "pack_edges"]
