"""Native (C++) runtime of the port: the flat layout's batch packer.

packer.cpp is the component, native.py its ctypes binding;
graph.pack_graphs(native=...) is where packing uses it.
"""
from .native import available, pack_edges

__all__ = ["available", "pack_edges"]
