"""Datasets and batch loading."""
