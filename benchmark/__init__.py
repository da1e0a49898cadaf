"""The benchmark of dgn_tpu_torch: one training cell per run (bench.py)."""
