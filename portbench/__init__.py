"""The benchmark of hop_tpu_torch: one cell run once by `portbench/run.py`
(see README.md)."""
