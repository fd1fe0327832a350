"""The benchmark of open_provence_tpu_torch on NVIDIA H100 cards (see README.md)."""
