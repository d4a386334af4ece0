"""The benchmark of `ffrnet_torch` on one NVIDIA H100: see README.md."""
