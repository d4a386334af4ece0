"""Data for the port (numpy only). Counterpart of ffrnet_tpu/data/."""
