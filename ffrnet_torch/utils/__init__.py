"""Host utilities of the port: the train loop's Timer and Logger, and
torch.profiler hooks (counterpart of ffrnet_tpu/utils/)."""
