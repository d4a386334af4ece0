"""Training of RecNet (the frozen IR-SE50 encoder never trains): the
four-part objective, the optimizers and their schedule, and the
single-card train step. Counterpart of ffrnet_tpu/training/."""
