"""train_samples_per_s: every sample (a face and its masked twin) of every
step completed in the window, over the window's time; the window ends on a
synchronize (host clock)."""


def read(run, name):
    return run.window.items / run.window.seconds
