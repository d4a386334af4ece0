"""faces_per_s: every face whose embeddings reached the host in the
window, over the window's time (host clock)."""


def read(run, name):
    return run.window.items / run.window.seconds
