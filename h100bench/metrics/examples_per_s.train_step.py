"""The window's training rate, rows of every step over the window's host
time (what ``train_examples_per_s`` measures), in a training cell where
that rate is too unsteady on the host to hold a bound end to end."""


def read(trace):
    return trace.window.get("metrics", {}).get("train_examples_per_s")
