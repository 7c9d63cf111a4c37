"""The share of the traced slice in which no operation ran on the card:
1 - (the union of the device operations' intervals) / (the slice's wall
time), in percent."""


def read(trace):
    if not trace.device_ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
