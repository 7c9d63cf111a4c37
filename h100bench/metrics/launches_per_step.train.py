"""CUDA kernels launched in the traced slice, per unit of work in it (a
scored batch, or a training step): the work of the kernel wrappers and the
encoder's routing. A count that repeats exactly."""


def read(trace):
    if not trace.kernels or not trace.units:
        return None
    return len(trace.kernels) / trace.units
