"""The model's share of the card's peak over the window: the frozen FLOP
model's operations for the work the window completed, each example at its
own lengths (``frozen/flops.py``), over the window's seconds times 989
TFLOP/s, in percent."""

from h100bench.frozen.flops import H100_BF16_FLOPS


def read(trace):
    w = trace.window
    if not w.get("flops") or not w.get("seconds"):
        return None
    return 100.0 * w["flops"] / (w["seconds"] * H100_BF16_FLOPS)
