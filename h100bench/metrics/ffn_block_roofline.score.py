"""Kernel #3 (``fused_ffn_block``, ``csrc/fused_ffn_block.cu``) against its
roofline: the frozen bound (``frozen/bounds.py``) of the FFN blocks of
every batch in the traced slice, one a layer at the batch's B x L rows,
over the device time of the kernels named ``fused_ffn_kernel``, in
percent. Nothing matched: no reading."""

from h100bench.frozen.bounds import bound_s, ffn_block


def read(trace):
    t = trace.kernel_seconds(lambda n: "fused_ffn_kernel" in n)
    if t <= 0:
        return None
    c = trace.model
    need = sum(c["num_hidden_layers"] * bound_s(*ffn_block(
        B * L, c["hidden_size"], c["intermediate_size"]))
        for B, L in trace.shapes)
    return 100.0 * need / t
