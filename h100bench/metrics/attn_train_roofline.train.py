"""The training attention kernels #5 (``attn_stream_kernel``), #6a
(``attn_bwd_rows_kernel``) and #6b (``attn_bwd_keys_kernel``; all in
``csrc/attention_stream.cuh`` and ``csrc/attention_train.cu``) against
their roofline: the frozen bounds (``frozen/bounds.py``) of each step's
launches in the traced slice, one a layer at the step's (B, L), over
those kernels' device time, in percent; a kernel that ran in no step adds
neither bound nor time. Nothing matched: no reading."""

from h100bench.frozen import bounds as BD

KERNELS = (("attn_stream_kernel", BD.attn_train_fwd),
           ("attn_bwd_rows_kernel", BD.attn_bwd_rows),
           ("attn_bwd_keys_kernel", BD.attn_bwd_keys))


def read(trace):
    c = trace.model
    N = c["num_attention_heads"]
    D = c["hidden_size"] // N
    rate = c["attention_probs_dropout_prob"]
    need = took = 0.0
    for name, work in KERNELS:
        t = trace.kernel_seconds(lambda n: name in n)
        if t <= 0:
            continue
        took += t
        for B, L in trace.shapes:
            args = (B, L, N, D) if work is BD.attn_train_fwd else (
                B, L, N, D, rate)
            need += c["num_hidden_layers"] * BD.bound_s(*work(*args))
    return 100.0 * need / took if took > 0 else None
