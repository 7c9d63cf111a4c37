"""The matrix-product FLOP model of the encoder (port of
uc2_tpu/utils/flops.py) and the peak rates of the card the port runs on.

A rate printed beside a measured time must stay under the card's peak;
one above it means the timed program skipped work. The peaks are those of
an NVIDIA H100 SXM ("NVIDIA H100 80GB HBM3" at a 700 W power limit, as
``nvidia-smi`` names it): dense tensor-core rates, without sparsity, and
the HBM3 bandwidth. A card held below 700 W runs slower than these.
"""

H100 = "NVIDIA H100 80GB HBM3, 700.00 W"
H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core operations a second
H100_INT8_OPS = 1979e12        # dense int8 tensor-core operations a second
H100_BYTES_PER_S = 3.35e12     # HBM3


def encoder_fwd_flops_per_pair(L, n_layers=12, H=768, F=3072):
    """Encoder forward matrix-product FLOPs of one (text, image) pair at
    joint length L: per layer the four H x H projections (QKV and the
    output), the two H x F products of the FFN, and Q.K^T and P.V."""
    per_layer = 2 * L * H * (4 * H) + 2 * L * (2 * H * F) + 4 * L * L * H
    return n_layers * per_layer


def grad_flops_per_example(Lt, Nb, M, n_layers=12, H=768, F=3072,
                           V=250002, img_dim=2048):
    """Matrix-product FLOPs of one example's mlm training step (forward,
    the activations' and the weights' backward: ~3x the forward): the
    encoder, the image embedding and the LM head over M masked slots. A
    recomputed forward (remat) is not counted: the rate stays that of the
    model's work."""
    enc = encoder_fwd_flops_per_pair(Lt + Nb, n_layers=n_layers, H=H, F=F)
    img_emb = 2 * Nb * img_dim * H
    head = 2 * M * H * H + 2 * M * H * V
    return 3 * (enc + img_emb + head)
