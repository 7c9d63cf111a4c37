"""The matrix-product FLOP model of the encoder and the H100's published
peaks.

Copied, frozen, from ``uc2_torch/utils/flops.py`` at commit 9035995;
``img_embed_flops`` is the image-embedding term that ``grad_flops_per_example``
there adds inline. Dense tensor-core rates without sparsity and the HBM3
bandwidth of an H100 SXM at its 700 W power limit (NVIDIA's data sheet).
"""

H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core operations a second
H100_BYTES_PER_S = 3.35e12     # HBM3


def encoder_fwd_flops_per_pair(L, n_layers=12, H=768, F=3072):
    """Encoder forward matrix-product FLOPs of one (text, image) pair at
    joint length L: per layer the four H x H projections (QKV and the
    output), the two H x F products of the FFN, and Q.K^T and P.V."""
    per_layer = 2 * L * H * (4 * H) + 2 * L * (2 * H * F) + 4 * L * L * H
    return n_layers * per_layer


def img_embed_flops(Nb, H=768, img_dim=2048):
    """The image embedding's product over ``Nb`` regions."""
    return 2 * Nb * img_dim * H


def grad_flops_per_example(Lt, Nb, M, n_layers=12, H=768, F=3072,
                           V=250002, img_dim=2048):
    """Matrix-product FLOPs of one example's training step (forward, the
    activations' and the weights' backward: ~3x the forward): the encoder,
    the image embedding and the LM head over M masked slots. A recomputed
    forward (remat) is not counted."""
    enc = encoder_fwd_flops_per_pair(Lt + Nb, n_layers=n_layers, H=H, F=F)
    head = 2 * M * H * H + 2 * M * H * V
    return 3 * (enc + img_embed_flops(Nb, H, img_dim) + head)
