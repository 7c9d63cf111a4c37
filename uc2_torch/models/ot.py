"""IPOT optimal-transport distance, the itm-ot regulariser (port of
uc2_tpu/models/ot.py).

Plain tensor operations on the inputs' device; nothing here is a kernel
in the reference either. All of the math runs in fp32: the update adds
1e4-scaled pad masks, which bf16 cannot hold. The transport plan carries
no gradient (the reference's ``stop_gradient``): gradients reach the
embeddings only through the cost matrix. The update order is the
reference's: delta from the current sigma, then sigma, and the plan's
update reuses the last delta.
"""

from __future__ import annotations

import torch


def cost_matrix_cosine(x, y, eps: float = 1e-5):
    """Pairwise cosine distance [B, M, D], [B, N, D] -> [B, M, N] in fp32,
    each row normalised as x / max(||x||, eps)."""
    x, y = x.float(), y.float()
    xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                         min=eps)
    yn = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                         min=eps)
    return 1.0 - torch.bmm(xn, yn.transpose(1, 2))


@torch.no_grad()
def ipot(C, x_len, x_pad, y_len, y_pad, joint_pad, beta: float = 0.5,
         iteration: int = 50, k: int = 1):
    """Inexact proximal point OT. C [B, M, N] cost; x_len [B], y_len [B]
    the unpadded lengths; x_pad [B, M], y_pad [B, N], joint_pad [B, M, N]
    bool (True = padding). Returns the plan T [B, N, M] (transposed, as the
    reference returns it)."""
    b, m, n = C.shape
    C = C.float()
    sigma = torch.where(x_pad, 0.0, 1.0 / x_len[:, None])[..., None]
    joint_pad_t = joint_pad.transpose(1, 2)                  # [B, N, M]
    T = (~joint_pad_t).float()
    A = torch.where(joint_pad_t, 0.0, torch.exp(-C.transpose(1, 2) / beta))
    x_len_b = x_len[:, None, None]
    y_len_b = y_len[:, None, None]
    x_mask = (x_pad.float() * 1e4)[:, None, :]               # [B, 1, M]
    y_mask = (y_pad.float() * 1e4)[:, None, :]               # [B, 1, N]
    delta = torch.zeros(b, 1, n, device=C.device)
    for _ in range(iteration):
        Q = A * T
        for _ in range(k):
            delta = 1.0 / (y_len_b * torch.bmm(Q, sigma).transpose(1, 2)
                           + y_mask)
            sigma = (1.0 / (x_len_b * torch.bmm(delta, Q) + x_mask)
                     ).transpose(1, 2)
        T = delta.transpose(1, 2) * Q * sigma.transpose(1, 2)
    return torch.where(joint_pad_t, 0.0, T)


def optimal_transport_dist(txt_emb, img_emb, txt_pad, img_pad,
                           beta: float = 0.5, iteration: int = 50,
                           k: int = 1):
    """The OT distance of each example [B] (fp32) between the text block
    [B, M, D] and the image block [B, N, D]; txt_pad [B, M] and img_pad
    [B, N] bool, True = padding."""
    cost = cost_matrix_cosine(txt_emb, img_emb)
    joint_pad = txt_pad[:, :, None] | img_pad[:, None, :]
    cost = torch.where(joint_pad, 0.0, cost)
    txt_len = (txt_pad.shape[1] - txt_pad.sum(1)).float()
    img_len = (img_pad.shape[1] - img_pad.sum(1)).float()
    T = ipot(cost.detach(), txt_len, txt_pad, img_len, img_pad, joint_pad,
             beta, iteration, k)
    return torch.einsum("bmn,bnm->b", cost, T)
