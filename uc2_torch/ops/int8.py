"""int8 serving products (port of ``int8_matmul``,
uc2_tpu/models/encoder.py).

``int8_linear(x, weight, bias, dtype)`` is the reference's serving product
for the port's ``nn.Linear`` layout (``weight`` [out, in], fp32):

* per-row activation scales ``s_x = max(amax|x| / 127, 1e-8)`` and codes
  ``clip(round(x / s_x), -127, 127)`` as int8 (``round`` is half to even,
  as ``jnp.round``);
* per-output-channel weight scales ``s_w = max(amax|W| / 127, 1e-12)``
  over the input dimension (the reference's ``axis=0`` of its [in, out]
  kernel) and codes ``clip(round(W / s_w), -127, 127)``;
* the int8 x int8 -> int32 product, then ``(y * s_x) * s_w`` in fp32,
  cast to ``dtype``, plus the bias in ``dtype``.

The reference computes the product with XLA outside any Pallas kernel; on
a CUDA tensor the port asks cuBLASLt for it through ``torch._int_mm`` (the
int8 tensor cores) and raises where that call refuses the shape (it wants
more than 16 rows and K, N multiples of 8): there is no fallback on the
card. On a CPU tensor ``int8_product_plain`` runs ``torch._int_mm``'s CPU
version, an exact integer sum (an fp32 product would not be: the sums
reach 127^2 * 3072 > 2^24).

The weight codes are computed once per weight version, as the
reference's XLA hoists them out of its eval programs: the cache is keyed
on the parameter itself, its storage and its version counter, so an
optimizer step (an in-place update) between two validations quantizes
again.

Under tensor parallelism (``uc2_torch/parallel/tensor.py``) the reference's
GSPMD takes its row and channel maxima over whole rows and channels, and
its int32 sums are exact, so its codes are the unsharded model's. The
column-parallel products (QKV, the FFN's first dense) see whole rows and
whole input columns and stay ``int8_linear``; the row-parallel ones (the
attention output, the FFN's second dense) run ``int8_linear_row_parallel``:
the activation row maxima and the weight channel maxima taken over the
model group (``max_over_model``; the weights' cached as above, so every
process of the group misses the cache at the same call, the weights
changing in lockstep), each shard's int32 sums summed over the group in
int32, which is exact (the whole sum is bounded by 127^2 * 3072 < 2^31),
then the one-process scaling and bias. ``quantize_rows`` and ``quantize_weight`` take given
maxima, so that shards can be quantized without a process group.
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from uc2_torch.parallel import tensor as TP

QMAX = 127.0
X_SCALE_MIN = 1e-8
W_SCALE_MIN = 1e-12

# parameter -> ((version, data pointer, device, over the group), (codes
# [out, in], scales [out]))
_WEIGHT_CODES = WeakIdKeyDictionary()


def _over_qmax(t):
    """t / 127 as a true division on t's device. (A Python number as the
    divisor would let PyTorch's CUDA kernel multiply by its reciprocal,
    which can differ from the quotient in the last bit, and then a code
    at a rounding tie from the reference's and the CPU's.)"""
    return t / torch.full((), QMAX, device=t.device)


def row_maxima(x2):
    """amax |x2| of each row of ``x2`` [rows, K], fp32 [rows, 1]."""
    return x2.float().abs().amax(dim=-1, keepdim=True)


def channel_maxima(weight):
    """amax |W| of each output channel of ``weight`` [out, in], fp32
    [out]."""
    return weight.detach().float().abs().amax(dim=1)


def quantize_rows(x2, amax=None):
    """(int8 codes, fp32 scales [rows, 1]) of ``x2`` [rows, K], one scale
    a row, from the rows' maxima ``amax`` [rows, 1] (``row_maxima(x2)``
    when None)."""
    x32 = x2.float()
    if amax is None:
        amax = row_maxima(x32)
    s_x = _over_qmax(amax).clamp_min(X_SCALE_MIN)
    return torch.clamp(torch.round(x32 / s_x), -QMAX, QMAX).to(
        torch.int8), s_x


def quantize_weight(weight, amax=None):
    """(int8 codes [out, in], fp32 scales [out]) of an fp32 ``weight``
    [out, in], one scale an output channel, from the channels' maxima
    ``amax`` [out] (``channel_maxima(weight)`` when None)."""
    w = weight.detach().float()
    if amax is None:
        amax = channel_maxima(w)
    s_w = _over_qmax(amax).clamp_min(W_SCALE_MIN)
    return torch.clamp(torch.round(w / s_w[:, None]), -QMAX, QMAX).to(
        torch.int8).contiguous(), s_w


def weight_codes(weight, over_model: bool = False):
    """``quantize_weight(weight)``, cached until ``weight`` changes; with
    ``over_model`` (a row-parallel shard) from the channel maxima over the
    model group, a collective on a miss. Counts its misses
    (``weight_codes.misses``)."""
    key = (weight._version, weight.data_ptr(), weight.device, over_model)
    hit = _WEIGHT_CODES.get(weight)
    if hit is not None and hit[0] == key:
        return hit[1]
    amax = channel_maxima(weight)
    codes = quantize_weight(weight,
                            TP.max_over_model(amax) if over_model else amax)
    _WEIGHT_CODES[weight] = (key, codes)
    weight_codes.misses += 1
    return codes


weight_codes.misses = 0


def int8_product_plain(x_q, w_q):
    """[rows, out] int32: x_q [rows, K] int8 times w_q [out, K] int8
    transposed, summed exactly (``torch._int_mm`` on the CPU)."""
    return torch._int_mm(x_q.cpu(), w_q.cpu().t()).to(x_q.device)


def int8_product(x_q, w_q):
    """``int8_product_plain``'s sums: on a CUDA tensor one cuBLASLt int8
    product (``torch._int_mm``, which raises for a shape it refuses), on
    a CPU tensor the plain version."""
    if not x_q.is_cuda:
        return int8_product_plain(x_q, w_q)
    int8_product.launches += 1
    return torch._int_mm(x_q, w_q.t())


int8_product.launches = 0


def int8_output(acc, s_x, s_w, bias, dtype):
    """The int32 sums ``acc`` [rows, out] scaled, ``(acc * s_x) * s_w`` in fp32, cast to ``dtype``, plus
    ``bias`` (or None) in ``dtype``."""
    y = (acc.float() * s_x * s_w).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def int8_linear(x, weight, bias, dtype):
    """x [..., in] through the int8 serving product with ``weight``
    [out, in] (fp32) and ``bias`` [out] (or None); output in ``dtype``."""
    shape = x.shape
    x_q, s_x = quantize_rows(x.reshape(-1, shape[-1]))
    w_q, s_w = weight_codes(weight)
    y = int8_output(int8_product(x_q, w_q), s_x, s_w, bias, dtype)
    return y.reshape(*shape[:-1], weight.shape[0])


def int8_linear_row_parallel(x, weight, bias, dtype):
    """``int8_linear`` of a row-parallel product under tensor parallelism:
    x [..., in_s] this process's input columns, ``weight`` [out, in_s] its
    shard (fp32), ``bias`` [out] replicated (or None). The row and channel
    maxima are taken over the model group and the int32 sums summed over
    it exactly, so the result is the whole product's ``int8_linear``, the
    same on every process. Collectives: one maximum and one sum a call,
    and one maximum on a miss of the weight cache."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    x_q, s_x = quantize_rows(x2, TP.max_over_model(row_maxima(x2)))
    w_q, s_w = weight_codes(weight, over_model=True)
    acc = TP.sum_over_model(int8_product(x_q, w_q))
    y = int8_output(acc, s_x, s_w, bias, dtype)
    return y.reshape(*shape[:-1], weight.shape[0])
