"""uc2_torch CUDA kernels against their plain versions at edge shapes the
main paths do not reach (L = 1, ragged query and row tiles, B = 1,
strided and contiguous heads, the encoder's length limit of 512), the
long-L inference kernel (#4), #1 bitwise equal to it, and the dispatch
between them, the wrappers' refusals on CUDA tensors, the training
kernels' dropout mask against the plain Philox mask bit for bit, the
backward's two passes each against its plain version (statistics, keep
bits bit for bit) and its bitwise repeat, the training FFN kernels (#9,
#10) against their plain versions and for a bitwise repeat (#9 at rate 0
bit for bit #3's launch), the QKV-in-kernel
attention block (#7) and the segment-masked attention of the "flash"
route (#12, #12a, #12b: all rows valid, most rows invalid, a first key
block masked for whole rows, a bitwise repeat of the backward), the
encoder's kernel paths (scoring and training steps, "flash" and
``UC2_ATTN_V2`` included) against its eager path, and the two kernels of
the kernel lab: the whole encoder layer (#8) and attention with
unnormalised bf16 probabilities (#11), the retrieval finetuning step
(itm-rank) against the CPU and for a bitwise repeat, and tensor
parallelism's kernel modes: #2's and #3's partial modes on shards of the
heads and of the intermediate against their plain versions and, summed
with the epilogue, against the whole kernels, #5/#6a on a shard of
the heads bit for bit those heads of the whole launch, and #7's, #9's and
#10's partial modes (T = 2, 3, 4 and 12 at tile edges, rates 0 and 0.1)
against their plain versions, for a bitwise repeat and, summed over the
shards, against the whole kernels. Needs a CUDA device
(sm_90a); run on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: the repository's conftest configures JAX, which that
machine does not need). Elsewhere every test skips."""

import pytest
import torch

from uc2_torch.config import UC2Config
from uc2_torch.models.convert import shard_tensor
from uc2_torch.models.finetune import UC2ForImageTextRetrieval
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.ops.flash_attention import (
    flash_attention, flash_attention_long,
    flash_attention_long_plain, flash_attention_plain, flash_attention_train,
    flash_attention_train_bwd, flash_attention_train_bwd_dkdv,
    flash_attention_train_bwd_dkdv_plain, flash_attention_train_bwd_dq,
    flash_attention_train_bwd_dq_plain, flash_attention_train_bwd_plain,
    flash_attention_train_fwd, flash_attention_train_plain,
    flash_attention_v3, unpack_keep_bits)
from uc2_torch.ops.philox import keep_mask
from uc2_torch.training.optim import build_optimizer, constant
from uc2_torch.training.step import train_step
from uc2_torch.ops.fused_block import (fused_attn_block,
                                       fused_attn_block_plain,
                                       fused_ffn_block, fused_ffn_block_plain)
from uc2_torch.ops.ffn_train import (
    fused_ffn_block_train, fused_ffn_block_train_bwd,
    fused_ffn_block_train_bwd_plain, fused_ffn_block_train_fwd,
    fused_ffn_block_train_plain)
from uc2_torch.ops.philox import ffn_keep_mask
from uc2_torch.ops.fused_block import (fused_attn_block_v2,
                                       fused_attn_block_v2_plain)
from uc2_torch.ops import segment_flash as sf
from uc2_torch.ops.fused_block import (fused_layer_block,
                                       fused_layer_block_plain)
from uc2_torch.ops.lab_attention import (attention_bf16_probs,
                                         attention_bf16_probs_plain)

pytestmark = pytest.mark.cuda

N, D, H = 12, 64, 768
# both versions round to bf16 at the same points; allow two bf16 ulps of
# the value plus 2e-2 for fp32 sums taken in another order
ATOL, RTOL = 2e-2, 2.0 ** -7


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(out, ref):
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    assert ((out - ref).abs() <= ATOL + RTOL * ref.abs()).all(), \
        (out - ref).abs().max().item()


def _heads(gen, B, L, strided):
    if strided:   # views into one [B, L, 3H] projection, as the encoder
        qkv = torch.randn(B, L, 3 * H, generator=gen, device="cuda").bfloat16()
        return [t.view(B, L, N, D) for t in qkv.split(H, -1)]
    return [torch.randn(B, L, N, D, generator=gen, device="cuda").bfloat16()
            for _ in range(3)]


def _bias(gen, B, L):
    lens = torch.randint(max(1, L // 2), L + 1, (B,), generator=gen,
                         device="cuda")
    mask = (torch.arange(L, device="cuda")[None] < lens[:, None]).float()
    return ((1.0 - mask) * -10000.0)[:, None, None, :].contiguous()


def _vec(gen, n, scale, offset=0.0):
    return torch.randn(n, generator=gen, device="cuda") * scale + offset


@pytest.mark.parametrize("B,L,strided", [(1, 1, False), (2, 17, True),
                                         (3, 129, False), (1, 200, True),
                                         (2, 512, True)])
def test_flash_attention_kernel_matches_plain(gen, B, L, strided):
    q, k, v = _heads(gen, B, L, strided)
    bias = _bias(gen, B, L)
    _close(flash_attention_v3(q, k, v, bias),
           flash_attention_plain(q, k, v, bias))


# kernel #4: the rows of the dispatch's long side, ragged query and key
# tiles (the streamed core's 64 and 128 rows), B = 1 and 3
@pytest.mark.parametrize("B,L,strided", [(1, 419, True), (3, 450, False),
                                         (3, 512, True), (1, 512, False),
                                         (1, 1, True), (2, 97, True),
                                         (3, 63, True), (1, 64, True),
                                         (3, 65, True), (1, 127, True),
                                         (3, 129, True), (3, 162, True),
                                         (1, 174, True), (3, 257, True),
                                         (1, 339, True), (3, 511, True)])
def test_flash_attention_long_kernel_matches_plain(gen, B, L, strided):
    q, k, v = _heads(gen, B, L, strided)
    bias = _bias(gen, B, L)
    before = flash_attention_long.launches
    _close(flash_attention_long(q, k, v, bias),
           flash_attention_long_plain(q, k, v, bias))
    assert flash_attention_long.launches == before + 1


@pytest.mark.parametrize("B,L", [(1, 1), (3, 65), (64, 98), (2, 162),
                                 (3, 339), (1, 512)])
def test_flash_attention_v3_is_kernel_4(gen, B, L):
    """#1 and #4 compute one function and launch one streamed core: the
    same bits on the same inputs, each call repeated bit for bit."""
    q, k, v = _heads(gen, B, L, strided=True)
    bias = _bias(gen, B, L)
    out1 = flash_attention_v3(q, k, v, bias)
    assert torch.equal(out1, flash_attention_long(q, k, v, bias))
    assert torch.equal(flash_attention_v3(q, k, v, bias), out1)


def test_flash_attention_routes_as_the_reference(gen):
    """#1 up to L = 418 at 12 heads, #4 from 419 (n L^2 4 B > 8 MiB); the
    eager-recompute backward behind both."""
    for L, long in ((418, False), (419, True)):
        q, k, v = _heads(gen, 1, L, strided=True)
        bias = _bias(gen, 1, L)
        before = (flash_attention.launches, flash_attention_long.launches)
        _close(flash_attention(q, k, v, bias),
               flash_attention_plain(q, k, v, bias))
        assert (flash_attention.launches - before[0],
                flash_attention_long.launches - before[1]) == (
                    (0, 1) if long else (1, 0))
    q.requires_grad_(True)
    flash_attention(q, k, v, bias).float().sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad.float()).all()


def test_flash_attention_long_refuses(gen):
    q, k, v = _heads(gen, 1, 419, strided=False)
    bias = _bias(gen, 1, 419)
    with pytest.raises(ValueError):                      # head_dim 32
        flash_attention_long(*(t[..., :32].contiguous() for t in (q, k, v)),
                             bias)
    q2, k2, v2 = _heads(gen, 1, 513, strided=False)     # past the limit
    with pytest.raises(ValueError):
        flash_attention_long(q2, k2, v2, _bias(gen, 1, 513))
    with pytest.raises(TypeError):                       # fp32 activations
        flash_attention_long(q.float(), k.float(), v.float(), bias)


# the edges of the 64-row query tiles and key tiles of kernels #2 and #7
# (#7's clusters span a batch row: 2 ceil(L / 64) blocks, 16 at L = 512)
BLOCK_EDGES = (1, 63, 64, 65, 127, 128, 129, 162, 192, 193, 257, 448, 512)
# kernel #2: every edge on views into one [B, L, 3H] projection at B = 1-3,
# contiguous heads at some, one grid past a whole wave of 132 SMs (67 tiles
# of two blocks), and the lengths of the earlier cases; each call repeated
# bit for bit, one launch a call
# a grid past a whole wave is repeated this often more: its blocks start
# at other times relative to each other, which shows a race one repeat
# misses
REPEATS_PAST_A_WAVE = 10
BLOCK_CASES = ([(1 + i % 3, L, True) for i, L in enumerate(BLOCK_EDGES)]
               + [(2, L, False) for L in (63, 65, 162, 512)]
               + [(67, 128, True), (2, 33, True), (1, 300, False)])


@pytest.mark.parametrize("B,L,strided", BLOCK_CASES)
def test_fused_attn_block_kernel_matches_plain(gen, B, L, strided):
    q, k, v = _heads(gen, B, L, strided=strided)
    args = (q, k, v, _bias(gen, B, L),
            torch.randn(B, L, H, generator=gen, device="cuda").bfloat16(),
            (torch.randn(H, H, generator=gen, device="cuda") * 0.05).bfloat16(),
            _vec(gen, H, 0.02), _vec(gen, H, 0.1, 1.0), _vec(gen, H, 0.1))
    before = fused_attn_block.launches
    out = fused_attn_block(*args)
    _close(out, fused_attn_block_plain(*args))
    assert torch.equal(fused_attn_block(*args), out)
    assert fused_attn_block.launches == before + 2
    for _ in range(REPEATS_PAST_A_WAVE if B > 3 else 0):
        assert torch.equal(fused_attn_block(*args), out)


def test_fused_attn_block_refuses(gen):
    """fp32 inputs, L past 512, and bases the kernel's TMA cannot read."""
    def args(L, **kw):
        q, k, v = _heads(gen, 1, L, strided=True)
        a = dict(q=q, k=k, v=v, bias=_bias(gen, 1, L),
                 x=torch.randn(1, L, H, generator=gen, device="cuda").bfloat16(),
                 wo=torch.zeros(H, H, device="cuda").bfloat16(),
                 bo=_vec(gen, H, 0.02), gamma=_vec(gen, H, 0.1, 1.0),
                 beta=_vec(gen, H, 0.1))
        a.update(kw)
        return a
    a = args(16)
    with pytest.raises(TypeError):                       # fp32 activations
        fused_attn_block(**{**a, "x": a["x"].float()})
    with pytest.raises(TypeError):
        fused_attn_block(**{**a, **{n: a[n].float() for n in "qkv"}})
    with pytest.raises(ValueError):                      # past the limit
        fused_attn_block(**args(513))
    buf = torch.zeros(16 * H + 1, device="cuda").bfloat16()
    with pytest.raises(ValueError):                      # x 2 bytes off
        fused_attn_block(**{**a, "x": buf[1:].view(1, 16, H)})
    wbuf = torch.zeros(H * H + 1, device="cuda").bfloat16()
    with pytest.raises(ValueError):                      # wo 2 bytes off
        fused_attn_block(**{**a, "wo": wbuf[1:].view(H, H)})
    qbuf = torch.zeros(3 * 16 * H + 8, device="cuda").bfloat16()
    q, k, v = (t.view(1, 16, N, D) for t in
               qbuf[4:4 + 3 * 16 * H].view(1, 16, 3 * H).split(H, -1))
    with pytest.raises(ValueError):                      # heads 8 bytes off
        fused_attn_block(**{**a, "q": q, "k": k, "v": v})


# kernel #3 (a 64-row tile is a cluster of two blocks, one a column half):
# the edges of its tiles, one past a whole wave of 132 SMs (66 tiles) and
# past 132 tiles, the scoring shapes, F = 128 and 3072; each call repeated
# bit for bit, one launch a call
@pytest.mark.parametrize("shape,F", [((1, 1), 3072), ((1, 33), 3072),
                                     ((3, 98), 3072), ((2, 40), 128)]
                         + [((rows,), F) for rows in
                            (1, 63, 64, 65, 129, 64 * 66 + 1, 64 * 132 + 1)
                            for F in (128, 3072)]
                         + [((64, 162), 3072), ((64, 162), 128),
                            ((3, 98), 128)])
def test_fused_ffn_block_kernel_matches_plain(gen, shape, F):
    x = torch.randn(*shape, H, generator=gen, device="cuda").bfloat16()
    args = (x, (torch.randn(F, H, generator=gen, device="cuda") * 0.05).bfloat16(),
            _vec(gen, F, 0.02),
            (torch.randn(H, F, generator=gen, device="cuda") * 0.05).bfloat16(),
            _vec(gen, H, 0.02), _vec(gen, H, 0.1, 1.0), _vec(gen, H, 0.1))
    before = fused_ffn_block.launches
    out = fused_ffn_block(*args)
    _close(out, fused_ffn_block_plain(*args))
    assert torch.equal(fused_ffn_block(*args), out)
    assert fused_ffn_block.launches == before + 2


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q, k, v = _heads(gen, 2, 16, strided=False)
    bias = _bias(gen, 2, 16)
    with pytest.raises(TypeError):                       # fp32 activations
        flash_attention(q.float(), k.float(), v.float(), bias)
    with pytest.raises(ValueError):                      # head_dim 32
        flash_attention(*(t[..., :32] for t in (q, k, v)), bias)
    q2, k2, v2 = _heads(gen, 1, 513, strided=False)     # past the limit
    with pytest.raises(ValueError):
        flash_attention(q2, k2, v2, _bias(gen, 1, 513))
    x = torch.zeros(2, 16, H, device="cuda").bfloat16().requires_grad_(True)
    wo = torch.zeros(H, H, device="cuda").bfloat16()
    vh = [torch.zeros(H, device="cuda") for _ in range(3)]
    with pytest.raises(RuntimeError):                    # no backward
        fused_attn_block(q, k, v, bias, x, wo, *vh)
    q.requires_grad_(True)             # flash_attention has the eager one
    flash_attention(q, k, v, bias).float().sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad.float()).all()
    x = torch.randn(4, H, 2, device="cuda").bfloat16().transpose(1, 2)
    w1 = torch.zeros(128, H, device="cuda").bfloat16()
    w2 = torch.zeros(H, 128, device="cuda").bfloat16()
    vecs = [torch.zeros(n, device="cuda") for n in (128, H, H, H)]
    with pytest.raises(ValueError):                      # non-contiguous x
        fused_ffn_block(x, w1, vecs[0], w2, *vecs[1:])
    x = x.contiguous()
    with pytest.raises(ValueError):                      # F not a multiple of 64
        fused_ffn_block(x, w1[:96].contiguous(), vecs[0][:96].contiguous(),
                        w2[:, :96].contiguous(), *vecs[1:])
    with pytest.raises(TypeError):                       # fp32 weights
        fused_ffn_block(x, w1.float(), vecs[0], w2.float(), *vecs[1:])


@pytest.mark.parametrize("impl,Nb", [(True, 36), (True, 66), ("fused-force", 36)])
def test_encoder_kernel_path_matches_eager_path(gen, impl, Nb):
    cfg = UC2Config(vocab_size=1000, num_hidden_layers=2,
                    max_position_embeddings=130, img_dim=64,
                    dtype="bfloat16", use_pallas_attention=impl)
    model = UC2ForImageTextRetrieval(cfg, device="cuda", seed=1)
    eager = UC2ForImageTextRetrieval(cfg.replace(use_pallas_attention=False),
                                     device="cuda")
    eager.load_state_dict(model.state_dict())
    B, Lt = 4, 62
    ids = torch.randint(4, 1000, (B, Lt), generator=gen, device="cuda")
    mask = torch.ones(B, Lt + Nb, dtype=torch.long, device="cuda")
    mask[0, 20:Lt] = 0
    mask[1, Lt + Nb // 2:] = 0
    ids[0, 20:] = 1
    batch = {"input_ids": ids,
             "img_feat": torch.randn(B, Nb, 64, generator=gen, device="cuda"),
             "img_pos_feat": torch.rand(B, Nb, 7, generator=gen,
                                        device="cuda"),
             "attn_mask": mask}
    counts = [f.launches for f in (flash_attention, fused_attn_block,
                                   fused_ffn_block)]
    got = model.scores(batch)
    after = [f.launches for f in (flash_attention, fused_attn_block,
                                  fused_ffn_block)]
    assert sum(after) - sum(counts) == 2 * 2        # two kernels per layer
    want = eager.scores(batch)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 5e-2


# the training kernels: forward and backward against their plain versions
TRAIN_CASES = [(1, 1), (2, 17), (1, 98), (2, 162), (1, 256),
               (3, 63), (1, 64), (3, 65), (1, 127), (3, 129), (3, 174)]


def _close_report(what, out, ref, atol=ATOL, rtol=RTOL):
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    assert torch.isfinite(out).all(), what
    assert (err <= atol + rtol * ref.abs()).all(), (what, err.max().item())


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,L", TRAIN_CASES)
def test_attention_train_kernels_match_plain(gen, B, L, rate):
    q, k, v = _heads(gen, B, L, strided=True)
    bias = _bias(gen, B, L)
    g = torch.randn(B, L, N, D, generator=gen, device="cuda").bfloat16()
    seed = 1234 + L
    _close_report("fwd", flash_attention_train_fwd(q, k, v, bias, seed, rate),
                  flash_attention_train_plain(q, k, v, bias, seed, rate))
    got = flash_attention_train_bwd(q, k, v, bias, seed, rate, g)
    want = flash_attention_train_bwd_plain(q, k, v, bias, seed, rate, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close_report(name, a, b)


@pytest.mark.parametrize("B,L", [(3, 65), (1, 162), (3, 339), (1, 512)])
def test_attention_train_at_rate_0_is_kernel_4(gen, B, L):
    """#4 and #5 are one streamed core: at rate 0 they give the same bits
    on the same inputs, and each call repeats bit for bit."""
    q, k, v = _heads(gen, B, L, strided=True)
    bias = _bias(gen, B, L)
    long_out = flash_attention_long(q, k, v, bias)
    train_out = flash_attention_train_fwd(q, k, v, bias, 3, 0.0)
    assert torch.equal(train_out, long_out)
    assert torch.equal(flash_attention_long(q, k, v, bias), long_out)
    again = flash_attention_train_fwd(q, k, v, bias, 3, 0.1)
    assert torch.equal(flash_attention_train_fwd(q, k, v, bias, 3, 0.1),
                       again)


def test_attention_train_mask_is_the_plain_philox_mask(gen):
    """q = k = 0, bias 0, v = I (L = d = 64): the output is the dropped,
    rescaled probability matrix, so its zeros are the dropped scores."""
    L, rate, seed = 64, 0.5, 77
    q = torch.zeros(1, L, 1, D, device="cuda").bfloat16()
    v = torch.eye(L, device="cuda").bfloat16().reshape(1, L, 1, D)
    bias = torch.zeros(1, 1, 1, L, device="cuda")
    out = flash_attention_train_fwd(q, q, v, bias, seed, rate)
    keep = keep_mask(seed, rate, 1, 1, L, L, "cuda")[0, 0]
    assert torch.equal(out[0, :, 0, :] != 0, keep)
    assert torch.all(out[0, :, 0, :][keep] == 2.0 / L)


def test_attention_train_autograd_runs_both_kernels(gen):
    q, k, v = _heads(gen, 2, 40, strided=True)
    bias = _bias(gen, 2, 40)
    for t in (q, k, v):
        t.requires_grad_(True)
    counted = (flash_attention_train_fwd, flash_attention_train_bwd_dq,
               flash_attention_train_bwd_dkdv)
    before = [f.launches for f in counted]
    out = flash_attention_train(q, k, v, bias, 5, 0.1)
    g = torch.randn_like(out)
    out.backward(g)
    assert [f.launches - b for f, b in zip(counted, before)] == [1, 1, 1]
    want = flash_attention_train_bwd_plain(q, k, v, bias, 5, 0.1, g)
    for a, b in zip((q.grad, k.grad, v.grad), want):
        _close_report("grad", a, b)


def test_attention_train_wrappers_refuse(gen):
    q, k, v = _heads(gen, 1, 513, strided=False)
    bias = _bias(gen, 1, 513)
    with pytest.raises(ValueError):                      # past the limit
        flash_attention_train_fwd(q, k, v, bias, 1, 0.1)
    with pytest.raises(ValueError):
        flash_attention_train_bwd(q, k, v, bias, 1, 0.1, q)
    q, k, v = _heads(gen, 2, 16, strided=False)
    bias = _bias(gen, 2, 16)
    with pytest.raises(TypeError):                       # fp32 activations
        flash_attention_train_fwd(q.float(), k.float(), v.float(), bias, 1,
                                  0.1)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)  # [B, n, L, d] data
    with pytest.raises(ValueError):                      # bad strides
        flash_attention_train_fwd(qt, k, v, bias, 1, 0.1)
    with pytest.raises(ValueError):
        flash_attention_train_bwd(qt, k, v, bias, 1, 0.1, q)
    dq, stats, bits = flash_attention_train_bwd_dq(q, k, v, bias, 1, 0.1, q)
    with pytest.raises(ValueError):                      # no keep bits
        flash_attention_train_bwd_dkdv(q, k, v, bias, 1, 0.1, q, stats, None)
    with pytest.raises(ValueError):                      # stats of another L
        flash_attention_train_bwd_dkdv(q, k, v, bias, 1, 0.1, q,
                                       stats[..., :8], bits)
    q, k, v = _heads(gen, 1, 300, strided=False)
    with pytest.raises(ValueError):                      # head_dim 32
        flash_attention_train_bwd(*(t[..., :32].contiguous()
                                    for t in (q, k, v)), _bias(gen, 1, 300),
                                  1, 0.1, q[..., :32].contiguous())


def _passes_match_plain(q, k, v, bias, seed, rate, g):
    """Each pass of #6 against its plain version on the same inputs: dq and
    the statistics, the keep bits bit for bit; dk, dv and the dbias
    partials from the plain pass 1's statistics and bits."""
    dq, stats, bits = flash_attention_train_bwd_dq(q, k, v, bias, seed, rate,
                                                   g)
    pdq, pstats, pbits = flash_attention_train_bwd_dq_plain(q, k, v, bias,
                                                            seed, rate, g)
    _close_report("dq pass", dq, pdq)
    for i in range(3):
        _close_report(f"stats {i}", stats[i], pstats[i])
    if rate == 0.0:
        assert bits is None and pbits is None
    else:
        torch.cuda.synchronize()
        assert torch.equal(bits, pbits)
        assert torch.equal(unpack_keep_bits(bits, q.shape[1]),
                           keep_mask(seed, rate, q.shape[0], N, q.shape[1],
                                     q.shape[1], "cuda"))
    dk, dv, dbp = flash_attention_train_bwd_dkdv(q, k, v, bias, seed, rate,
                                                 g, pstats, pbits)
    pdk, pdv, pdbp = flash_attention_train_bwd_dkdv_plain(
        q, k, v, bias, seed, rate, g, pstats, pbits)
    _close_report("dk pass", dk, pdk)
    _close_report("dv pass", dv, pdv)
    _close_report("dbias partials", dbp, pdbp)
    if q.shape[1] > 1:  # at L = 1, dS = P (dP - D) = 0: dbias is 0
        assert _rel(dbp, pdbp) <= 1e-3


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,L", [(1, 1), (2, 98), (1, 162), (3, 257)])
def test_attention_train_bwd_passes_match_plain(gen, B, L, rate):
    """#6's two passes run at every L; each holds to its plain version."""
    q, k, v = _heads(gen, B, L, strided=True)
    bias = _bias(gen, B, L)
    g = torch.randn(B, L, N, D, generator=gen, device="cuda").bfloat16()
    _passes_match_plain(q, k, v, bias, 7 + L, rate, g)


# the long-caption lengths and the tiles' edges beyond them
LONG_TRAIN_CASES = [(1, 257), (2, 339), (1, 512), (3, 419), (1, 450),
                    (3, 511)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,L", LONG_TRAIN_CASES)
def test_attention_train_long_kernels_match_plain(gen, B, L, rate):
    q, k, v = _heads(gen, B, L, strided=True)
    bias = _bias(gen, B, L)
    g = torch.randn(B, L, N, D, generator=gen, device="cuda").bfloat16()
    seed = 99 + L
    _close_report("fwd", flash_attention_train_fwd(q, k, v, bias, seed, rate),
                  flash_attention_train_plain(q, k, v, bias, seed, rate))
    passes = (flash_attention_train_bwd_dq, flash_attention_train_bwd_dkdv)
    before = [f.launches for f in passes]
    got = flash_attention_train_bwd(q, k, v, bias, seed, rate, g)
    assert [f.launches - b for f, b in zip(passes, before)] == [1, 1]
    want = flash_attention_train_bwd_plain(q, k, v, bias, seed, rate, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close_report(name, a, b)
    # dbias sums n * L terms per key in another order: in relative norm
    assert _rel(got[3], want[3]) <= 1e-3
    _passes_match_plain(q, k, v, bias, seed, rate, g)
    # no atomics: a second call gives the same bits
    again = flash_attention_train_bwd(q, k, v, bias, seed, rate, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_attention_train_mask_at_512_is_the_plain_philox_mask(gen):
    """q = k = 0, bias 0, v = the first 64 columns of I: output column c of
    row i is Pd[i, c] for c < 64 (keys 0..63 of 512)."""
    L, rate, seed = 512, 0.5, 78
    q = torch.zeros(1, L, 1, D, device="cuda").bfloat16()
    v = torch.eye(L, D, device="cuda").bfloat16().reshape(1, L, 1, D)
    bias = torch.zeros(1, 1, 1, L, device="cuda")
    out = flash_attention_train_fwd(q, q, v, bias, seed, rate)[0, :, 0, :]
    keep = keep_mask(seed, rate, 1, 1, L, L, "cuda")[0, 0, :, :D]
    assert torch.equal(out != 0, keep)
    assert torch.all(out[keep] == 2.0 / L)


def test_train_step_kernel_path_matches_eager_path(gen):
    """One AdamW step at rate 0 from the same weights: "pallas-train" (the
    training kernels) against "xla" (eager attention)."""
    cfg = UC2Config(vocab_size=1000, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    max_position_embeddings=130, img_dim=64,
                    dtype="bfloat16", hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0,
                    use_pallas_attention="pallas-train")
    B, Lt, Nb, M = 4, 30, 20, 6
    mask = torch.ones(B, Lt + Nb, dtype=torch.long, device="cuda")
    mask[0, 20:Lt] = 0
    batch = {"input_ids": torch.randint(4, 1000, (B, Lt), generator=gen,
                                        device="cuda"),
             "img_feat": torch.randn(B, Nb, 64, generator=gen, device="cuda"),
             "img_pos_feat": torch.rand(B, Nb, 7, generator=gen,
                                        device="cuda"),
             "attn_mask": mask,
             "masked_pos": torch.randint(1, 20, (B, M), generator=gen,
                                         device="cuda"),
             "masked_weight": torch.ones(B, M, device="cuda"),
             "txt_labels": torch.randint(4, 1000, (B, M), generator=gen,
                                         device="cuda")}
    out = {}
    for impl in ("pallas-train", "xla"):
        model = UC2ForPretraining(cfg.replace(use_pallas_attention=impl),
                                  device="cuda", seed=3)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = build_optimizer(model, constant(1e-3), grad_norm=5.0)
        m = train_step(model, opt, batch, DropoutRng(0, "cuda"))
        out[impl] = (m["loss"].item(), m["grad_norm"].item(),
                     {n: p.detach() - start[n]
                      for n, p in model.named_parameters()})
    (lk, nk, dk), (le, ne, de) = out["pallas-train"], out["xla"]
    assert abs(lk - le) <= 1e-2 and abs(nk - ne) <= 2e-2 * ne
    # Adam's first update is ~lr * sign(g): a gradient near 0 may flip sign
    # between the two bf16 paths (a difference of up to 2 lr); few may
    diff = torch.cat([(dk[n] - de[n]).abs().flatten() for n in dk])
    assert diff.max().item() <= 2.05e-3
    assert (diff > 1e-4).float().mean().item() <= 1e-2


# the training FFN kernels (#9 forward, #10 backward): #10's tiles are
# 128-row product tiles, 64-row row-pass tiles and 128 columns of F, its
# weight gradients split the rows from 4096 on; F = 384 is a width other
# than uc2-base's that the wrappers take
FFN_CASES = ([(rows, 3072) for rows in (1, 17, 31, 33, 63, 64, 65, 129, 4097,
                                        20736)]
             + [(rows, 384) for rows in (1, 63, 64, 65, 129, 4097)])
# dW1, dW2 and the vector gradients are sums over every row, taken in
# another order than the plain version's: held in relative norm
FFN_GRAD_RTOL = 1e-3


def _ffn_args(gen, rows, F=3072):
    def w(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.05).bfloat16()
    x = torch.randn(rows, H, generator=gen, device="cuda").bfloat16()
    return (x, w(F, H), _vec(gen, F, 0.02), w(H, F), _vec(gen, H, 0.02),
            _vec(gen, H, 0.1, 1.0), _vec(gen, H, 0.1))


def _rel(a, b):
    torch.cuda.synchronize()
    a, b = a.float(), b.float()
    assert torch.isfinite(a).all()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows,F", FFN_CASES)
def test_ffn_train_kernels_match_plain(gen, rows, F, rate):
    """#9 and #10 against their plain versions; #10 launched once a call
    and repeated bit for bit."""
    args = _ffn_args(gen, rows, F=F)
    seed = 99 + rows
    _close_report("fwd", fused_ffn_block_train_fwd(*args, seed, rate),
                  fused_ffn_block_train_plain(*args, seed, rate))
    dy = torch.randn(rows, H, generator=gen, device="cuda").bfloat16()
    bwd_args = (*args[:6], seed, rate, 1e-12, dy)
    before = fused_ffn_block_train_bwd.launches
    got = fused_ffn_block_train_bwd(*bwd_args)
    assert fused_ffn_block_train_bwd.launches == before + 1
    want = fused_ffn_block_train_bwd_plain(*bwd_args)
    _close_report("dx", got[0], want[0])
    for name, a, b in zip(("dW1", "db1", "dW2", "db2", "dgamma", "dbeta"),
                          got[1:], want[1:]):
        assert _rel(a, b) <= FFN_GRAD_RTOL, (name, _rel(a, b))
    again = fused_ffn_block_train_bwd(*bwd_args)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.parametrize("rows,F", [(1, 3072), (65, 3072), (129, 384),
                                    (20736, 3072)])
def test_ffn_train_fwd_at_rate_0_is_fused_ffn_block(gen, rows, F):
    """#9 is #3's kernel with the dropout in its epilogue: at rate 0 it
    launches #3's kernel, so the two agree bit for bit."""
    args = _ffn_args(gen, rows, F=F)
    before = (fused_ffn_block_train_fwd.launches, fused_ffn_block.launches)
    got = fused_ffn_block_train_fwd(*args, 7, 0.0)
    assert torch.equal(got, fused_ffn_block(*args))
    assert (fused_ffn_block_train_fwd.launches - before[0],
            fused_ffn_block.launches - before[1]) == (1, 1)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_train_fwd_is_bitwise_repeatable(gen, rate):
    args = _ffn_args(gen, 64 * 132 + 1)     # one tile past a wave
    first = fused_ffn_block_train_fwd(*args, 5, rate)
    for _ in range(3):
        assert torch.equal(first, fused_ffn_block_train_fwd(*args, 5, rate))


def test_ffn_train_fwd_refuses_a_misaligned_x(gen):
    """TMA reads x from a 16-byte boundary: a contiguous x that starts
    elsewhere raises and is never computed by the plain version."""
    x, *rest = _ffn_args(gen, 64, F=256)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = fused_ffn_block_train_fwd.launches
    with pytest.raises(ValueError):
        fused_ffn_block_train_fwd(shifted, *rest, 1, 0.1)
    assert fused_ffn_block_train_fwd.launches == before


def test_ffn_train_bwd_is_bitwise_repeatable(gen):
    args = _ffn_args(gen, 2000)
    dy = torch.randn(2000, H, generator=gen, device="cuda").bfloat16()
    a, b = (fused_ffn_block_train_bwd(*args[:6], 5, 0.1, 1e-12, dy)
            for _ in range(2))
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_ffn_train_mask_is_the_plain_philox_mask(gen):
    """x = 0, W2 = 0, b2 = 1, gamma = 1, beta = 0, rate 0.5: the pre-LN
    row is 2 where kept and 0 where dropped, so the output is positive
    exactly where the mask keeps (rows that keep all or nothing skipped)."""
    rows, rate, seed = 256, 0.5, 41
    x, w1, b1, _, _, _, _ = _ffn_args(gen, rows, F=256)
    x.zero_()
    w2 = torch.zeros(H, 256, device="cuda").bfloat16()
    out = fused_ffn_block_train_fwd(
        x, w1, b1, w2, torch.ones(H, device="cuda"),
        torch.ones(H, device="cuda"), torch.zeros(H, device="cuda"), seed,
        rate)
    keep = ffn_keep_mask(seed, rate, rows, H, "cuda")
    mixed = keep.any(1) & ~keep.all(1)
    assert mixed.sum() > rows // 2
    assert torch.equal((out > 0)[mixed], keep[mixed])


def test_ffn_train_autograd_runs_both_kernels(gen):
    x, w1, b1, w2, b2, gamma, beta = _ffn_args(gen, 96, F=256)
    leaves = [t.requires_grad_(True) for t in (x, w1, b1, w2, b2, gamma,
                                                beta)]
    before = (fused_ffn_block_train_fwd.launches,
              fused_ffn_block_train_bwd.launches)
    out = fused_ffn_block_train(*leaves, 3, 0.1)
    dy = torch.randn_like(out)
    out.backward(dy)
    assert (fused_ffn_block_train_fwd.launches - before[0],
            fused_ffn_block_train_bwd.launches - before[1]) == (1, 1)
    want = fused_ffn_block_train_bwd_plain(*(t.detach() for t in leaves[:6]),
                                           3, 0.1, 1e-12, dy)
    _close_report("dx", x.grad, want[0])
    assert w1.grad.dtype == torch.bfloat16 and b1.grad.dtype == torch.float32
    for a, b in zip((w1.grad, b1.grad, w2.grad, b2.grad, gamma.grad,
                     beta.grad), want[1:]):
        assert _rel(a, b) <= 2.0 ** -7        # dW rounded to bf16


def test_ffn_train_wrappers_refuse(gen):
    x, w1, b1, w2, b2, gamma, beta = _ffn_args(gen, 64, F=256)
    dy = torch.zeros_like(x)
    with pytest.raises(TypeError):                       # fp32 x
        fused_ffn_block_train_fwd(x.float(), w1, b1, w2, b2, gamma, beta, 1,
                                  0.1)
    with pytest.raises(TypeError):
        fused_ffn_block_train_bwd(x.float(), w1, b1, w2, b2, gamma, 1, 0.1,
                                  1e-12, dy.float())
    h = 64                                               # H != 768
    small = (x[:, :h].contiguous(), w1[:, :h].contiguous(), b1,
             w2[:h].contiguous(), b2[:h].contiguous(), gamma[:h].contiguous(),
             beta[:h].contiguous())
    with pytest.raises(ValueError):
        fused_ffn_block_train_fwd(*small, 1, 0.1)
    with pytest.raises(ValueError):
        fused_ffn_block_train_bwd(*small[:6], 1, 0.1, 1e-12,
                                  dy[:, :h].contiguous())
    xt = torch.zeros(H, 64, device="cuda").bfloat16().t()   # not contiguous
    with pytest.raises(ValueError):
        fused_ffn_block_train_fwd(xt, w1, b1, w2, b2, gamma, beta, 1, 0.1)
    with pytest.raises(ValueError):
        fused_ffn_block_train_bwd(xt, w1, b1, w2, b2, gamma, 1, 0.1, 1e-12,
                                  dy)
    with pytest.raises(ValueError):                      # F not a multiple of 128
        fused_ffn_block_train_fwd(x, w1[:192].contiguous(), b1[:192].contiguous(),
                                  w2[:, :192].contiguous(), b2, gamma, beta,
                                  1, 0.1)


def test_train_step_ffn_kernel_path_matches_eager_path(gen, monkeypatch):
    """One AdamW step at rate 0 from the same weights: "pallas-train" with
    UC2_FFN_TRAIN=1 (#5, #6, #9 and #10 in every layer) against "xla"."""
    monkeypatch.setenv("UC2_FFN_TRAIN", "1")
    cfg = UC2Config(vocab_size=1000, num_hidden_layers=2,
                    intermediate_size=256, max_position_embeddings=130,
                    img_dim=64, dtype="bfloat16", hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0,
                    use_pallas_attention="pallas-train")
    B, Lt, Nb, M = 4, 30, 20, 6
    mask = torch.ones(B, Lt + Nb, dtype=torch.long, device="cuda")
    mask[0, 20:Lt] = 0
    batch = {"input_ids": torch.randint(4, 1000, (B, Lt), generator=gen,
                                        device="cuda"),
             "img_feat": torch.randn(B, Nb, 64, generator=gen, device="cuda"),
             "img_pos_feat": torch.rand(B, Nb, 7, generator=gen,
                                        device="cuda"),
             "attn_mask": mask,
             "masked_pos": torch.randint(1, 20, (B, M), generator=gen,
                                         device="cuda"),
             "masked_weight": torch.ones(B, M, device="cuda"),
             "txt_labels": torch.randint(4, 1000, (B, M), generator=gen,
                                         device="cuda")}
    out = {}
    for impl in ("pallas-train", "xla"):
        model = UC2ForPretraining(cfg.replace(use_pallas_attention=impl),
                                  device="cuda", seed=3)
        before = (fused_ffn_block_train_fwd.launches,
                  fused_ffn_block_train_bwd.launches)
        opt = build_optimizer(model, constant(1e-3), grad_norm=5.0)
        m = train_step(model, opt, batch, DropoutRng(0, "cuda"))
        launched = (fused_ffn_block_train_fwd.launches - before[0],
                    fused_ffn_block_train_bwd.launches - before[1])
        assert launched == ((2, 2) if impl == "pallas-train" else (0, 0))
        out[impl] = (m["loss"].item(), m["grad_norm"].item())
    (lk, nk), (le, ne) = out["pallas-train"], out["xla"]
    assert abs(lk - le) <= 1e-2 and abs(nk - ne) <= 2e-2 * ne


# kernel #7: the attention block with the QKV projection inside
def _v2_args(gen, B, L):
    def w(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.05).bfloat16()
    x = torch.randn(B, L, H, generator=gen, device="cuda").bfloat16()
    return (x, w(3 * H, H), _vec(gen, 3 * H, 0.05), _bias(gen, B, L), w(H, H),
            _vec(gen, H, 0.02), _vec(gen, H, 0.1, 1.0), _vec(gen, H, 0.1), N)


@pytest.mark.parametrize("B,L", [(1 + i % 3, L) for i, L in
                                 enumerate(BLOCK_EDGES)]
                         + [(67, 128), (3, 45), (2, 162), (1, 512)])
def test_fused_attn_block_v2_kernel_matches_plain(gen, B, L):
    """BLOCK_EDGES at B = 1-3 (L = 45 and 162 end in a ragged query tile;
    257 and up take clusters of more than eight blocks), one grid past a
    whole wave; each call repeated bit for bit, one launch a call."""
    args = _v2_args(gen, B, L)
    before = fused_attn_block_v2.launches
    out = fused_attn_block_v2(*args)
    _close(out, fused_attn_block_v2_plain(*args))
    assert torch.equal(fused_attn_block_v2(*args), out)
    assert fused_attn_block_v2.launches == before + 2
    for _ in range(REPEATS_PAST_A_WAVE if B > 3 else 0):
        assert torch.equal(fused_attn_block_v2(*args), out)


def test_fused_attn_block_v2_refuses(gen):
    x, w_qkv, b_qkv, bias, wo, bo, gamma, beta, n = _v2_args(gen, 1, 16)
    with pytest.raises(TypeError):                       # fp32 activations
        fused_attn_block_v2(x.float(), w_qkv, b_qkv, bias, wo, bo, gamma,
                            beta, n)
    with pytest.raises(ValueError):                      # head_dim 128
        fused_attn_block_v2(x, w_qkv, b_qkv, bias, wo, bo, gamma, beta, 6)
    args = _v2_args(gen, 1, 513)                        # past the limit
    with pytest.raises(ValueError):
        fused_attn_block_v2(*args)
    buf = torch.zeros(16 * H + 1, device="cuda").bfloat16()
    with pytest.raises(ValueError):                      # x 2 bytes off
        fused_attn_block_v2(buf[1:].view(1, 16, H), w_qkv, b_qkv, bias, wo,
                            bo, gamma, beta, n)
    wbuf = torch.zeros(3 * H * H + 1, device="cuda").bfloat16()
    with pytest.raises(ValueError):                      # w_qkv 2 bytes off
        fused_attn_block_v2(x, wbuf[1:].view(3 * H, H), b_qkv, bias, wo, bo,
                            gamma, beta, n)
    with pytest.raises(RuntimeError):                    # no backward
        fused_attn_block_v2(x.requires_grad_(True), w_qkv, b_qkv, bias, wo,
                            bo, gamma, beta, n)


# kernels #12, #12a, #12b: the "flash" route's segment-masked attention
def _segment_bias(B, L, case):
    """'valid': every key; 'invalid': most keys invalid (all but the first
    10 of each row); 'first_block': keys from 128 on invalid, so the
    invalid rows see their whole first 128-key block masked; 'leading':
    keys 0..127 invalid, so the valid rows do."""
    mask = torch.ones(B, L, device="cuda")
    if case == "invalid":
        mask[:, 10:] = 0.0
    elif case == "first_block":
        mask[:, 128:] = 0.0
    elif case == "leading":
        mask[:, :128] = 0.0
    return ((1.0 - mask) * -10000.0)[:, None, None, :].contiguous()


# the edges of #12's 128-key blocks and 64-row query tiles (L = 1 and 65
# too, which the wrappers take though the "flash" route calls them from
# L = 128), B = 1-3 and one grid past a wave of 132 SMs (64 x 12 x 3
# blocks)
SEGMENT_CASES = [(2, 128, "valid"), (2, 128, "invalid"), (1, 129, "valid"),
                 (1, 129, "invalid"), (3, 162, "valid"), (3, 162, "invalid"),
                 (1, 200, "first_block"), (1, 384, "valid"),
                 (2, 384, "invalid"), (1, 512, "valid"),
                 (1, 512, "invalid"), (3, 162, "first_block"),
                 (1, 255, "leading"), (2, 256, "first_block"),
                 (3, 257, "invalid"), (1, 512, "leading"),
                 (64, 162, "invalid"), (1, 1, "valid"), (2, 65, "invalid"),
                 # #12a's 64-key tile edges inside the library's last
                 # 128-key block, where its sweep stops short of Lp
                 (1, 192, "valid"), (2, 192, "invalid"),
                 (1, 192, "first_block"), (1, 193, "valid"),
                 (2, 193, "invalid"), (3, 193, "first_block"),
                 (1, 200, "leading")]


@pytest.mark.parametrize("B,L,case", SEGMENT_CASES)
def test_segment_flash_kernels_match_plain(gen, B, L, case):
    q, k, v = _heads(gen, B, L, strided=True)
    bias = _segment_bias(B, L, case)
    g = torch.randn(B, L, N, D, generator=gen, device="cuda").bfloat16()
    before = sf.segment_flash_fwd.launches
    out, stats = sf.segment_flash_fwd(q, k, v, bias)
    assert sf.segment_flash_fwd.launches == before + 1
    pout, pstats = sf.segment_flash_plain(q, k, v, bias)
    _close_report("out", out, pout)
    _close_report("m", stats[0], pstats[0])
    _close_report("l", stats[1], pstats[1])
    again = sf.segment_flash_fwd(q, k, v, bias)
    assert torch.equal(out, again[0]) and torch.equal(stats, again[1])
    # each backward kernel on the same inputs as its plain version
    dq, di = sf.segment_flash_bwd_dq(q, k, v, bias, pout, g, pstats)
    pdq, pdi = sf.segment_flash_bwd_dq_plain(q, k, v, bias, pout, g, pstats)
    _close_report("dq", dq, pdq)
    _close_report("di", di, pdi)
    dk, dv = sf.segment_flash_bwd_dkdv(q, k, v, bias, g, pstats, pdi)
    pdk, pdv = sf.segment_flash_bwd_dkdv_plain(q, k, v, bias, g, pstats, pdi)
    _close_report("dk", dk, pdk)
    _close_report("dv", dv, pdv)
    # the autograd Function: #12, then #12a and #12b
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    before = [f.launches for f in (sf.segment_flash_fwd,
                                   sf.segment_flash_bwd_dq,
                                   sf.segment_flash_bwd_dkdv)]
    sf.segment_flash_attention(*leaves, bias).backward(g)
    assert [f.launches - b for f, b in zip(
        (sf.segment_flash_fwd, sf.segment_flash_bwd_dq,
         sf.segment_flash_bwd_dkdv), before)] == [1, 1, 1]
    want = (pdq, *sf.segment_flash_bwd_dkdv_plain(q, k, v, bias, g, pstats,
                                                  pdi))
    for name, a, b in zip(("dq", "dk", "dv"), (t.grad for t in leaves), want):
        _close_report(f"autograd {name}", a, b)


def test_segment_flash_dkdv_at_the_mlm_shape(gen):
    """#12b at the "flash" mlm step's (B, L) = (128, 162) against its plain
    version, launched once a call and repeated bit for bit."""
    B, L = 128, 162
    q, k, v = _heads(gen, B, L, strided=True)
    bias = _bias(gen, B, L)
    g = torch.randn(B, L, N, D, generator=gen, device="cuda").bfloat16()
    out, stats = sf.segment_flash_fwd(q, k, v, bias)
    _, di = sf.segment_flash_bwd_dq(q, k, v, bias, out, g, stats)
    before = sf.segment_flash_bwd_dkdv.launches
    dk, dv = sf.segment_flash_bwd_dkdv(q, k, v, bias, g, stats, di)
    assert sf.segment_flash_bwd_dkdv.launches == before + 1
    pdk, pdv = sf.segment_flash_bwd_dkdv_plain(q, k, v, bias, g, stats, di)
    _close_report("dk", dk, pdk)
    _close_report("dv", dv, pdv)
    for _ in range(2):
        again = sf.segment_flash_bwd_dkdv(q, k, v, bias, g, stats, di)
        assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


def test_segment_flash_dq_at_the_mlm_shape(gen):
    """#12a at the "flash" mlm step's (B, L) = (128, 162) against its plain
    version (dq and di), launched once a call and repeated bit for bit."""
    B, L = 128, 162
    q, k, v = _heads(gen, B, L, strided=True)
    bias = _bias(gen, B, L)
    g = torch.randn(B, L, N, D, generator=gen, device="cuda").bfloat16()
    out, stats = sf.segment_flash_fwd(q, k, v, bias)
    before = sf.segment_flash_bwd_dq.launches
    dq, di = sf.segment_flash_bwd_dq(q, k, v, bias, out, g, stats)
    assert sf.segment_flash_bwd_dq.launches == before + 1
    pdq, pdi = sf.segment_flash_bwd_dq_plain(q, k, v, bias, out, g, stats)
    _close_report("dq", dq, pdq)
    _close_report("di", di, pdi)
    for _ in range(2):
        again = sf.segment_flash_bwd_dq(q, k, v, bias, out, g, stats)
        assert torch.equal(dq, again[0]) and torch.equal(di, again[1])


def test_segment_flash_backward_is_bitwise_repeatable(gen):
    q, k, v = _heads(gen, 2, 300, strided=True)
    bias = _segment_bias(2, 300, "invalid")
    g = torch.randn(2, 300, N, D, generator=gen, device="cuda").bfloat16()
    out, stats = sf.segment_flash_fwd(q, k, v, bias)
    runs = []
    for _ in range(2):
        dq, di = sf.segment_flash_bwd_dq(q, k, v, bias, out, g, stats)
        runs.append((dq, di, *sf.segment_flash_bwd_dkdv(q, k, v, bias, g,
                                                        stats, di)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_segment_flash_wrappers_refuse(gen):
    q, k, v = _heads(gen, 1, 130, strided=False)
    bias = _segment_bias(1, 130, "valid")
    with pytest.raises(TypeError):                       # fp32 activations
        sf.segment_flash_fwd(q.float(), k.float(), v.float(), bias)
    with pytest.raises(ValueError):                      # head_dim 32
        sf.segment_flash_fwd(*(t[..., :32].contiguous() for t in (q, k, v)),
                             bias)
    q2, k2, v2 = _heads(gen, 1, 513, strided=False)     # past the limit
    with pytest.raises(ValueError):
        sf.segment_flash_fwd(q2, k2, v2, _segment_bias(1, 513, "valid"))
    out, stats = sf.segment_flash_fwd(q, k, v, bias)
    with pytest.raises(TypeError):                       # fp32 gradient
        sf.segment_flash_bwd_dq(q, k, v, bias, out, out.float(), stats)
    with pytest.raises(ValueError):                      # stats of another L
        sf.segment_flash_bwd_dq(q, k, v, bias, out, out, stats[..., :64])
    # a gradient off the 16-byte boundary TMA reads from
    _, di = sf.segment_flash_bwd_dq(q, k, v, bias, out, out, stats)
    buf = torch.empty(out.numel() + 1, dtype=out.dtype, device="cuda")
    g = buf[1:].view(out.shape)
    g.copy_(out)
    with pytest.raises(ValueError):
        sf.segment_flash_bwd_dkdv(q, k, v, bias, g, stats, di)


@pytest.mark.parametrize("route,Nb", [("v2", 66), ("v2", 100), ("flash", 66),
                                      ("flash", 100)])
def test_encoder_v2_and_flash_paths_match_eager_path(gen, monkeypatch, route,
                                                     Nb):
    """Scoring at full width (2 layers): under "pallas" with UC2_ATTN_V2=1,
    #7 and #3 in every layer and no #2; under "flash", #12 in every layer
    and none of the fused blocks; scores against the eager path."""
    if route == "v2":
        monkeypatch.setenv("UC2_ATTN_V2", "1")
    impl = True if route == "v2" else "flash"
    cfg = UC2Config(vocab_size=1000, num_hidden_layers=2,
                    max_position_embeddings=130, img_dim=64,
                    dtype="bfloat16", use_pallas_attention=impl)
    model = UC2ForImageTextRetrieval(cfg, device="cuda", seed=1)
    eager = UC2ForImageTextRetrieval(cfg.replace(use_pallas_attention=False),
                                     device="cuda")
    eager.load_state_dict(model.state_dict())
    B, Lt = 4, 62
    mask = torch.ones(B, Lt + Nb, dtype=torch.long, device="cuda")
    mask[0, 20:Lt] = 0
    mask[1, Lt + Nb // 2:] = 0
    ids = torch.randint(4, 1000, (B, Lt), generator=gen, device="cuda")
    ids[0, 20:] = 1
    batch = {"input_ids": ids,
             "img_feat": torch.randn(B, Nb, 64, generator=gen, device="cuda"),
             "img_pos_feat": torch.rand(B, Nb, 7, generator=gen,
                                        device="cuda"),
             "attn_mask": mask}
    kernels = (fused_attn_block_v2, fused_attn_block, fused_ffn_block,
               sf.segment_flash_fwd, flash_attention)
    before = [f.launches for f in kernels]
    got = model.scores(batch)
    launched = [f.launches - b for f, b in zip(kernels, before)]
    assert launched == ([2, 0, 2, 0, 0] if route == "v2"
                        else [0, 0, 0, 2, 0])
    assert torch.isfinite(got).all()
    assert (got - eager.scores(batch)).abs().max().item() <= 5e-2


def test_train_step_flash_path_matches_eager_path(gen):
    """One AdamW step at attention dropout 0 from the same weights at joint
    L = 130: "flash" (#12, #12a, #12b in every layer) against "xla"."""
    cfg = UC2Config(vocab_size=1000, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    max_position_embeddings=130, img_dim=64,
                    dtype="bfloat16", hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0,
                    use_pallas_attention="flash")
    B, Lt, Nb, M = 4, 30, 100, 6
    mask = torch.ones(B, Lt + Nb, dtype=torch.long, device="cuda")
    mask[0, 20:Lt] = 0
    mask[1, Lt + 60:] = 0
    batch = {"input_ids": torch.randint(4, 1000, (B, Lt), generator=gen,
                                        device="cuda"),
             "img_feat": torch.randn(B, Nb, 64, generator=gen, device="cuda"),
             "img_pos_feat": torch.rand(B, Nb, 7, generator=gen,
                                        device="cuda"),
             "attn_mask": mask,
             "masked_pos": torch.randint(1, 20, (B, M), generator=gen,
                                         device="cuda"),
             "masked_weight": torch.ones(B, M, device="cuda"),
             "txt_labels": torch.randint(4, 1000, (B, M), generator=gen,
                                         device="cuda")}
    kernels = (sf.segment_flash_fwd, sf.segment_flash_bwd_dq,
               sf.segment_flash_bwd_dkdv)
    out = {}
    for impl in ("flash", "xla"):
        model = UC2ForPretraining(cfg.replace(use_pallas_attention=impl),
                                  device="cuda", seed=3)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        before = [f.launches for f in kernels]
        opt = build_optimizer(model, constant(1e-3), grad_norm=5.0)
        m = train_step(model, opt, batch, DropoutRng(0, "cuda"))
        launched = [f.launches - b for f, b in zip(kernels, before)]
        assert launched == ([2, 2, 2] if impl == "flash" else [0, 0, 0])
        out[impl] = (m["loss"].item(), m["grad_norm"].item(),
                     {n: p.detach() - start[n]
                      for n, p in model.named_parameters()})
    (lk, nk, dk), (le, ne, de) = out["flash"], out["xla"]
    assert abs(lk - le) <= 1e-2 and abs(nk - ne) <= 2e-2 * ne
    diff = torch.cat([(dk[n] - de[n]).abs().flatten() for n in dk])
    assert diff.max().item() <= 2.05e-3
    assert (diff > 1e-4).float().mean().item() <= 1e-2


# kernel #8: the whole encoder layer
def _layer_args(gen, B, L, strided=True, F=3072):
    def w(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.02).bfloat16()
    q, k, v = _heads(gen, B, L, strided)
    x = torch.randn(B, L, H, generator=gen, device="cuda").bfloat16()
    return (q, k, v, _bias(gen, B, L), x, w(H, H), _vec(gen, H, 0.01),
            _vec(gen, H, 0.1, 1.0), _vec(gen, H, 0.1), w(F, H),
            _vec(gen, F, 0.01), w(H, F), _vec(gen, H, 0.01),
            _vec(gen, H, 0.1, 1.0), _vec(gen, H, 0.1))


@pytest.mark.parametrize("B,L,strided", [(1, 1, True), (2, 98, True),
                                         (2, 128, False), (3, 162, True),
                                         (1, 257, False), (1, 512, True),
                                         (3, 1, False), (2, 63, False),
                                         (3, 64, True), (1, 65, False),
                                         (2, 129, True), (1, 162, False),
                                         (2, 257, True), (23, 162, True)])
def test_fused_layer_block_kernel_matches_plain(gen, B, L, strided):
    """The edges of the 64-row query tiles (L = 1, 63, 64, 65, 129 and the
    padded last tiles of 98, 162 and 257), the key tiles of 512, heads as
    views into one projection and contiguous, and B = 23 at L = 162: 138
    clusters' blocks on 132 SMs, past a wave, repeated ten times."""
    args = _layer_args(gen, B, L, strided)
    before = fused_layer_block.launches
    out = fused_layer_block(*args)
    _close(out, fused_layer_block_plain(*args))
    assert fused_layer_block.launches == before + 1
    past_a_wave = 2 * B * -(-L // 64) > 132
    for _ in range(10 if past_a_wave else 1):                # bitwise repeat
        assert torch.equal(fused_layer_block(*args), out)


@pytest.mark.parametrize("F", [64, 128])
def test_fused_layer_block_at_narrow_ffn_widths(gen, F):
    """F = 64 and 128: warpgroups whose W rings carry fewer slots than the
    ring has, one or two chunks in all."""
    args = _layer_args(gen, 2, 65, F=F)
    out = fused_layer_block(*args)
    _close(out, fused_layer_block_plain(*args))
    assert torch.equal(fused_layer_block(*args), out)


def test_fused_layer_block_takes_other_ffn_widths(gen):
    args = _layer_args(gen, 2, 40, F=1024)
    out = fused_layer_block(*args)
    _close(out, fused_layer_block_plain(*args))
    assert torch.equal(fused_layer_block(*args), out)


def test_fused_layer_block_refuses(gen):
    args = list(_layer_args(gen, 1, 16))
    bad = list(args)
    bad[4] = bad[4].float()                               # fp32 activations
    with pytest.raises(TypeError):
        fused_layer_block(*bad)
    bad = list(args)
    bad[7] = bad[7].bfloat16()                            # bf16 LayerNorm
    with pytest.raises(TypeError):
        fused_layer_block(*bad)
    long_args = _layer_args(gen, 1, 513)                  # past the limit
    with pytest.raises(ValueError):
        fused_layer_block(*long_args)
    # hidden 512 (8 heads of 64): not the kernel's 768
    q, k, v = (t[:, :, :8].contiguous() for t in args[:3])
    Hs = 512
    small = (q, k, v, args[3], args[4][..., :Hs].contiguous(),
             args[5][:Hs, :Hs].contiguous(), *(a[:Hs] for a in args[6:9]),
             args[9][:, :Hs].contiguous(), args[10],
             args[11][:Hs].contiguous(), *(a[:Hs] for a in args[12:]))
    with pytest.raises(ValueError):
        fused_layer_block(*small)
    buf = torch.empty(args[9].numel() + 1, dtype=args[9].dtype, device="cuda")
    w1 = buf[1:].view(args[9].shape)                      # 2 bytes off
    w1.copy_(args[9])
    with pytest.raises(ValueError):
        fused_layer_block(*args[:9], w1, *args[10:])
    with pytest.raises(RuntimeError):                     # no backward
        fused_layer_block(*args[:4], args[4].requires_grad_(True), *args[5:])


# kernel #11: attention with unnormalised bf16 probabilities, on the
# streamed core: every edge of its 64-row query and key tiles, heads as
# views into one projection and as contiguous tensors
@pytest.mark.parametrize("B,L,strided", [(1, 1, True), (2, 98, True),
                                         (2, 162, False), (1, 512, True)]
                         + [(2 if L > 256 else 3, L, strided)
                            for L in (1, 2, 63, 64, 65, 98, 162, 257, 512)
                            for strided in (True, False)])
def test_attention_bf16_probs_kernel_matches_plain(gen, B, L, strided):
    q, k, v = _heads(gen, B, L, strided)
    bias = _bias(gen, B, L)
    before = attention_bf16_probs.launches
    out = attention_bf16_probs(q, k, v, bias)
    _close(out, attention_bf16_probs_plain(q, k, v, bias))
    assert attention_bf16_probs.launches == before + 1
    assert torch.equal(attention_bf16_probs(q, k, v, bias), out)


def test_attention_bf16_probs_refuses(gen):
    q, k, v = _heads(gen, 1, 16, strided=True)
    bias = _bias(gen, 1, 16)
    with pytest.raises(TypeError):
        attention_bf16_probs(q.float(), k.float(), v.float(), bias)
    with pytest.raises(ValueError):                       # head_dim 32
        attention_bf16_probs(*(t[..., :32] for t in (q, k, v)), bias)
    q, k, v = _heads(gen, 1, 513, strided=True)
    with pytest.raises(ValueError):
        attention_bf16_probs(q, k, v, _bias(gen, 1, 513))



@pytest.mark.parametrize("rows,shape,small", [
    (2, (208, 100), True), (2, (176, 36), True), (2, (56, 100), True),
    (250002, (208, 62), False), (514, (208, 62), False)])
def test_embedding_backward_repeats_bit_for_bit(gen, rows, shape, small):
    """The encoder's embedding gradients on the card: the few-row tables
    (token types, region mask) through ``SmallTableLookup``, whose masked
    sums give the same bits on every backward and equal the embedding
    backward's up to the order of its sums; the word and position tables
    through the embedding backward, whose sums repeat at the training
    shapes' duplicate counts (here 2080 copies of the mask token)."""
    from uc2_torch.models.encoder import SmallTableLookup
    table = torch.nn.Embedding(rows, H, device="cuda")
    ids = torch.randint(0, min(rows, 64), shape, generator=gen,
                        device="cuda")
    if rows == 250002:
        ids[:, 0], ids[:, -1], ids[:, 5:15] = 0, 2, rows - 1
    g = torch.randn(*shape, H, generator=gen, device="cuda")

    def lookup():
        if small:
            return SmallTableLookup.apply(table.weight, ids)
        return table(ids)
    grads = []
    for _ in range(5):
        table.weight.grad = None
        lookup().backward(g)
        grads.append(table.weight.grad.clone())
    assert all(torch.equal(x, grads[0]) for x in grads[1:])
    table.weight.grad = None
    table(ids).backward(g)
    torch.testing.assert_close(grads[0], table.weight.grad, rtol=1e-5,
                               atol=1e-3)
    assert torch.equal(lookup(), table(ids))


# ------------------------------------------ the objectives' heads and IPOT
OBJ_TINY = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=66, img_dim=32, img_label_dim=11,
                dtype="float32", hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, use_pallas_attention=False)
OBJ_TASKS = ("mmxlm", "vmlm-soft", "mmxlm-soft", "mrfr", "mrm-nce", "mrc",
             "mrc-kl", "itm-ot")


def _objective_batch(task, cfg, B, Lt, Nb, seed=1):
    """A collated batch of ``task`` from the port's datasets over an
    in-memory corpus of the config's widths (11 detector classes), and the
    label vocabulary's valid ids."""
    import numpy as np
    from uc2_torch.data import datasets as D
    from uc2_torch.data.collate import BucketSpec
    from uc2_torch.data.labels import LabelVocab, hash_tokenize
    from uc2_torch.data.memdb import synth_pretrain_corpus
    txt_db, img_db = synth_pretrain_corpus(
        5, n_imgs=2 * B, txt_per_img=1, vocab=cfg.vocab_size,
        img_dim=cfg.img_dim, n_classes=11, min_bb=Nb // 2, max_bb=Nb,
        max_words=(Lt - 4) // 4)
    vocab = LabelVocab(
        tokenize=lambda w: hash_tokenize(w, vocab_size=cfg.vocab_size),
        words={"en": [f"en{i}" for i in range(10)]})
    ds = {"mmxlm": lambda: D.MmxlmDataset(txt_db, img_db, 0.4, vocab),
          "vmlm-soft": lambda: D.VmlmSoftDataset(txt_db, img_db, 0.4, vocab),
          "mmxlm-soft": lambda: D.MmxlmSoftDataset(txt_db, img_db, 0.4,
                                                   vocab),
          "mrfr": lambda: D.MrfrDataset(txt_db, img_db, 0.4),
          "mrm-nce": lambda: D.MrmNceDataset(txt_db, img_db, 0.4,
                                             neg_size=16),
          "mrc": lambda: D.MrcDataset(txt_db, img_db, 0.4),
          "mrc-kl": lambda: D.MrcDataset(txt_db, img_db, 0.4),
          "itm-ot": lambda: D.ItmDataset(txt_db, img_db, 0.5)}[task]()
    rng = np.random.default_rng(seed)
    if hasattr(ds, "new_epoch"):
        ds.new_epoch(rng)
    spec = BucketSpec(Lt, Nb, B, type(ds).slot_budget(Lt, Nb))
    batch = ds.collate([ds.get_example(i, rng) for i in range(B)], spec)
    return ({k: torch.from_numpy(v) for k, v in batch.items()},
            vocab.valid_ids)


def _loss_and_grads(model, batch, task, valid_ids, rng=None):
    from uc2_torch.training.step import make_loss_fn
    for p in model.parameters():
        p.grad = None
    loss, _ = make_loss_fn(task, valid_ids=valid_ids, itm_ot_lambda=0.1)(
        model, batch, rng)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in
                           model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("task", OBJ_TASKS)
def test_objective_heads_on_the_card_match_the_cpu(gen, task):
    """Each new objective's loss and every gradient at fp32 on the card
    against the same model on the CPU (the eager encoder on both): the
    heads, the restricted decoder, the NCE logits and IPOT, at 1e-4."""
    cfg = UC2Config(**OBJ_TINY)
    batch, valid_ids = _objective_batch(task, cfg, 4, 24, 8)
    cpu = UC2ForPretraining(cfg, device="cpu", seed=0)
    card = UC2ForPretraining(cfg, device="cuda", seed=0)
    card.load_state_dict(cpu.state_dict())
    want, wg = _loss_and_grads(cpu, batch, task, valid_ids)
    got, gg = _loss_and_grads(card, {k: v.cuda() for k, v in batch.items()},
                              task, valid_ids)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert set(gg) == set(wg)
    for n in wg:
        torch.testing.assert_close(gg[n].cpu(), wg[n], rtol=1e-4, atol=1e-4,
                                   msg=n)


def test_ipot_on_the_card_matches_the_cpu(gen):
    """optimal_transport_dist at the itm-ot path's shape (B = 128, 62 text
    tokens, 100 regions, D = 768, padded rows) in fp32 on the card against
    the CPU: the distances and both gradients at 1e-4."""
    from uc2_torch.models.ot import optimal_transport_dist
    B, M, Nr = 128, 62, 100
    txt = torch.randn(B, M, H, generator=gen, device="cuda")
    img = torch.randn(B, Nr, H, generator=gen, device="cuda")
    tl = torch.randint(10, M + 1, (B,), generator=gen, device="cuda")
    il = torch.randint(10, Nr + 1, (B,), generator=gen, device="cuda")
    tpad = torch.arange(M, device="cuda")[None] >= tl[:, None]
    ipad = torch.arange(Nr, device="cuda")[None] >= il[:, None]
    tpad[0], ipad[0] = False, False
    w = torch.randn(B, generator=gen, device="cuda")
    out = []
    for dev in ("cuda", "cpu"):
        x = txt.to(dev).clone().requires_grad_(True)
        y = img.to(dev).clone().requires_grad_(True)
        d = optimal_transport_dist(x, y, tpad.to(dev), ipad.to(dev))
        (d * w.to(dev)).sum().backward()
        out.append([t.detach().cpu() for t in (d, x.grad, y.grad)])
    for a, b in zip(*out):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("task", ["mrm-nce", "itm-ot"])
def test_objective_backward_repeats_bit_for_bit(gen, monkeypatch, task):
    """The mrm-nce and itm-ot steps' loss and every gradient on a 768-wide,
    two-layer bf16 model under "pallas-train" with UC2_FFN_TRAIN=1 at
    dropout 0.1 (the training kernels #5, #6, #9, #10 in each layer): two
    runs from the same weights and seeds give the same bits."""
    monkeypatch.setenv("UC2_FFN_TRAIN", "1")
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        num_hidden_layers=2, vocab_size=1000, img_label_dim=11,
        dtype="bfloat16", use_pallas_attention="pallas-train")
    batch, valid_ids = _objective_batch(task, cfg, 16, 30, 36)
    batch = {k: v.cuda() for k, v in batch.items()}
    model = UC2ForPretraining(cfg, device="cuda", seed=0)
    runs = [_loss_and_grads(model, batch, task, valid_ids,
                            DropoutRng(11, "cuda")) for _ in range(2)]
    (l0, g0), (l1, g1) = runs
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    assert set(g0) == set(g1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def _rank_batch(cfg, S, groups, accum, Lt, Nb, seed=2):
    """A stacked batch of ``accum`` micro-batches of ``groups`` rank groups
    of ``S`` rows (ItmRankDataset over an in-memory gallery of the
    config's widths)."""
    import numpy as np
    from uc2_torch.data import datasets as D
    from uc2_torch.data.collate import BucketSpec
    from uc2_torch.data.memdb import synth_gallery
    txt_db, img_db = synth_gallery(seed=seed, n_imgs=4 * groups,
                                   txt_per_img=1, vocab=cfg.vocab_size,
                                   img_dim=cfg.img_dim, min_bb=Nb // 2,
                                   max_bb=Nb, max_words=(Lt - 2) // 2)
    ds = D.ItmRankDataset(txt_db, img_db, (S - 1) // 2)
    rng = np.random.default_rng(seed)
    micro = []
    for a in range(accum):
        ex = [e for i in range(a * groups, (a + 1) * groups)
              for e in ds.get_example(i, rng)]
        b = ds.collate(ex, BucketSpec(Lt, Nb, len(ex), 0))
        micro.append({k: v for k, v in b.items() if k != "targets"})
    return {k: torch.from_numpy(np.stack([m[k] for m in micro])).float()
            if micro[0][k].dtype == np.float16 else
            torch.from_numpy(np.stack([m[k] for m in micro]))
            for k in micro[0]}


def test_rank_step_on_the_card_matches_the_cpu(gen):
    """One retrieval finetuning step (itm-rank, two stacked micro-batches,
    AdamW with the itm config's clip) at fp32 on the card against the same
    model on the CPU (the eager encoder on both; weights moved off their
    init so that the scores spread): the loss, the grad norm, every
    gradient and every updated parameter at 1e-4."""
    from uc2_torch.training.optim import build_optimizer, constant
    cfg = UC2Config(**OBJ_TINY)
    batch = _rank_batch(cfg, 3, 4, 2, 24, 8)
    cpu = UC2ForImageTextRetrieval(cfg, device="cpu", seed=0)
    noise = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(torch.randn(p.shape, generator=noise) * 0.2)
    card = UC2ForImageTextRetrieval(cfg, device="cuda", seed=0)
    card.load_state_dict(cpu.state_dict())
    out = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        opt = build_optimizer(model, constant(1e-3), grad_norm=2.0)
        m = train_step(model, opt, {k: v.to(dev) for k, v in batch.items()},
                       DropoutRng(1, dev), task="itm-rank", sample_size=3)
        out.append((m["loss"].cpu(), m["grad_norm"].cpu(),
                    {n: p.grad.cpu() for n, p in model.named_parameters()},
                    {k: v.cpu() for k, v in model.state_dict().items()}))
    (lc, nc, gc, pc), (lg, ng, gg, pg) = out
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ng, nc, rtol=1e-4, atol=1e-4)
    for k in gc:
        torch.testing.assert_close(gg[k], gc[k], rtol=1e-4, atol=1e-4, msg=k)
    for k in pc:
        torch.testing.assert_close(pg[k], pc[k], rtol=1e-4, atol=1e-4, msg=k)


def test_rank_step_repeats_bit_for_bit(gen):
    """The rank step on a 768-wide, two-layer bf16 model under "pallas" at
    dropout 0.1 (#5 and #6's passes in every layer of both micro-batches):
    two steps from the same weights and seeds give the same loss, grad
    norm and parameters bit for bit."""
    from uc2_torch.training.optim import build_optimizer, constant
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        num_hidden_layers=2, vocab_size=1000, dtype="bfloat16")
    batch = {k: v.cuda() for k, v in _rank_batch(cfg, 3, 13, 2, 62,
                                                 100).items()}
    model = UC2ForImageTextRetrieval(cfg, device="cuda", seed=0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    before = flash_attention_train_fwd.launches
    for _ in range(2):
        model.load_state_dict(start)
        opt = build_optimizer(model, constant(1e-4), grad_norm=2.0)
        m = train_step(model, opt, batch, DropoutRng(5, "cuda"),
                       task="itm-rank", sample_size=3)
        runs.append((m["loss"], m["grad_norm"],
                     {k: v.clone() for k, v in model.state_dict().items()}))
    assert flash_attention_train_fwd.launches - before == 2 * 2 * 2
    (l0, n0, p0), (l1, n1, p1) = runs
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    assert torch.equal(n0, n1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


# tensor parallelism: shards of T = 2, 3, 4 and 12 of the heads (#2) and of
# the intermediate (#3), at tile edges and one grid past a wave
PARTIAL_ATTN_CASES = [(1, 1, 2), (2, 65, 3), (3, 129, 4), (2, 162, 12),
                      (1, 512, 2), (67, 128, 4)]


@pytest.mark.parametrize("B,L,T", PARTIAL_ATTN_CASES)
def test_fused_attn_block_partial_sums_to_the_whole_block(gen, B, L, T):
    from uc2_torch.ops.fused_block import (block_epilogue,
                                           fused_attn_block_partial,
                                           fused_attn_block_partial_plain)
    q, k, v = _heads(gen, B, L, strided=True)
    bias = _bias(gen, B, L)
    x = torch.randn(B, L, H, generator=gen, device="cuda").bfloat16()
    wo = (torch.randn(H, H, generator=gen, device="cuda") * 0.05).bfloat16()
    bo, gamma, beta = (_vec(gen, H, 0.02), _vec(gen, H, 0.1, 1.0),
                       _vec(gen, H, 0.1))
    n = N // T
    parts = []
    before = fused_attn_block_partial.launches
    for m in range(T):
        sl = slice(m * n, (m + 1) * n)
        args = (q[:, :, sl], k[:, :, sl], v[:, :, sl], bias,
                wo[:, m * n * D:(m + 1) * n * D].contiguous())
        out = fused_attn_block_partial(*args)
        assert out.dtype == torch.float32 and out.shape == (B, L, H)
        _close(out, fused_attn_block_partial_plain(*args))
        for _ in range(REPEATS_PAST_A_WAVE if B > 3 else 1):
            assert torch.equal(fused_attn_block_partial(*args), out)
        parts.append(out)
    assert fused_attn_block_partial.launches > before
    _close(block_epilogue(sum(parts), bo, x, gamma, beta),
           fused_attn_block(q, k, v, bias, x, wo, bo, gamma, beta))


@pytest.mark.parametrize("rows,T", [(1, 2), (65, 4), (129, 3), (10368, 2),
                                    (257, 12)])
def test_fused_ffn_block_partial_sums_to_the_whole_block(gen, rows, T):
    from uc2_torch.ops.fused_block import (block_epilogue,
                                           fused_ffn_block_partial,
                                           fused_ffn_block_partial_plain)
    F = 3072
    x = torch.randn(rows, H, generator=gen, device="cuda").bfloat16()
    w1 = (torch.randn(F, H, generator=gen, device="cuda") * 0.05).bfloat16()
    w2 = (torch.randn(H, F, generator=gen, device="cuda") * 0.05).bfloat16()
    b1, b2 = _vec(gen, F, 0.02), _vec(gen, H, 0.02)
    gamma, beta = _vec(gen, H, 0.1, 1.0), _vec(gen, H, 0.1)
    Fl = F // T
    parts = []
    for m in range(T):
        sl = slice(m * Fl, (m + 1) * Fl)
        args = (x, w1[sl].contiguous(), b1[sl].contiguous(),
                w2[:, sl].contiguous())
        out = fused_ffn_block_partial(*args)
        _close(out, fused_ffn_block_partial_plain(*args))
        assert torch.equal(fused_ffn_block_partial(*args), out)
        parts.append(out)
    _close(block_epilogue(sum(parts), b2, x, gamma, beta),
           fused_ffn_block(x, w1, b1, w2, b2, gamma, beta))


@pytest.mark.parametrize("B,L", [(3, 65), (2, 162), (1, 512)])
@pytest.mark.parametrize("T", [2, 4])
def test_attention_train_by_global_head_is_the_whole_launch(gen, B, L, T):
    """#5 and #6a on each shard of the heads, keyed by the shard's first
    head among the 12, give those heads of the whole launch bit for bit:
    output, dQ, row statistics and keep bits."""
    q, k, v = _heads(gen, B, L, strided=True)
    bias = _bias(gen, B, L)
    g = torch.randn(B, L, N, D, generator=gen, device="cuda").bfloat16()
    args = (q, k, v, bias, 77, 0.1)
    out = flash_attention_train_fwd(*args)
    dq, st, bits = flash_attention_train_bwd_dq(*args, g)
    n = N // T
    for m in range(T):
        sl = slice(m * n, (m + 1) * n)
        sargs = (q[:, :, sl], k[:, :, sl], v[:, :, sl], bias, 77, 0.1)
        got = flash_attention_train_fwd(*sargs, m * n, N)
        assert torch.equal(got, out[:, :, sl])
        _close(got, flash_attention_train_plain(*sargs, m * n, N))
        sdq, sst, sbits = flash_attention_train_bwd_dq(
            *sargs, g[:, :, sl].contiguous(), m * n, N)
        assert torch.equal(sdq, dq[:, :, sl])
        assert torch.equal(sst, st[:, :, sl])
        assert torch.equal(sbits, bits[:, sl])


@pytest.mark.parametrize("B,L,T", [(1, 1, 2), (2, 65, 3), (3, 129, 4),
                                   (2, 162, 12), (1, 512, 2), (67, 128, 4),
                                   (64, 162, 2)])
def test_fused_attn_block_v2_partial_sums_to_the_whole_block(gen, B, L, T):
    """#7's partial mode on every shard (a column half of 3, 2 or 1 heads,
    or 1 and none at T = 12) against its plain version, repeated bit for
    bit; the shards summed with the epilogue against the whole #7."""
    from uc2_torch.ops.fused_block import (block_epilogue,
                                           fused_attn_block_v2_partial,
                                           fused_attn_block_v2_partial_plain)
    x, w_qkv, b_qkv, bias, wo, bo, gamma, beta, n = _v2_args(gen, B, L)
    nl = n // T
    parts = []
    before = fused_attn_block_v2_partial.launches
    for m in range(T):
        args = (x, shard_tensor(w_qkv, "qkv", m, T),
                shard_tensor(b_qkv, "qkv", m, T), bias,
                wo[:, m * nl * D:(m + 1) * nl * D].contiguous(), nl)
        out = fused_attn_block_v2_partial(*args)
        assert out.dtype == torch.float32 and out.shape == (B, L, H)
        _close(out, fused_attn_block_v2_partial_plain(*args))
        for _ in range(REPEATS_PAST_A_WAVE if B > 3 else 1):
            assert torch.equal(fused_attn_block_v2_partial(*args), out)
        parts.append(out)
    assert fused_attn_block_v2_partial.launches > before
    _close(block_epilogue(sum(parts), bo, x, gamma, beta),
           fused_attn_block_v2(x, w_qkv, b_qkv, bias, wo, bo, gamma, beta, n))


FFN_PARTIAL_CASES = [(1, 2), (65, 4), (129, 3), (5184, 4), (20736, 2)]


def _ffn_shard(args, m, T):
    x, w1, b1, w2, b2 = args[:5]
    Fl = w1.shape[0] // T
    sl = slice(m * Fl, (m + 1) * Fl)
    return (x, w1[sl].contiguous(), b1[sl].contiguous(),
            w2[:, sl].contiguous(), b2 if m == 0 else None)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows,T", FFN_PARTIAL_CASES)
def test_ffn_train_fwd_partial_sums_to_the_whole_kernel(gen, rows, T, rate):
    """#9's partial mode on every shard (b2 on shard 0) against its plain
    version; the shards summed with the residual and the LayerNorm against
    the whole #9 on the same seed; at rate 0 a shard without b2 is #3's
    partial mode, bit for bit."""
    from uc2_torch.ops.ffn_train import (fused_ffn_block_train_partial_fwd,
                                         fused_ffn_block_train_partial_plain)
    from uc2_torch.ops.fused_block import (fused_ffn_block_partial,
                                           layer_norm_f32)
    args = _ffn_args(gen, rows)
    seed = 7 + rows
    parts = []
    for m in range(T):
        sargs = _ffn_shard(args, m, T)
        out = fused_ffn_block_train_partial_fwd(*sargs, seed, rate)
        assert out.dtype == torch.float32
        _close_report("partial", out,
                      fused_ffn_block_train_partial_plain(*sargs, seed, rate))
        assert torch.equal(fused_ffn_block_train_partial_fwd(*sargs, seed,
                                                             rate), out)
        if rate == 0.0 and m > 0:
            assert torch.equal(out, fused_ffn_block_partial(*sargs[:4]))
        parts.append(out)
    x, gamma, beta = args[0], args[5], args[6]
    got = layer_norm_f32(sum(parts) + x.float(), gamma, beta, 1e-12)
    _close_report("summed", got.to(x.dtype),
                  fused_ffn_block_train_fwd(*args, seed, rate))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows,T", FFN_PARTIAL_CASES)
def test_ffn_train_bwd_partial_sums_to_the_whole_kernel(gen, rows, T, rate):
    """#10's partial mode on every shard against its plain version (the
    summed gradients in relative norm), repeated bit for bit; the shards'
    dx summed plus dy_pre, and their weight gradients gathered, against
    the whole #10 on the same dy. The whole kernel takes dy_pre from its
    own recomputed forward, so its bf16 dy2 and da may round another way
    than the shards' (at one row dW1 moved by 1.07e-3 in relative norm
    on the H100): those are held to 2^-7, as #10 against autograd."""
    from uc2_torch.ops.ffn_train import (
        _forward_to_stats, fused_ffn_block_train_partial_bwd,
        fused_ffn_block_train_partial_bwd_plain)
    args = _ffn_args(gen, rows)
    seed, eps = 11 + rows, 1e-12
    dy = torch.randn(rows, H, generator=gen, device="cuda").bfloat16()
    whole = fused_ffn_block_train_bwd(*args[:6], seed, rate, eps, dy)
    # dy_pre: the LayerNorm's backward of dy (what autograd hands the
    # shards), from the plain forward's statistics
    *_, yhat, inv = _forward_to_stats(*args[:5], seed, rate, eps)
    dyn = dy.float() * args[5]
    dy_pre = (inv * (dyn - dyn.mean(-1, keepdim=True)
                     - yhat * (dyn * yhat).mean(-1, keepdim=True))
              ).contiguous()
    parts = []
    before = fused_ffn_block_train_partial_bwd.launches
    for m in range(T):
        x, w1, b1, w2, _ = _ffn_shard(args, m, T)
        got = fused_ffn_block_train_partial_bwd(x, w1, b1, w2, seed, rate,
                                                dy_pre)
        want = fused_ffn_block_train_partial_bwd_plain(x, w1, b1, w2, seed,
                                                       rate, dy_pre)
        _close_report("dx_part", got[0], want[0])
        for name, a, b in zip(("dW1", "db1", "dW2", "db2"), got[1:],
                              want[1:]):
            assert _rel(a, b) <= FFN_GRAD_RTOL, (name, _rel(a, b))
        again = fused_ffn_block_train_partial_bwd(x, w1, b1, w2, seed, rate,
                                                  dy_pre)
        assert all(torch.equal(u, v) for u, v in zip(got, again))
        parts.append(got)
    assert fused_ffn_block_train_partial_bwd.launches == before + 2 * T
    _close_report("dx", sum(p[0].float() for p in parts) + dy_pre, whole[0])
    for i, dim in ((1, 0), (2, 0), (3, 1)):       # dW1, db1, dW2 gathered
        assert _rel(torch.cat([p[i] for p in parts], dim), whole[i]) \
            <= 2.0 ** -7, i
    for p in parts:                               # db2, whole on each shard
        assert _rel(p[4], whole[4]) <= 2.0 ** -7
