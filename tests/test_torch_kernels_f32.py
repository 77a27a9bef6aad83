"""The port's f32 CUDA kernels against their plain f32 versions, on a card.

The f32 instances of K1, the backward pair and K5
(``csrc/flash_attention_fwd_f32.cu``, ``flash_attention_bwd_f32.cu``,
``decode_attention_f32.cu``) at ``test_torch_kernels.py``'s cases, on
the same inputs in f32; K1 and the pair also on their wide route over
head dim 128 (column groups of 64-column chunks: 192, 256, 320, 384, 448
and 512 in place, on each side of the groups' edges; 160 on a padded
copy). Marked ``cuda``; without a card each test skips.
This file imports no JAX:

    python -m pytest --noconftest -m cuda -p no:cacheprovider tests/test_torch_kernels_f32.py

Tolerances: the kernels run every product in 3xTF32 (~2^-22 relative
each) and sum in another order than the plain version's full-f32
products, so the forward and K5 are held to 1e-5 and the gradients (one
more softmax, dS, and dK and dV summed over the queries) to 1e-4,
norm-wise; a bf16 query's output is rounded to bf16 on both sides once.
"""
import pytest
import torch

from sct_gan_tpu_torch.ops.attention import attention_keep
from sct_gan_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from sct_gan_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)
from test_torch_kernels import (DECODE_CASES, FLASH_CASES, PAIR_HEAD_DIMS,
                                _decode_inputs, _qkv_mask, _rel_err,
                                cuda_device)

FWD_TOL = 1e-5
BWD_TOL = 1e-4
# the long walk's plain f32 backward holds (8, 8192, 8192) f32 scores
# several times over: it stays with the bf16 tests
F32_FLASH_CASES = sorted(c for c in FLASH_CASES if c != "b1_sk8192")
# the f32 K1 and pair's head dims: the instances, then the wide route
# (nhead 4, 3 and 2 at d = 768, a padded copy; the column groups' edges:
# K1 and dQ one group to 256 and two from 320, dK and dV one group at 192,
# two to 384 and three from 448, a part-full last group at 320 and 448)
F32_HEAD_DIMS = (*PAIR_HEAD_DIMS, 160, 192, 256, 320, 384, 448, 512)


def _f32(device, case, d):
    """A case's inputs (``_qkv_mask``) in f32, the same layout."""
    q, k, v, mask = _qkv_mask(device, case, d)
    return q.float(), k.float(), v.float(), mask


@pytest.mark.cuda
@pytest.mark.parametrize("d", F32_HEAD_DIMS)
@pytest.mark.parametrize("case", F32_FLASH_CASES)
def test_f32_flash_forward_matches_plain_on_card(cuda_device, case, d):
    """The f32 K1 with dropout 0.3 and its LSE, at each f32 head dim:
    output in f32 within 1e-5 and the LSE of the rows that attend a key
    within 1e-5 norm-wise; a fully-masked row gives zeros and lse =
    -1e30."""
    causal, kind = FLASH_CASES[case][2:4]
    q, k, v, mask = _f32(cuda_device, case, d)
    args = dict(key_padding_mask=mask, causal=causal, dropout_rate=0.3,
                seed=77, return_lse=True)
    got, lse = flash_attention(q, k, v, **args)
    want, want_lse = flash_attention_reference(q, k, v, **args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _rel_err(got, want) <= FWD_TOL
    live = want_lse > -1e29          # a fully-masked row's is -1e30
    assert _rel_err(lse[live], want_lse[live]) <= FWD_TOL
    if kind == "one_row_empty":
        assert got[1].abs().max().item() == 0.0
        assert bool((lse[1] == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", F32_HEAD_DIMS)
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("case", F32_FLASH_CASES)
def test_f32_flash_backward_matches_autograd_on_card(cuda_device, case,
                                                     rate, d):
    """The f32 pair (D, dKV, dQ) vs autograd through the plain version,
    same dO: dq, dk, dv within 1e-4 norm-wise; a fully-masked row gets
    dq = 0; two runs give the same bits (no atomics)."""
    causal, kind = FLASH_CASES[case][2:4]
    q, k, v, mask = _f32(cuda_device, case, d)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    dout = torch.randn_like(q)
    args = dict(key_padding_mask=mask, causal=causal, dropout_rate=rate,
                seed=5)
    got = torch.autograd.grad(flash_attention(q, k, v, **args), (q, k, v),
                              dout)
    again = torch.autograd.grad(flash_attention(q, k, v, **args), (q, k, v),
                                dout)
    want = torch.autograd.grad(flash_attention_reference(q, k, v, **args),
                               (q, k, v), dout)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.float32 and _rel_err(a, w) <= BWD_TOL
        assert torch.equal(a, b)
    if kind == "one_row_empty":
        assert got[0][1].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 192, 384])
def test_f32_dropout_keep_bits_equal_the_plain_mask_on_card(cuda_device, d):
    """q = 0 makes P uniform over the attended keys, so with V the 64 x 64
    identity on one 64-key window (a key mask), in every 64-column chunk,
    the f32 K1's output is the keep bit over 64 / (1 - rate), or 0: every
    bit at (2, 8, 256, 256) equals the plain version's hash mask, at the
    64 instance and in each 64-column chunk of the wide route's one group
    at 192 and two groups at 384."""
    dev, b, h, s, rate = cuda_device, 2, 8, 256, 0.3
    q = torch.zeros(b, h, s, d, device=dev)
    k = torch.randn(b, h, s, d, device=dev)
    v = torch.eye(64, device=dev).repeat(s // 64, d // 64).expand(
        b, h, s, d).contiguous()
    want = attention_keep((b, h, s, s), 11, rate, None, dev)
    for c in range(d // 64):
        got = torch.empty_like(want)
        for w in range(s // 64):
            mask = torch.zeros(b, s, dtype=torch.bool, device=dev)
            mask[:, 64 * w:64 * (w + 1)] = True
            out = flash_attention(q, k, v, key_padding_mask=mask,
                                  dropout_rate=rate, seed=11)
            got[..., 64 * w:64 * (w + 1)] = out[..., 64 * c:64 * (c + 1)] > 0
        torch.cuda.synchronize()
        assert torch.equal(got, want), c


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16],
                         ids=["f32_query", "bf16_query"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_f32_decode_matches_plain_on_card(cuda_device, case, qdtype):
    """K5 over f32 caches (a bf16 query read as it is, the output in the
    query's dtype): within 1e-5 norm-wise for an f32 query, 1e-2 for a
    bf16 one (both sides round the same f32 value to bf16 once). A
    fully-masked row gives zeros; two runs give the same bits."""
    q, k, v, mask = _decode_inputs(cuda_device, case)
    q, k, v = q.to(qdtype), k.float(), v.float()
    got = decode_attention(q, k, v, mask, sm_scale=96 ** -0.5)
    again = decode_attention(q, k, v, mask, sm_scale=96 ** -0.5)
    want = decode_attention_reference(q, k, v, mask, sm_scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == qdtype
    assert _rel_err(got, want) <= (FWD_TOL if qdtype == torch.float32
                                   else 1e-2)
    assert torch.equal(got, again)
    if DECODE_CASES[case][3] == "row_empty":
        assert got[1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_f32_routes_raise_on_card(cuda_device):
    """An f32 head dim over 128 runs in the flash kernels (the wide route,
    within 1e-5 of the plain version) and one over 512 in K5 f32 (within
    1e-5 of the plain version); mixed q/k/v dtypes in the flash wrapper,
    and a bf16 cache under an f32 query raise; nothing is cast."""
    dev = cuda_device
    x = torch.randn(1, 2, 64, 192, device=dev)
    got = flash_attention(x, x, x)
    assert got.dtype == torch.float32
    assert _rel_err(got, flash_attention_reference(x, x, x)) <= FWD_TOL
    y = torch.randn(1, 2, 64, 64, device=dev)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(y, y.to(torch.bfloat16), y)
    z = torch.randn(1, 2, 64, 516, device=dev)
    got = decode_attention(z[:, :, :1], z, z, None, sm_scale=0.1)
    want = decode_attention_reference(z[:, :, :1], z, z, None, sm_scale=0.1)
    assert got.dtype == torch.float32
    assert _rel_err(got, want) <= FWD_TOL
    with pytest.raises(ValueError, match="dtypes"):
        decode_attention(y[:, :, :1], y.to(torch.bfloat16),
                         y.to(torch.bfloat16), None, sm_scale=0.1)


# K5 f32 at the head dims it runs in place past the paths' 64, 96 and 128
# (chip_smoke.py's k5_f32_checks), the 8-key instances at 768 and 1024 and
# the column-chunk route at 1280: name -> (B, S, mask lens or None, the
# live length of a cache cut to it or None); 768 / d heads, from 1 to 8.
K5_F32_HEAD_DIMS = (16, 48, 80, 132, 192, 256, 384, 768, 1024, 1280)
K5_F32_CASES = {
    "b2_source_mask": (2, 1024, (1024, 900), None),
    "b64_every_key": (64, 1024, None, None),
    "cut_cache_300": (2, 1024, None, 300),
    "s65_row_masked": (2, 65, (65, 0), None),
    "s1": (2, 1, None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16],
                         ids=["f32_query", "bf16_query"])
@pytest.mark.parametrize("case", sorted(K5_F32_CASES))
@pytest.mark.parametrize("d", K5_F32_HEAD_DIMS)
def test_f32_decode_head_dims_match_plain_on_card(cuda_device, d, case,
                                                  qdtype, monkeypatch):
    """K5 f32 in place at head dims that are multiples of 4 (16 to 1280):
    within 1e-5 norm-wise of the plain version for an f32 query, 1e-2 for
    a bf16 one; two runs give the same bits; a fully masked row gives
    zeros; no padded copy is made."""
    from sct_gan_tpu_torch.ops import decode_attention as k5
    b, s, lens, cut = K5_F32_CASES[case]
    h = max(1, min(8, 768 // d))
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randn(b, 1, h * d, generator=g, device=cuda_device).view(
        b, 1, h, d).transpose(1, 2).to(qdtype)
    if cut is None:
        k, v = (torch.randn(b, s, h * d, generator=g, device=cuda_device)
                .view(b, s, h, d).transpose(1, 2) for _ in range(2))
    else:
        k, v = (torch.randn(b, h, s, d, generator=g,
                            device=cuda_device)[:, :, :cut] for _ in range(2))
    mask = None if lens is None else (
        torch.arange(s, device=cuda_device)[None, :]
        < torch.tensor(lens, device=cuda_device)[:, None])
    copies = []
    pad = k5.pad_head_dim
    monkeypatch.setattr(k5, "pad_head_dim",
                        lambda t, dk: copies.append(dk) or pad(t, dk))
    got = decode_attention(q, k, v, mask, sm_scale=d ** -0.5)
    again = decode_attention(q, k, v, mask, sm_scale=d ** -0.5)
    want = decode_attention_reference(q, k, v, mask, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == qdtype
    assert _rel_err(got, want) <= (FWD_TOL if qdtype == torch.float32
                                   else 1e-2)
    assert torch.equal(got, again)
    assert copies == []
    if lens is not None and lens[-1] == 0:
        assert got[1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_f32_decode_pads_a_head_dim_off_16_bytes_on_card(cuda_device,
                                                          monkeypatch):
    """Head dim 30 (120-byte f32 rows) runs on one copy of each of q, k
    and v padded to 32, within 1e-5 of the plain version."""
    from sct_gan_tpu_torch.ops import decode_attention as k5
    g = torch.Generator(device=cuda_device).manual_seed(30)
    q, k, v = (torch.randn(2, 4, s, 30, generator=g, device=cuda_device)
               for s in (1, 300, 300))
    copies = []
    pad = k5.pad_head_dim
    monkeypatch.setattr(k5, "pad_head_dim",
                        lambda t, dk: copies.append(dk) or pad(t, dk))
    got = decode_attention(q, k, v, None, sm_scale=30 ** -0.5)
    want = decode_attention_reference(q, k, v, None, sm_scale=30 ** -0.5)
    assert copies == [32] * 3
    assert _rel_err(got, want) <= FWD_TOL


# The edges of the Hopper f32 kernels' tiles (csrc/flash_attention_fwd_f32.cu,
# flash_attention_bwd_f32.cu: 128-row forward blocks, 64-row backward
# blocks, 16- to 64-key and 16- to 32-query walked tiles; on the wide route
# 64-row blocks walking 64-key and 64-query tiles): name -> (B, H, Sq, Sk,
# causal, mask kind, layout). "rows" masks every key of batch row 1; "tail"
# keeps the first Sk - 3 keys of row 0 and a third of row 1; "heads" is the
# model's (B, H, S, d) view of (B, S, H*d) projections. sq65_sk127 and
# causal_sq127_sk65 sit one row past and one short of the wide route's
# 64-row tiles on both sides.
F32_EDGE_CASES = {
    "sk1": (2, 4, 64, 1, False, None, "bhsd"),
    "sq100_sk65": (2, 4, 100, 65, False, "tail", "bhsd"),
    "sq1_sk1000": (2, 4, 1, 1000, False, "tail", "bhsd"),
    "causal_sq100_sk300": (2, 4, 100, 300, True, None, "bhsd"),
    "causal_sq300_sk100": (2, 4, 300, 100, True, "tail", "bhsd"),
    "row_all_masked": (3, 4, 200, 200, False, "rows", "bhsd"),
    "strided_heads_257": (2, 4, 257, 257, False, "tail", "heads"),
    "sq65_sk127": (2, 4, 65, 127, False, "tail", "heads"),
    "causal_sq127_sk65": (2, 4, 127, 65, True, "tail", "bhsd"),
}


def _edge_inputs(device, case, d):
    """q, k, v (f32, seed 3, head dim d) and the key mask of an edge case."""
    b, h, sq, sk, causal, kind, layout = F32_EDGE_CASES[case]
    g = torch.Generator(device=device).manual_seed(3)

    def make(s):
        if layout == "heads":
            return torch.randn(b, s, h * d, generator=g, device=device).view(
                b, s, h, d).transpose(1, 2)
        return torch.randn(b, h, s, d, generator=g, device=device)
    q, k, v = make(sq), make(sk), make(sk)
    keys = torch.arange(sk, device=device)
    mask = None
    if kind == "tail":
        lens = torch.tensor([max(sk - 3, 1), max(sk // 3, 1), sk][:b],
                            device=device)
        mask = keys[None, :] < lens[:, None]
    elif kind == "rows":
        mask = torch.ones(b, sk, dtype=torch.bool, device=device)
        mask[1] = False
    return q, k, v, mask, causal


EDGE_PARAMS = [(c, d) for c in sorted(F32_EDGE_CASES) for d in F32_HEAD_DIMS]
EDGE_PARAMS.append(("causal_sq100_sk300", 16))   # the padded route, 16 -> 64


@pytest.mark.cuda
@pytest.mark.parametrize("case,d", EDGE_PARAMS)
def test_f32_flash_forward_tile_edges_on_card(cuda_device, case, d):
    """The f32 K1 with dropout 0.3 and its LSE at the edges of its tiles:
    within 1e-5 norm-wise of the plain version, the LSE of the rows that
    attend a key too; a row with no attended key gives zeros and lse =
    -1e30."""
    q, k, v, mask, causal = _edge_inputs(cuda_device, case, d)
    args = dict(key_padding_mask=mask, causal=causal, dropout_rate=0.3,
                seed=13, return_lse=True)
    got, lse = flash_attention(q, k, v, **args)
    want, want_lse = flash_attention_reference(q, k, v, **args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _rel_err(got, want) <= FWD_TOL
    live = want_lse > -1e29
    assert _rel_err(lse[live], want_lse[live]) <= FWD_TOL
    if case == "row_all_masked":
        assert got[1].abs().max().item() == 0.0
        assert bool((lse[1] == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("case,d", EDGE_PARAMS)
def test_f32_flash_backward_tile_edges_on_card(cuda_device, case, d, rate):
    """The f32 pair at the edges of its tiles: dq, dk, dv within 1e-4
    norm-wise of autograd through the plain version (a gradient that is
    exactly zero there, dq and dk at Sk = 1 where dS = 0, within 1e-4 of
    dv's norm); two runs give the same bits; a row with no attended key
    gets dq = 0."""
    q, k, v, mask, causal = _edge_inputs(cuda_device, case, d)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(4), device=cuda_device)
    args = dict(key_padding_mask=mask, causal=causal, dropout_rate=rate,
                seed=17)
    got = torch.autograd.grad(flash_attention(q, k, v, **args), (q, k, v),
                              dout)
    again = torch.autograd.grad(flash_attention(q, k, v, **args), (q, k, v),
                                dout)
    want = torch.autograd.grad(flash_attention_reference(q, k, v, **args),
                               (q, k, v), dout)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        ref = w.norm().item() or want[2].norm().item()
        assert a.dtype == torch.float32
        assert (a - w).norm().item() <= BWD_TOL * ref
        assert torch.equal(a, b)
    if case == "row_all_masked":
        assert got[0][1].abs().max().item() == 0.0
