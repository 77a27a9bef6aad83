"""The flash kernels' wrapper rules, on the CPU: no card and no memory.

``_check_shapes`` refuses B*H*Sq*Sk >= 2^32 only with dropout, whose hash
keys its mask by a 32-bit flat (b, h, i, j) index. ``head_strides`` takes
the layouts the kernels read (the forward through rank-4 (D, S, H, B) TMA
maps, the backward by 16-byte copies: base and strides in whole 16-byte
units, last dim contiguous) and refuses the rest. Inputs are ``meta``
tensors or small CPU views: only shapes, strides and base addresses are
read. ``check_tf32_drops`` (the f32 wide route's guard) is driven through
a stand-in probe: it raises, naming the card, where the probe's products
are rounded, and probes a device once.
"""
import pytest
import torch

from sct_gan_tpu_torch.ops import flash_attention as fa
from sct_gan_tpu_torch.ops.flash_attention import _check_shapes, head_strides


def _head_view(b, s, h=8, d=96, device="meta"):
    """The model's (B, H, S, d) view of its (B, S, H*d) projections."""
    x = torch.empty(b, s, h * d, dtype=torch.bfloat16, device=device)
    return x.view(b, s, h, d).transpose(1, 2)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_check_shapes_limits_the_flat_index_only_with_dropout(rate):
    """B=512 at L=1024 (the analyzer's batch_size=512): 512*8*1024*1024 is
    exactly 2^32, taken without dropout and refused with it."""
    q = _head_view(512, 1024)
    assert q.shape[0] * q.shape[1] * q.shape[2] * q.shape[2] == 2 ** 32
    if rate > 0.0:
        with pytest.raises(ValueError, match="dropout"):
            _check_shapes(q, q, q, rate)
    else:
        assert _check_shapes(q, q, q, rate) == (512, 8, 1024, 1024, 96)


def test_check_shapes_takes_dropout_below_the_limit():
    q = _head_view(511, 1024)
    assert _check_shapes(q, q, q, 0.3) == (511, 8, 1024, 1024, 96)


def test_check_shapes_refuses_another_head_dim():
    """The kernels have instances for head dims 64, 96 and 128 only; the
    wrapper pads any other head dim before it reaches them."""
    for d in (64, 128):
        q = _head_view(2, 64, d=d)
        assert _check_shapes(q, q, q, 0.0) == (2, 8, 64, 64, d)
    q = _head_view(2, 64, d=80)
    with pytest.raises(ValueError, match="head dim"):
        _check_shapes(q, q, q, 0.0)


@pytest.mark.parametrize("b,s", [(8, 1024), (2, 1000), (4, 2048)])
def test_head_strides_takes_the_models_head_views(b, s):
    """(B, S, H*96) viewed as heads: byte strides 192 (h), 1536 (s) and
    S*1536 (b), all whole 16-byte units, read as they are."""
    q = _head_view(b, s)
    assert head_strides(q, "q", 16) == (s * 768, 96, 768)


def test_head_strides_takes_a_contiguous_tensor():
    q = torch.empty(2, 8, 1000, 96, dtype=torch.bfloat16, device="meta")
    assert head_strides(q, "q", 16) == (8 * 1000 * 96, 1000 * 96, 96)


def test_head_strides_refuses_a_row_stride_off_16_bytes():
    """Rows of 100 bf16 (200 bytes) cut to 96: a TMA map cannot take the
    stride."""
    q = torch.empty(2, 8, 64, 100, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="16-byte"):
        head_strides(q[..., :96], "q", 16)


def test_head_strides_refuses_a_base_off_16_bytes():
    """A view starting 4 elements (8 bytes) into its storage."""
    flat = torch.zeros(2 * 8 * 16 * 96 + 8, dtype=torch.bfloat16)
    q = flat[4:4 + 2 * 8 * 16 * 96].view(2, 8, 16, 96)
    with pytest.raises(ValueError, match="16-byte"):
        head_strides(q, "q", 16)
    assert head_strides(q, "q", 4) == (8 * 16 * 96, 16 * 96, 96)


def test_head_strides_refuses_a_strided_last_dim():
    q = torch.empty(2, 8, 64, 96, dtype=torch.bfloat16,
                    device="meta").transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        head_strides(q, "q", 16)


@pytest.mark.parametrize("products,raises", [
    (fa.TF32_DROPPED, False),
    ([1 + 2.0 ** -10, -1 - 2.0 ** -10, 1 + 2.0 ** -10], True),  # rounded
])
def test_tf32_guard_probes_once_and_raises_where_bits_are_rounded(
        monkeypatch, products, raises):
    calls = []
    monkeypatch.setattr(fa, "_TF32_PROBED", set())
    monkeypatch.setattr(fa, "tf32_probe",
                        lambda device: calls.append(device) or products)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card X")
    dev = torch.device("cuda", 3)
    if raises:
        with pytest.raises(RuntimeError, match="card X: its TF32"):
            fa.check_tf32_drops(dev)
        with pytest.raises(RuntimeError):     # no fallback, no memory of it
            fa.check_tf32_drops(dev)
        assert len(calls) == 2
    else:
        fa.check_tf32_drops(dev)
        fa.check_tf32_drops(dev)
        assert calls == [dev]
