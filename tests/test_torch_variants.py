"""The port's kernel-timing tools (K7-K10) and its profiling helpers against
the JAX package, on the CPU, same numpy inputs.

On the CPU each tool's wrapper runs its plain PyTorch version; the kernels
themselves are held against those on a card (``test_torch_kernels.py``,
``chip_smoke.py``). The TPU tools build their kernels inside ``main()``, so
the JAX side here is the JAX package where it has the function
(``mha_reference``, ``decode_attention`` in interpret mode, the dropout
hash) and otherwise a jnp transcription of the tool's kernel body, cited by
line, at one key block (nk == 1: the tools' BK = 1024 covers these S).

Tolerances: 1e-5 absolute and relative in f32 (the same arithmetic summed
in another order; an exponent's few-ulp differences stay below it); the
dropout variants bit for bit (integer hash, one bf16 multiply).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.ops.attention import mha_reference as jax_mha
from sct_gan_tpu.ops.decode_attention import \
    decode_attention as jax_decode_attention
from sct_gan_tpu.ops.dropout import _hash_keep
from sct_gan_tpu.utils.profiling import MetricsLogger as JaxMetricsLogger
from sct_gan_tpu.utils.profiling import StepTimer as JaxStepTimer
from sct_gan_tpu_torch.tools import time_decode_kernel_variants as k9
from sct_gan_tpu_torch.tools import time_dropout_kernel as k10
from sct_gan_tpu_torch.tools import time_flash_parts as k7
from sct_gan_tpu_torch.tools import time_flash_variants as k8
from sct_gan_tpu_torch.utils import profiling

TOL = dict(rtol=1e-5, atol=1e-5)
SEQ = {96: 128, 128: 256}       # head dim -> S of the test input
TOOLS = {"parts": (k7.flash_parts, k7.MODES),
         "variants": (k8.flash_variants, k8.MODES)}


def _x(dh: int, seed: int = 0) -> np.ndarray:
    """(B=2, H=2, S, dh) f32, the tools' q = k = v."""
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((2, 2, SEQ[dh], dh))).astype(np.float32)


def _dot(a, b):
    return jnp.einsum("bhqk,bhkd->bhqd", a, b,
                      preferred_element_type=jnp.float32)


def _scores(x, scale):
    return jnp.einsum("bhqd,bhkd->bhqk", x, x,
                      preferred_element_type=jnp.float32) * scale


def _jax_parts(x, mode):
    """tools/time_flash_parts.py:47-78 (init, one key block, fin)."""
    v = x
    s = _scores(x, 0.1)
    if mode == "full":
        m_prev = jnp.full(s.shape[:-1] + (1,), -1e30, jnp.float32)
        m_new = jnp.maximum(m_prev, jnp.max(s, axis=-1, keepdims=True))
        p = jnp.exp(s - m_new)
        alpha = jnp.exp(m_prev - m_new)
        l = 0.0 * alpha + jnp.sum(p, axis=-1, keepdims=True)
        acc = 0.0 * alpha + _dot(p.astype(v.dtype), v)
    elif mode == "noexp":
        p = jnp.clip(s, 0.0, 1.0)
        l = jnp.sum(p, axis=-1, keepdims=True)
        acc = _dot(p.astype(v.dtype), v)
    else:
        l = 1.0
        acc = _dot(s.astype(v.dtype), v)
    return (acc / jnp.maximum(l, 1e-9)).astype(x.dtype)


def _jax_variants(x, mode):
    """tools/time_flash_variants.py:45-72. bf16p takes the exponent of the
    bf16 argument in f32 and rounds it to bf16: XLA's own bf16 exp2 on the
    CPU approximates more coarsely than a bf16 step, so a transcription with
    it would test XLA's CPU approximation, not the tool's function."""
    v = x
    use2 = mode in ("exp2", "mxsum", "bf16p")
    s = _scores(x, 0.1 * (math.log2(math.e) if use2 else 1.0))
    if mode == "mmonly":
        return _dot(s.astype(v.dtype), v).astype(x.dtype)
    m = jnp.max(s, axis=-1, keepdims=True)
    if mode == "bf16p":
        arg = (s - m).astype(jnp.bfloat16).astype(jnp.float32)
        p = jnp.exp2(arg).astype(jnp.bfloat16).astype(jnp.float32)
    elif use2:
        p = jnp.exp2(s - m)
    else:
        p = jnp.exp(s - m)
    if mode == "masked":
        p = jnp.where(s > -1e29, p, 0.0)
    pv = p.astype(v.dtype)
    if mode == "mxsum":
        ones = jnp.ones(s.shape[-1:] + (128,), v.dtype)
        l = jnp.einsum("bhqk,kd->bhqd", pv, ones,
                       preferred_element_type=jnp.float32)[..., 0:1]
    else:
        l = jnp.sum(p, axis=-1, keepdims=True)
    acc = _dot(pv, v)
    return (acc / jnp.maximum(l, 1e-9)).astype(x.dtype)


JAX_BODIES = {"parts": _jax_parts, "variants": _jax_variants}


@pytest.mark.parametrize("dh", sorted(SEQ))
@pytest.mark.parametrize("tool,mode", [("parts", "full"), ("variants", "nk1"),
                                       ("variants", "exp2"),
                                       ("variants", "masked")])
def test_softmax_modes_match_jax_mha_reference(tool, mode, dh):
    """The softmax modes are attention at scale 0.1: the port's plain
    versions against the JAX package's ``mha_reference`` in f32."""
    x = _x(dh)
    want = jax_mha(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                   sm_scale=0.1)
    fn, _ = TOOLS[tool]
    got = fn(torch.from_numpy(x), mode)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dh", sorted(SEQ))
@pytest.mark.parametrize("tool,mode,rising",
                         [pytest.param("parts", m, False, id=f"parts-{m}")
                          for m in k7.MODES]
                         + [pytest.param("variants", m, False,
                                         id=f"variants-{m}")
                            for m in k8.MODES]
                         + [pytest.param("parts", m, True,
                                         id=f"parts-{m}-rising")
                            for m in k7.MODES])
def test_modes_match_the_tool_kernel_bodies(tool, mode, rising, dh):
    """Every mode of K7 and K8 against a jnp transcription of the TPU
    tool's kernel body, f32 inputs; K7 also on ``rising_max``'s input,
    whose row maxima rise along the keys."""
    x = _x(dh, seed=1)
    if rising:
        x = k7.rising_max(torch.from_numpy(x)).numpy()
    fn, _ = TOOLS[tool]
    got = fn(torch.from_numpy(x), mode).numpy()
    want = np.asarray(JAX_BODIES[tool](jnp.asarray(x), mode))
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_inputs_round_p_as_the_tool_does():
    """In bf16 the plain versions round P (and bf16p its exponent's
    argument) to bf16 before P V, as the tool bodies do: within one bf16
    step of the jnp transcription at the output's magnitude."""
    xb = _x(96, seed=2).astype(jnp.bfloat16)
    for tool, (fn, modes) in TOOLS.items():
        for mode in modes:
            got = fn(torch.from_numpy(xb.astype(np.float32)).to(
                torch.bfloat16), mode).float().numpy()
            want = np.asarray(JAX_BODIES[tool](jnp.asarray(xb), mode),
                              np.float32)
            step = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
            np.testing.assert_allclose(got, want, rtol=0, atol=step,
                                       err_msg=f"{tool} {mode}")


@pytest.mark.parametrize("dh", [64, 96, 128])
@pytest.mark.parametrize("seq", [128, 256])
@pytest.mark.parametrize("mode", ["v2", "v3"])
def test_decode_variants_match_jax_kernel(mode, seq, dh):
    """v2 and v3 compute K5's function at each head dim of the kernel's
    instances: against the JAX package's ``decode_attention`` in interpret
    mode, f32, a key mask with about 10% of keys off and one fully-masked
    row (zeros)."""
    rng = np.random.default_rng(seq + dh)
    q = rng.standard_normal((2, 2, 1, dh)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, seq, dh)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((2, seq)) > 0.1
    mask[1] = False
    scale = dh ** -0.5
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask),
                                sm_scale=scale, interpret=True)
    got = k9.decode_variants(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(mask),
                             mode, sm_scale=scale).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.all(got[1] == 0.0)


@pytest.mark.parametrize("dh,seq,mode", [(80, 64, "v2"), (192, 64, "v3"),
                                         (32, 64, "v2"), (96, 8193, "v2"),
                                         (96, 4097, "v3")])
def test_decode_variants_kernel_shape_raises_outside_its_instances(dh, seq,
                                                                   mode):
    """The K9 kernel has instances at head dims 64, 96 and 128 only, up to
    8192 keys (v2) and 4096 (v3): any other shape raises before a launch
    (``kernel_shape``, which the wrapper calls on a CUDA tensor)."""
    q = torch.zeros(1, 2, 1, dh)
    k = torch.zeros(1, 2, seq, dh)
    with pytest.raises(ValueError, match="not supported"):
        k9.kernel_shape(q, k, k, mode)


@pytest.mark.parametrize("dh", k9.HEAD_DIMS)
def test_decode_variants_kernel_shape_takes_its_instances(dh):
    """Every head dim of an instance, at the key limit of each mode."""
    q = torch.zeros(1, 2, 1, dh)
    for mode, seq in (("v2", k9.MAX_KEYS), ("v3", k9.MAX_SLAB_KEYS)):
        k = torch.zeros(1, 2, seq, dh)
        assert k9.kernel_shape(q, k, k, mode) == (1, 2, seq, dh)


def _jax_hash_bits(n: int, seed: int):
    """The murmur3 finaliser of sct_gan_tpu/ops/dropout.py:100-104, up to
    the bits that ``_hash_keep`` compares with its threshold."""
    h = jax.lax.iota(jnp.uint32, n)
    h = (h + jnp.uint32(seed)) * jnp.uint32(0x9E3779B1)
    h = (h ^ (h >> 16)) * jnp.uint32(0x85EBCA6B)
    h = (h ^ (h >> 13)) * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


def _jax_dropout_tool(x, mode, rate, seed):
    """tools/time_dropout_kernel.py:47-73 with the hash for the TPU's
    ``prng_random_bits`` (over the flat word index)."""
    if mode == "copy":
        return x * jnp.asarray(1.0001, x.dtype)
    inv = 1.0 / (1.0 - rate)
    n, c = x.shape
    if mode == "drop":
        bits = _jax_hash_bits(n * c, seed).reshape(n, c)
        keep = bits >= jnp.uint32(int(rate * 4294967296.0))
        return jnp.where(keep, x * jnp.asarray(inv, x.dtype),
                         jnp.zeros((), x.dtype))
    if mode == "byte4":
        bits = _jax_hash_bits(n * c // 4, seed).reshape(n, c // 4)
        thr8 = jnp.uint32(int(rate * 256.0))
        mult = jnp.concatenate(
            [jnp.where(((bits >> s) & jnp.uint32(0xFF)) >= thr8,
                       jnp.float32(inv), 0.0) for s in (0, 8, 16, 24)],
            axis=1)
    else:
        bits = _jax_hash_bits(n * c // 2, seed).reshape(n, c // 2)
        thr16 = jnp.uint32(int(rate * 65536.0))
        mult = jnp.concatenate(
            [jnp.where(((bits >> s) & jnp.uint32(0xFFFF)) >= thr16,
                       jnp.float32(inv), 0.0) for s in (0, 16)], axis=1)
    return x * mult.astype(x.dtype)


def test_hash_transcription_is_the_jax_package_hash():
    """The transcription above keeps exactly ``_hash_keep``'s masks."""
    for rate, seed in ((0.1, 0), (0.3, 2 ** 31 - 2)):
        want = _hash_keep((4096,), jnp.int32(seed), rate)
        got = _jax_hash_bits(4096, seed) >= jnp.uint32(
            int(min(rate, 0.999999) * 4294967296.0))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 12345])
@pytest.mark.parametrize("mode", k10.MODES)
def test_dropout_variants_match_jax_bit_for_bit(mode, seed):
    """Every mode at (256, 768) bf16, rate 0.1, bit for bit (bf16 bit
    patterns, so a dropped negative x must be -0 where the tool gives -0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((256, 768)).astype(np.float32)
    want = np.asarray(_jax_dropout_tool(jnp.asarray(x, jnp.bfloat16), mode,
                                        0.1, seed))
    got = k10.dropout_variants(torch.from_numpy(x).to(torch.bfloat16), mode,
                               0.1, seed)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    if mode != "copy":
        assert 0.05 < float((got == 0).float().mean()) < 0.15


def test_step_timer_summary_matches_jax():
    """Same recorded times: the same summary keys and values."""
    times = [0.012, 0.010, 0.031, 0.011, 0.0105, 0.013, 0.02]
    for tokens in (0, 8192):
        port, ref = profiling.StepTimer(tokens), JaxStepTimer(tokens)
        port.times, ref.times = list(times), list(times)
        got, want = port.summary(), ref.summary()
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-12)
    assert profiling.StepTimer().summary() == JaxStepTimer().summary() == {}


def test_step_timer_records_steps():
    """``stop`` takes the step's result (tensors in a nest, CPU here) and
    records one time a step; ``step()`` reads ``box["result"]``."""
    timer = profiling.StepTimer(tokens_per_step=64)
    timer.start()
    dt = timer.stop({"loss": torch.ones(2), "parts": [torch.zeros(3), 1.0]})
    with timer.step() as box:
        box["result"] = torch.arange(4) * 2
    assert dt >= 0.0 and len(timer.times) == 2
    assert timer.summary()["steps"] == 2.0
    assert timer.summary()["tokens_per_sec"] > 0.0


def test_metrics_logger_matches_jax(tmp_path):
    """The same records, in memory and in the JSONL file, but the clock."""
    port = profiling.MetricsLogger(str(tmp_path / "port" / "m.jsonl"))
    ref = JaxMetricsLogger(str(tmp_path / "jax" / "m.jsonl"))
    for step in range(3):
        for logger in (port, ref):
            logger.log(step, loss=np.float32(1.5 / (step + 1)), tag="x",
                       n=step)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "time"}
                          for r in rows]
    assert strip(port.history) == strip(ref.history)
    assert port.series("loss") == ref.series("loss")
    lines = (tmp_path / "port" / "m.jsonl").read_text().splitlines()
    assert len(lines) == 3


def test_trace_context_writes_a_chrome_trace(tmp_path):
    """Enabled, it writes ``trace.json``; disabled, it does nothing."""
    off = tmp_path / "off"
    with profiling.trace_context(str(off), enabled=False):
        torch.ones(4).sum()
    assert not off.exists()
    with profiling.trace_context(str(tmp_path / "on")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "on" / "trace.json").stat().st_size > 0


def test_bound_ms_takes_the_larger_time():
    """At the H100's peaks: K7's 25.8 GFLOP is bound by operations, K10's
    25.2 MB by bytes."""
    flops = 4 * 8 * 8 * 1024 * 1024 * 96
    ms, by = profiling.bound_ms(flops, 25_165_824)
    assert by == "operations" and ms == pytest.approx(flops / 989e9)
    ms, by = profiling.bound_ms(0, 25_165_824)
    assert by == "bytes" and ms == pytest.approx(25_165_824 / 3.35e9)


@pytest.mark.parametrize("shape,count", [((8192, 768), 9),
                                         ((8, 1024, 2048), 4),
                                         ((4, 8192, 2048), 3)])
def test_ring_inputs_outgrow_the_l2(shape, count):
    """Distinct copies, at least 3 and ``RING_BYTES`` together: K10's
    12.6 MB x takes 9, K6's 33.5 MB takes 4, 67 MB takes 3."""
    x0 = torch.full(shape, 1.5, dtype=torch.bfloat16)
    xs = profiling.ring_inputs(x0)
    nbytes = x0.numel() * x0.element_size()
    assert len(xs) == count and count * nbytes >= profiling.RING_BYTES
    assert len({x.data_ptr() for x in xs} | {x0.data_ptr()}) == len(xs) + 1
    assert all(torch.equal(x, x0) for x in xs)


def test_ring_inputs_copy_a_tuple_together():
    """One call's (q, k, v) head views, 6.3 MB a set: 17 sets of distinct
    copies, each keeping its view's strides."""
    def heads(s):
        x = torch.zeros(2, s, 768, dtype=torch.bfloat16)
        return x.view(2, s, 8, 96).transpose(1, 2)
    q0 = (heads(1), heads(1024), heads(1024))
    sets = profiling.ring_inputs(q0)
    assert len(sets) == 17
    for got in sets:
        assert [t.stride() for t in got] == [t.stride() for t in q0]
        assert len({t.data_ptr() for t in got + q0}) == 6


TOOL_MODULES = {"parts": k7, "variants": k8, "decode": k9, "dropout": k10}


@pytest.mark.parametrize("tool", sorted(TOOL_MODULES))
def test_tool_entry_points_raise_without_a_card(tool):
    """The tools measure the card: without one, ``main()`` raises before
    it measures anything, and never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TOOL_MODULES[tool].main([])


def _call(tool: str, device: str, mode=None):
    """One call of ``tool``'s wrapper on small inputs on ``device``."""
    if tool == "decode":
        q = torch.randn(1, 2, 1, 96, device=device)
        kv = torch.randn(1, 2, 64, 96, device=device)
        return k9.decode_variants(q, kv, kv, None, mode or "v3",
                                  sm_scale=0.1)
    if tool == "dropout":
        return k10.dropout_variants(torch.randn(4, 64, device=device),
                                    mode or "half2")
    module = TOOL_MODULES[tool]
    fn = k7.flash_parts if tool == "parts" else k8.flash_variants
    return fn(torch.randn(1, 2, 64, 96, device=device),
              mode or module.MODES[0])


@pytest.mark.parametrize("tool", sorted(TOOL_MODULES))
def test_wrappers_take_only_cpu_or_cuda_tensors(tool):
    """A CPU tensor runs the plain version and counts no launch; a tensor
    on another device than the CPU or a card, or an unknown mode, raises."""
    wrapper = {"parts": k7.flash_parts, "variants": k8.flash_variants,
               "decode": k9.decode_variants,
               "dropout": k10.dropout_variants}[tool]
    before = wrapper.launches
    assert _call(tool, "cpu").device.type == "cpu"
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        _call(tool, "meta")
    with pytest.raises(ValueError, match="mode"):
        _call(tool, "cpu", "nope")
