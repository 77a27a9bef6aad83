"""The step tools' card-only parts, on a CUDA card: ``trace_device`` (the
one reading of ``torch.profiler``, C7's repair) held to the launch
counters, and ``time_dispatch``'s CUDA graph of K train steps held to K
eager steps from the same state and seeds.

Marked ``cuda``; without a card each test skips. This file imports no JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_step_tools_cuda.py

(``chip_smoke.py``'s step-tools phase runs the same at the JAX tools'
full size.)
"""
import pytest
import torch

from sct_gan_tpu_torch.config import ModelConfig
from sct_gan_tpu_torch.ops.flash_attention import flash_attention
from sct_gan_tpu_torch.tools import ablate_step, time_dispatch
from sct_gan_tpu_torch.utils import profiling


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_trace_device_matches_the_launch_counters(cuda_device):
    """Ten traces of a chain of 20 K1 calls (each times 0.999): every one
    whole, its K1 records equal to the counter's 20 a run, its rows free
    of the primers, and its device time positive."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(8, 8, 1024, 96, generator=g, device=cuda_device).to(
        torch.bfloat16) * 0.05
    mask = torch.ones(8, 1024, dtype=torch.bool, device=cuda_device)

    def chain():
        x = q
        for _ in range(20):
            x = flash_attention(x, x, x, key_padding_mask=mask) * 0.999

    chain()
    for _ in range(10):
        before = flash_attention.launches
        trace = profiling.trace_device(chain)
        assert flash_attention.launches - before == 20 * trace.runs
        assert profiling.port_records(trace.rows)["flash_attention_fwd"] \
            == 20
        assert not any(profiling.PRIMER_NAME in r[0] for r in trace.rows)
        assert trace.total_us > 0


@pytest.mark.cuda
def test_graph_of_k_steps_matches_k_eager_steps(cuda_device):
    """``time_dispatch.parity`` at a small GAN model (d=128, 2 heads of 64,
    1+1 layers, L=128, bf16, dropout 0.3): K=3 steps captured in one CUDA
    graph and replayed leave the parameters of 3 eager steps from the same
    state and generator state, bit for bit or within ``PARITY_RTOL`` of
    the update; the replay's trace holds the launches counted at capture."""
    cfg = ModelConfig(d_model=128, nhead=2, num_encoder_layers=1,
                      num_decoder_layers=1, dim_feedforward=256,
                      max_length=128, max_lines=128, vocab_size=512,
                      use_gan=True, compute_dtype="bfloat16")
    step = ablate_step.AblatedStep(cfg, ablate_step.make_batch(2, 128, 512),
                                   cuda_device)
    k = 3
    with time_dispatch.stream_of(cuda_device):
        step()
        check = time_dispatch.parity(step, k)
        row = time_dispatch.time_graph(check.pop("graph"),
                                       check.pop("launches"), k,
                                       cuda_device)
    assert check["bitwise"] or (check["update_rel_err"]
                                <= time_dispatch.PARITY_RTOL)
    assert row["nodes"] > 0 and row["device_ms"] > 0
    assert row["launches"]["flash_attention_fwd"] > 0
