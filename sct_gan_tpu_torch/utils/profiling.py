"""Tracing, timing and the card's peaks: the port's profiling helpers.

Counterpart of ``sct_gan_tpu/utils/profiling.py``:

  * ``trace_context`` wraps ``torch.profiler`` (CPU activity, and the card's
    when there is one) and writes a Chrome trace; it does nothing when
    disabled;
  * ``StepTimer`` times steps on the host clock; ``stop(result)``
    synchronises the device of every tensor in ``result`` first, the
    counterpart of ``jax.block_until_ready``, so asynchronous launches
    cannot hide work. Its ``summary()`` keys are the JAX class's;
  * ``MetricsLogger`` is the JSONL metrics stream, unchanged.

The JAX module's ``enable_compilation_cache`` has no counterpart here:
PyTorch runs eagerly and compiles nothing per shape, and the port's only
compiled artefacts, its CUDA kernels, are cached by ``ops/_build.py`` in
``_kernels_build/`` under a hash of their sources.

Added for the card: ``card_line`` (the card's name and power limit, which
every kept number is written beside), ``cuda_ms``, ``chain_ms`` and
``ring_ms`` (device time by CUDA events), and ``bound_ms`` with the H100
SXM's published peaks.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

# H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet): the bf16
# tensor-core rate and the HBM3 bandwidth, for bound_ms
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# ring_ms's inputs together: twice the H100's 50 MB L2, so that each is
# evicted before the ring comes back to it
RING_BYTES = 100 * 2 ** 20


@contextlib.contextmanager
def trace_context(logdir: str, enabled: bool = True):
    """Profile the enclosed block with ``torch.profiler`` and write
    ``<logdir>/trace.json`` (Chrome trace format); a no-op when disabled."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _synchronize(result) -> None:
    """Wait for the devices of every CUDA tensor in ``result`` (a tensor or
    a nest of lists, tuples and dicts of them)."""
    stack, devices = [result], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock step timing with device barriers and token accounting."""

    def __init__(self, tokens_per_step: int = 0):
        self.tokens_per_step = tokens_per_step
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """Stop the step clock; pass the step's outputs to wait for their
        devices first, so that asynchronous launches cannot hide work."""
        if result is not None:
            _synchronize(result)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.times.append(dt)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        box: Dict[str, Any] = {}
        yield box
        self.stop(box.get("result"))

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        med = ts[n // 2]
        out = {
            "steps": float(n),
            "mean_ms": sum(ts) / n * 1e3,
            "median_ms": med * 1e3,
            "p90_ms": ts[min(n - 1, int(0.9 * n))] * 1e3,
            "min_ms": ts[0] * 1e3,
        }
        if self.tokens_per_step:
            out["tokens_per_sec"] = self.tokens_per_step / med
        return out


class MetricsLogger:
    """Append-only JSONL metrics stream + in-memory history."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.history: List[Dict[str, Any]] = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def series(self, key: str) -> List[Any]:
        return [r[key] for r in self.history if key in r]


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def require_card() -> torch.device:
    """The first CUDA device; raises without one. Measuring entry points
    call it first: they never carry on on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: this entry point "
                           "measures the card and has no CPU mode")
    return torch.device("cuda")


def cuda_ms(fn: Callable[[], Any], iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# chain_ms and ring_ms replay their captured calls this many times: one
# warm-up replay, then the timed ones
TIMED_REPLAYS = 3
GRAPH_REPLAYS = 1 + TIMED_REPLAYS


def _replay_ms(calls: Callable[[int], None], n: int) -> float:
    """Device ms per call of ``calls(n)``, which makes ``n`` calls.

    The calls are captured once in a CUDA graph and replayed, so the host's
    dispatch (tens of µs of Python a call, more than a short kernel takes)
    is not timed: the JAX tools time a chain of calls inside one jit for the
    same reason. One eager call (``calls(1)``) on a side stream comes first,
    so that lazy set-up stays out of the capture; then one warm-up replay,
    and the best of ``TIMED_REPLAYS`` replays by CUDA events. A wrapper
    counts its eager call and the ``n`` launches it makes while the calls
    are captured; a replay reruns the captured kernels without calling it,
    so the kernel runs ``GRAPH_REPLAYS * n`` times more than it counts."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls(1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        calls(n)
    graph.replay()
    best = float("inf")
    for _ in range(TIMED_REPLAYS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best / n


def chain_ms(step: Callable[[Any], Any], x0, n: int) -> float:
    """Device ms per call of a chain of ``n`` dependent calls
    ``x = step(x)`` from ``x0``, replayed from a CUDA graph (``_replay_ms``).

    Each call reads what the one before wrote: where that fits the card's
    50 MB L2 it is read from there, so use ``ring_ms`` for a kernel whose
    bound counts HBM bytes."""
    def calls(k: int) -> None:
        x = x0
        for _ in range(k):
            x = step(x)
    return _replay_ms(calls, n)


def ring_ms(fn: Callable[[Any], Any], inputs: Sequence[Any], n: int) -> float:
    """Device ms per call of ``n`` calls ``fn(inputs[i % len(inputs)])``,
    replayed from a CUDA graph (``_replay_ms``).

    Each output is held until the call ``len(inputs)`` later, so the outputs
    too take ``len(inputs)`` (+1) distinct buffers. Give ``inputs`` several
    distinct tensors with more bytes together than the L2 (``RING_BYTES``):
    then every call reads its input from HBM and its output is written back
    there, and the time can be held against a bound at the HBM rate. The
    calls do not depend on each other; one stream runs them in order."""
    def calls(k: int) -> None:
        held = [None] * len(inputs)
        for i in range(k):
            held[i % len(inputs)] = fn(inputs[i % len(inputs)])
    return _replay_ms(calls, n)


def ring_inputs(x0):
    """Distinct copies of ``x0``, at least 3 and ``RING_BYTES`` together,
    for ``ring_ms``. ``x0`` is a tensor, or a tuple of tensors that one
    call takes, copied together (each copy keeps its tensor's strides)."""
    if isinstance(x0, torch.Tensor):
        return [x0.clone() for _ in range(_ring_count((x0,)))]
    return [tuple(x.clone() for x in x0) for _ in range(_ring_count(x0))]


def _ring_count(xs: Sequence[torch.Tensor]) -> int:
    return max(3, -(-RING_BYTES // sum(x.numel() * x.element_size()
                                       for x in xs)))


def bound_ms(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least time in ms, what bounds it): operations at the bf16 peak or
    bytes (each input read once, each output written once) at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
