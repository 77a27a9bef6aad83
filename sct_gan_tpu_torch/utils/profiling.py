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
``ring_ms`` (device time by CUDA events), ``bound_ms`` with the H100
SXM's published peaks, ``kernel_launches`` and ``reset_kernel_launches``
(the one table of the launch counts of the port's kernel wrappers) and
``trace_device``, the one place the port
reads ``torch.profiler``'s device records.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

# H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet): the bf16
# tensor-core rate and the HBM3 bandwidth, for bound_ms
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# f32-accurate products on the tensor cores: 3xTF32 runs three TF32
# products (495 TFLOP/s) for each, the f32 kernels' route
PEAK_3XTF32_FLOPS = 495e12 / 3
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


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = PEAK_BF16_FLOPS) -> Tuple[float, str]:
    """(least time in ms, what bounds it): operations at ``peak_flops``
    (the bf16 peak by default) or bytes (each input read once, each output
    written once) at the HBM rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _launch_counters() -> Dict[str, Tuple[Any, str]]:
    """Each kernel of the main paths -> (its wrapper, the wrapper's count
    attribute): the one table of the port's launch counters."""
    from ..ops.decode_attention import decode_attention
    from ..ops.dropout import dropout
    from ..ops.flash_attention import (flash_attention,
                                       flash_attention_backward)
    return {"flash_attention_fwd": (flash_attention, "launches"),
            "flash_attention_bwd": (flash_attention_backward, "launches"),
            "dropout": (dropout, "launches"),
            "decode_attention": (decode_attention, "launches"),
            "flash_attention_fwd_f32": (flash_attention, "f32_launches"),
            "flash_attention_bwd_f32": (flash_attention_backward,
                                        "f32_launches"),
            "decode_attention_f32": (decode_attention, "f32_launches")}


def kernel_launches() -> Dict[str, int]:
    """The launch counts of the main paths' kernels (each wrapper adds one
    where it launches its kernel; on the CPU they stay 0)."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _launch_counters().items()}


def reset_kernel_launches() -> None:
    """Set every count of ``kernel_launches`` to 0."""
    for fn, attr in _launch_counters().values():
        setattr(fn, attr, 0)


# The device kernels of each counted wrapper, by name, and how many one
# launch runs: K1 one; the backward pair three (D, dKV, dQ); K6 one; K5 one;
# their f32 instances likewise, on any route (the wide route's kernels are
# flash_f32_{fwd,dkv,dq}_group_kernel and flash_f32_{fwd,dq}_split_kernel)
PORT_KERNELS = {
    "flash_attention_fwd": (re.compile(r"\bflash_fwd_(?:hopper_)?kernel\b"),
                            1),
    "flash_attention_bwd": (re.compile(
        r"\bflash_bwd_(?:dvec|dkv_\w+|dq_\w+)_kernel\b"), 3),
    "dropout": (re.compile(r"\bdropout_kernel\b"), 1),
    "decode_attention": (re.compile(r"\bdecode_(?:splitk|wide)_kernel\b"), 1),
    "flash_attention_fwd_f32": (re.compile(
        r"\bflash_f32_fwd(?:_\w+)?_kernel\b"), 1),
    "flash_attention_bwd_f32": (re.compile(
        r"\bflash_f32_(?:dvec|dkv|dq)(?:_\w+)?_kernel\b"), 3),
    "decode_attention_f32": (re.compile(r"\bdecode_f32_kernel\b"), 1),
}
# Every device trace opens with this many short spin kernels
# (``torch.cuda._sleep``), then waits for them. A profiler session can lose
# the first records it would take, all at its start: in a process that has
# run for a minute or two, the first 7 of a 40-kernel run's records in every
# session, now and then more (``chip_smoke.py --profiler-probe``). The
# primers absorb the loss; a trace in which none survived, or whose port
# kernels fall short of the launch counters, lost records of the run
# itself.
PRIMERS = 64
PRIMER_CYCLES = 1000
PRIMER_NAME = "spin_kernel"
TRACES = 5      # traces of a run before a short one raises


class DeviceTrace(NamedTuple):
    """One traced run: ``rows`` (kernel name, records, device µs) by
    device time, the primers left out; ``runs``, the runs made to get a
    whole trace (1, or more after short ones); ``value``, what the last
    run returned."""

    rows: List[Tuple[str, int, float]]
    runs: int
    value: Any

    @property
    def total_us(self) -> float:
        return sum(r[2] for r in self.rows)

    @property
    def records(self) -> int:
        return sum(r[1] for r in self.rows)


def port_records(rows) -> Dict[str, int]:
    """Launches of each counted wrapper that ``rows`` (kernel name,
    records, ...) hold: each wrapper's kernel records over its kernels a
    launch."""
    got = dict.fromkeys(PORT_KERNELS, 0)
    for name, count, *_ in rows:
        for wrapper, (pattern, _) in PORT_KERNELS.items():
            if pattern.search(name):
                got[wrapper] += count
    return {k: v / PORT_KERNELS[k][1] for k, v in got.items()}


def trace_device(run: Callable[[], Any],
                 expected: Optional[Dict[str, int]] = None,
                 cpu: bool = False) -> DeviceTrace:
    """``run()`` under ``torch.profiler``, the device kernels' records.

    On the card (``cpu=False``) the trace opens with ``PRIMERS`` spin
    kernels, waited for, then runs ``run()`` and waits for the card. The
    trace is whole when at least one primer's record survived (the loss
    takes a session's first records only) and the records of the port's
    kernels equal the wrapper's launches: ``expected`` (wrapper -> launches,
    for a run that replays a CUDA graph, which counts nothing) or the
    launch counters over the run. A short trace is profiled again, with
    the run made again, up to ``TRACES`` runs; past them it raises. No
    caller reads a short trace. ``cpu=True`` profiles CPU activity (the
    ops' self time), with no primer and no check."""
    from torch.profiler import ProfilerActivity, profile
    short = []
    for runs in range(1, TRACES + 1):
        before = kernel_launches()
        with profile(activities=[ProfilerActivity.CPU if cpu
                                 else ProfilerActivity.CUDA]) as prof:
            if not cpu:
                for _ in range(PRIMERS):
                    torch.cuda._sleep(PRIMER_CYCLES)
                torch.cuda.synchronize()
            value = run()
            if not cpu:
                torch.cuda.synchronize()
        want = expected or {k: v - before[k]
                            for k, v in kernel_launches().items()}
        rows, primers = _rows(prof, cpu), 0
        for i, (key, count, _) in enumerate(rows):
            if PRIMER_NAME in key:
                primers = rows.pop(i)[1]
                break
        got = port_records(rows)
        if cpu or (primers > 0 and all(got[k] == want.get(k, 0)
                                       for k in got)):
            rows.sort(key=lambda r: -r[2])
            return DeviceTrace(rows, runs, value)
        short.append(f"{primers} of {PRIMERS} primers, port kernels "
                     f"{got} against launches {want}")
    raise RuntimeError(f"torch.profiler lost records of the run in "
                       f"{TRACES} traces: " + "; ".join(short))


def _rows(prof, cpu: bool) -> List[Tuple[str, int, float]]:
    """(name, records, µs) of a finished trace, by name: the CPU ops' self
    time (``key_averages``), or each device kernel's time read from the
    raw records (``key_averages`` builds an object a record, seconds for
    the ~100k kernels of a graph of 8 train steps)."""
    from torch.autograd import DeviceType
    if cpu:
        return [(e.key, e.count, e.self_cpu_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
    acc: Dict[str, List[float]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = acc.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += (e.end_ns() - e.start_ns()) / 1e3
    return [(k, int(c), us) for k, (c, us) in acc.items()]
