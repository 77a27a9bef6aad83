"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together (so a build takes as long as its slowest source, not the
sum, as kernels are added), and the objects are linked into ONE shared
library with a
plain C interface, loaded with ``ctypes``. The library is built at first
use, in ``_kernels_build/`` beside the package (listed in ``.gitignore``),
under a name keyed by a hash of the sources and the flags, so an edited
source rebuilds and an unchanged one loads at once. ``ptxas``'s ``-v``
report (registers, stack, spills) is kept beside the library under the same
key, so a loaded library's report can be checked as a fresh build's can.
``build_library`` builds another library the same way from sources outside
the main build (the block sweep's, ``csrc/sweep/``), with its own defines.

A failed build raises with the compiler's stderr: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_kernels_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
# dropout seed threshold inv_keep, then the dropout index's batch origin,
# head origin and global head count
_DROP = [_I, _U, _U, _F, _I, _I, _I]
# C entry points and their argument types (see the .cu files)
_SIGNATURES = {
    "flash_attention_fwd_bf16": [_P, _P, _P, _P, _P, _P,     # q k v mask o lse
                                 _I, _I, _I, _I, _I,         # B H Sq Sk D
                                 *[_I] * 12,                 # q k v o strides
                                 _I, _I, _F,                 # mask_sb causal scale
                                 *_DROP, _P],                # ... stream
    "flash_attention_bwd_bf16": [*[_P] * 11,  # q k v dout o mask lse D dq dk dv
                                 _I, _I, _I, _I, _I,         # B H Sq Sk D
                                 *[_I] * 24,                 # 8 tensors' strides
                                 _I, _I, _F,                 # mask_sb causal scale
                                 *_DROP, _P],                # ... stream
    # the f32 kernels take the bf16 ones' arguments (the decode one also
    # whether its output is bf16)
    "flash_attention_fwd_f32": [_P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, *[_I] * 12,
                                _I, _I, _F, *_DROP, _P],
    "flash_attention_bwd_f32": [*[_P] * 11, _I, _I, _I, _I, _I,
                                *[_I] * 24, _I, _I, _F, *_DROP, _P],
    "decode_attention_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                             *[_I] * 12,                 # q k v o strides
                             _I, _I, _F, _I, _P],  # ... scale o_bf16 stream
    "hash_dropout": [_P, _P, _U, _I,                         # x y n is_bf16
                     _U, _U, _F,                 # seed threshold scale
                     _U, _U, _U, _P],   # origin row_len row_stride stream
    "decode_attention_bf16": [_P, _P, _P, _P, _P,                # q k v mask o
                              _I, _I, _I, _I,                    # B H S D
                              _I, _I, _I, _I, _I, _I,            # q, k strides
                              _I, _I, _I, _I, _I, _I,            # v, o strides
                              _I, _I, _F, _P],  # mask_sb splits scale stream
    # the timing variants of the tools (sct_gan_tpu_torch/tools/)
    "flash_parts_bf16": [_P, _P, _P, _P,                     # q k v o
                         _I, _I, _I, _I, _F, _P],  # BH S D mode scale stream
    "flash_variants_bf16": [_P, _P, _P, _P,
                            _I, _I, _I, _I, _F, _P],   # as flash_parts_bf16
    "decode_variants_bf16": [_P, _P, _P, _P, _P,             # q k v mask o
                             _I, _I, _I, _I, _I,             # mode B H S D
                             _I, _I, _I, _I, _I,             # q, k strides
                             _I, _I, _I, _I, _I,             # v, o strides
                             _I, _F, _P],        # mask_sb scale stream
    "dropout_variants_bf16": [_P, _P, _I, _I, _I,            # x y N C mode
                              _U, _U, _F, _P],   # seed threshold scale stream
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last nvcc run
ptxas_log: str = ""         # nvcc's -Xptxas -v report of the library built


def _sources():
    return sorted(os.path.join(_SRC_DIR, f) for f in os.listdir(_SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _main_cu():
    return [s for s in _sources() if s.endswith(".cu")]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(cu=None, tag: str = "sct_kernels", defines=()) -> str:
    """Where the library of the ``.cu`` files ``cu`` (default: the main
    build's) built with ``defines`` lives: keyed by the flags and every
    source it may include (all of ``csrc/``'s headers)."""
    cu = _main_cu() if cu is None else list(cu)
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    headers = [s for s in _sources() if s.endswith(".cuh")]
    for src in sorted(set(cu) | set(headers)):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{tag}_{h.hexdigest()[:16]}.so")


def report_path(lib_path: str) -> str:
    """Where the ``ptxas -v`` report of the library ``lib_path`` is kept."""
    return lib_path[:-len(".so")] + ".ptxas.txt"


def build_library(cu=None, tag: str = "sct_kernels", defines=()):
    """(path, ``ptxas -v`` report, nvcc seconds or None when it was built
    before) of the library of ``cu`` with ``defines``: one ``nvcc -c`` per
    source, all running at once, then one link; a library without its
    report is built again."""
    cu = _main_cu() if cu is None else list(cu)
    lib_path = library_path(cu, tag, defines)
    if os.path.exists(lib_path) and os.path.exists(report_path(lib_path)):
        with open(report_path(lib_path)) as f:
            return lib_path, f.read(), None
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        procs = []
        for src in cu:
            obj = os.path.join(work, os.path.basename(src) + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} (exit "
                              f"{proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", tmp,
                               *(obj for _, obj, _ in procs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):"
                               f"\n{link.stderr}")
        report = os.path.join(work, "ptxas.txt")
        with open(report, "w") as f:
            f.write("".join(logs))
        # atomic, the report first: a library is never seen without its
        # report, nor half written by concurrent builders
        os.replace(report, report_path(lib_path))
        os.replace(tmp, lib_path)
    return lib_path, "".join(logs), time.perf_counter() - t0


def build() -> str:
    """Build the main library if none exists for these sources, and set
    ``ptxas_log`` to its report (``build_seconds`` to nvcc's wall time when
    it ran)."""
    global build_seconds, ptxas_log
    lib_path, ptxas_log, seconds = build_library()
    if seconds is not None:
        build_seconds = seconds
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; signatures declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
