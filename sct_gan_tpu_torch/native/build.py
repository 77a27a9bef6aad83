"""Build and load the port's native tokenizer (g++ → .so, keyed by the source).

The library is compiled from this package's own ``fast_tokenizer.cpp`` at
first use into ``_kernels_build/`` beside the package (listed in
``.gitignore``), under a name keyed by a hash of the source, so an edited
source rebuilds. Without a C++ toolchain ``load_library`` returns None and
the tokenizer runs its pure-Python encode path with the same ids.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fast_tokenizer.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_kernels_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(" ".join(_FLAGS).encode() + f.read()).hexdigest()
    return os.path.join(BUILD_DIR, f"libfast_tokenizer_{h[:16]}.so")


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (if not built yet) and dlopen the native library; None when
    there is no working C++ toolchain."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    path = library_path()
    try:
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                               capture_output=True, timeout=120)
                os.replace(tmp, path)   # atomic: no reader sees half a file
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.SubprocessError):
        _build_failed = True
        return None
    lib.ft_create.restype = ctypes.c_void_p
    lib.ft_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.ft_add_token.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int32]
    lib.ft_destroy.argtypes = [ctypes.c_void_p]
    lib.ft_encode.restype = ctypes.c_int32
    lib.ft_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.ft_encode_lines.restype = ctypes.c_int32
    lib.ft_encode_lines.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32]
    _lib = lib
    return lib


def native_available() -> bool:
    return load_library() is not None
