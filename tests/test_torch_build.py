"""The kernel build's cache and the spill check of ``chip_smoke.py``, on the
CPU: no ``nvcc`` and no card. A library is cached under a hash of its
sources with ``ptxas``'s ``-v`` report beside it, so the report of a library
that was built before can be checked as a fresh build's can."""
import os

import pytest

import chip_smoke
from sct_gan_tpu_torch.ops import _build

FWD = "_ZN12_GLOBAL__N_116flash_fwd_kernelE14CUtensorMap_st"
DKV = ("_ZN12_GLOBAL__N_127flash_bwd_dkv_hopper_kernelINS_8DkvShapeILi96ELi2E"
       "Li3ELi1EEEEEv14CUtensorMap_stS3_S3_S3_NS_7BwdArgsE")
DQ = ("_ZN12_GLOBAL__N_126flash_bwd_dq_hopper_kernelINS_7DqShapeILi128ELi2E"
      "Li2EEEEEv14CUtensorMap_stS3_S3_S3_NS_7BwdArgsE")
DKV64 = ("_ZN12_GLOBAL__N_127flash_bwd_dkv_hopper_kernelINS_8DkvShapeILi64ELi2E"
         "Li3ELi1EEEEEv14CUtensorMap_stS3_S3_S3_NS_7BwdArgsE")
WIDE_DQ = ("_ZN12_GLOBAL__N_125flash_bwd_dq_wgmma_kernelILi192ELb0EEEv"
           "14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE")
DECODE = "_ZN12_GLOBAL__N_122decode_perbatch_kernelEPK13__nv_bfloat16"
SPLITK = "_ZN12_GLOBAL__N_120decode_splitk_kernelEPK13__nv_bfloat16"


def _entry(name, stack, stores, loads, regs):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {stack} bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n")


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "ptxas_log", "")
    return tmp_path


def test_a_cached_library_gives_its_saved_report(build_dir, monkeypatch):
    lib = _build.library_path()
    assert os.path.dirname(lib) == str(build_dir)
    report = _entry(FWD, 0, 0, 0, 148)
    with open(_build.report_path(lib), "w") as f:
        f.write(report)
    with open(lib, "wb") as f:
        f.write(b"")

    def no_nvcc():
        raise AssertionError("a cached library must not be rebuilt")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.build() == lib
    assert _build.ptxas_log == report


def test_a_cached_library_without_its_report_is_built_again(build_dir,
                                                            monkeypatch):
    with open(_build.library_path(), "wb") as f:
        f.write(b"")

    def nvcc():
        raise RuntimeError("nvcc asked for")
    monkeypatch.setattr(_build, "_nvcc", nvcc)
    with pytest.raises(RuntimeError, match="nvcc asked for"):
        _build.build()


def test_report_path_sits_beside_the_library():
    lib = os.path.join("x", "libsct_kernels_0123456789abcdef.so")
    assert _build.report_path(lib) == os.path.join(
        "x", "libsct_kernels_0123456789abcdef.ptxas.txt")


@pytest.mark.parametrize("log,flagged", [
    (_entry(FWD, 0, 0, 0, 148) + _entry(DKV, 0, 0, 0, 254), []),
    # a stack frame without spills is not a spill
    (_entry(DKV, 48, 0, 0, 168), []),
    (_entry(FWD, 0, 0, 0, 148) + _entry(DKV, 48, 42, 72, 168), [DKV]),
    (_entry(FWD, 8, 6, 4, 200), [FWD]),
    # another kernel's spill is not the flash kernels' budget; K9's
    # per-batch decode kernel stays out of it
    (_entry(DECODE, 8, 4, 4, 32) + _entry(FWD, 0, 0, 0, 148), []),
    # the split-K decode attention (K5) is held to no spill as well
    (_entry(SPLITK, 16, 12, 12, 112) + _entry(DECODE, 0, 0, 0, 40), [SPLITK]),
    (_entry(SPLITK, 0, 0, 0, 96), []),
    # the backward pair's Hopper instances at 64-128, each by its own name
    (_entry(DQ, 0, 0, 0, 168) + _entry(DKV64, 0, 0, 0, 200), []),
    (_entry(DQ, 24, 20, 20, 200) + _entry(DKV, 0, 0, 0, 232), [DQ]),
    (_entry(DKV64, 0, 0, 0, 190) + _entry(DKV, 16, 8, 12, 255), [DKV]),
    (_entry(WIDE_DQ, 8, 4, 4, 255) + _entry(DQ, 0, 0, 0, 168), [WIDE_DQ]),
])
def test_flash_spills_flags_only_the_flash_kernels_spills(log, flagged):
    got = chip_smoke.kernel_spills(log)
    assert [g.split(":")[0] for g in got] == flagged
