"""The block sweep of the backward pair (``tools/sweep_flash_blocks.py``),
on the CPU: no ``nvcc`` and no card. Its candidates are compiled from
``csrc/sweep/flash_bwd_sweep.cu``, so here only what surrounds them runs:
the shipped shapes must be among the candidates, the sweep library is
keyed apart from the main one, the ``ptxas`` report is read back per
candidate, and ``main`` raises without a card."""
import os
import re

import pytest
import torch

from sct_gan_tpu_torch.ops import _build
from sct_gan_tpu_torch.tools import sweep_flash_blocks as sweep

CSRC = os.path.join(os.path.dirname(sweep.SOURCE), os.pardir)


def _read(path):
    with open(path) as f:
        return f.read()


def _shipped():
    """head dim -> (dKV shape, dQ shape) from ``Shipped<D>``."""
    text = _read(os.path.join(CSRC, "flash_bwd_hopper.cuh"))
    out = {}
    for d, dkv, dq in re.findall(
            r"struct Shipped<(\d+)> \{\s*using Dkv = DkvShape<([\d, ]+)>;"
            r"\s*using Dq = DqShape<([\d, ]+)>;", text):
        out[int(d)] = (tuple(int(x) for x in dkv.split(",")),
                       tuple(int(x) for x in dq.split(",")))
    return out


def _candidates(kind):
    """The candidates of ``kind`` ("Dkv" or "Dq") with D left symbolic."""
    text = _read(sweep.SOURCE)
    block = re.search(rf"using {kind}Candidates = List<(.*?)>;", text,
                      re.S).group(1)
    return [tuple(int(x) for x in args.split(","))
            for args in re.findall(rf"{kind}Shape<D, ([\d, ]+)>", block)]


def test_every_head_dim_ships_one_of_its_candidates():
    shipped = _shipped()
    assert sorted(shipped) == list(sweep.HEAD_DIMS)
    for d, (dkv, dq) in shipped.items():
        assert dkv[0] == d and dq[0] == d
        assert dkv[1:] in _candidates("Dkv")
        assert dq[1:] in _candidates("Dq")


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    return tmp_path


def test_a_sweep_library_is_keyed_by_its_head_dim(build_dir):
    paths = {d: _build.library_path([sweep.SOURCE], f"sct_sweep_dh{d}",
                                     [f"-DSWEEP_D={d}"])
             for d in sweep.HEAD_DIMS}
    assert len(set(paths.values()) | {_build.library_path()}) == 4
    assert all(os.path.basename(p).startswith(f"libsct_sweep_dh{d}_")
               for d, p in paths.items())


def test_a_cached_sweep_library_is_not_built_again(build_dir, monkeypatch):
    args = ([sweep.SOURCE], "sct_sweep_dh96", ["-DSWEEP_D=96"])
    lib = _build.library_path(*args)
    with open(_build.report_path(lib), "w") as f:
        f.write("report")
    with open(lib, "wb") as f:
        f.write(b"")

    def no_nvcc():
        raise AssertionError("a cached library must not be rebuilt")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.build_library(*args) == (lib, "report", None)


def _entry(name, regs, stores=0):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {stores} bytes spill stores, "
            f"{stores} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n")


def test_ptxas_shapes_reads_each_candidates_report():
    dkv = ("_ZN12_GLOBAL__N_127flash_bwd_dkv_hopper_kernelINS_8DkvShapeILi96E"
           "Li2ELi3ELi1EEEEEv14CUtensorMap_stS3_S3_S3_NS_7BwdArgsE")
    dq = ("_ZN12_GLOBAL__N_126flash_bwd_dq_hopper_kernelINS_7DqShapeILi96ELi3E"
          "Li2EEEEEv14CUtensorMap_stS3_S3_S3_NS_7BwdArgsE")
    other = "_ZN12_GLOBAL__N_116flash_fwd_kernelE14CUtensorMap_st"
    got = sweep.ptxas_shapes(_entry(dkv, 232) + _entry(other, 148, 8)
                             + _entry(dq, 168, 16))
    assert got == {("dkv", (96, 2, 3, 1)): {"registers": 232,
                                           "spill_bytes": 0},
                   ("dq", (96, 3, 2)): {"registers": 168,
                                        "spill_bytes": 32}}


def test_build_refuses_a_head_dim_without_candidates():
    with pytest.raises(ValueError, match="head dim 80"):
        sweep.build(80)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sweep.main(["--head-dims", "96"])
