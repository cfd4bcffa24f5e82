"""build.ptxas_report: what ptxas said of a CUDA source's kernels.

A CUDA source is built with ``-Xptxas -v`` and its report kept beside the
library; ``ptxas_report`` reads each entry function's registers, spills and
shared memory from it, under the kernel's name and template arguments. No
nvcc here: the report is written by hand in ptxas's format.
"""
import pytest

from mfnerf_tpu_torch import build

REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_130composite_train\
_bw_regs_kernelILi4EEEvxiifPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_130composite_train\
_bw_regs_kernelILi4EEEvxiifPKfS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 61 registers, used 0 barriers, 496 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125composite_train\
_bw_kernelExiifPKfS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125composite_train\
_bw_kernelExiifPKfS1_
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 8 bytes cumulative stack \
size, 128 bytes smem, 496 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121composite_test\
_kernelExifPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121composite_test\
_kernelExifPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 400 bytes cmem[0]
"""


@pytest.mark.parametrize("mangled,label", [
    ("_ZN47_GLOBAL__N__8e3c7b6c_11_raymarch_cu_4f0ba1f619march_window_kernel"
     "ILi8EEEv11MarchParamsxPKf", "march_window_kernel<8>"),
    ("_ZN47_GLOBAL__N__8e3c7b6c_11_raymarch_cu_4f0ba1f618march_train_kernel"
     "E11MarchParamsxPKf", "march_train_kernel"),
    ("_ZN12_GLOBAL__N_119hashgrid_bwd_kernelILi2ELb0EEEvPKf",
     "hashgrid_bwd_kernel<2,0>"),
    ("_Z10foo_kernelv", "foo_kernel"),
    ("_Z3barv", "_Z3barv"),          # no kernel's name: kept as it is
])
def test_kernel_label(mangled, label):
    assert build._kernel_label(mangled) == label


@pytest.fixture
def built(tmp_path, monkeypatch):
    """A library whose build left REPORT beside it."""
    lib = tmp_path / "libcomposite-0123456789abcdef.so"
    build._ptxas_path(lib).write_text(REPORT)
    monkeypatch.setattr(build, "build", lambda name: lib)
    return lib


def test_ptxas_report_reads_every_kernel(built):
    assert build.ptxas_report("composite") == {
        "composite_train_bw_regs_kernel<4>": dict(
            registers=61, spill_stores=0, spill_loads=0, smem_bytes=0),
        "composite_train_bw_kernel": dict(
            registers=40, spill_stores=8, spill_loads=4, smem_bytes=128),
        "composite_test_kernel": dict(
            registers=30, spill_stores=0, spill_loads=0, smem_bytes=0)}


def test_ptxas_report_keeps_the_named_kernels(built):
    report = build.ptxas_report("composite", "composite_train_bw")
    assert sorted(report) == ["composite_train_bw_kernel",
                              "composite_train_bw_regs_kernel<4>"]
    assert build.ptxas_report("composite", "no_such_kernel") == {}


def test_cuda_flags_ask_ptxas_for_its_report(tmp_path, monkeypatch):
    """A .cu source is compiled with -Xptxas -v (part of its library's
    hash); a .cpp source is not."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("")
    (tmp_path / "h.cpp").write_text("")
    assert build._flags(tmp_path / "k.cu")[-2:] == ("-Xptxas", "-v")
    assert "-Xptxas" not in build._flags(tmp_path / "h.cpp")
    assert build._ptxas_path(build.library_path("k")).name.endswith(
        ".ptxas.txt")
