"""Build and load the port's CUDA kernels and its host library.

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host code:
the JPEG decoder) has a plain C interface. It is compiled by ``nvcc``, or by
the host compiler (``$CXX``, else ``g++``), into a shared library under
``_build/`` (listed in ``.gitignore``) at first use and loaded with
``ctypes``. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
A CUDA source is compiled with ``-Xptxas -v``, and what ptxas says of its
kernels (registers, spills, shared memory) is kept beside the library:
:func:`ptxas_report` reads it. Nothing here runs at import time: machines without ``nvcc`` import the
package and use the plain torch versions on CPU tensors.
"""
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
PTXAS_FLAGS = ("-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def nvcc():
    """Path of nvcc: on PATH, else in $CUDA_HOME/bin (/usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def cxx():
    """The host C++ compiler: ``$CXX``, else ``g++`` on PATH."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("no host C++ compiler: set CXX or put g++ on PATH")
    return found


def _source(name):
    """``csrc/<name>.cu`` if there is one, else ``csrc/<name>.cpp``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(src):
    """nvcc's flags for a .cu source, the host compiler's for a .cpp."""
    return NVCC_FLAGS + PTXAS_FLAGS if src.suffix == ".cu" else CXX_FLAGS


def library_path(name):
    """Where ``csrc/<name>.cu`` (or ``.cpp``) is built for its current source
    and flags."""
    src = _source(name)
    flags = _flags(src)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                            ).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name):
    """Compile ``csrc/<name>.cu`` (or ``.cpp``) unless its library exists;
    return its path.

    Raises ``RuntimeError`` with the compiler's output if the compiler
    fails.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = _source(name)
    compiler = nvcc() if src.suffix == ".cu" else cxx()
    cmd = [compiler, *_flags(src), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(compiler).name} failed ({proc.returncode})"
                           f": {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    if src.suffix == ".cu":
        report = tmp.with_suffix(".ptxas.tmp")
        report.write_text(proc.stdout + proc.stderr)
        os.replace(report, _ptxas_path(out))
    os.replace(tmp, out)
    return out


def _ptxas_path(library):
    """Where ptxas's report of ``library``'s build is kept."""
    return library.with_suffix(".ptxas.txt")


def _kernel_label(mangled):
    """A kernel's name and integer template arguments from its mangled
    name: march_window_kernel<8> from _ZN..19march_window_kernelILi8EE..
    (each name in it is its length, then the name)."""
    for i in range(len(mangled)):
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            continue
        at = i + m.end()
        name = mangled[at:at + int(m.group())]
        if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
            t = re.match(r"I((?:L[a-z]+\d+E)+)E", mangled[at + len(name):])
            args = re.findall(r"(\d+)E", t.group(1)) if t else []
            return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_report(name, kernel=""):
    """{kernel<args>: registers, spill_stores, spill_loads (bytes),
    smem_bytes} of each entry function of ``csrc/<name>.cu`` whose mangled
    name holds ``kernel``, from what ptxas said when it was built (built
    here unless it was)."""
    text = _ptxas_path(build(name)).read_text()
    out, label = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            label = _kernel_label(m.group(1)) if kernel in m.group(1) \
                else None
        elif label is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out.setdefault(label, {}).update(
                    spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                out.setdefault(label, {}).update(
                    registers=int(m.group(1)),
                    smem_bytes=int(smem.group(1)) if smem else 0)
    return out


@functools.cache
def load_library(name):
    """The ``ctypes`` handle of ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use."""
    return ctypes.CDLL(str(build(name)))
