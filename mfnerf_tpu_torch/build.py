"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
into a shared library under ``_build/`` (listed in ``.gitignore``) at first
use and loaded with ``ctypes``. The library's file name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing here runs at import time: machines without ``nvcc``
import the package and use the plain torch versions on CPU tensors.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


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


def library_path(name):
    """Where ``csrc/<name>.cu`` is built for its current source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name):
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path.

    Raises ``RuntimeError`` with the compiler's output if nvcc fails.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library(name):
    """The ``ctypes`` handle of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name)))
