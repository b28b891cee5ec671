"""Build-at-first-use for the port's native sources under `csrc/`: the
CUDA kernels with nvcc, the host C++ with g++, each into a shared
library with a plain C interface under `_build/`, loaded with ctypes.

A library is rebuilt when its source is newer. It is written to a
temporary name and renamed, so concurrent processes never load a
partial file. Every failure raises: there is no fallback.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]


def nvcc() -> str:
    """nvcc on PATH, else $CUDA_HOME/bin/nvcc (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                           "port's CUDA kernels cannot be built")
    return path


def gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the port's host C++ "
                           "cannot be built")
    return found


def build_library(compiler_cmd: List[str], source: str, lib_name: str,
                  force: bool = False) -> str:
    """Compile `source` with `compiler_cmd` (compiler and flags) into
    _build/<lib_name> unless an up-to-date library exists; returns its
    path. Raises RuntimeError naming the compiler on failure."""
    lib_path = os.path.join(BUILD_DIR, lib_name)
    if (not force and os.path.exists(lib_path)
            and os.path.getmtime(lib_path) >= os.path.getmtime(source)):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.tmp.{os.getpid()}"
    cmd = compiler_cmd + ["-o", tmp, source]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler_cmd[0])} failed "
                           f"({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path
