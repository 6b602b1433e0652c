"""Build the port's CUDA kernels with `nvcc` and load them with `ctypes`.

`csrc/<name>.cu` exposes a plain `extern "C"` launcher and compiles into a
shared library under `kernels/_build/` (git-ignored), named by a hash of the
source, the `csrc/` headers it includes (`#include "x.cuh"`, followed into
the headers' own includes) and the flags, so an edited source or header
never loads a stale library.  The
build runs at first use, never at import: the CPU tests import every module
on machines without `nvcc`.  A failed build raises with the compiler's
output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """`nvcc` from PATH, else from CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of repro_torch need the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str, csrc: Path = CSRC) -> list:
    """`csrc/<name>.cu` and every header of `csrc` it includes, directly
    or through another header, in the order first met."""
    found, todo = [], [csrc / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = csrc / inc.decode()
            if header.is_file():
                todo.append(header)
    return found


def library_path(name: str, csrc: Path = CSRC) -> Path:
    digest = hashlib.sha1()
    for path in sources(name, csrc):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, compiled at first use."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads half
    lib = _LOADED[name] = ctypes.CDLL(str(out))
    return lib
