"""Build and load the port's hand-written CUDA kernels.

Each kernel source (cova_tpu_torch/csrc/*.cu) is compiled by `nvcc` into
its own shared library with a plain C interface under
cova_tpu_torch/build/, at first use and again whenever the source is newer
than the library, then loaded with ctypes. Nothing here runs at import
time: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin (default /usr/local/cuda), then PATH."""
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build(name: str, verbose: bool = False) -> pathlib.Path:
    """Compile csrc/<name>.cu into build/lib<name>.so unless the library
    is up to date. The library lands by atomic rename, so concurrent
    builders never load a half-written file. Returns its path."""
    src = CSRC / f"{name}.cu"
    lib = BUILD / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        out = pathlib.Path(tmp) / lib.name
        cmd = [
            nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(out), str(src),
        ]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name}:\n{res.stdout}\n{res.stderr}"
            )
        if verbose and (res.stdout or res.stderr):
            print(res.stdout + res.stderr)
        os.replace(out, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
