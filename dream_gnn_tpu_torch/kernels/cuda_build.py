"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc for sm_90a into
``build/lib<name>.so``, a shared library with a plain C interface that the
kernel modules load with ctypes.  ``build`` starts one nvcc per source that
is out of date, all at once, and waits for them; ``load`` builds at first
use.  A library is out of date when it is older than its source or than
any header of ``csrc/``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("grid_decoder", "edge_decoder", "spmm", "scale_decoder",
           "bilinear_decoder")

_libs = {}


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def build(force: bool = False) -> str:
    """Compile every source that is out of date (all of them when
    ``force``), one nvcc each, in parallel.  Returns nvcc's output: its
    -Xptxas -v report of registers, shared memory and spills."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if force or _stale(n)]
    if not todo:
        return ""
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, failed = [], []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        report.append(f"-- {name}.cu\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(report)


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if it is out of date."""
    if name not in _libs:
        build()
        _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return _libs[name]
