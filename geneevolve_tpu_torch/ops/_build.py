"""Build and load the package's CUDA kernels.

Every `.cu` source under `csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`), one `nvcc` per source, all started together, and the objects
are linked into ONE shared library with a plain C interface, loaded with
`ctypes`. The build runs at first use, into `geneevolve_tpu_torch/_build/`,
and is keyed on a hash of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is reused. Nothing here runs at import time:
the CPU tests import every module on a machine without `nvcc`.

Each entry point takes its pointers and the stream as `c_void_p` and
returns `cudaGetLastError()`; `check` turns a non-zero code into an
exception naming the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# name -> argtypes (restype is always int: a cudaError_t)
SIGNATURES = {
    "ge_cdf_bins": [_P, _P, _P, _I64, _I64, _I, _P],
    "ge_merge_count": [
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _P,
    ],
    "ge_gamete_inherit": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
        _I64, _I64, _I64, _I, _I, _I, _I, _I, _I, _P,
    ],
    "ge_gather_rows": [_P, _P, _P, _I64, _I64, _I64, _I64, _P],
    "ge_meiose_merge": [
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I,
        _I, _I, _I, _P,
    ],
    "ge_meiose_packed": [
        _P, _P, _I64, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _I, _I64,
        _I, _I, _I, _I, _I, _I, _I, _I, _I64, _I, _P,
    ],
    "ge_meiose_planes": [
        _P, _P, _I64, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
        _I, _I, _I, _I, _P,
    ],
    "ge_point_draws": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I,
        _I, _I, _P,
    ],
    "ge_paint": [
        _P, _P, _I, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I,
        _I, _I, _I, _I64, _I, _I, _P,
    ],
}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build this process ran ("" if reused)


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
            "cannot be built"
        )
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgeneevolve_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if no build of these sources exists; returns
    its path. Writes to a temporary name and renames, so concurrent
    processes never load a half-written file."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    cus = [s for s in sources() if s.suffix == ".cu"]
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in cus]
    procs = [
        subprocess.Popen([nvcc, *FLAGS, "-c", "-o", str(o), str(s)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for s, o in zip(cus, objs)
    ]
    logs, failed = [], []
    for s, p in zip(cus, procs):
        logs.append(f"== {s.name}\n{p.communicate()[0]}")
        if p.returncode != 0:
            failed.append(s.name)
    if not failed:
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        logs.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append("link")
    for o in objs:
        o.unlink(missing_ok=True)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, out)
    (BUILD_DIR / "build.log").write_text(build_log)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = cdll
        return _lib


def check(code: int, kernel: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed: cudaError {code}")
