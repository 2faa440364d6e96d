"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` is compiled on first use into its own shared library,
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

All sources are compiled together (one nvcc process each, started at
once), and a library is reused while the hash of its source, the shared
headers and the flags is unchanged.  ``-Xptxas -v`` writes each kernel's
registers, shared memory and spills into ``<name>.log`` beside it.

Each kernel is a :class:`Kernel`: a C entry point that takes raw pointers,
sizes and the CUDA stream (pointers and the stream as ``c_void_p``) and
returns ``cudaGetLastError()``.  :meth:`Kernel.launch` raises if that is not
0 and counts the launch in ``Kernel.launches``; nothing else touches the
count.  Nothing is built or loaded while a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

__all__ = ["BUILD_DIR", "CSRC", "KERNELS", "Kernel", "SIMT_DTYPES",
           "build_all", "build_info", "reset_launches"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, Path] = {}
_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no current library, all at once.

    Returns ``{name: library path}``.  Raises with the compiler's output
    when a source does not build.
    """
    with _LOCK:
        if _LIBS:
            return _LIBS
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        libs: dict[str, Path] = {}
        for src in sorted(CSRC.glob("*.cu")):
            lib = BUILD_DIR / f"lib{src.stem}-{_digest(src)}.so"
            libs[src.stem] = lib
            if lib.is_file():
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            log = BUILD_DIR / f"{src.stem}.log"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            with open(log, "w") as fh:
                proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
            jobs.append((src.stem, proc, tmp, lib, log))
        for name, proc, tmp, lib, log in jobs:
            rc = proc.wait()
            if rc != 0:
                for _, other, *_ in jobs:
                    other.wait()
                raise RuntimeError(
                    f"nvcc failed on {name}.cu (rc {rc}):\n{log.read_text()}")
            os.replace(tmp, lib)
        _INFO.update(seconds=time.perf_counter() - t0,
                     built=[j[0] for j in jobs],
                     logs={n: (BUILD_DIR / f"{n}.log").read_text()
                           for n in libs if (BUILD_DIR / f"{n}.log").is_file()})
        _LIBS.update(libs)
        return _LIBS


def build_info() -> dict:
    """Seconds of the last :func:`build_all`, what it compiled, and the
    compiler's output (``-Xptxas -v``) per source."""
    return dict(_INFO)


class Kernel:
    """One C entry point of one ``csrc/<source>.cu`` library."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence) -> None:
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None
        self._err: Optional[ctypes._CFuncPtr] = None
        KERNELS[name] = self

    def _bind(self) -> None:
        lib = ctypes.CDLL(str(build_all()[self.source]))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.source}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def launch(self, *args) -> None:
        """Call the entry point; raise unless it returns cudaSuccess."""
        if self._fn is None:
            self._bind()
        rc = self._fn(*args)
        if rc != 0:
            msg = self._err(rc).decode(errors="replace")
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{rc} ({msg})")
        self.launches += 1


#: every kernel of the port, by name (filled as the kernel modules import)
KERNELS: dict[str, Kernel] = {}

#: the element types of the general kernels (``csrc/*_simt.cu``) and their
#: codes there (``simt::DType`` in ``csrc/simt_common.cuh``)
SIMT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
