"""Build the port's CUDA kernels and bind them through ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds), placed in ``build/repro_torch_kernels/`` at the repository root and
named by a digest of its source and flags, so an edited source never loads a
stale library. :func:`build` compiles every missing library in parallel (one
``nvcc`` process per source); a kernel's first launch builds just its own.

Flags: ``--fmad=false`` and no ``--use_fast_math``. The primal-gradient
kernel must reproduce the plain PyTorch formula bit for bit — one ulp of PG
can flip which task wins an admission tie — so nvcc may not contract a
multiply and an add on its own; any FMA a kernel wants is written out as
``__fmaf_rn``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "CudaKernel", "build", "current_stream",
           "find_nvcc"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def find_nvcc() -> str | None:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    return next((c for c in cands if c and os.path.exists(c)), None)


def _lib_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build(sources=None) -> dict[str, dict]:
    """Compile the given ``csrc`` sources (all when None) that have no built
    library yet, one ``nvcc`` per source, all started together.

    Returns ``{source: {"seconds": s, "log": ptxas report}}`` for the sources
    compiled by this call. Raises with the compiler's output on a failure.
    """
    sources = sorted(p.name for p in CSRC.glob("*.cu")) if sources is None \
        else list(sources)
    todo = [s for s in sources if not _lib_path(s).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for s in todo:
        out = _lib_path(s)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    report, failed = {}, []
    for s, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {s} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        report[s] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def current_stream(device_index: int) -> int:
    """The caller's current CUDA stream on ``device_index`` as a raw handle:
    ``torch.cuda.current_stream(device_index).cuda_stream``, read without
    building a ``torch.cuda.Stream`` object (the lookup Triton's launcher
    makes)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


class CudaKernel:
    """One exported C launcher of a ``csrc`` library, loaded at first use.

    ``launches`` counts the launches this wrapper made — incremented after
    the launcher enqueued the kernel and ``cudaGetLastError`` came back
    clean, nowhere else. The launcher returns that error code; a nonzero
    code raises here, with CUDA's own message. The ctypes function is
    resolved once; a call is that function and the check of its code.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None

    def _load(self):
        if self._fn is None:
            build([self.source])
            lib = ctypes.CDLL(str(_lib_path(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.repro_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def library(self) -> ctypes.CDLL:
        """The loaded library, for its other exported functions."""
        self._load()
        return self._lib

    def __call__(self, *args) -> None:
        code = (self._fn or self._load())(*args)
        if code != 0:
            msg = self._lib.repro_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {code} ({msg})")
        self.launches += 1
