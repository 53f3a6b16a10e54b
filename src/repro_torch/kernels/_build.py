"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``src/repro_torch/csrc/`` with a plain C
interface (the tensor-core ones include the shared ``csrc/wgmma.cuh``).
``build`` compiles it with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at the repository root, under a name keyed by the hash
of the source, the shared headers and the flags, so an unchanged source is
compiled once; ``load``
opens the library with ``ctypes``.  Several sources given to one ``build`` call
are compiled by concurrent ``nvcc`` processes.  ``on_cpu`` is the wrappers'
device dispatch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class CudaSource:
    """One kernel source and the extra ``nvcc`` flags it is built with."""

    name: str                    # file stem under csrc/, e.g. "rmsnorm"
    extra_flags: Tuple[str, ...] = ()

    @property
    def path(self) -> pathlib.Path:
        return CSRC / f"{self.name}.cu"

    @property
    def flags(self) -> Tuple[str, ...]:
        return BASE_FLAGS + self.extra_flags

    def lib_path(self) -> pathlib.Path:
        # the shared headers (csrc/*.cuh) are part of every source's key
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        key = hashlib.sha256(self.path.read_bytes() + headers + " ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.name}_{key.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(*sources: CudaSource) -> Dict[str, Dict[str, object]]:
    """Compile every source not built before, one ``nvcc`` each, all at once.

    Returns ``{name: {"path", "seconds", "log", "cached"}}``.  Each library is
    written to a temporary file and renamed into place, so racing processes
    never load half a library.  Raises ``RuntimeError`` naming every source
    that failed to compile."""
    out: Dict[str, Dict[str, object]] = {}
    running: List[Tuple[CudaSource, pathlib.Path, str, subprocess.Popen, float]] = []
    try:
        for src in sources:
            lib_path = src.lib_path()
            if lib_path.exists():
                out[src.name] = {"path": str(lib_path), "seconds": 0.0, "log": "", "cached": True}
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *src.flags, "-o", tmp, str(src.path)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            running.append((src, lib_path, tmp, proc, time.perf_counter()))
        errors = []
        for src, lib_path, tmp, proc, t0 in running:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}) on {src.path.name}:\n{stderr}")
                continue
            os.replace(tmp, lib_path)
            out[src.name] = {"path": str(lib_path), "seconds": time.perf_counter() - t0,
                             "log": stdout + stderr, "cached": False}
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, _, tmp, proc, _ in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(src: CudaSource) -> ctypes.CDLL:
    """The built library of ``src`` (built first if need be).  The caller
    declares ``argtypes`` and ``restype`` of what it calls."""
    lib = ctypes.CDLL(build(src)[src.name]["path"])
    lib.veer_cuda_error_string.argtypes = [ctypes.c_int]
    lib.veer_cuda_error_string.restype = ctypes.c_char_p
    return lib


def on_cpu(what: str, *tensors) -> bool:
    """True for tensors all on the CPU (a wrapper's plain version), False
    for tensors on one CUDA device (its kernel); ``ValueError`` for anything
    else: no call carries on with tensors the kernel cannot take."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what} kernel needs its tensors on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    return False


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = lib.veer_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")
