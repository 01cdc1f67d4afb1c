"""Build the port's CUDA kernels from ``csrc/*.cu`` and bind them with ctypes.

Each source compiles with nvcc into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Libraries land in
``video_vae_tpu_torch/_build/`` under a name keyed by a hash of the source, the
``csrc`` headers it includes and the flags, so an edited source or header
rebuilds and an unchanged one is reused. nvcc finds a quoted include beside
the source that names it.
Nothing is built when a module is imported: a kernel builds at its first
launch, or all at once through :func:`build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# the dtype argument of every kernel's entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for candidate in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(f"nvcc not found (looked in {cuda_home}/bin and on PATH)")


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _with_headers(source: str, seen: tuple[str, ...] = ()) -> tuple[str, ...]:
    """``source`` and every ``csrc`` header it includes with quotes, transitively."""
    if source in seen:
        return seen
    seen += (source,)
    for header in _LOCAL_INCLUDE.findall((CSRC / source).read_text()):
        seen = _with_headers(header, seen)
    return seen


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    digest = hashlib.sha256()
    for name in _with_headers(source):
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: Iterable[str]) -> dict[str, str]:
    """Compile every source whose library is missing, one nvcc each, all at once.

    Returns the compiler's messages per source (ptxas register and spill
    counts; empty for a library that was already built). Raises with the
    compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[source] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    logs = {}
    failed = []
    for source, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[source] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {source} exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


class CudaKernel:
    """One C entry point of a ``csrc`` library, with the count of its launches.

    The entry point takes device pointers, sizes and a stream, launches, and
    returns the ``cudaError_t`` of the launch; :meth:`launch` raises if it is
    not 0. ``launches`` counts successful launches and nothing else.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._error_string = None

    def _load(self):
        build([self.source])
        lib = ctypes.CDLL(str(library_path(self.source)))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.vvt_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._error_string = fn, err

    def launch(self, *args) -> None:
        if self._fn is None:
            self._load()
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.symbol} failed: {self._error_string(code).decode()} ({code})"
            )
        self.launches += 1
