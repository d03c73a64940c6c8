"""Build and load the port's hand-written CUDA kernels.

Each kernel library is one ``.cu`` file under ``ops/csrc/`` with a plain C
interface. It is compiled by ``nvcc`` for ``sm_90a`` into a shared library
and loaded with ``ctypes``. The build happens at first use, never at import,
into ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), keyed on a hash of the source and the flags, so a second
use in any process loads the library already built. A failed build raises.

``build_all()`` starts one ``nvcc`` per library at once and waits for all
of them, so several kernels build in the time of the slowest.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# library name -> source file under csrc/
SOURCES = {"flash_attention": "flash_attention.cu",
           "flash_attention_tc": "flash_attention_tc.cu",
           "flash_attention_tf32": "flash_attention_tf32.cu",
           "flash_attention_bwd_tc": "flash_attention_bwd_tc.cu"}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    key = hashlib.sha256(src + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every library in ``names`` (default: all) that is not built
    yet, all ``nvcc`` processes at once. Returns the seconds each build took
    (0.0 for one already built). Raises with nvcc's output on failure."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failures:
        raise RuntimeError("kernel build failed\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the last
    build of ``name`` in this checkout, or '' if it was never built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.v6t_cuda_error_string.argtypes = [ctypes.c_int]
        lib.v6t_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib.v6t_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
