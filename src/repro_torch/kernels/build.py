"""Build the CUDA kernels with ``nvcc`` at first use and bind them with
``ctypes``.

Each source under ``csrc/`` compiles on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)
under ``<repo>/build/repro_torch/``, named by a hash of its source and
flags: a changed source rebuilds, an unchanged one loads.  All missing
libraries are compiled in parallel, one ``nvcc`` each.  Nothing is built
when this module is imported; a failed build raises with ``nvcc``'s
output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point and argtypes of each source: every pointer and the stream
# are c_void_p, or ctypes would pass them as 32-bit ints
ENTRY_POINTS = {
    "flash_attention": ("repro_flash_attention",
                        (P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P)),
    "flash_decode": ("repro_flash_decode",
                     (P, P, P, P, P, P, I, I, I, I, I, I, LL, LL, I, I, I, F, I, P)),
    "ssd_scan": ("repro_ssd_scan",
                 (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, LL, LL,
                  LL, I, P)),
    "rmsnorm": ("repro_rmsnorm", (P, P, P, I, I, F, I, I, P)),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}
build_log: Dict[str, str] = {}       # nvcc output of the builds this process ran


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _compile_missing(names) -> None:
    todo = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode == 0:
            os.replace(tmp, lib)         # atomic: a reader never sees half a file
        else:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(*names: str) -> Dict[str, ctypes._CFuncPtr]:
    """Build (where needed) and bind the named kernels, all by default.
    Returns ``{name: C function}`` with argtypes and restype set."""
    names = names or tuple(ENTRY_POINTS)
    with _lock:
        missing = [n for n in names if n not in _loaded]
        if missing:
            _compile_missing(missing)
            for name in missing:
                symbol, argtypes = ENTRY_POINTS[name]
                fn = getattr(ctypes.CDLL(str(_library_path(name))), symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _loaded[name] = fn
        return {n: _loaded[n] for n in names}


def kernel(name: str) -> ctypes._CFuncPtr:
    return load(name)[name]
