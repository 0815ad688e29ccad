"""Build the port's CUDA kernels with ``nvcc`` at first use; load them
with ``ctypes``.

Each source in ``repro_torch/csrc`` compiles into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>-<digest>.so <name>.cu

``--fmad=false`` is part of the bit contract of ``cell_update`` and
``hist_accum``: their plain PyTorch versions round every multiply and add
on its own, and a contracted ``a*b+c`` would not. The attention kernels,
held to their plain versions by a bf16 tolerance, are built with the
same flags. The libraries land in ``repro_torch/build/`` (git-ignored),
named by a digest of the sources and flags, so an edited source
rebuilds and an unchanged one loads as built. ``build_all`` starts one
``nvcc`` per missing library, all at once, and waits for them together;
a failed build raises with the compiler's output.
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

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("hist_sketch", "cell_update", "flash_attention",
           "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "repro_torch/csrc at first use and need the CUDA "
                       "toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> Path:
    """The compiler's output (``-Xptxas -v`` register/shared-memory
    report) of the last build of ``name``."""
    return BUILD_DIR / f"{name}.log"


def build_all() -> dict[str, float]:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together. Returns the seconds each build
    took (empty when everything was built already)."""
    with _LOCK:
        todo = [n for n in SOURCES if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        secs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            build_log(name).write_text(log)
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode}):\n"
                              f"{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point of
    ``lib`` (every library exports ``error_string``)."""
    if status != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(status).decode()
        raise RuntimeError(f"{what} failed: cudaError_t {status} ({msg})")
