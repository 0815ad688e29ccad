"""Build the port's CUDA kernels with ``nvcc`` at first use; load them
with ``ctypes``.

Each source in ``repro_torch/csrc`` compiles into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [--fmad=false] [-lcuda]
         -o lib<name>-<digest>.so <name>.cu

The flags differ by source (``nvcc_flags``). ``--fmad=false`` is part of
the bit contract of ``cell_update``, ``hist_accum`` and ``rglru_scan``:
their plain PyTorch versions round every multiply and add on its own,
and a contracted ``a*b+c`` would not. ``ssd_scan`` writes its products
as explicit ``__fmaf_rn`` and keeps the flag as it was built with. The
attention kernels, held to their plain versions by a bf16 tolerance,
are built without it, so nvcc contracts their softmax arithmetic.
``flash_attention`` links libcuda (``-lcuda``) for
``cuTensorMapEncodeTiled``, which encodes its TMA tensor maps. The
libraries land in ``repro_torch/build/`` (git-ignored), named by a
digest of the sources and each one's own flags, so an edited source or
a changed flag rebuilds and an unchanged one loads as built.
``build_all`` starts one ``nvcc`` per missing library, all at once, and
waits for them together; a failed build raises with the compiler's
output.
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
           "decode_attention", "ssd_scan", "rglru_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# held bit for bit (or, ssd_scan, product by product) to their plain versions
NO_FMAD = ("hist_sketch", "cell_update", "ssd_scan", "rglru_scan")
# call libcuda itself (cuTensorMapEncodeTiled)
LINK_LIBCUDA = ("flash_attention",)

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


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The ``nvcc`` flags of kernel source ``name`` (output and input
    paths aside)."""
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}")
    return (NVCC_FLAGS + (("--fmad=false",) if name in NO_FMAD else ())
            + (("-lcuda",) if name in LINK_LIBCUDA else ()))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
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
        # libcuda's link stub, where the toolkit has one
        stubs = Path(nvcc).resolve().parent.parent / "lib64" / "stubs"
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            flags = nvcc_flags(name)
            libs = [f for f in flags if f.startswith("-l")]
            if libs and stubs.is_dir():
                libs.insert(0, f"-L{stubs}")
            cmd = [nvcc, *(f for f in flags if not f.startswith("-l")),
                   "-o", str(tmp), str(CSRC / f"{name}.cu"), *libs]
            log = open(build_log(name), "w")
            procs[name] = (subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, text=True), log,
                tmp, out)
        secs, failed = {}, []
        while len(secs) < len(procs):  # each build's own seconds
            for name, (proc, log, tmp, out) in procs.items():
                if name in secs or proc.poll() is None:
                    continue
                secs[name] = time.perf_counter() - t0
                log.close()
                if proc.returncode != 0:
                    failed.append(f"--- {name} (nvcc exit {proc.returncode})"
                                  f":\n{build_log(name).read_text()}")
                else:
                    os.replace(tmp, out)
            time.sleep(0.05)
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
