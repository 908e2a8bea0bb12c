"""Build of the port's CUDA kernels: each ``csrc/*.cu`` source is compiled
by ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), under ``build/torch_ext/``
at the root of the checkout, and loaded with ctypes by its wrapper.

A library's file name carries the hash of its source and of the flags, so
an edited source builds anew. :func:`build` starts one ``nvcc`` for every
source whose library is missing, all at once, and waits for them all.
It holds an exclusive ``fcntl.flock`` on the build directory's lock file
meanwhile, so processes that start together (the ranks of the spmd
backend) compile each source once: one builds, the others wait for the
lock, find the libraries and only load them.

``BUILD_DIR`` is the build directory; ``launch/compile_cache.py`` points
it elsewhere (``--compile-cache DIR``) before the first build, so that a
second process on the same directory compiles nothing. With a recorder
active (``repro_torch.obs``) each :func:`build` writes a
``kernels/build`` span: ``built``, the sources it compiled, and
``cached``, how many it found built.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

# nvcc's output of the last build of each source (the ptxas -v lines)
logs: dict = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"


def build(*sources: Path) -> list:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together; returns the libraries' paths in order. Raises
    with nvcc's output if any build fails."""
    from repro_torch.obs import recorder

    rec = recorder.active()
    t0 = rec.clock() if rec is not None else None
    libs = [library_path(s) for s in sources]
    built = []
    try:
        if not all(lib.exists() for lib in libs):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / "build.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)  # released when closed
                built = _build_missing(sources, libs)
    except BaseException:
        if rec is not None:
            rec.end_span("kernels/build", t0, failed=True, built=built,
                         cached=0)
        raise
    if rec is not None:
        rec.end_span("kernels/build", t0, built=built,
                     cached=len(sources) - len(built))
    return libs


def _build_missing(sources, libs) -> list:
    """Compile the sources whose library is (still) missing; returns
    their file names."""
    jobs = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        logs[src.name] = out
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc failed ({proc.returncode}):\n"
                          f"{out}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [src.name for src, *_ in jobs]
