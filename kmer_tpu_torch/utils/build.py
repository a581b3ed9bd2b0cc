"""One build-and-load helper for the port's native libraries.

Host C++ (the ingest parser and the pair aggregator, under
kmer_tpu_torch/native) is compiled with g++; the Hopper kernels under
kmer_tpu_torch/csrc are compiled with nvcc for sm_90a.  Every library is
a plain C interface loaded with ctypes, built at first use into the
git-ignored kmer_tpu_torch/_build/, and rebuilt when its source (or, for
a kernel, a header under csrc/) is newer.
Builds go to a process-unique temp name and are os.rename()d into place
(atomic on POSIX), so concurrent first uses (test workers) never dlopen
a half-written file.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NATIVE_DIR = os.path.join(PKG_DIR, "native")

CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread"]
NVCCFLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]

# seconds spent compiling, per library built in this process
build_seconds: dict[str, float] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build_cdll(src: str, name: str, *, cuda: bool = False,
               extra_link: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile `src` into _build/lib{name}.so if missing or stale, and
    dlopen it.  Raises RuntimeError with the compiler's output when the
    build fails."""
    so_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    deps = [src] + (glob.glob(os.path.join(CSRC_DIR, "*.cuh")) if cuda
                    else [])
    if (not os.path.exists(so_path) or os.path.getmtime(so_path)
            < max(os.path.getmtime(d) for d in deps)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.tmp.{os.getpid()}"
        cmd = ([nvcc(), *NVCCFLAGS] if cuda else ["g++", *CXXFLAGS])
        cmd += ["-shared", "-o", tmp, src, *extra_link]
        t0 = time.perf_counter()
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"build of {src} failed:\n{' '.join(cmd)}"
                                   f"\n{res.stdout}{res.stderr}")
            os.rename(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_seconds[name] = time.perf_counter() - t0
    return ctypes.CDLL(so_path)
