"""Build and load the port's CUDA kernels.

Every `mico_tpu_torch/csrc/*.cu` is compiled by `nvcc` for `sm_90a` into its
own shared library with a plain C interface, at first use, into
`build/mico_tpu_torch/` at the repository root. The library's file name
carries a hash of all sources in `csrc/` (headers included) and of the
flags, so an edited source is rebuilt and a stale library is never loaded.
All sources compile in parallel, one `nvcc` each. The libraries are loaded
with `ctypes`; each C entry returns `cudaGetLastError()` after its launches.

Host code (`csrc/*.cpp`, the audio decoder) is built apart by `g++`
(`build_host`), one library per source whose name carries a hash of that
source and the flags alone: neither joins the `*.cu` set or its hash, so a
host edit rebuilds no kernel. Nothing compiles at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "mico_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
GXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels need the CUDA toolkit"
    )


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build_all() -> Dict[str, Path]:
    """Compile every kernel source that has no up-to-date library; returns
    {source stem: library path}. Raises with nvcc's output on failure."""
    tag = sources_hash()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {p.stem: BUILD_DIR / f"lib{p.stem}-{tag}.so"
            for p in sorted(CSRC.glob("*.cu"))}
    jobs = []
    for stem, lib in libs.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{stem}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((stem, lib, tmp, proc))
    failures = []
    for stem, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            os.unlink(tmp)
            failures.append(f"{stem}.cu (exit {proc.returncode}):\n{out}")
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return libs


@functools.lru_cache(maxsize=None)
def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<stem>.cu`."""
    return ctypes.CDLL(str(build_all()[stem]))


@functools.lru_cache(maxsize=None)
def build_host(stem: str) -> Path:
    """Compile `csrc/<stem>.cpp` with `g++` unless its library exists;
    returns the library's path. The library is written to a temporary file
    and renamed into place, so processes that build at once each load a
    whole one. Raises with g++'s output on failure, or when there is no
    g++."""
    src = CSRC / f"{stem}.cpp"
    tag = hashlib.sha256(" ".join(GXX_FLAGS).encode() + src.read_bytes())
    lib = BUILD_DIR / f"lib{stem}-{tag.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {src.name} is host C++ built at "
                           f"first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {src.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_host(stem: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<stem>.cpp`."""
    return ctypes.CDLL(str(build_host(stem)))
