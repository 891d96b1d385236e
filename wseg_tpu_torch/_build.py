"""Build and load the hand-written native code in ``csrc/``.

Each ``csrc/<name>.cu`` is a CUDA source with a plain C interface,
compiled by ``nvcc`` for ``sm_90a``; each ``csrc/<name>.cc`` is host C++
with a plain C interface, compiled by the C++ compiler on ``PATH``
(``$CXX``, else ``c++``, else ``g++``).  Either becomes a shared library
under ``build/kernels/`` at the repository root, named by a hash of its
source and flags (an edited source rebuilds), loaded with ctypes.  The
build runs on first use in a process; nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_libs: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def find_cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler ($CXX, c++, g++ on PATH): the host "
                       "lattice library cannot be built")


def source(name: str) -> Path:
    for suffix in (".cu", ".cc"):
        path = CSRC_DIR / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cc")


def _command(src: Path) -> list:
    """Compiler and flags for ``src``, without the output."""
    if src.suffix == ".cu":
        return [find_nvcc(), *NVCC_FLAGS]
    return [find_cxx(), *CXX_FLAGS]


def library_path(name: str) -> Path:
    src = source(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` or ``.cc`` unless its library is already
    built.  Returns the library path; raises with the compiler's output
    on failure.  The output (``-Xptxas -v``'s lines) goes to ``build.log``
    and to a ``.log`` file beside the library."""
    lib = library_path(name)
    log = lib.with_suffix(".log")
    if lib.exists():
        if name not in build.log and log.exists():
            build.log[name] = log.read_text()
        return lib
    src = source(name)
    cmd = _command(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {src.name} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    build.log[name] = (proc.stdout + proc.stderr).strip()
    log.write_text(build.log[name])
    os.replace(tmp, lib)
    return lib


build.log = {}  # compiler output by name, also kept beside the library


def load(name: str) -> ctypes.CDLL:
    """Build (once) and load the library ``name``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
