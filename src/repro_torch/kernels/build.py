"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` exposes a plain C interface and is compiled, at
first use, into ``build/repro_torch_kernels/`` at the repo root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused. A failed build raises.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists. The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``.log``."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):"
                           f"\n{proc.stdout}\n{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)          # atomic: never load a half-written file
    return so


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_log(name: str) -> str:
    """What nvcc printed when it built the current ``<name>`` library."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if need be."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
