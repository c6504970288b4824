"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` exposes a plain C interface and is compiled, at
first use, into ``build/repro_torch_kernels/`` at the repo root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, of the shared headers
(``csrc/*.cuh``) and of the flags, so an edited source or header is rebuilt
and an unchanged one is reused. A failed build raises.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

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


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(_flags(defines)).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists. The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``.log``. ``defines`` (``NAME=value``)
    build a variant of the source for a measurement; the port's own calls
    give none."""
    so = library_path(name, defines)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *_flags(defines), "-o", tmp, str(CSRC / f"{name}.cu")]
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


def build_log(name: str, defines: Tuple[str, ...] = ()) -> str:
    """What nvcc printed when it built the current ``<name>`` library."""
    return library_path(name, defines).with_suffix(".log").read_text()


def kernel_resources(name: str, kernels: Tuple[str, ...],
                     defines: Tuple[str, ...] = ()) -> Dict[str, dict]:
    """Registers and spill bytes, from ptxas's log (``-Xptxas -v``) of the
    built ``<name>`` library, of each kernel whose entry name holds one of
    ``kernels``, keyed by that string."""
    out = {}
    for entry, block in re.findall(r"Compiling entry function '([^']*)'"
                                   r"(.*?)(?=Compiling entry|\Z)",
                                   build_log(name, defines), re.S):
        kernel = next((k for k in kernels if k in entry), None)
        if kernel is None:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        out[kernel] = {"registers": int(regs.group(1)) if regs else None,
                       "spill_store_bytes": int(spill.group(1)) if spill
                       else None,
                       "spill_load_bytes": int(spill.group(2)) if spill
                       else None}
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if need be."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
