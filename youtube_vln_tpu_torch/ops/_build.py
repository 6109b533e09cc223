"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface in the build directory, ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``) unless ``set_build_dir`` names another
(the entries' ``--compilation_cache_dir``), named by a hash of its source,
of every header under ``csrc/`` and of the compiler flags, so an edited
kernel or shared header is rebuilt.  Nothing is built at import time:
``load`` builds on first use, and ``build_all`` starts one ``nvcc`` per
source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("attention_fwd", "attention_bwd", "epilogue", "layer_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_build_dir = BUILD_DIR


def set_build_dir(path) -> None:
    """Build and load the kernels under ``path`` from now on (``""`` or
    None: ``BUILD_DIR``); a library loaded already stays loaded."""
    global _build_dir
    _build_dir = Path(path) if path else BUILD_DIR


def build_dir() -> Path:
    return _build_dir


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location."""
    home = os.environ.get("CUDA_HOME")
    for cand in (str(Path(home) / "bin" / "nvcc") if home else "",
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """``<build dir>/lib<name>_<hash>.so``; the hash covers the source,
    every ``*.cuh`` under ``csrc/`` (any of them may be included) and the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:12]}.so"


def _start(name: str, verbose: bool) -> Tuple[Path, Path, subprocess.Popen]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build_all(names: Tuple[str, ...] = SOURCES,
              verbose: bool = False) -> Dict[str, str]:
    """Compiles every source not built yet, all ``nvcc`` processes in
    parallel.  Returns the compiler output by source name."""
    build_dir().mkdir(parents=True, exist_ok=True)
    jobs: List[Tuple[str, Path, Path, subprocess.Popen]] = [
        (n, *_start(n, verbose)) for n in names
        if verbose or not library_path(n).exists()]
    logs, failed = {}, []
    for name, out, tmp, proc in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).exists():
            build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
