"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at the
repo root, where ``<hash>`` is a digest of the source, the shared
headers (``csrc/*.cuh``) and the flags: an edited source or header
builds anew, an unchanged one is loaded from the last build. The
library is loaded with ``ctypes``. Only the sources in this package's
``csrc/`` are ever built.

A build happens at a kernel's first launch, never at import: machines
without ``nvcc`` import every module and use the plain versions. Each
library that ``nvcc`` actually compiles is one compile event of
:mod:`repro_torch.core.monitoring`, with the seconds from the start of
the builds to its end.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.core import monitoring

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> Path:
    path = CSRC / f"{name}.cu"
    if not path.is_file():
        raise FileNotFoundError(f"no kernel source {path}")
    return path


def library_path(name: str) -> Path:
    """Where ``name``'s build lives: keyed on its source, the headers
    and the flags."""
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA "
                           "kernels build only on a machine with the "
                           "CUDA toolkit")
    return found


def build(names) -> dict[str, Path]:
    """Compile every named kernel that has no current build, one
    ``nvcc`` per source, all started together. Returns the library
    paths; ``nvcc``'s output (register and shared-memory use) is kept
    beside each library as ``.log``."""
    names = list(names)
    libs = {name: library_path(name) for name in names}
    todo = [name for name in names if not libs[name].is_file()]
    if not todo:
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = libs[name].with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        monitoring.record_compile(time.perf_counter() - t0)
        libs[name].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
