"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into a shared library, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so \\
         src/repro_torch/csrc/<name>.cu

The build runs at first use, with one ``nvcc`` per source all started
together, into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``).  A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
``ptxas -v`` (registers, shared memory, spills) goes to ``<name>.log`` beside
it.  Nothing here runs at import: the CPU tests import every module.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, all ``nvcc`` runs at
    once.  -> {source stem: seconds spent building it (0.0 if reused)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        started[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    seconds = {src.stem: 0.0 for src in CSRC.glob("*.cu")}
    failures = []
    for stem, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[stem] = time.perf_counter() - t0
        (BUILD_DIR / f"{stem}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {stem}.cu:\n{log}")
            continue
        os.replace(tmp, out)        # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(stem: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<stem>.cu``, building the
    libraries first if needed.  It returns a cudaError_t as an int."""
    with _lock:
        key = (stem, symbol)
        if key not in _functions:
            path = _library_path(CSRC / f"{stem}.cu")
            if not path.exists():
                build_all()
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[key] = fn
        return _functions[key]
