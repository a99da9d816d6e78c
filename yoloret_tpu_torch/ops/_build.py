"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale one is never loaded.
Builds go to ``build/yoloret_tpu_torch/`` beside the package (``build/``
is git-ignored); ``build_all`` starts one ``nvcc`` per source at once.
Nothing here runs at import time.
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
from typing import Any, Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yoloret_tpu_torch"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# nms.cu: no FMA contraction, so IoU and its threshold test round exactly
# as the plain PyTorch version does.
EXTRA_FLAGS = {"mbconv": [], "nms": ["-fmad=false"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str):
    return ARCH + BASE_FLAGS + EXTRA_FLAGS[name]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, out, tmp, proc


def _finish(job) -> None:
    name, out, tmp, proc = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = tuple(EXTRA_FLAGS)) -> float:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes at once; returns the seconds it took."""
    t0 = time.perf_counter()
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    try:
        for job in jobs:
            _finish(job)
    finally:
        for _, _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def ptxas_log(name: str) -> str:
    """What ``-Xptxas -v`` reported for the built library (registers,
    shared memory, spills per kernel)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, prototypes: Dict[str, Tuple[list, Any]]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed, with
    ``argtypes``/``restype`` set from ``prototypes`` ({symbol: (argtypes,
    restype)}) on first load."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for symbol, (argtypes, restype) in prototypes.items():
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = argtypes, restype
            _libs[name] = lib
        return lib
