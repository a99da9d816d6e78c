"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. The host library ``native`` (``native/dataloader.cc``, the
JPEG loader) is compiled by ``g++`` with the JAX package's own flags, so
the two builds agree bit for bit on one machine. A library's file name
carries a hash of its source and flags, so an edited source is rebuilt
and a stale one is never loaded; each build writes a temporary file and
renames it into place, so concurrent builds (test workers) never load a
half-written library. Builds go to ``build/yoloret_tpu_torch/`` beside
the package (``build/`` is git-ignored); ``build_all`` starts one
compiler per source at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yoloret_tpu_torch"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# nms.cu: no FMA contraction, so IoU and its threshold test round exactly
# as the plain PyTorch version does.
EXTRA_FLAGS = {"mbconv": [], "nms": ["-fmad=false"]}
# Host libraries: name -> source. g++ flags of yoloret_tpu/native/__init__.py.
HOST_SOURCES = {"native": PKG / "native" / "dataloader.cc"}
HOST_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
HOST_LIBS = ["-ljpeg", "-lpthread"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source(name: str) -> Path:
    return HOST_SOURCES.get(name) or CSRC / f"{name}.cu"


def _flags(name: str):
    if name in HOST_SOURCES:
        return HOST_FLAGS + HOST_LIBS
    return ARCH + BASE_FLAGS + EXTRA_FLAGS[name]


def library_path(name: str) -> Path:
    h = hashlib.sha1(_source(name).read_bytes())
    if name in HOST_SOURCES:  # -march=native: a build is only for the host that made it
        h.update(platform.node().encode())
    else:
        for dep in sorted(CSRC.glob("*.cuh")):
            h.update(dep.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list:
    src = str(_source(name))
    if name in HOST_SOURCES:  # libraries after the source, as the linker needs them
        return ["g++", *HOST_FLAGS, src, *HOST_LIBS, "-o", str(out)]
    return [nvcc_path(), *_flags(name), "-o", str(out), src]


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:  # no compiler
        raise RuntimeError(f"cannot build {_source(name).relative_to(PKG)}: {e}") from e
    return name, out, tmp, proc


def _finish(job) -> None:
    name, out, tmp, proc = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        compiler = "g++" if name in HOST_SOURCES else "nvcc"
        raise RuntimeError(f"{compiler} failed for {_source(name).relative_to(PKG)}:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = tuple(EXTRA_FLAGS)) -> float:
    """Compile every named library that is not built yet, all compilers
    at once; returns the seconds it took. Raises the first failure after
    every compiler has ended."""
    t0 = time.perf_counter()
    jobs, error = [], None
    for n in names:
        try:
            job = _start(n)
        except RuntimeError as e:
            error = error or e
            continue
        if job is not None:
            jobs.append(job)
    try:
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:
                error = error or e
        if error is not None:
            raise error
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
    """The loaded library ``name`` (``csrc/<name>.cu`` or a host library of
    ``HOST_SOURCES``), built if needed, with
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
