"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``: no PyTorch headers, so a
build takes seconds instead of minutes. The build happens at first use (or in
``build_all``, which starts one ``nvcc`` per source at once) into
``wormhole_tpu_torch/ops/_build/``, a directory git ignores. A library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and two processes that build at once each publish a complete file.

Nothing here runs when the module is imported: hosts without ``nvcc`` (the
CPU test hosts) import it freely and never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# --fmad=false: no multiply-add is contracted into an FMA, so the shared
# train-step math (csrc/tile_math.cuh) rounds alike in every kernel and the
# fused and split paths agree bitwise
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}   # guarded-by: _lock


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from ops/csrc at first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """(final path, Popen or None when already built, tmp path)."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish(name: str, out: Path, proc, tmp) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, str]:
    """Build every ``csrc/*.cu`` that is not built yet, one ``nvcc`` per
    source, all started together. Returns each new build's compiler log
    (``-Xptxas=-v`` register and shared-memory lines); empty for a source
    already built."""
    started = {n: _start(n) for n in sources()}
    return {n: _finish(n, *started[n]) for n in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, proc, tmp = _start(name)
            _finish(name, out, proc, tmp)
            lib = _libs[name] = ctypes.CDLL(str(out))
            lib.wh_error_string.argtypes = [ctypes.c_int]
            lib.wh_error_string.restype = ctypes.c_char_p
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.wh_error_string(err).decode()}")
