"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -I csrc -Xptxas -v -o build/kernels/<name>-<hash>.so csrc/<name>.cu

``<hash>`` covers the flags and every source and header in ``csrc/``, so an
edit rebuilds and an unchanged tree reuses the library. The build directory
``build/kernels/`` sits at the repository root and is listed in
``.gitignore``. Nothing here runs when the module is imported: a library
is built at its first use, or ahead of time by :func:`build`, which starts
one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entries per library: pointers and the stream as void*, sizes as int
SIGNATURES = {
    "conv_block": {
        "sinddm_conv_block_f32": [_P] * 10 + [_I] * 6 + [_P],
        "sinddm_conv_block_bf16": [_P] * 10 + [_I] * 6 + [_P],
    },
    "dw_conv": {
        "sinddm_dw_conv5x5_f32": [_P] * 5 + [_I] * 5 + [_P],
        "sinddm_dw_conv5x5_bf16": [_P] * 5 + [_I] * 5 + [_P],
    },
    "warp_sample": {
        "sinddm_warp_whole_fwd": [_P] * 3 + [_F] + [_I] * 6 + [_P],
        "sinddm_warp_whole_bwd": [_P] * 3 + [_I] * 8 + [_P],
        "sinddm_warp_win_fwd": [_P] * 3 + [_F] + [_I] * 6 + [_P],
        "sinddm_warp_winx_fwd": [_P] * 3 + [_F] + [_I] * 6 + [_P],
        "sinddm_warp_winb_fwd": [_P] * 3 + [_F] + [_I] * 6 + [_P],
        "sinddm_warp_win_bwd": [_P] * 3 + [_I] * 6 + [_P],
        "sinddm_warp_win3_fwd": [_P] * 3 + [_F] + [_I] * 6 + [_P],
        "sinddm_warp_win3_bwd": [_P] * 3 + [_I] * 6 + [_P],
    },
}

KERNELS = tuple(SIGNATURES)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns each build's seconds (0.0 for a
    library that was already there). Raises with the compiler's output if
    a build fails. The ``-Xptxas -v`` report goes to ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.sinddm_error_string.argtypes = [ctypes.c_int]
        lib.sinddm_error_string.restype = ctypes.c_char_p
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero cudaError_t."""
    if err != 0:
        msg = lib.sinddm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
