"""Build-at-first-use of the CUDA sources in ``csrc/`` and their ctypes binding.

The kernels have a plain C interface and include no framework header, so
``nvcc`` compiles each translation unit in seconds. :func:`load` compiles
every ``csrc/*.cu`` (one ``nvcc`` per source, all started together), links
them into ``_build/<hash>/librepro_kernels.so`` next to this file and opens
the library with ``ctypes``. ``<hash>`` covers the sources and the compiler
flags, so an edit rebuilds and an unchanged tree reuses the library. Nothing
here runs at import: a machine without ``nvcc`` imports the package fine and
only a kernel launch needs the compiler. A failed build raises with
``nvcc``'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load", "build", "check", "sources", "build_root", "NVCC_FLAGS",
           "DTYPE_SUFFIX"]

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_NAME = "librepro_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

#: suffix of the C functions for each working dtype name
DTYPE_SUFFIX = {"float32": "f32", "float64": "f64", "float16": "f16",
                "bfloat16": "bf16"}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# Argument types of the C interface (csrc/gemm.cuh, REPRO_DEFINE_C_API;
# csrc/gemm_tc.cuh, REPRO_DEFINE_TC_API; csrc/gemm_dmma.cuh,
# REPRO_DEFINE_DMMA_API; csrc/attention.cuh, REPRO_DEFINE_ATTENTION_API and
# REPRO_DEFINE_ATTN_COMBINE_API). Every pointer and the stream are c_void_p:
# without argtypes ctypes would pass them as 32-bit ints and cut the
# address. Each base name exists in every DTYPE_SUFFIX.
_SIGNATURES = {
    "repro_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _I, _I, _P],
    "repro_square_whole": [_P, _P, _I, _I, _L, _L, _I, _I, _I, _P],
    "repro_square_panel": [_P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _I, _P],
    "repro_flash_attention": [_P] * 6 + [_I] * 12 + [_F, _P],
    "repro_attn_combine": [_P, _P, _P, _I, _L, _I, _P],
}

_lock = threading.Lock()
_lib = None


def build_root() -> Path:
    """Directory the libraries are built into (git-ignored)."""
    return Path(__file__).resolve().parent / "_build"


def sources() -> list:
    """Every file of ``csrc/`` that enters the build, sorted."""
    return sorted(p for p in CSRC.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "cannot build the CUDA kernels: no nvcc on PATH, under $CUDA_HOME "
        "or under /usr/local/cuda")


def _run_all(commands) -> None:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in commands]
    failures = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n(exit {proc.returncode})\n"
                            f"{out}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def build() -> Path:
    """Compile and link the kernels if this source tree's library is not
    there yet; return the library's path."""
    out_dir = build_root() / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _find_nvcc()
    build_root().mkdir(parents=True, exist_ok=True)
    # Build in a scratch directory of our own and rename into place, so two
    # processes building at once never see a half-written library.
    work = Path(tempfile.mkdtemp(prefix=f"{out_dir.name}.tmp-",
                                 dir=build_root()))
    try:
        units = [p for p in sources() if p.suffix == ".cu"]
        objects = [str(work / (src.stem + ".o")) for src in units]
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
                   obj] for src, obj in zip(units, objects)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(work / LIB_NAME),
                   *objects]])
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(work / LIB_NAME, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def load():
    """The kernels' library, built on the first call and cached after."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for base, argtypes in _SIGNATURES.items():
                for suffix in DTYPE_SUFFIX.values():
                    fn = getattr(lib, f"{base}_{suffix}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned anything but 0 (``cudaSuccess``).

    A refused launch (too much shared memory, a bad grid) never runs and is
    reported only by this code; -1 means the library has no instantiation
    for the requested tile, -2 that a TMA tensor map could not be encoded.
    """
    if code == 0:
        return
    if code == -1:
        raise ValueError(f"{what}: no kernel is instantiated for this tile")
    if code == -2:
        raise RuntimeError(f"{what}: could not encode a TMA tensor map for "
                           f"the operands")
    raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")
