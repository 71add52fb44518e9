"""Build and load the package's CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``ops/_build/`` under a name
keyed by a hash of the sources and flags, and loaded with ``ctypes``.
Nothing here runs when the module is imported, so the CPU tests import it
freely; ``build()`` starts one ``nvcc`` per source, all at once.

No JAX twin: the JAX package's kernels are Pallas, compiled by XLA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_fwd", "flash_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


class FlashArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct FlashArgs`` in csrc/flash_common.cuh."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("q", "k", "v", "k_scale", "v_scale",
                                        "out", "lse", "starts", "pad_lens")]
        + [(n, ctypes.c_longlong) for n in (
            "q_sb", "q_ss", "q_sh", "k_sb", "k_ss", "k_sh", "v_sb", "v_ss",
            "v_sh", "sc_sb", "sc_ss", "sc_sh", "o_sb", "o_ss", "o_sh")]
        + [(n, ctypes.c_int) for n in (
            "act_dtype", "kv_dtype", "B", "Sq", "Sk", "Hq", "Hkv", "D",
            "start", "n_start", "causal", "window", "sinks")]
        + [("scale", ctypes.c_float)])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together. Returns
    {name: nvcc output} (register and spill counts from ``-Xptxas -v``) for
    the sources it compiled; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use; its one
    entry point ``<name>(const FlashArgs*, cudaStream_t) -> cudaError_t``."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(FlashArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
