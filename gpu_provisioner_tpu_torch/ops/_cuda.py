"""Build and load the package's CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``ops/_build/`` under a name
keyed by a hash of the sources and flags, and loaded with ``ctypes``. Each C
entry point takes a pointer to its argument struct and a stream and returns
``cudaGetLastError()`` (``ENTRIES``).
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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_fwd", "flash_fwd_mid", "flash_decode", "flash_decode_narrow",
           "flash_decode_mid", "flash_bwd", "flash_bwd_mid", "flash_tri",
           "flash_tri_narrow", "flash_tri_mid")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# seconds from the start of the last build() to each of its nvcc processes'
# end, by source
BUILD_SECONDS: dict[str, float] = {}
_TRI_CTAS: dict[tuple, int] = {}
_TRI_WS: dict[tuple, int] = {}


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
        + [("scale", ctypes.c_float), ("ws", ctypes.c_void_p),
           ("ws_floats", ctypes.c_longlong), ("splits", ctypes.c_int)])


class FlashBwdArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct FlashBwdArgs`` in
    csrc/flash_common.cuh."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("q", "k", "v", "dout", "lse", "delta",
                                        "dq", "dk", "dv")]
        + [(f"{t}_s{ax}", ctypes.c_longlong)
           for t in ("q", "k", "v", "do", "dq", "dk", "dv") for ax in "bsh"]
        + [(n, ctypes.c_int) for n in ("act_dtype", "B", "S", "Hq", "Hkv", "D",
                                       "causal", "window")]
        + [("scale", ctypes.c_float)])


class FlashTriArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct FlashTriArgs`` in
    csrc/flash_common.cuh."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("q", "k", "v", "dout", "out", "lse",
                                        "delta", "dq", "dk", "dv", "ws")]
        + [(f"{t}_s{ax}", ctypes.c_longlong)
           for t in ("q", "k", "v", "do", "o", "dq", "dk", "dv") for ax in "bsh"]
        + [("ws_floats", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in ("act_dtype", "B", "S", "Hq", "Hkv", "D",
                                       "ctas")]
        + [("scale", ctypes.c_float)])


# C entry point -> (source in csrc/, argument struct)
ENTRIES = {
    "flash_fwd": ("flash_fwd", FlashArgs),
    "flash_fwd_mid": ("flash_fwd_mid", FlashArgs),
    "flash_decode": ("flash_decode", FlashArgs),
    "flash_decode_narrow": ("flash_decode_narrow", FlashArgs),
    "flash_decode_mid": ("flash_decode_mid", FlashArgs),
    "flash_bwd_dq": ("flash_bwd", FlashBwdArgs),
    "flash_bwd_dkv": ("flash_bwd", FlashBwdArgs),
    "flash_bwd_dq_mid": ("flash_bwd_mid", FlashBwdArgs),
    "flash_bwd_dkv_mid": ("flash_bwd_mid", FlashBwdArgs),
    "flash_fwd_tri": ("flash_tri", FlashTriArgs),
    "flash_bwd_dq_tri": ("flash_tri", FlashTriArgs),
    "flash_bwd_dkv_tri": ("flash_tri", FlashTriArgs),
    "flash_fwd_tri_narrow": ("flash_tri_narrow", FlashTriArgs),
    "flash_bwd_dq_tri_narrow": ("flash_tri_narrow", FlashTriArgs),
    "flash_bwd_dkv_tri_narrow": ("flash_tri_narrow", FlashTriArgs),
    "flash_fwd_tri_mid": ("flash_tri_mid", FlashTriArgs),
    "flash_bwd_dq_tri_mid": ("flash_tri_mid", FlashTriArgs),
    "flash_bwd_dkv_tri_mid": ("flash_tri_mid", FlashTriArgs),
}
# the `which` argument of flash_tri_ctas() and flash_tri_ws_floats() for
# each flattened-triangle entry
TRI_WHICH = {"flash_fwd_tri": 0, "flash_bwd_dq_tri": 1, "flash_bwd_dkv_tri": 2}


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
    the sources it compiled (each one's seconds in BUILD_SECONDS); raises
    with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    BUILD_SECONDS.clear()
    t0 = time.perf_counter()
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
    with ThreadPoolExecutor(max(1, len(procs))) as pool:
        texts = dict(zip(procs, pool.map(
            lambda n: _wait(n, procs[n][0], t0), procs)))
    for name, (proc, tmp, out) in procs.items():
        text = logs[name] = texts[name]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def _wait(name: str, proc, t0: float) -> str:
    """nvcc's output once ``proc`` ends; its seconds since ``t0`` go to
    BUILD_SECONDS."""
    text, _ = proc.communicate()
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return text


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


# the kernels whose head dims 32 and 16 live in a source of their own
# (csrc/flash_decode_narrow.cu, csrc/flash_tri_narrow.cu), built beside the
# 64 and 128 of flash_decode.cu and flash_tri.cu: C entry <kernel>_narrow
NARROW = ("flash_decode", "flash_fwd_tri", "flash_bwd_dq_tri",
          "flash_bwd_dkv_tri")
# the kernels whose head dims 80 and 96 live in a source of their own
# (csrc/flash_fwd_mid.cu, csrc/flash_decode_mid.cu, csrc/flash_bwd_mid.cu,
# csrc/flash_tri_mid.cu): C entry <kernel>_mid, every kernel
MID = ("flash_fwd", "flash_decode", "flash_bwd_dq", "flash_bwd_dkv",
       "flash_fwd_tri", "flash_bwd_dq_tri", "flash_bwd_dkv_tri")
MID_HEAD_DIMS = (80, 96)


def entry(kernel: str, head_dim: int) -> str:
    """The C entry that launches ``kernel`` at ``head_dim``: ``kernel``,
    ``kernel + "_narrow"`` for a kernel of NARROW at head dim 32 or 16, or
    ``kernel + "_mid"`` for a kernel of MID at head dim 80 or 96."""
    if kernel in MID and head_dim in MID_HEAD_DIMS:
        return f"{kernel}_mid"
    return f"{kernel}_narrow" if kernel in NARROW and head_dim < 64 \
        else kernel


def _tri_library(head_dim: int) -> ctypes.CDLL:
    """The library whose flash_tri_ctas / flash_tri_ws_floats answer for
    ``head_dim``: flash_tri_narrow's at 32 and 16, flash_tri_mid's at 80
    and 96, flash_tri's else."""
    if head_dim in MID_HEAD_DIMS:
        return library("flash_tri_mid")
    return library("flash_tri_narrow" if head_dim < 64 else "flash_tri")


def kernel(entry: str):
    """The C entry point ``entry`` (a key of ENTRIES) of its library, typed
    ``(const Args*, cudaStream_t) -> cudaError_t``."""
    source, args = ENTRIES[entry]
    fn = getattr(library(source), entry)
    fn.argtypes = [ctypes.POINTER(args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tri_ctas(entry: str, act_dtype: int, head_dim: int,
             device_index: int) -> int:
    """The persistent grid P of flattened-triangle entry ``entry`` at act
    dtype ``act_dtype`` and head dim ``head_dim`` on the card
    ``device_index`` (the SM count times the blocks of its kernel that fit
    on one SM, from the ``flash_tri_ctas`` of csrc/flash_tri.cu, or of
    flash_tri_narrow.cu at 32 and 16 and flash_tri_mid.cu at 80 and 96),
    cached."""
    key = (entry, act_dtype, head_dim, device_index)
    if key not in _TRI_CTAS:
        fn = _tri_library(head_dim).flash_tri_ctas
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        P = fn(TRI_WHICH[entry], act_dtype, head_dim)
        if P <= 0:
            raise RuntimeError(f"flash_tri_ctas({entry}, D={head_dim}) "
                               f"failed with cudaError {-P}")
        _TRI_CTAS[key] = P
    return _TRI_CTAS[key]


def bwd_dkv_blocks(B: int, Hkv: int, S: int, act_dtype: int) -> int:
    """The blocks ``flash_bwd_dkv`` launches for (B, Hkv, S) at act dtype
    ``act_dtype`` (0 f32, 1 bf16: the key tile differs; csrc/flash_bwd.cu's
    ``flash_bwd_dkv_blocks``, which owns the grid)."""
    fn = library("flash_bwd").flash_bwd_dkv_blocks
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    n = fn(B, Hkv, S, act_dtype)
    if n < 0:
        raise RuntimeError(f"flash_bwd_dkv_blocks failed with cudaError {-n}")
    return n


def tri_ws_floats(entry: str, act_dtype: int, head_dim: int) -> int:
    """f32 workspace values per CTA of flattened-triangle entry ``entry``
    for act dtype ``act_dtype`` (0 f32, 1 bf16: the dK/dV tile edge
    differs) and head dim ``head_dim`` (``flash_tri_ws_floats`` of
    csrc/flash_tri.cuh's entries, which own the layout), cached: the wrapper
    allocates ``tri_ctas(...)`` times this."""
    key = (entry, act_dtype, head_dim)
    if key not in _TRI_WS:
        fn = _tri_library(head_dim).flash_tri_ws_floats
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
        n = fn(TRI_WHICH[entry], act_dtype, head_dim)
        if n <= 0:
            raise RuntimeError(f"flash_tri_ws_floats({entry}, D={head_dim}) "
                               f"failed with cudaError {-n}")
        _TRI_WS[key] = n
    return _TRI_WS[key]
