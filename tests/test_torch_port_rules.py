"""Rules the port keeps, checked on the CPU.

- The port package and chip_smoke.py import neither jax nor anything of the
  JAX package (only the tests import both).
- Entry points run on cuda unless the caller names a device: with no card
  they raise instead of drifting to the CPU.
- The ctypes mirrors of the kernels' argument structs follow the CUDA
  header.
"""

import ctypes
import re
import shutil
from pathlib import Path

import pytest
import torch

from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import engine as te
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy
from gpu_provisioner_tpu_torch.ops import _cuda

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+gpu_provisioner_tpu(\.|\s|,|$)"
    r"|from\s+gpu_provisioner_tpu(\.|\s))", re.M)


def _port_files():
    files = sorted((ROOT / "gpu_provisioner_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 8 and all(f.exists() for f in files)
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


@pytest.mark.parametrize("line,hit", [
    ("import jax", True), ("from jax import lax", True),
    ("    import jax.numpy as jnp", True),
    ("from gpu_provisioner_tpu.models import llama", True),
    ("import gpu_provisioner_tpu.ops", True),
    ("from gpu_provisioner_tpu import ops", True),
    ("from gpu_provisioner_tpu_torch.models import llama", False),
    ("import gpu_provisioner_tpu_torch", False), ("import jaxtyping", False),
])
def test_the_import_rule_catches_what_it_should(line, hit):
    assert bool(FORBIDDEN.search(line)) == hit


def test_entry_points_without_device_raise_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = tl.PRESETS["tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.init_kv_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.make_train_state(cfg, torch.Generator())
    params = tl.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.generate(params, torch.zeros(1, 4, dtype=torch.int32), cfg,
                    max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.ServeEngine(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"lm_head": params["lm_head"].numpy()})
    with pytest.raises(ValueError, match="params on cpu"):
        td.generate(params, torch.zeros(1, 4, dtype=torch.int32), cfg,
                    max_new_tokens=2, device="meta")


def _header_fields(struct: str) -> list:
    header = (_cuda.CSRC / "flash_common.cuh").read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\}};", header, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return re.findall(r"\*?\s*(\w+)\s*(?=[,;])", body)


def test_flash_args_mirror_the_cuda_struct():
    assert _header_fields("FlashArgs") == \
        [f[0] for f in _cuda.FlashArgs._fields_]
    assert ctypes.sizeof(_cuda.FlashArgs) == 248


def test_flash_bwd_args_mirror_the_cuda_struct():
    """9 pointers, 21 strides, 8 ints and the scale: 276 bytes, padded to
    the 8-byte alignment of the pointers."""
    assert _header_fields("FlashBwdArgs") == \
        [f[0] for f in _cuda.FlashBwdArgs._fields_]
    assert ctypes.sizeof(_cuda.FlashBwdArgs) == 280


def test_flash_tri_args_mirror_the_cuda_struct():
    """11 pointers, 24 strides, the workspace length, 7 ints and the
    scale: 316 bytes, padded to the 8-byte alignment of the pointers."""
    assert _header_fields("FlashTriArgs") == \
        [f[0] for f in _cuda.FlashTriArgs._fields_]
    assert ctypes.sizeof(_cuda.FlashTriArgs) == 320


def test_tri_grid_query_names_every_tri_entry():
    """flash_tri_ctas(which, ...) and flash_tri_ws_floats(which) number the
    three tri entries as the source's enum does."""
    text = (_cuda.CSRC / "flash_tri.cu").read_text()
    assert re.search(r"enum Which \{ FWD = 0, DQ = 1, DKV = 2 \}", text)
    assert _cuda.TRI_WHICH == {"flash_fwd_tri": 0, "flash_bwd_dq_tri": 1,
                               "flash_bwd_dkv_tri": 2}
    assert {e for e, (src, _) in _cuda.ENTRIES.items()
            if src == "flash_tri"} == set(_cuda.TRI_WHICH)
    assert 'extern "C" int flash_tri_ctas(int which, int act_dtype)' in text
    assert 'extern "C" long long flash_tri_ws_floats(int which)' in text


def test_every_entry_point_has_its_source_and_struct():
    assert set(_cuda.SOURCES) == {src for src, _ in _cuda.ENTRIES.values()}
    for entry, (source, args) in _cuda.ENTRIES.items():
        text = (_cuda.CSRC / f"{source}.cu").read_text()
        assert re.search(rf'extern "C" int {entry}\(const {args.__name__}\*',
                         text), entry


def test_kernel_libraries_are_keyed_by_source_hash_and_need_nvcc():
    paths = [_cuda.lib_path(n) for n in _cuda.SOURCES]
    assert len(set(paths)) == len(paths)
    assert all(p.parent == _cuda.BUILD_DIR for p in paths)
    assert _cuda.lib_path("flash_fwd") == _cuda.lib_path("flash_fwd")
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc present: the build itself is checked on the card")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build(("flash_fwd",))
