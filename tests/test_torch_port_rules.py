"""Rules the port keeps, checked on the CPU.

- The port package and chip_smoke.py import neither jax nor anything of the
  JAX package (only the tests import both).
- Entry points run on cuda unless the caller names a device: with no card
  they raise instead of drifting to the CPU.
- The ctypes mirrors of the kernels' argument structs follow the CUDA
  header.
"""

import ctypes
import inspect
import re
import shutil
from pathlib import Path

import pytest
import torch

from gpu_provisioner_tpu_torch import bench as tbench
from gpu_provisioner_tpu_torch import entry as tentry
from gpu_provisioner_tpu_torch import onchip_checks as tonchip
from gpu_provisioner_tpu_torch.examples import serve as tserve
from gpu_provisioner_tpu_torch.examples import train_resume
from gpu_provisioner_tpu_torch.models import checkpoint as tck
from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.models import engine as te
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import moe as tm
from gpu_provisioner_tpu_torch.models import speculative as tspec
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy
from gpu_provisioner_tpu_torch.ops import _cuda
from gpu_provisioner_tpu_torch.parallel import bootstrap as tboot
from gpu_provisioner_tpu_torch.parallel import launch as tlaunch
from gpu_provisioner_tpu_torch.parallel import topology as ttopo

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


def test_import_rule_reads_the_parallel_modules():
    """The rule's rglob reaches the multi-GPU modules (the pipeline too, and
    the spawned ranks' case runner)."""
    files = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    for name in ("topology", "bootstrap", "comm", "ring", "launch", "jobs",
                 "pipeline"):
        assert f"gpu_provisioner_tpu_torch/parallel/{name}.py" in files


def test_parallel_entry_points_without_device_raise_when_cuda_is_absent():
    """make_mesh, initialize_distributed, the mesh form of make_train_state
    and spawn_ranks run on cuda unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    topo = ttopo.SliceTopology(generation="v5e", topology="2x4", chips=8,
                               hosts=2, worker_hostnames=("h0", "h1"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttopo.make_mesh(4, sp=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tboot.initialize_distributed(topo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.make_train_state(tl.PRESETS["tiny"], torch.Generator(),
                                mesh=object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.spawn_ranks(print, 2, backend="gloo")


def test_pipeline_and_expert_states_raise_when_cuda_is_absent():
    """The pipelined train state and the MoE train state on a mesh run on
    cuda unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.make_pipeline_train_state(tl.PRESETS["tiny"],
                                         torch.Generator(), object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.make_moe_train_state(tm.PRESETS_MOE["tiny-moe"],
                                torch.Generator(), mesh=object())


def test_moe_entry_points_without_device_raise_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = tm.PRESETS_MOE["tiny-moe"]
    for init in (tm.init_moe_model, tm.init_moe_params):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.init_kv_cache(cfg, 1, 16)
    params = tm.init_moe_model(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.generate(params, torch.zeros(1, 4, dtype=torch.int32), cfg,
                    max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.ServeEngine(params, cfg)
    with pytest.raises(ValueError, match="params on cpu"):
        td.generate(params, torch.zeros(1, 4, dtype=torch.int32), cfg,
                    max_new_tokens=2, device="meta")
    with pytest.raises(ValueError, match="params on cpu"):
        te.ServeEngine(params, cfg, device="meta")


def test_speculation_entry_points_without_device_raise_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = tl.PRESETS["tiny"]
    params = tl.init_params(cfg, torch.Generator(), device="cpu")
    prompt = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspec.speculative_generate(params, params, prompt, cfg, cfg,
                                   max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.ServeEngine(params, cfg, draft_params=params, draft_cfg=cfg)
    with pytest.raises(ValueError, match="params on cpu"):
        tspec.speculative_generate(params, params, prompt, cfg, cfg,
                                   max_new_tokens=2, device="meta")
    elsewhere = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError, match="draft_params on meta"):
        tspec.speculative_generate(params, elsewhere, prompt, cfg, cfg,
                                   max_new_tokens=2, device="cpu")
    with pytest.raises(ValueError, match="draft_params on meta"):
        te.ServeEngine(params, cfg, draft_params=elsewhere, draft_cfg=cfg,
                       device="cpu")


def test_training_entry_points_without_device_raise_when_cuda_is_absent(
        tmp_path):
    """Checkpoint restore and its manager, the MoE train state, the two
    training bench twins and the resume example run on cuda by default."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = tl.PRESETS["tiny"]
    params, opt = ttrain.make_train_state(cfg, torch.Generator(), "cpu")
    tck.save_train_state(tmp_path / "ckpt", params, opt, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.restore_train_state(tmp_path / "ckpt", cfg,
                                ttrain.default_optimizer)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.TrainCheckpointManager(tmp_path / "mgr", cfg,
                                   ttrain.default_optimizer)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.make_moe_train_state(tm.PRESETS_MOE["tiny-moe"],
                                torch.Generator())
    for twin in (tbench.bench_train_step, tbench.bench_workload):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twin(True, cfg=cfg, shape=(1, 16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_resume.main([])


def test_import_rule_reads_the_entry_and_example_surfaces():
    """The rule's rglob reaches the entry, both examples and the bench
    twins (the serving sections live in bench.py too)."""
    files = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    for name in ("entry.py", "bench.py", "examples/serve.py",
                 "examples/train_resume.py"):
        assert f"gpu_provisioner_tpu_torch/{name}" in files
    for twin in ("bench_decode", "bench_moe_decode", "bench_engine",
                 "bench_cached_prefill"):
        assert tbench.SECTIONS[twin.replace("bench_", "").replace(
            "cached_prefill", "prefill_cached")] is getattr(tbench, twin)


def test_serving_surfaces_without_device_raise_when_cuda_is_absent():
    """entry(), dryrun_multichip, the serving bench twins and the serve
    example run on cuda unless the caller names the CPU; serving on a mesh
    of another device type is refused."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(4)
    cfg = tl.PRESETS["tiny"]
    for twin, kw in ((tbench.bench_decode, {"cfg": cfg, "shape": (1, 8, 2)}),
                     (tbench.bench_moe_decode, {
                         "cfg": tm.PRESETS_MOE["tiny-moe"],
                         "shape": (1, 8, 2)}),
                     (tbench.bench_engine, {"cfg": cfg,
                                            "shape": (1, 512, 1)}),
                     (tbench.bench_cached_prefill, {
                         "shape": (1, 128, 512, 4, 2, 16)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twin(True, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main([])

    class CudaMesh:
        device_type = "cuda"

    params = tl.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="a cuda mesh for serving on cpu"):
        td.generate(params, torch.zeros(1, 4, dtype=torch.int32), cfg,
                    max_new_tokens=2, device="cpu", mesh=CudaMesh())


def test_onchip_checks_read_by_the_import_rule_raise_without_cuda():
    """The twin of hack/tpu_onchip_checks.py lies in the package, where the
    import rule reads it, and its entry (``python3 -m
    gpu_provisioner_tpu_torch.onchip_checks``) runs on cuda: without a card
    it raises before any check."""
    files = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    assert "gpu_provisioner_tpu_torch/onchip_checks.py" in files
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tonchip.main()


def _header_fields(struct: str) -> list:
    header = (_cuda.CSRC / "flash_common.cuh").read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\}};", header, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return re.findall(r"\*?\s*(\w+)\s*(?=[,;])", body)


def test_flash_args_mirror_the_cuda_struct():
    """9 pointers, 15 strides, 13 ints and the scale (248 bytes), then
    flash_decode's workspace pointer, its length and the split count: 268
    bytes, padded to the 8-byte alignment of the pointers."""
    assert _header_fields("FlashArgs") == \
        [f[0] for f in _cuda.FlashArgs._fields_]
    assert ctypes.sizeof(_cuda.FlashArgs) == 272


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
    """flash_tri_ctas(which, ...) and flash_tri_ws_floats(which, ...)
    number the three tri entries as the source's enum does, and both take
    the act dtype (the bf16 dK/dV tile edge differs from the f32 one) and
    the head dim (the blocks an SM and the workspace's rows depend on it),
    as _cuda types them."""
    text = (_cuda.CSRC / "flash_tri.cu").read_text()
    assert re.search(r"enum Which \{ FWD = 0, DQ = 1, DKV = 2 \}", text)
    assert _cuda.TRI_WHICH == {"flash_fwd_tri": 0, "flash_bwd_dq_tri": 1,
                               "flash_bwd_dkv_tri": 2}
    assert {e for e, (src, _) in _cuda.ENTRIES.items()
            if src == "flash_tri"} == set(_cuda.TRI_WHICH)
    assert ('extern "C" int flash_tri_ctas(int which, int act_dtype, '
            'int head_dim)') in text
    assert ('extern "C" long long flash_tri_ws_floats(int which, '
            'int act_dtype, int head_dim)') in text
    for fn in (_cuda.tri_ctas, _cuda.tri_ws_floats):
        assert "head_dim" in inspect.signature(fn).parameters


def test_bwd_dkv_grid_query_is_declared():
    """flash_bwd.cu owns flash_bwd_dkv's grid and answers for it through
    flash_bwd_dkv_blocks(B, Hkv, S, act_dtype), which _cuda types."""
    text = (_cuda.CSRC / "flash_bwd.cu").read_text()
    assert ('extern "C" long long flash_bwd_dkv_blocks(int B, int Hkv, '
            'int S, int act_dtype)') in text
    assert "dkv_grid<T>(a.B, a.Hkv, a.S)" in text
    assert callable(_cuda.bwd_dkv_blocks)


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
