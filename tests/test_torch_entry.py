"""The port's graft entry (gpu_provisioner_tpu_torch/entry.py) against
the JAX package's ``__graft_entry__.py``, on the CPU.

- ``entry()``: the same (fn, example_args) contract; its forward on the
  JAX entry's params (carried across by ``models/convert.py``) within 3e-2
  of the JAX forward (bf16 activations, as ``tiny``'s), and its own
  params the JAX tree's shapes;
- ``_pick_cases``: the same regimes and splits for 1 to 8 ranks;
- ``dryrun_multichip(4, device="cpu")``: one world of 4 gloo ranks prints
  every regime's ``ok`` line and covers data, pipe, seq, expert and
  model, as the reference's at n = 4.
"""

import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu_torch import entry as tentry
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
BF16_TOL = 3e-2


def _jax_entry():
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JENTRY = _jax_entry()


def test_entry_forward_matches_the_jax_entry():
    jfn, (jparams, jtokens) = JENTRY.entry()
    fn, (params, tokens) = tentry.entry(device="cpu")
    assert tokens.shape == jtokens.shape and tokens.dtype == torch.int32
    assert not tokens.any()
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert shapes == jshapes
    want = np.asarray(jax.jit(jfn)(jparams, jtokens))
    got = fn(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
             tokens)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("n", range(1, 9))
def test_pick_cases_match_the_reference(n):
    assert tentry._pick_cases(n) == JENTRY._pick_cases(n)


def test_dryrun_multichip_on_a_cpu_world(capsys):
    tentry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    for regime in ("dense", "pipeline", "moe", "serving", "serving_moe"):
        m = re.search(rf"dryrun_multichip \[{regime}\] ok: mesh=(\{{.*?\}}) "
                      r"(loss|mean_token)=(\S+)", out)
        assert m, (regime, out)
        assert np.isfinite(float(m.group(3)))
    covered = re.search(r"dryrun_multichip ok: n=4 axes>1 covered: (.*)",
                        out).group(1)
    assert covered == str(["data", "expert", "model", "pipe", "seq"])
