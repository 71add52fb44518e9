"""The port's on-card check surface (``onchip_checks.py``) against the JAX
package's ``hack/tpu_onchip_checks.py``, on the CPU.

The JAX script needs a TPU, so it is never imported or run here: its check
names are read from its source by ``ast`` (string literals and f-strings
expanded over the literal tuples of their enclosing ``for`` loops), and
the twin must print the same names in the same order. On CPU tensors the
twin's wrappers run their plain versions, so each of its groups passes
here (the lowering pass at a small S; at its S=16384 it is card-only);
``tests/test_torch_port_rules.py`` holds its import rule and its entry's
refusal without a card.
"""

import ast
import itertools
from pathlib import Path

import pytest

from gpu_provisioner_tpu_torch import onchip_checks as oc

ROOT = Path(__file__).resolve().parent.parent


def _loop_values(node: ast.For):
    """{name: values} bound by ``for x in (literals)`` or by the first name
    of ``for x, ... in zip((literals), ...)``; None for another loop."""
    it, target = node.iter, node.target
    if isinstance(it, ast.Call) and getattr(it.func, "id", None) == "zip":
        it, target = it.args[0], target.elts[0]
    if not isinstance(it, (ast.Tuple, ast.List)):
        return None
    return {target.id: [ast.literal_eval(e) for e in it.elts]}


def _names(node, loops=()):
    """The check names of the JAX script below ``node``, in source order:
    the first argument of check() / finite() calls and the "check" value of
    dict literals, f-strings expanded over their enclosing loops."""
    found = []
    name = None
    if isinstance(node, ast.Call) and getattr(node.func, "id", None) in (
            "check", "finite"):
        name = node.args[0]
    elif isinstance(node, ast.Dict):
        name = next((v for k, v in zip(node.keys, node.values)
                     if isinstance(k, ast.Constant) and k.value == "check"),
                    None)
    if isinstance(name, ast.Constant):
        found.append(name.value)
    elif isinstance(name, ast.JoinedStr):
        env = [b for b in loops if b]
        for combo in itertools.product(*(next(iter(b.values()))
                                         for b in env)):
            values = {next(iter(b)): c for b, c in zip(env, combo)}
            found.append("".join(
                part.value if isinstance(part, ast.Constant)
                else str(values[part.value.id]) for part in name.values))
    inner = loops + (_loop_values(node),) if isinstance(node, ast.For) \
        else loops
    for child in ast.iter_child_nodes(node):
        found += _names(child, inner)
    return found


def _jax_names():
    tree = ast.parse((ROOT / "hack" / "tpu_onchip_checks.py").read_text())
    return _names(tree)


def test_the_jax_script_reads_as_its_checks():
    """The reader itself: the JAX script's 65 checks (11 forward, 21
    backward, 21 cached and decode, 2 generate, 10 lowering), its loops
    expanded."""
    names = _jax_names()
    assert len(names) == len(set(names)) == 65
    assert names[:2] == ["resident_fwd_causal=True_hkv=4",
                         "resident_fwd_causal=True_hkv=2"]
    assert "resident_bwd_dk_causal=False_hkv=1" in names
    assert names[-1] == "tri_vs_rect_bwd_dv"


@pytest.fixture(scope="module")
def twin_lines():
    """Every group of the twin on the CPU, the lowering pass at S=128
    repeated twice."""
    groups = {g.__name__: g("cpu") for g in oc.GROUPS[:-1]}
    groups["run_lowering_checks"] = oc.run_lowering_checks("cpu", S=128,
                                                           repeat=2)
    return groups


def test_twin_prints_the_jax_scripts_checks_in_order(twin_lines):
    got = [line["check"] for g in oc.GROUPS
           for line in twin_lines[g.__name__]]
    assert got == _jax_names()


@pytest.mark.parametrize("group", [g.__name__ for g in oc.GROUPS])
def test_every_group_passes_on_the_cpu(twin_lines, group):
    """The head-dim-64 f32 groups hold the plain versions to the dense
    references within the card's tolerances (1e-4; gradients relative to
    the largest), the generate checks' tokens are equal, the lowering
    pass's values finite and its triangle equal to the rectangle."""
    lines = twin_lines[group]
    assert lines and all(line["ok"] for line in lines), lines
    for line in lines:
        assert set(line) in ({"check", "max_err", "tol", "ok"},
                             {"check", "finite", "ok"},
                             {"check", "tokens_equal", "ok"})
