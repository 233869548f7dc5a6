"""The port stands alone: nothing under habitat_torch/, nothing in
chip_smoke.py and nothing in scripts/eval_flagship_torch.py imports JAX,
Flax, Optax, Orbax, gymnasium (the card's machine has none) or the
habitat_tpu package."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gymnasium", "habitat_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "scripts", "eval_flagship_torch.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "habitat_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_files_found():
    files = _port_files()
    assert os.path.join(ROOT, "chip_smoke.py") in files
    assert len(files) > 15
    for module in ("tasks/rearrange/rearrange_env.py", "tasks/rearrange/generator.py", "ops/navgrid.py",
                   "models/policy.py", "baselines/ppo.py"):
        assert os.path.join(ROOT, "habitat_torch", module) in files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
