"""habitat_torch's config tree (``config/omega.py``, ``structured.py``,
``default.py``) and registry (``core/registry.py``) against habitat_tpu's.

- ``get_config(...).to_dict()`` of both packages is equal for every
  composable root of the in-repo tree: the 11 benchmark files and the 2
  experiment files; and under two override sets (a dotted override, ``1e6``
  and ``2.5e-4`` as numbers, an empty string, an unknown key, which both
  packages add as a new node). A malformed override gives the JAX
  package's error.
- Read-only after compose, ``read_write``, ``${habitat.seed}``
  interpolation.
- The registry: the JAX registry's sixteen kinds, both registration forms
  (and the port's ``register_x("Name")``), ``names()``, the
  ``baseline_registry`` alias and the ``KeyError`` text.
"""

import glob
import os

import pytest

from habitat_tpu.config.default import CONFIG_ROOT as JAX_ROOT
from habitat_tpu.config.default import get_config as jax_get_config
from habitat_tpu.core.registry import Registry as JaxRegistry
from habitat_tpu.core.registry import registry as jax_registry

from habitat_torch.config.default import get_config
from habitat_torch.config.omega import read_write
from habitat_torch.core import registry as treg

ROOTS = sorted(os.path.relpath(p, JAX_ROOT) for p in glob.glob(os.path.join(JAX_ROOT, "benchmark", "**", "*.yaml"),
                                                               recursive=True)
               + glob.glob(os.path.join(JAX_ROOT, "experiments", "**", "*.yaml"), recursive=True))
OVERRIDE_SETS = {
    "experiment": ("experiments/pointnav/ppo_pointnav_example.yaml", [
        "habitat_baselines.rl.ppo.num_steps=8", "habitat_baselines.total_num_steps=1e6",
        "habitat_baselines.tensorboard_dir=", "habitat.no_such.key=3",
    ]),
    "rearrange": ("benchmark/rearrange/pick_procgen.yaml", [
        "habitat.seed=7", "habitat.task.actions.arm_action.type=ArmAction", "habitat.simulator.tpu.lr=2.5e-4",
        "habitat.task.slack_reward=-0.05",
    ]),
}


def test_tree_found():
    assert len(ROOTS) == 13 and sum(r.startswith("experiments") for r in ROOTS) == 2


@pytest.mark.parametrize("root", ROOTS)
def test_compose_matches_jax(root):
    assert get_config(root).to_dict() == jax_get_config(root).to_dict()


@pytest.mark.parametrize("name", list(OVERRIDE_SETS))
def test_overrides_match_jax(name):
    root, overrides = OVERRIDE_SETS[name]
    cfg = get_config(root, overrides)
    assert cfg.to_dict() == jax_get_config(root, overrides).to_dict()
    if name == "experiment":
        hb = cfg.habitat_baselines
        assert hb.total_num_steps == 1e6 and isinstance(hb.total_num_steps, float)
        assert hb.rl.ppo.lr == 2.5e-4 and hb.tensorboard_dir is None and cfg.habitat.no_such.key == 3
    else:
        assert cfg.habitat.simulator.tpu.lr == 2.5e-4 and cfg.habitat.seed == 7


def test_bad_override_matches_jax():
    root = "benchmark/nav/pointnav/pointnav_procgen.yaml"
    with pytest.raises(ValueError) as want:
        jax_get_config(root, ["no_equals_sign"])
    with pytest.raises(ValueError) as got:
        get_config(root, ["no_equals_sign"])
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        get_config("benchmark/no/such.yaml")


def test_readonly_read_write_and_interpolation():
    overrides = ["habitat.seed=11", "habitat_baselines.eval.seed_copy=${habitat.seed}"]
    cfg = get_config("pointnav/ppo_pointnav_example.yaml", overrides)
    assert cfg.habitat_baselines.eval.seed_copy == 11
    assert cfg.to_dict() == jax_get_config("pointnav/ppo_pointnav_example.yaml", overrides).to_dict()
    assert cfg.is_readonly() and cfg.habitat.simulator.is_readonly()
    with pytest.raises(RuntimeError, match="readonly"):
        cfg.habitat.seed = 3
    with pytest.raises(RuntimeError, match="readonly"):
        cfg.habitat.simulator["forward_step_size"] = 1.0
    with read_write(cfg):
        cfg.habitat.seed = 3
        cfg.habitat.simulator.set_path("tpu.dynamics", "gravity")
    assert cfg.is_readonly() and cfg.habitat.seed == 3 and cfg.get_path("habitat.simulator.tpu.dynamics") == "gravity"
    assert cfg.get_path("habitat.no.such", "default") == "default"


@pytest.fixture
def scratch_tables():
    """The port's registry tables restored after the test."""
    saved = {kind: dict(table) for kind, table in treg.Registry._tables.items()}
    yield
    treg.Registry._tables.clear()
    treg.Registry._tables.update(saved)


def test_registry_kinds_and_forms(scratch_tables):
    assert treg.Registry._KINDS == JaxRegistry._KINDS and len(treg.Registry._KINDS) == 16
    reg = treg.registry
    assert treg.baseline_registry is reg and treg.Registry().mapping is reg.mapping
    for suffix, kind in treg.Registry._KINDS:
        register, get = getattr(reg, f"register_{suffix}"), getattr(reg, f"get_{suffix}")

        class Plain:
            pass

        class Named:
            pass

        def builder():
            pass

        assert register(Plain) is Plain  # @register_x, under its own name
        assert register(name=f"named_{suffix}")(Named) is Named  # @register_x(name=...)
        assert register(builder, name=f"call_{suffix}") is builder  # register_x(obj, name=...)
        assert register(f"str_{suffix}")(builder) is builder  # @register_x("Name")
        assert get("Plain") is Plain and get(f"named_{suffix}") is Named
        assert get(f"call_{suffix}") is builder is get(f"str_{suffix}")
        assert {"Plain", f"named_{suffix}"} <= set(reg.names(kind))
        with pytest.raises(KeyError) as got:
            get("NoSuchComponent")
        with pytest.raises(KeyError) as want:
            getattr(jax_registry, f"get_{suffix}")("NoSuchComponent")
        assert str(got.value).split(". Available")[0] == str(want.value).split(". Available")[0]
