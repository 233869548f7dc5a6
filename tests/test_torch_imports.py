"""The port stands alone: nothing under habitat_torch/, nothing in
chip_smoke.py and nothing in scripts/eval_flagship_torch.py imports JAX,
Flax, Optax, Orbax, gymnasium, OpenCV, imageio, grpc, PIL, moviepy,
websockets (the card's machine has none of them) or the habitat_tpu package. The config path's modules, imported one by one in a
fresh interpreter, load none of them, and ``habitat_torch.config`` composes
the in-repo YAML tree (read as data) without them either."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gymnasium", "cv2", "imageio", "grpc", "PIL", "moviepy",
             "websockets", "habitat_tpu")


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
                   "models/policy.py", "baselines/ppo.py", "datasets/object_nav.py", "datasets/image_nav.py",
                   "parallel/distributed.py", "baselines/aux_losses.py", "tasks/shortest_path_follower.py",
                   "baselines/il/bc_trainer.py", "tasks/rearrange/multi_task/pddl.py", "baselines/hrl/hierarchical.py",
                   "baselines/hrl/planner.py", "baselines/hrl/hrl_ppo.py", "tasks/eqa.py", "tasks/vln.py",
                   "baselines/il/eqa_trainers.py", "baselines/il/pacman.py", "core/agent.py",
                   "baselines/agents/simple_agents.py", "baselines/agents/ppo_agents.py", "baselines/tensor_dict.py",
                   "core/env.py", "core/environments.py", "core/benchmark.py", "datasets/registration.py",
                   "sims/loaders.py", "utils/timing.py", "utils/gfx_replay.py", "utils/visualizations/maps.py",
                   "utils/visualizations/fog_of_war.py", "tasks/rearrange/social_nav.py",
                   "baselines/multi_agent.py", "articulated_agents/humanoid.py",
                   "tasks/rearrange/multi_task/pddl_yaml.py", "sims/sim_utilities.py", "sims/receptacles.py",
                   "tasks/rearrange/samplers.py", "sims/kinematic_relationship_manager.py",
                   "sims/object_state_machine.py", "sims/procedural.py", "utils/threefry.py",
                   "tasks/rearrange/art_scene.py", "sims/tpu_sim.py", "core/simulator.py",
                   "sims/semantic_scene.py", "sims/debug_visualizer.py", "baselines/obs_transformers.py",
                   "utils/common.py", "utils/info_dict.py", "utils/profiling_wrapper.py", "core/vector_env.py",
                   "utils/visualizations/utils.py", "utils/visualizations/image_io.py", "utils/tb.py",
                   "models/clip_resnet.py", "models/running_mean_and_var.py", "models/rnn_state_encoder.py",
                   "hitl/app_states.py", "hitl/unity_protocol.py", "hitl/controllers.py", "hitl/websocket.py",
                   "hitl/hitl_main.py", "examples/hitl_minimal_app.py", "examples/hitl_basic_viewer_app.py",
                   "examples/hitl_sim_viewer_app.py", "examples/hitl_rearrange_app.py",
                   "examples/hitl_pick_throw_app.py", "examples/hitl_rearrange_v2_app.py",
                   "examples/interactive_play.py", "examples/shortest_path_follower_example.py"):
        assert os.path.join(ROOT, "habitat_torch", module) in files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


# the modules of the config path, imported in this order in one fresh
# interpreter (this process has JAX loaded by the conftest)
CONFIG_PATH_MODULES = (
    "habitat_torch.config.omega", "habitat_torch.config.structured", "habitat_torch.config.default",
    "habitat_torch.core.registry", "habitat_torch.core.logging", "habitat_torch.utils.tb",
    "habitat_torch.tasks.rearrange.sensors", "habitat_torch.tasks.rearrange.task_actions",
    "habitat_torch.core.construct", "habitat_torch.baselines.evaluator", "habitat_torch.baselines.run",
    "habitat_torch.datasets.object_nav", "habitat_torch.datasets.image_nav",
    "habitat_torch.parallel.distributed", "habitat_torch.baselines.aux_losses",
    "habitat_torch.tasks.shortest_path_follower", "habitat_torch.baselines.il.bc_trainer",
    "habitat_torch.tasks.rearrange.multi_task.pddl", "habitat_torch.baselines.hrl",
    "habitat_torch.baselines.hrl.hrl_ppo", "habitat_torch.tasks.eqa", "habitat_torch.tasks.vln",
    "habitat_torch.baselines.il.eqa_trainers", "habitat_torch.baselines.il.pacman", "habitat_torch.core.agent",
    "habitat_torch.baselines.agents.simple_agents", "habitat_torch.baselines.agents.ppo_agents",
    "habitat_torch.baselines.tensor_dict", "habitat_torch.sims.loaders", "habitat_torch.datasets.registration",
    "habitat_torch.utils.timing", "habitat_torch.utils.visualizations.fog_of_war",
    "habitat_torch.utils.visualizations.maps", "habitat_torch.utils.gfx_replay", "habitat_torch.core.env",
    "habitat_torch.core.environments", "habitat_torch.core.benchmark", "habitat_torch.tasks.rearrange.social_nav",
    "habitat_torch.baselines.multi_agent", "habitat_torch.articulated_agents.humanoid",
    "habitat_torch.tasks.rearrange.multi_task.pddl_yaml", "habitat_torch.sims.sim_utilities",
    "habitat_torch.sims.receptacles", "habitat_torch.tasks.rearrange.samplers",
    "habitat_torch.sims.kinematic_relationship_manager", "habitat_torch.sims.object_state_machine",
    "habitat_torch.utils.threefry", "habitat_torch.tasks.rearrange.generator",
    "habitat_torch.tasks.rearrange.art_scene", "habitat_torch.core.simulator", "habitat_torch.sims.semantic_scene",
    "habitat_torch.sims.tpu_sim", "habitat_torch.sims.debug_visualizer", "habitat_torch.baselines.obs_transformers",
    "habitat_torch.utils.common", "habitat_torch.utils.info_dict", "habitat_torch.utils.profiling_wrapper",
    "habitat_torch", "habitat_torch.core.vector_env", "habitat_torch.utils.visualizations.image_io",
    "habitat_torch.utils.visualizations.utils", "habitat_torch.models.clip_resnet",
    "habitat_torch.models.running_mean_and_var", "habitat_torch.hitl.app_states", "habitat_torch.hitl.unity_protocol",
    "habitat_torch.hitl.controllers", "habitat_torch.hitl.websocket", "habitat_torch.hitl.hitl_main",
    "habitat_torch.examples.hitl_minimal_app", "habitat_torch.examples.hitl_basic_viewer_app",
    "habitat_torch.examples.hitl_sim_viewer_app", "habitat_torch.examples.hitl_rearrange_app",
    "habitat_torch.examples.hitl_pick_throw_app", "habitat_torch.examples.hitl_rearrange_v2_app",
    "habitat_torch.examples.interactive_play", "habitat_torch.examples.shortest_path_follower_example",
)
_PROBE = """
import json, sys
def bad():
    return sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
out = {{}}
for name in {modules!r}:
    __import__(name)
    out[name] = bad()
from habitat_torch.config.default import get_config
cfg = get_config("benchmark/rearrange/pick_procgen.yaml", ["habitat.seed=3"])
out["get_config"] = bad() + ([] if cfg.habitat.seed == 3 and cfg.habitat.task.type == "RearrangePickTask-v0" else ["?"])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def config_path_imports():
    """{module: the forbidden modules loaded once it is imported}, and under
    "get_config" those loaded once the port composed an in-repo config."""
    import json
    import subprocess
    import sys

    code = _PROBE.format(forbidden=FORBIDDEN, modules=CONFIG_PATH_MODULES)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", CONFIG_PATH_MODULES + ("get_config",))
def test_config_path_loads_no_jax(config_path_imports, module):
    assert config_path_imports[module] == [], f"{module}: {config_path_imports[module]}"
