"""Every public name of the JAX package has a counterpart in the port.

Each module of ``gnn_motion_planning_tpu/`` is read with ``ast`` (JAX is
never imported): its public top-level functions, classes and assignments,
and each public method of its classes, must exist in the port's module of
the same path (imported; a class's methods may be inherited), or stand in
``REPLACED`` with what takes their place. The README's port section lists
the same replacements, one line each.
"""

import ast
import importlib
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "gnn_motion_planning_tpu"

# "module:name" (module relative to the package) -> what replaces it
REPLACED = {
    "api.registry:ExplorerModel": "models/explorer.py::Explorer (a module holding cfg and weights)",
    "api.registry:SmootherModel": "models/smoother.py::Smoother",
    "envs.base:Scene": "no alias: a scene is a tensor or a NamedTuple of tensors",
    "envs.kuka:chain_state_free": "ops/capsule.py::chain_states_free (entry B, batched)",
    "envs.kuka2:dual_state_free": "envs/kuka2.py::make_dual_kernels' batch_state_free",
    "envs.maze:OccScene": "the (W, W) bool grid on the device (MazeEnv.device_scene)",
    "envs.maze:make_occ_scene": "MazeEnv.device_scene",
    "envs.maze:OCC_LOOKUP": "envs/maze.py::occ_at (a gather)",
    "envs.snake:SnakeScene": "envs/kuka.py::BoxScene (make_snake_scene returns one)",
    "envs.snake:snake_state_free": "envs/snake.py::make_snake_kernels' batch_state_free",
    "envs.ur5:ur5_state_free": "envs/ur5.py::ur5_states_free (batched)",
    "models.mlp:PARITY_PRECISION": "TF32 off in gnn_motion_planning_tpu_torch/__init__.py",
    "ops.pallas_capsule:capsules_hit": "ops/capsule.py::capsules_hit (csrc/capsules_hit.cu)",
    "planners.gnn_explore:make_explore_round": "planners/gnn_explore.py::make_explore_round_core",
    "planners.gnn_explore:make_explore_round_batch":
        "planners/gnn_explore.py::make_explore_round_batch_chunked",
    "planners.gnn_smooth:make_projection": "planners/gnn_smooth.py::make_projection_core",
    "planners.gnn_smooth:make_projection_batch": "planners/gnn_smooth.py::make_projection_lanes",
}


def _public(tree: ast.Module):
    """(name, [public method names] or None) of each public top-level name."""

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names = [(node.name, None)]
        elif isinstance(node, ast.ClassDef):
            methods = [f.name for f in node.body
                       if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                       and not f.name.startswith("_")]
            names = [(node.name, methods)]
        elif isinstance(node, ast.Assign):
            names = [(t.id, None) for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names = [(node.target.id, None)]
        else:
            names = []
        yield from ((n, m) for n, m in names if not n.startswith("_"))


def _modules():
    for path in sorted(JAX_PKG.rglob("*.py")):
        parts = path.relative_to(JAX_PKG).with_suffix("").parts
        yield ".".join(p for p in parts if p != "__init__"), path


def test_every_public_name_has_a_counterpart():
    missing, used = [], set()
    for rel, path in _modules():
        names = list(_public(ast.parse(path.read_text())))
        try:
            mod = importlib.import_module("gnn_motion_planning_tpu_torch" + ("." + rel if rel else ""))
        except ModuleNotFoundError:
            mod = None
        for name, methods in names:
            key = f"{rel}:{name}"
            if key in REPLACED:
                used.add(key)
                continue
            if mod is None or not hasattr(mod, name):
                missing.append(key)
                continue
            missing += [f"{key}.{m}" for m in methods or [] if not hasattr(getattr(mod, name), m)]
    assert not missing, missing
    assert used == set(REPLACED), set(REPLACED) - used  # no stale entry


def test_readme_lists_the_replacements():
    readme = (REPO / "README.md").read_text()
    for key in REPLACED:
        assert f"`{key.split(':')[1]}`" in readme, key
