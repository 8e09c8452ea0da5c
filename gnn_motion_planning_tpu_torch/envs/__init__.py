"""Environments: batched collision oracles on the card, and host wrappers.

Each environment has two faces (port of gnn_motion_planning_tpu/envs):

* a **host wrapper class** with the reference's duck-typed env protocol
  (``init_new_problem``, ``sample_n_points``, ``_state_fp``/``_edge_fp``,
  ``distance``/``interpolate``/``in_goal_region``/``step``,
  ``collision_check_count``), so drivers, baselines and tests are drop-in
  compatible; and
* a **device kernel set** (``kernels()``: batched functions over a scene of
  tensors on the env's device), used inside the planner loops.

The classes load lazily: ``from gnn_motion_planning_tpu_torch.envs import
KukaEnv`` imports only the module that defines it.
"""

_LAZY = {
    "MazeEnv": "gnn_motion_planning_tpu_torch.envs.maze",
    "KukaEnv": "gnn_motion_planning_tpu_torch.envs.kuka",
    "Kuka2Env": "gnn_motion_planning_tpu_torch.envs.kuka2",
    "SnakeEnv": "gnn_motion_planning_tpu_torch.envs.snake",
    "UR5Env": "gnn_motion_planning_tpu_torch.envs.ur5",
}

__all__ = list(_LAZY)

# reference environment/__init__.py:8
strs = ["maze2", "kuka7", "snake7", "kuka13", "ur5", "kuka14"]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)
