"""Maze-family constants (port of gnn_motion_planning_tpu/envs/env_config.py;
reference environment/env_config.py:3-5)."""

import numpy as np

RRT_EPS = 5e-2
STICK_LENGTH = 1.5 * 2 / 15
LIMITS = np.array([1.0, 1.0, 8.0 * RRT_EPS])
