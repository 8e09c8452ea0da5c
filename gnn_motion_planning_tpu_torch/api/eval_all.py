"""Grand benchmark sweep: every env x every method (reference eval_all.py).

Port of gnn_motion_planning_tpu/api/eval_all.py: the same env list, index
ranges, method set and result pickling as the reference (eval_all.py:
9-47). The envs are built on ``device`` (None: CUDA, which must exist).
Also usable as a module:
``python -m gnn_motion_planning_tpu_torch.api.eval_all [env ...]
[--methods=m,..] [--device=cpu]``.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from gnn_motion_planning_tpu_torch.api.eval_baselines import (
    eval_bit,
    eval_lazysp,
    eval_next,
    eval_rrt,
)
from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn

METHODS = {
    "GNN": eval_gnn,
    "NEXT": eval_next,
    "BIT*": eval_bit,
    "RRT*": eval_rrt,
    "LazySP": eval_lazysp,
}


def default_env_table(device=None):
    """(name, env factory, indexes) matching reference eval_all.py:9-19."""

    from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv
    from gnn_motion_planning_tpu_torch.envs.kuka2 import Kuka2Env
    from gnn_motion_planning_tpu_torch.envs.maze import MazeEnv

    def maze(dim, map_file):
        return lambda: MazeEnv(dim=dim, map_file=map_file, device=device)

    return [
        ("Maze_2D_Easy", maze(2, "maze_files/mazes_easy.npz"), np.arange(1000)),
        ("Maze_2D_Normal", maze(2, "maze_files/mazes_normal.npz"), np.arange(1000)),
        ("Maze_2D_Hard", maze(2, "maze_files/mazes_hard.npz"), np.arange(1000)),
        # reference eval_all.py:19 uses arange(2000, 3000) here, but the
        # shipped mazes_hard_3.npz holds exactly 1000 problems (indexes
        # 2000+ are out of range — upstream bug); use the file's range
        ("Maze_3D", maze(3, "maze_files/mazes_hard_3.npz"), np.arange(1000)),
        ("Kuka_7D", lambda: KukaEnv(device=device), np.arange(2000, 3000)),
        ("Kuka_13D", lambda: KukaEnv(kuka_file="kuka_iiwa/model_3.urdf",
                                     map_file="maze_files/kukas_13_3000.pkl", device=device),
         np.arange(2000, 3000)),
        ("Kuka_14D", lambda: Kuka2Env(device=device), np.arange(2000, 3000)),
    ]


def eval_all(
    env_names=None,
    method_names=None,
    seeds=(1234,),
    out_path: str = "data/result.p",
    n_problems=None,
    device=None,
):
    table = default_env_table(device)
    if env_names:
        table = [row for row in table if row[0] in env_names]
    methods = {k: v for k, v in METHODS.items() if not method_names or k in method_names}

    result_total = {}
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    for env_name, env_factory, indexes in table:
        env = env_factory()
        if n_problems:
            indexes = indexes[:n_problems]
        for method_name, method in methods.items():
            results = []
            for seed in seeds:
                print(env_name, method_name, seed)
                # positional: eval_gnn names its first arg str_, baselines
                # name it str — keyword passing crashed the GNN method
                result = method(str(env), seed, env, indexes, use_tqdm=True)
                results.append(result)
                result_total[env_name, method_name, str(seed)] = result
                pickle.dump(result_total, open(out_path, "wb"))

            print(env_name, method_name, "Avg")
            print("success rate:", np.mean([r[0] for r in results]))
            print("collision check: %.2f" % np.mean([r[1] for r in results]))
            print("running time: %.2f" % np.mean([r[2] for r in results]))
            print("path cost: %.2f" % np.mean([r[3] for r in results]))
            print("total time: %.2f" % np.mean([r[4] for r in results]))
            print("")
            result_total[env_name, method_name, "Avg"] = tuple(
                np.mean([r[i] for r in results]) for i in range(5)
            )
            pickle.dump(result_total, open(out_path, "wb"))
    return result_total


if __name__ == "__main__":
    import sys

    env_names = [a for a in sys.argv[1:] if not a.startswith("--")]
    method_names = None
    device = None
    for a in sys.argv[1:]:
        if a.startswith("--methods="):
            method_names = a.split("=", 1)[1].split(",")
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
    eval_all(env_names=env_names or None, method_names=method_names, device=device)
