from gnn_motion_planning_tpu_torch.api.registry import str2env, str2models, str2name
from gnn_motion_planning_tpu_torch.api.eval_gnn import (
    eval_gnn,
    eval_gnn_batched,
    eval_gnn_pure,
    explore,
    explore_batch,
    path_cost,
)
from gnn_motion_planning_tpu_torch.api.eval_baselines import (
    eval_bit,
    eval_lazysp,
    eval_next,
    eval_rrt,
    str2next,
)

__all__ = [
    "str2env",
    "str2name",
    "str2models",
    "str2next",
    "eval_gnn",
    "eval_gnn_batched",
    "eval_gnn_pure",
    "eval_bit",
    "eval_lazysp",
    "eval_next",
    "eval_rrt",
    "explore",
    "explore_batch",
    "path_cost",
]
