"""Search-tree store for NEXT / RRT*: preallocated structure-of-arrays.

Port of gnn_motion_planning_tpu/planners/search_tree.py (host numpy, as there).

Behavioral equivalent of the reference's list-append tree store
(reference: algorithm/search_tree.py:5-113 — states, parents, rewired
parents, free-space flags, costs, best-path lengths, goal flags, plus the
multi-armed-bandit statistics: visit counts, predicted state values,
kernel-regression weights w and their running sum).

Redesigned storage: every column lives in one preallocated numpy array that
grows geometrically, so inserts are O(1) amortised (the reference re-copies
``states`` via ``np.append`` on every insert, O(n) each) and the UCB select
loop's vectorised reads (``tsa.select``) index live array views with no
list->array conversion cost. Attribute names and indexing semantics
(negative indexes, ``len(tree.states)``) are preserved, so the planner code
reads identically to the reference protocol.
"""

from __future__ import annotations

import numpy as np

_INIT_CAP = 256


class _Columns:
    """Geometric-growth column store: float/int/bool columns share one
    size counter; views over the live prefix are handed out on access."""

    def __init__(self, dim: int, cap: int = _INIT_CAP):
        self.cap = cap
        self.size = 0
        self.states = np.zeros((cap, dim), np.float64)
        self.parents = np.full(cap, -1, np.int64)
        self.rewired = np.full(cap, -1, np.int64)
        self.by_rrt = np.zeros(cap, bool)
        self.freesp = np.zeros(cap, bool)
        self.costs = np.zeros(cap, np.float64)
        self.path_lengths = np.zeros(cap, np.float64)
        self.in_goal = np.zeros(cap, bool)
        self.visits = np.zeros(cap, np.int64)
        self.values = np.zeros(cap, np.float64)
        self.w = np.zeros(cap, np.float64)

    def grow(self):
        new_cap = self.cap * 2
        for name in ("states", "parents", "rewired", "by_rrt", "freesp",
                     "costs", "path_lengths", "in_goal", "visits", "values", "w"):
            old = getattr(self, name)
            new = np.zeros((new_cap,) + old.shape[1:], old.dtype)
            if name in ("parents", "rewired"):
                new[:] = -1
            new[: self.cap] = old
            setattr(self, name, new)
        self.cap = new_cap


class SearchTree:
    def __init__(self, env, root, model=None, dim: int = 2):
        root = np.asarray(root, np.float64)
        self._c = _Columns(root.shape[-1])
        c = self._c
        c.states[0] = root
        c.freesp[0] = True
        c.costs[0] = 0.0
        c.path_lengths[0] = -1.0
        c.size = 1

        self._nt_idx = np.zeros(_INIT_CAP, np.int64)
        self._nt_size = 1  # root is non-terminal

        self.cumulated_collision_checks = [0]
        self._use_model = model is not None
        if model is not None:
            c.visits[0] = 1
            c.values[0] = float(np.asarray(model.pred_value(root)).reshape(-1)[0])
            c.w[0] = compute_w(env, self, idx=0)
            self.w_sum = float(c.w[0])

    # -- live views (reference attribute surface) ---------------------------

    @property
    def states(self):
        return self._c.states[: self._c.size]

    @property
    def parents(self):
        return self._c.parents[: self._c.size]

    @property
    def rewired_parents(self):
        return self._c.rewired[: self._c.size]

    @property
    def expanded_by_rrt(self):
        return self._c.by_rrt[: self._c.size]

    @property
    def freesp(self):
        return self._c.freesp[: self._c.size]

    @property
    def costs(self):
        return self._c.costs[: self._c.size]

    @property
    def path_lengths(self):
        return self._c.path_lengths[: self._c.size]

    @property
    def in_goal_region(self):
        return self._c.in_goal[: self._c.size]

    @property
    def visits(self):
        return self._c.visits[: self._c.size]

    @property
    def state_values(self):
        return self._c.values[: self._c.size]

    @property
    def w(self):
        return self._c.w[: self._c.size]

    @property
    def non_terminal_idxes(self):
        return self._nt_idx[: self._nt_size]

    @property
    def non_terminal_states(self):
        return self._c.states[self._nt_idx[: self._nt_size]]

    # -- mutation ------------------------------------------------------------

    def _append_row(self, state, parent_idx, no_collision, done, expanded_by_rrt):
        c = self._c
        if c.size == c.cap:
            c.grow()
        i = c.size
        c.states[i] = state
        c.parents[i] = parent_idx
        c.rewired[i] = parent_idx
        c.by_rrt[i] = bool(expanded_by_rrt)
        c.freesp[i] = bool(no_collision)
        c.in_goal[i] = bool(done)
        c.path_lengths[i] = c.path_lengths[i - 1]
        c.costs[i] = -1.0
        c.size = i + 1

        if no_collision and not done:
            if self._nt_size == len(self._nt_idx):
                new = np.zeros(len(self._nt_idx) * 2, np.int64)
                new[: self._nt_size] = self._nt_idx[: self._nt_size]
                self._nt_idx = new
            self._nt_idx[self._nt_size] = i
            self._nt_size += 1
        return i

    def path(self):
        """Best path by rewired-parent backtrack from the last node
        (reference search_tree.py path reconstruction)."""

        if not self.in_goal_region[-1]:
            return [], []
        path, path_cost = [], []
        cost = 0.0
        current = self._c.size - 1
        while True:
            path.append(self._c.states[current].copy())
            path_cost.append(cost)
            if current == 0:
                break
            parent = int(self._c.rewired[current])
            cost -= float(
                np.linalg.norm(self._c.states[current] - self._c.states[parent])
            )
            current = parent
        path.reverse()
        path_cost.reverse()
        return path, path_cost


def update_collision_checks(search_tree, collision_checks):
    search_tree.cumulated_collision_checks.append(collision_checks)


def rewire_to(search_tree, child_idx, new_parent_idx):
    if child_idx < 0:
        child_idx += search_tree._c.size
    if new_parent_idx < 0:
        new_parent_idx += search_tree._c.size
    search_tree._c.rewired[child_idx] = new_parent_idx


def set_cost(search_tree, idx, new_cost):
    c = search_tree._c
    if idx < 0:
        idx += c.size
    c.costs[idx] = new_cost
    if idx == c.size - 1 and c.in_goal[idx]:
        if c.path_lengths[idx] < 0 or c.path_lengths[idx] > new_cost:
            c.path_lengths[idx] = new_cost


def insert_new_state(
    env, search_tree, state, model, parent_idx, no_collision, done, expanded_by_rrt=False
):
    if parent_idx is not None and parent_idx < 0:
        parent_idx += search_tree._c.size
    i = search_tree._append_row(state, parent_idx, no_collision, done, expanded_by_rrt)

    if model is not None:
        c = search_tree._c
        c.visits[parent_idx] += 1
        c.visits[i] = 0
        c.values[i] = float(np.asarray(model.pred_value(state)).reshape(-1)[0])

        search_tree.w_sum -= float(c.w[parent_idx])
        parent_w = compute_w(env, search_tree, idx=parent_idx)
        c.w[parent_idx] = parent_w
        search_tree.w_sum += parent_w

        w = compute_w(env, search_tree, state=state)
        c.w[i] = w
        search_tree.w_sum += w
    return i


def state_kernel(env, state_A, state_B):
    diff = env.distance(state_A, state_B) / env.RRT_EPS
    return np.exp(-(diff**2) * 1.0)


def compute_w(env, search_tree, idx=None, state=None):
    if state is None:
        state = search_tree.states[idx]
    kernel = np.maximum(state_kernel(env, search_tree.states, state), 1e-3)
    return float(np.sum(kernel))
