"""NEXT models: attention plus a conv-LSTM value iteration over map grids.

Port of gnn_motion_planning_tpu/models/next_model.py (reference
next_model/model2D.py:12-210, next_model/model3D.py:11-307): a spatial
attention over the 15^d occupancy grid driven by the query state, a
20-iteration conv-LSTM latent value iteration seeded from the goal
attention, and dim-action plus value heads. ``Model2D`` and ``Model3D``
keep the reference's numpy-facing API (``set_problem``, ``pred_value``,
``policy``) with the problem representation cached on the env's device.

The modules are ``nn.Module``s whose dotted names are the shipped
``next_*.pt`` state dicts' own, so a checkpoint loads by name
(``models/convert.py``). The convolutions and the LSTM cell run as
``torch.nn.functional`` calls and matmuls, written out as the JAX package
writes them (convolution then bias, matmul then bias, gate order i, f, g,
o), with TF32 off (``gnn_motion_planning_tpu_torch/__init__.py``).
``pb_forward`` and ``state_forward`` carry gradients (NEXT's training loss
goes through them); the planner's calls (``set_problem``, ``net_forward``)
run under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gnn_motion_planning_tpu_torch.envs.env_config import LIMITS
from gnn_motion_planning_tpu_torch.models.convert import params_from_numpy, read_checkpoint
from gnn_motion_planning_tpu_torch.models.convert import load_flat
from gnn_motion_planning_tpu_torch.models.mlp import linear


class NextConfig(NamedTuple):
    env_width: int = 15
    cap: int = 8
    dim: int = 2
    point_dim: int = 0  # 0: the 2-D model (the state's first two entries are spatial)
    nd: int = 2
    g: int = 8
    iters: int = 20

    @property
    def latent_dim(self):
        return self.cap * self.g

    @property
    def conv_cap(self):
        return self.cap * 8

    @property
    def spatial(self):
        return self.point_dim if self.point_dim else 2


_SHARE = (16, 16, 32, 32, 64, 1)  # mlp_share's 1x1 convolutions, keys 0, 2, ..., 10


def _conv_module(nd: int, n_in: int, n_out: int, k: int) -> nn.Module:
    return (nn.Conv2d if nd == 2 else nn.Conv3d)(n_in, n_out, k, padding=k // 2)


class Attention(nn.Module):
    """Spatial attention (``mlp_share``, 1x1 convolutions over the state's
    spatial entries and the grid coordinates) times capacity attention
    (``mlp``) (model2D.py:57-82 / model3D.py:59-86)."""

    def __init__(self, cfg: NextConfig, mlp_in: int):
        super().__init__()
        share, n_in = [], cfg.spatial + cfg.nd
        for n_out in _SHARE:
            share += [_conv_module(cfg.nd, n_in, n_out, 1), nn.ReLU()]
            n_in = n_out
        self.mlp_share = nn.Sequential(*share[:-1])
        self.mlp = nn.Sequential(nn.Linear(mlp_in, 64), nn.ReLU(), nn.Linear(64, cfg.cap))


class NextNet(nn.Module):
    """The parameters of one NEXT network, named as its checkpoint."""

    def __init__(self, cfg: NextConfig, mlp_in: int):
        super().__init__()
        self.cfg = cfg
        self.hidden = _conv_module(cfg.nd, 1 + cfg.cap, cfg.latent_dim, 3)
        self.h0 = _conv_module(cfg.nd, cfg.latent_dim, cfg.latent_dim, 3)
        self.c0 = _conv_module(cfg.nd, cfg.latent_dim, cfg.latent_dim, 3)
        self.conv = _conv_module(cfg.nd, cfg.latent_dim, cfg.conv_cap, 3)
        self.lstm = nn.LSTMCell(cfg.conv_cap, cfg.latent_dim)
        self.attention_g = Attention(cfg, mlp_in)
        self.attention_s = Attention(cfg, mlp_in)
        self.policy = nn.Sequential(nn.Linear(cfg.cap, 128), nn.ReLU(), nn.Linear(128, 64),
                                    nn.ReLU(), nn.Linear(64, cfg.dim + 1))
        w = cfg.env_width
        idx = torch.arange(w, dtype=torch.float32)
        if cfg.nd == 2:
            col = idx.reshape(1, w).expand(w, w)
            row = idx.reshape(w, 1).expand(w, w)
            coords = torch.stack([col, row])
        else:
            col = idx.reshape(1, w, 1).expand(w, w, w)
            row = idx.reshape(w, 1, 1).expand(w, w, w)
            layer = idx.reshape(1, 1, w).expand(w, w, w)
            coords = torch.stack([col, row, layer])
        self.register_buffer("coords", coords[None].contiguous(), persistent=False)


def _conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Convolution, then the bias (JAX ``_conv``)."""

    fn = F.conv2d if x.dim() == 4 else F.conv3d
    y = fn(x, m.weight, None, padding=m.weight.shape[-1] // 2)
    return y + m.bias.reshape((1, -1) + (1,) * (x.dim() - 2))


def _seq(m: nn.Sequential, x: torch.Tensor, apply) -> torch.Tensor:
    """A Sequential of (layer, ReLU, ...) applied with ``apply``."""

    layers = [layer for layer in m if not isinstance(layer, nn.ReLU)]
    for i, layer in enumerate(layers):
        x = apply(layer, x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _lstm_cell(m: nn.LSTMCell, x, h, c):
    gates = ((torch.matmul(x, m.weight_ih.T) + m.bias_ih) + torch.matmul(h, m.weight_hh.T)
             + m.bias_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def attention(att: Attention, net: NextNet, inp: torch.Tensor) -> torch.Tensor:
    """(B, cap, w^nd...) spatial x capacity attention."""

    cfg = net.cfg
    b, w = inp.shape[0], cfg.env_width
    grid = (w,) * cfg.nd
    x = inp[:, : cfg.spatial].reshape((b, cfg.spatial) + (1,) * cfg.nd).expand(
        (b, cfg.spatial) + grid)
    x = torch.cat([x, net.coords.expand((b, cfg.nd) + grid)], dim=1)
    x = _seq(att.mlp_share, x, _conv)
    atten_spatial = torch.softmax(x.reshape(b, -1), dim=-1).reshape(b, 1, -1)
    mlp_in = inp if cfg.point_dim == 0 else inp[:, cfg.point_dim:]
    atten_cap = torch.softmax(_seq(att.mlp, mlp_in, linear), dim=-1).reshape(b, cfg.cap, 1)
    return (atten_spatial * atten_cap).reshape((b, cfg.cap) + grid)


def pb_forward(net: NextNet, goal_state: torch.Tensor, maze_map: torch.Tensor) -> torch.Tensor:
    """Problem representation (model2D.py:151-185): goal attention, then 20
    conv-LSTM iterations over the map: (B, g, cap, w^nd...)."""

    cfg = net.cfg
    b, w = maze_map.shape[0], cfg.env_width
    grid = (w,) * cfg.nd
    x = torch.cat([maze_map.reshape((b, 1) + grid), attention(net.attention_g, net, goal_state)],
                  dim=1)
    n_cells = w ** cfg.nd
    perm = (0,) + tuple(range(2, cfg.nd + 2)) + (1,)  # channels last
    inv_perm = (0, cfg.nd + 1) + tuple(range(1, cfg.nd + 1))
    h_layer = _conv(net.hidden, x)
    h = _conv(net.h0, h_layer).permute(perm).reshape(b * n_cells, cfg.latent_dim)
    c = _conv(net.c0, h_layer).permute(perm).reshape(b * n_cells, cfg.latent_dim)
    for _ in range(cfg.iters):
        h_map = h.reshape((b,) + grid + (cfg.latent_dim,)).permute(inv_perm)
        lstm_inp = _conv(net.conv, h_map).permute(perm).reshape(b * n_cells, cfg.conv_cap)
        h, c = _lstm_cell(net.lstm, lstm_inp, h, c)
    x = h.reshape((b,) + grid + (cfg.latent_dim,)).permute(inv_perm)
    return x.reshape((b, cfg.g, cfg.cap) + grid)


def state_forward(net: NextNet, cur_states: torch.Tensor, pb_rep: torch.Tensor) -> torch.Tensor:
    """(B, dim + 1): the action mean and the value (model2D.py:187-210)."""

    cfg = net.cfg
    b = cur_states.shape[0]
    state_atten = attention(net.attention_s, net, cur_states).reshape(
        (b, 1, cfg.cap) + (cfg.env_width,) * cfg.nd)
    x = (pb_rep * state_atten).reshape(b, cfg.g, cfg.cap, -1).sum(dim=-1).sum(dim=-1)
    return _seq(net.policy, x, linear)


def next_net(cfg: NextConfig, mlp_in: int, flat: dict, device) -> NextNet:
    """A NextNet with the floats of ``flat`` ({dotted name: array}), in
    eval mode on ``device``."""

    net = load_flat(NextNet(cfg, mlp_in), flat)
    return net.to(device).eval()


@torch.no_grad()
def init_next_from_scratch(net: NextNet, seed: int) -> NextNet:
    """``net`` re-initialised for training from scratch (JAX
    training/next.py:85-103): every weight of rank >= 2 He normal,
    N(0, 2 / prod(shape[1:])) (torch's layout puts the fan-in there), every
    other leaf zero; drawn from a generator seeded by ``seed``."""

    gen = torch.Generator(device=net.coords.device).manual_seed(int(seed))
    for p in net.parameters():
        if p.dim() >= 2:
            fan_in = float(np.prod(p.shape[1:]))
            p.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)
        else:
            p.zero_()
    return net


def next_net_from_params(cfg: NextConfig, mlp_in: int, params: dict, device) -> NextNet:
    """A NextNet from the JAX package's nested numpy NEXT parameters (its
    ``load_params`` tree), for holding the two packages' forwards side by
    side."""

    net = params_from_numpy(NextNet(cfg, mlp_in), params)
    return net.to(device).eval()


class _ModelBase:
    """The reference Model2D/Model3D numpy-facing API over a NextNet."""

    def __init__(self, env, net: NextNet, std=None):
        if std is None:
            std = env.RRT_EPS * 0.3
        self.env = env
        self.net = net
        self.cfg = net.cfg
        self.std = std
        self.dim = self.cfg.dim
        self.device = net.coords.device
        self.pb_rep = None

    def _augment(self, states: np.ndarray) -> np.ndarray:
        return states

    def _normalize(self, states: np.ndarray) -> np.ndarray:
        return states

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    @torch.no_grad()
    def set_problem(self, problem):
        self.problem = problem
        w = self.cfg.env_width
        maze_map = np.asarray(problem["map"], np.float32).reshape((1,) + (w,) * self.cfg.nd)
        goal = np.asarray(problem["goal_state"], np.float32).reshape(1, -1)
        goal = self._normalize(self._augment(goal))
        self.pb_rep = pb_forward(self.net, self._tensor(goal), self._tensor(maze_map))

    @torch.no_grad()
    def net_forward(self, states):
        states = np.asarray(states, np.float32)
        if states.ndim == 1:
            states = states.reshape(1, -1)
        aug = self._normalize(self._augment(states)).astype(np.float32)
        y = state_forward(self.net, self._tensor(aug), self.pb_rep).cpu().numpy()
        pred_actions, pred_values = y[:, : self.dim], y[:, -1]
        if pred_actions.shape[0] == 1:
            return pred_actions[0], pred_values[0]
        return pred_actions, pred_values

    def pred_value(self, states):
        return self.net_forward(states)[1]

    def policy(self, state, k: int = 1):
        action_mean, _ = self.net_forward(state)
        rng = self.env.rng if getattr(self.env, "rng", None) is not None else np.random
        d = action_mean.shape[-1]
        actions, priors = [], []
        log_norm = -0.5 * d * np.log(2 * np.pi * self.std**2)
        for _ in range(k):
            eps = rng.normal(0.0, self.std, d)
            action = action_mean + eps
            logp = log_norm - 0.5 * np.sum(eps**2) / self.std**2
            actions.append(action)
            priors.append(float(np.exp(logp)))
        return actions, priors


def model_config(cls_name: str, dim: int, point_dim: int = 2, env_width: int = 15,
                 model_cap: int = 8) -> NextConfig:
    """The NextConfig of ``Model2D`` or ``Model3D`` for a state of ``dim``."""

    if cls_name == "Model2D":
        return NextConfig(env_width=env_width, cap=model_cap, dim=dim, point_dim=0, nd=2)
    return NextConfig(env_width=env_width, cap=model_cap, dim=dim, point_dim=point_dim, nd=3)


class Model2D(_ModelBase):
    """Grid-map NEXT model (maze2, maze3, snake7; model2D.py:213-294)."""

    def _normalize(self, states):
        states = states.copy()
        states[:, -1] = states[:, -1] / LIMITS[2]
        return states


class Model3D(_ModelBase):
    """Voxel-map NEXT model (kuka, ur5; model3D.py:216-307): the state is
    prefixed with the env's FK workspace points, one FK pass for all the
    states of a call (``env.robot_points``; per row, so each row is what
    ``get_robot_points`` gives it alone)."""

    def _augment(self, states):
        pts = np.asarray(self.env.robot_points(states)).reshape(len(states), -1)
        return np.concatenate([pts, states], axis=-1).astype(np.float32)


def load_next(cls, env, ckpt: str, dim: int, point_dim: int = 2, device=None):
    """``cls`` (Model2D or Model3D) with the shipped checkpoint ``ckpt``
    (``data/weights/next_*.pt``), on ``device`` (the env's by default)."""

    cfg = model_config(cls.__name__, dim, point_dim)
    mlp_in = dim
    net = next_net(cfg, mlp_in, read_checkpoint(ckpt), device or env.device)
    return cls(env, net)
