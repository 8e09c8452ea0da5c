"""Plots of maps, trees and paths (port of gnn_motion_planning_tpu/utils/plot.py;
reference utils/plot.py:12-179).

Matplotlib renderings of maze problems with explored edges and solution
paths, the arms' and the snake's swept paths (the envs' ``plot``), and a
grid montage. Headless (the Agg backend). matplotlib and PIL are imported
inside the functions that draw, so importing this module needs neither.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_edges(states, edges, problem, save_path=None, title=None):
    """Render a maze problem with an edge set and highlighted states
    (reference utils/plot.py:12-92)."""

    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    occ_map = np.asarray(problem["map"])
    w = occ_map.shape[0]

    # occupancy cells in world coords ([-1, 1]^2)
    for i in range(w):
        for j in range(w):
            if occ_map[i, j]:
                x0 = 2.0 * i / w - 1.0
                y0 = 2.0 * j / w - 1.0
                ax.add_patch(
                    plt.Rectangle((x0, y0), 2.0 / w, 2.0 / w, color="0.3")
                )

    for a, b in (edges.items() if isinstance(edges, dict) else edges):
        a = np.asarray(a)
        b = np.asarray(b)
        ax.plot([a[0], b[0]], [a[1], b[1]], "-", color="tab:blue", lw=1, alpha=0.7)

    if states is not None and len(states):
        pts = np.asarray([np.asarray(s)[:2] for s in states])
        ax.plot(pts[:, 0], pts[:, 1], ".", color="tab:orange", ms=4)

    init = np.asarray(problem["init_state"])
    goal = np.asarray(problem["goal_state"])
    ax.plot(init[0], init[1], "g*", ms=14)
    ax.plot(goal[0], goal[1], "r*", ms=14)
    ax.set_xlim(-1, 1)
    ax.set_ylim(-1, 1)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return save_path
    return fig


def _fig_rgba(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def _interp_configs(env, path, step):
    """Interpolated config sweep along a path — the reference's gif sweep
    (kuka_env.py:318-333: K = ceil(d / 0.5) frames per edge)."""

    path = [np.asarray(p, float) for p in path]
    out = []
    for a, b in zip(path[:-1], path[1:]):
        d = float(env.distance(a, b))
        k_n = max(int(np.ceil(d / step)), 1)
        for k in range(k_n):
            out.append(np.asarray(env.interpolate(a, b, k / k_n), float))
    out.append(path[-1])
    return out


def _vec3(x):
    """Coerce ragged obstacle specs (lists mixing scalars and 1-element
    arrays, as shipped in the ur5 dataset) to a flat (3,) float array."""

    if isinstance(x, (list, tuple)):
        return np.array(
            [float(np.asarray(v).reshape(-1)[0]) for v in x], float
        )
    return np.asarray(x, float).reshape(-1)[:3]


def _draw_box3d(ax, base, half, color="0.55", alpha=0.35):
    """Axis-aligned box as 6 translucent faces."""

    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    lo = np.asarray(base, float) - np.asarray(half, float)
    hi = np.asarray(base, float) + np.asarray(half, float)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    c = lambda *pts: [list(p) for p in pts]
    faces = [
        c((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0)),
        c((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)),
        c((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)),
        c((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1)),
        c((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1)),
        c((x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1)),
    ]
    ax.add_collection3d(
        Poly3DCollection(faces, facecolor=color, edgecolor="0.3", alpha=alpha)
    )


def _draw_arm(ax, env, config, color, alpha=1.0, lw=4):
    p0, p1 = env._render_segments(config)
    for s, e in zip(p0, p1):
        ax.plot([s[0], e[0]], [s[1], e[1]], [s[2], e[2]],
                "-", color=color, lw=lw, alpha=alpha, solid_capstyle="round")
    return np.asarray(p1[-1], float)  # last capsule tip ~ end effector


def plot_arm_path(env, path, make_gif=False, save_path=None, step=0.5):
    """The reference's PyBullet env.plot (kuka_env.py:281-346,
    kuka_2arm_env.py:265-345, ur5_env.py:306-360) as a
    headless matplotlib 3D render of the capsule skeleton swept along the
    path, obstacle boxes, a translucent goal arm, and the end-effector
    trail. Returns the list of RGBA frames when ``make_gif`` (one per
    interpolation step, K = ceil(d / 0.5) per edge like the reference),
    else renders a single summary figure and returns []."""

    plt = _plt()
    path = [np.asarray(p, float) for p in path]

    def new_axes():
        fig = plt.figure(figsize=(5, 5), dpi=80)
        ax = fig.add_subplot(projection="3d")
        for half, base in getattr(env, "obstacles", []):
            _draw_box3d(ax, _vec3(base), _vec3(half))
        ax.set_xlim(-1, 1)
        ax.set_ylim(-1, 1)
        ax.set_zlim(-0.5, 1.5)
        ax.set_box_aspect((1, 1, 1))
        _draw_arm(ax, env, path[-1], "tab:green", alpha=0.35)
        return fig, ax

    gifs = []
    if make_gif:
        trail = []
        for cfg in _interp_configs(env, path, step):
            fig, ax = new_axes()
            tip = _draw_arm(ax, env, cfg, "tab:blue")
            trail.append(tip)
            tr = np.asarray(trail)
            ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], "-", color="red", lw=2)
            gifs.append(_fig_rgba(fig))
            plt.close(fig)
        if save_path:
            _save_gif(gifs, save_path)
        return gifs

    fig, ax = new_axes()
    _draw_arm(ax, env, path[0], "tab:blue")
    trail = np.asarray(
        [_tip_only(env, c) for c in _interp_configs(env, path, step)]
    )
    ax.plot(trail[:, 0], trail[:, 1], trail[:, 2], "-", color="red", lw=2)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return gifs


def _tip_only(env, config):
    _, p1 = env._render_segments(config)
    return np.asarray(p1[-1], float)


def _save_gif(frames, save_path):
    """Write RGBA frames as an animated GIF (PIL ships with matplotlib)."""

    from PIL import Image

    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(
        save_path, save_all=True, append_images=ims[1:], duration=80, loop=0
    )
    return save_path


def plot_maze_path(env, path, make_gif=False, save_path=None, step=0.05):
    """Maze env.plot equivalent: occupancy map + path sweep. The reference
    MazeEnv ships no plot method (maze rendering lives in its utils/plot.py);
    this provides the same env-protocol surface as the other env families."""

    plt = _plt()
    path = [np.asarray(p, float) for p in path]
    problem = env.get_problem()

    def new_axes():
        fig, ax = plt.subplots(figsize=(5, 5), dpi=80)
        occ_map = np.asarray(problem["map"])
        w = occ_map.shape[0]
        for i in range(w):
            for j in range(w):
                if occ_map[i, j]:
                    ax.add_patch(plt.Rectangle(
                        (2.0 * i / w - 1.0, 2.0 * j / w - 1.0),
                        2.0 / w, 2.0 / w, color="0.3",
                    ))
        ax.plot(*path[0][:2], "g*", ms=14)
        ax.plot(*path[-1][:2], "r*", ms=14)
        ax.set_xlim(-1, 1)
        ax.set_ylim(-1, 1)
        ax.set_aspect("equal")
        return fig, ax

    pts = np.asarray([c[:2] for c in _interp_configs(env, path, step)])
    gifs = []
    if make_gif:
        for t in range(len(pts)):
            fig, ax = new_axes()
            ax.plot(pts[: t + 1, 0], pts[: t + 1, 1], "-", color="red", lw=2)
            ax.plot(pts[t, 0], pts[t, 1], "o", color="tab:blue", ms=10)
            gifs.append(_fig_rgba(fig))
            plt.close(fig)
        if save_path:
            _save_gif(gifs, save_path)
        return gifs

    fig, ax = new_axes()
    ax.plot(pts[:, 0], pts[:, 1], "-", color="red", lw=2)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return gifs


def plot_snake_path(env, occ_map, path, make_gif=False, save_path=None,
                    step=0.5):
    """Snake env.plot equivalent (snake_env.py:287-330): top-down 2D view —
    occupancy map, body skeleton swept along the path, base trail."""

    plt = _plt()
    path = [np.asarray(p, float) for p in path]
    occ_map = np.asarray(occ_map)

    def new_axes():
        fig, ax = plt.subplots(figsize=(5, 5), dpi=80)
        w = occ_map.shape[0]
        for i in range(w):
            for j in range(w):
                if occ_map[i, j]:
                    ax.add_patch(plt.Rectangle(
                        (2.0 * i / w - 1.0, 2.0 * j / w - 1.0),
                        2.0 / w, 2.0 / w, color="0.3",
                    ))
        _draw_snake(ax, env, path[-1], "tab:green", alpha=0.35)
        ax.set_xlim(-1, 1)
        ax.set_ylim(-1, 1)
        ax.set_aspect("equal")
        return fig, ax

    def _draw_snake(ax, env, cfg, color, alpha=1.0):
        p0, p1 = env._render_segments(cfg)
        for s, e in zip(p0, p1):
            ax.plot([s[0], e[0]], [s[1], e[1]], "-", color=color, lw=5,
                    alpha=alpha, solid_capstyle="round")

    gifs = []
    configs = _interp_configs(env, path, step)
    if make_gif:
        for t, cfg in enumerate(configs):
            fig, ax = new_axes()
            base = np.asarray([c[:2] for c in configs[: t + 1]])
            ax.plot(base[:, 0], base[:, 1], "-", color="red", lw=2)
            _draw_snake(ax, env, cfg, "tab:blue")
            gifs.append(_fig_rgba(fig))
            plt.close(fig)
        if save_path:
            _save_gif(gifs, save_path)
        return gifs

    fig, ax = new_axes()
    _draw_snake(ax, env, path[0], "tab:blue")
    base = np.asarray([c[:2] for c in configs])
    ax.plot(base[:, 0], base[:, 1], "-", color="red", lw=2)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return gifs


def merge_pic(figs, n_cols, save_path=None):
    """Grid montage of rendered figures (reference utils/plot.py:150-179)."""

    plt = _plt()
    n = len(figs)
    n_rows = (n + n_cols - 1) // n_cols
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(4 * n_cols, 4 * n_rows))
    axes = np.atleast_1d(axes).reshape(-1)
    for ax in axes[n:]:
        ax.axis("off")
    for ax, f in zip(axes, figs):
        f.canvas.draw()
        img = np.asarray(f.canvas.buffer_rgba())
        ax.imshow(img)
        ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=100)
        plt.close(fig)
        return save_path
    return fig
