"""Section timer with the reference's tag taxonomy (port of
gnn_motion_planning_tpu/utils/timer.py; reference environment/timer.py:6-26).

Append-only [start, end, tag] log of host wall-clock sections; the
planners' ``timer=`` arguments and the env oracles' ``timed`` tags write it.
"""

from __future__ import annotations

from time import time


class Timer:
    VERTEX_CHECK = 0
    SAMPLE = 1
    PLAN = 2
    CREATE = 3
    EDGE_CHECK = 4
    FORWARD = 5
    NN = 6
    EXPAND = 7
    HEAP = 8
    GPU = 9
    SHORTEST_PATH = 10

    def __init__(self):
        self.log = []
        self.st = None

    def start(self):
        self.st = time()

    def finish(self, action):
        self.log.append([float(self.st), time(), action])

    def total(self, action=None):
        return sum(
            e - s for s, e, a in self.log if action is None or a == action
        )

    def summary(self):
        tags = {}
        for s, e, a in self.log:
            tags[a] = tags.get(a, 0.0) + (e - s)
        return tags

    def clear(self):
        self.log = []

    NAMES = {
        0: "vertex_check", 1: "sample", 2: "plan", 3: "create",
        4: "edge_check", 5: "forward", 6: "nn", 7: "expand",
        8: "heap", 9: "gpu", 10: "shortest_path",
    }

    def pretty(self):
        return {
            self.NAMES.get(a, str(a)): round(t, 4)
            for a, t in sorted(self.summary().items())
        }


def timed(tag):
    """Bracket an env oracle method with the reference's timer tags
    (kuka_env.py:373-410: timer.start()/finish(Timer.VERTEX_CHECK /
    EDGE_CHECK) around _state_fp/_edge_fp). The timer is created lazily on
    the instance so env constructors need no changes."""

    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            t = getattr(self, "timer", None)
            if t is None:
                t = self.timer = Timer()
            st = time()
            try:
                return fn(self, *args, **kwargs)
            finally:
                t.log.append([st, time(), tag])

        return wrapper

    return deco
