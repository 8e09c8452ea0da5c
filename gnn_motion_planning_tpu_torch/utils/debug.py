"""Debug and consistency utilities (port of
gnn_motion_planning_tpu/utils/debug.py): an eager-against-compiled check
for pure tensor functions, a NaN/Inf guard, and a profiler trace section
(host tags pair with utils/timer.py).
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [tree]


def _compiled(fn, args):
    """The compiled form of ``fn`` on ``args``' device, run once -> its
    outputs. On a card: a CUDA graph, captured after a warm-up on a side
    stream (so that caches fill outside the capture) and replayed. On the
    CPU: the graph TorchDynamo captures from ``fn`` (``torch.compile`` with
    the "eager" backend: the captured graph replayed op by op, no code
    generated). Neither stands in for a kernel: this is a check of the
    function's purity."""

    tensors = [a for a in _leaves(args) if isinstance(a, torch.Tensor)]
    if tensors and tensors[0].is_cuda:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*args)
        graph.replay()
        torch.cuda.synchronize()
        return out
    return torch.compile(fn, backend="eager", fullgraph=True)(*args)


def jit_eager_consistent(fn, *args, rtol=1e-5, atol=1e-6) -> bool:
    """Run a pure tensor function eagerly and in its compiled form (a CUDA
    graph on the card; on the CPU the graph TorchDynamo captures, see
    :func:`_compiled`) and assert that the outputs agree."""

    eager = fn(*args)
    compiled = _compiled(fn, args)
    for a, b in zip(_leaves(eager), _leaves(compiled), strict=True):
        np.testing.assert_allclose(
            torch.as_tensor(a).double().cpu().numpy(), torch.as_tensor(b).double().cpu().numpy(),
            rtol=rtol, atol=atol)
    return True


def assert_finite(tree, name: str = "output"):
    """NaN/Inf guard for model outputs: raises FloatingPointError when a
    floating tensor or array of ``tree`` holds one. Returns ``tree``."""

    for leaf in _leaves(tree):
        t = torch.as_tensor(leaf) if isinstance(leaf, (np.ndarray, torch.Tensor)) else None
        if t is not None and t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}")
    return tree


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """A ``torch.profiler`` section (the CPU, and the card when there is
    one) written as a Chrome trace to ``<log_dir>/trace.json`` on exit
    (default: ``gmp_trace`` in the temporary directory). Yields
    ``log_dir``."""

    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "gmp_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
