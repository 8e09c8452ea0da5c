"""Two-process smoke of the port's ``parallel/mesh.py`` on the CPU (the
counterpart of tools/multiproc_smoke.py): a launcher and its workers.

The launcher (no arguments) picks a free local port and starts two worker
processes, which join one gloo process group through ``init_distributed``,
check that ``global_mesh`` spans both processes, all-gather their indices
and sum a tensor over the group. It prints ``MULTIPROC_SMOKE_OK n=2`` when
both workers report success. A worker (arguments: <process_id>
<num_processes> <port>) runs with no CUDA device visible, so the group is
gloo's on any host.

Usage: python tools/torch_port_multiproc_smoke.py
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def worker(pid: int, n: int, port: int) -> None:
    sys.path.insert(0, str(REPO))

    import torch
    import torch.distributed as dist

    from gnn_motion_planning_tpu_torch.parallel.mesh import (
        all_reduce_sum,
        global_mesh,
        init_distributed,
    )

    rank, count = init_distributed(f"localhost:{port}", n, pid)
    assert (rank, count) == (pid, n), (rank, count)
    try:
        mesh = global_mesh()
        assert mesh.size == n and mesh.process_index == pid, mesh
        assert mesh.devices == (torch.device("cpu"),), mesh
        gathered = [None] * n
        dist.all_gather_object(gathered, pid)
        assert gathered == list(range(n)), gathered
        t = torch.full((3,), float(pid + 1))
        all_reduce_sum([t], mesh)
        assert t.tolist() == [n * (n + 1) / 2] * 3, t
    finally:
        dist.destroy_process_group()
    print(f"WORKER_OK pid={pid} mesh_size={mesh.size}", flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(n: int = 2, timeout: int = 100) -> None:
    port = free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [
        subprocess.Popen([sys.executable, __file__, str(pid), str(n), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(REPO), env=env)
        for pid in range(n)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [p.returncode for p in procs if p.returncode != 0]
    ok = sum("WORKER_OK" in o for o in outs)
    if bad or ok != n:
        print("\n".join(outs))
        raise SystemExit(f"workers failed: rc {[p.returncode for p in procs]}, {ok}/{n} OK")
    print(f"MULTIPROC_SMOKE_OK n={n}")


if __name__ == "__main__":
    if len(sys.argv) == 4:
        worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
    else:
        launch()
