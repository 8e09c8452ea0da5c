"""Run ``chip_smoke.py``'s phase 11 (the last slice: the scatter repair, the
cheap projection, the sampler biases, snake7's grid window, the mesh on one
card, the scratch trainer, ``rgg.Graph`` and the debug utilities) alone on
one card, the kernels built first as in phase 0:

    python3 tools/torch_port_rest.py

The checks are the smoke's own (module docstring of ``chip_smoke.py``);
it fails as the smoke fails. Its last line is the launches of both
entries over the paths it ran.
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_port_rest: no CUDA device", file=sys.stderr)
        return 2
    from gnn_motion_planning_tpu_torch.api.registry import str2name
    from gnn_motion_planning_tpu_torch.ops import capsule
    from gnn_motion_planning_tpu_torch.utils import geomcore

    dev = torch.device("cuda")
    card = smoke.card_line()
    launches: dict = {}
    counted = smoke.launch_counter(launches)
    with smoke.phase("0 card and build"):
        print(f"  card: {card}", flush=True)
        with ThreadPoolExecutor(max_workers=2) as pool:
            for b in [pool.submit(capsule.load_library), pool.submit(geomcore.get_lib)]:
                b.result()
    with smoke.phase("11 the rest"):
        arm_envs = {}
        for config in ("ur5", "snake7"):
            env, model, _, model_s, _ = str2name(config, device=dev)
            arm_envs[config] = (env, model, model_s)
        smoke.the_rest(dev, str2name("kuka7", device=dev)[0], arm_envs, counted, card)
    print(json.dumps({"launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
