"""Run ``chip_smoke.py``'s phase 10 (the strict verifier, the batched edge
oracle, the audit and the kuka14 2170 witness) and phase 8's snake7 rows
alone on one card, the kernels built first as in phase 0:

    python3 tools/torch_port_strict.py

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
        print("torch_port_strict: no CUDA device", file=sys.stderr)
        return 2
    from gnn_motion_planning_tpu_torch.api.registry import str2name
    from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv
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
    with smoke.phase("8 baselines: snake7"):
        smoke.snake7_baselines(str2name("snake7", device=dev)[0], counted, card)
    with smoke.phase("10 strict and audit"):
        envs = {config: str2name(config, device=dev)[0] for config in ("kuka7", "ur5")}
        env14, model14, _, model14_s, _ = str2name("kuka14", device=dev)
        envs["kuka14"] = env14
        envs["kuka13"] = KukaEnv(kuka_file="kuka_iiwa/model_3.urdf",
                                 map_file="maze_files/kukas_13_3000.pkl", device=dev)
        smoke.strict_and_audit(dev, envs, (model14, model14_s), counted, card)
    print(json.dumps({"launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
