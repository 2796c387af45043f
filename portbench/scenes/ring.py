"""Scene kind ``ring``: the whole of ``make_collection_scene``'s textured
ring, ``views`` views spread over the full circle. Pool entry ``index`` is a
ring of its own, its seed drawn from the run's scene seed and ``index``."""
from __future__ import annotations

import numpy as np

from portbench import render


def make(scene_cfg, seed: int, index: int, pool: int, device):
    ring_seed = int(np.random.SeedSequence([seed, 8, index]).generate_state(1)[0]) % 1_000_000
    n = scene_cfg["views"]
    images, poses, K = render.ring_sector(n, 0, n, scene_cfg["height"], scene_cfg["width"],
                                          scene_cfg["focal"], ring_seed, device)
    return {"images": images, "gt_poses": poses, "K": K,
            "label": f"ring seed {ring_seed}, {n} views"}
