"""Scene kind ``ring_sector``: consecutive views of ``make_collection_scene``'s
textured ring. A run draws one ring from its seed and a first sector start;
pool entry ``index`` starts ``index / pool`` of the way further round, so the
sectors of one pool never overlap."""
from __future__ import annotations

import numpy as np

from portbench import render


def make(scene_cfg, seed: int, index: int, pool: int, device):
    ring_seed, start0 = (int(x) for x in np.random.SeedSequence([seed, 2]).generate_state(2))
    n = scene_cfg["ring_views"]
    start = (start0 + index * n // max(pool, 1)) % n
    ring_seed %= 1_000_000
    images, poses, K = render.ring_sector(n, start, scene_cfg["views"], scene_cfg["height"],
                                          scene_cfg["width"], scene_cfg["focal"], ring_seed,
                                          device)
    return {"images": images, "gt_poses": poses, "K": K,
            "label": f"ring seed {ring_seed}, views {start}-{start + scene_cfg['views'] - 1}"}
