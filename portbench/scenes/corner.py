"""Scene kind ``corner``: ``make_scene``'s textured corner from a converging
arc of cameras; each pool entry is rendered from its own seed."""
from __future__ import annotations

import numpy as np

from portbench import render


def make(scene_cfg, seed: int, index: int, pool: int, device):
    """Pool entry ``index`` of a run with ``seed``: images, ground truth, K."""
    render_seed = int(np.random.SeedSequence([seed, 1, index]).generate_state(1)[0]) % 1_000_000
    images, poses, K = render.corner_scene(scene_cfg["views"], scene_cfg["height"],
                                           scene_cfg["width"], scene_cfg.get("focal"),
                                           render_seed, device)
    return {"images": images, "gt_poses": poses, "K": K, "label": f"render seed {render_seed}"}
