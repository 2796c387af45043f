"""Tools around the port: the synthetic textured scene renderer, the matcher's
benchmark, the profilers, and the reference's small command-line tools
(rotations, draw_keypoints)."""
