"""Interactive terminal UI — the headless stand-in for the legacy FLTK
DistanceUI (legacy/DistanceUI.{h,cpp}). Counterpart of ``tpusfm/ui.py``.

The FLTK panel (DistanceUI.cpp:109-162) offers a directory chooser,
matcher-strategy checkboxes combined into the IDistance bitmask
(DistanceUI.cpp:120-127, IDistance.h:32-35), and buttons to run
"match features" (IDistance::OnlyMatchFeatures), "recover depth"
(RecoverDepthFromImages) and "visualize" (RunVisualization). This module
is the same control surface as a terminal dialog, driven by any
file-like input stream so it is scriptable and testable.

Commands:
  dir <path>        choose the image directory (the Fl_File_Chooser role)
  downscale <f>     set the image downscale factor
  strategy <name>   toggle a matcher strategy: rich | of | dense | surf | stereo
                    (the checkbox row; exactly one is active at a time —
                    the reference bitmask also resolves to one matcher in
                    MultiCameraDistance.cpp:106-117)
  match             extract features + build the match matrix only
                    (the "match features" button -> OnlyMatchFeatures)
  run               full incremental reconstruction
                    (the "recover depth" button -> RecoverDepthFromImages)
  viz <path.html>   export the interactive HTML viewer of the last run
                    (the "visualize" button -> RunVisualization)
  save <prefix>     write <prefix>_points.ply / _cameras.ply
  status            print current settings + reconstruction summary
  quit              exit
"""
from __future__ import annotations

import shlex
import sys
from typing import Optional

from tpusfm_torch.config import MatcherKind, SfMConfig

_STRATEGIES = {
    "rich": MatcherKind.RICH,
    "of": MatcherKind.OPTICAL_FLOW,
    "dense": MatcherKind.DENSE,
    "surf": MatcherKind.SURF,
    "stereo": MatcherKind.STEREO,
}


class InteractiveSession:
    """State machine behind the prompt loop (separated for testability)."""

    def __init__(self, directory: Optional[str] = None, out=sys.stdout,
                 base_config: Optional[SfMConfig] = None, device="cuda"):
        self.directory = directory
        self.device = device
        self.downscale = 1.0
        self.strategy = "rich"
        self.out = out
        self.base_config = base_config
        self.pipe = None
        self.rec = None

    def _print(self, msg: str):
        print(msg, file=self.out, flush=True)

    def _build_pipeline(self):
        from tpusfm_torch import io
        from tpusfm_torch.pipeline import SfMPipeline

        if not self.directory:
            self._print("no directory chosen — use: dir <path>")
            return None
        import dataclasses

        base = self.base_config or SfMConfig(console_debug_level=2)
        cfg = dataclasses.replace(base, downscale=self.downscale,
                                  matcher=_STRATEGIES[self.strategy])
        imgs = io.load_image_directory(self.directory, cfg.downscale)
        self._print(f"loaded {imgs.num_views} images from {self.directory}")
        self.pipe = SfMPipeline(imgs.gray, cfg, images_rgb=imgs.rgb, device=self.device)
        return self.pipe

    def handle(self, line: str) -> bool:
        """Execute one command; returns False when the session should end."""
        parts = shlex.split(line.strip())
        if not parts:
            return True
        cmd, args = parts[0].lower(), parts[1:]
        if cmd in ("quit", "exit", "q"):
            return False
        if cmd == "dir":
            self.directory = args[0] if args else self.directory
            self.pipe = None
            self._print(f"directory = {self.directory}")
        elif cmd == "downscale":
            self.downscale = float(args[0])
            self.pipe = None
            self._print(f"downscale = {self.downscale}")
        elif cmd == "strategy":
            name = args[0].lower() if args else ""
            if name not in _STRATEGIES:
                self._print(f"unknown strategy {name!r}; one of "
                            f"{sorted(_STRATEGIES)}")
            else:
                self.strategy = name
                self.pipe = None
                self._print(f"strategy = {name}")
        elif cmd == "match":
            pipe = self.pipe or self._build_pipeline()
            if pipe is not None:
                pipe.extract()
                pipe.match()
                n = int(pipe.match_valid.sum()) if pipe.match_valid is not None else 0
                self._print(f"match matrix built: {n} pairwise matches")
        elif cmd == "run":
            pipe = self.pipe or self._build_pipeline()
            if pipe is not None:
                self.rec = pipe.run()
                self._print(
                    f"reconstructed {self.rec.num_points} points, "
                    f"{int(self.rec.pose_valid.sum())}/{len(self.rec.pose_valid)} "
                    f"cameras, mean reprojection error "
                    f"{self.rec.mean_reprojection_error:.3f}px")
        elif cmd == "viz":
            if self.rec is None:
                self._print("nothing reconstructed yet — run first")
            else:
                path = args[0] if args else "reconstruction.html"
                self.rec.save_html(path)
                self._print(f"viewer written to {path}")
        elif cmd == "save":
            if self.rec is None:
                self._print("nothing reconstructed yet — run first")
            else:
                prefix = args[0] if args else "output"
                self.rec.save_ply(prefix)
                self._print(f"saved {prefix}_points.ply / {prefix}_cameras.ply")
        elif cmd == "status":
            self._print(f"directory={self.directory} downscale={self.downscale} "
                        f"strategy={self.strategy} "
                        f"points={self.rec.num_points if self.rec else 0}")
        elif cmd in ("help", "?"):
            self._print(__doc__.split("Commands:")[1])
        else:
            self._print(f"unknown command {cmd!r} — try help")
        return True


def interactive_loop(directory: Optional[str] = None, stream=None,
                     out=sys.stdout, base_config=None, device="cuda") -> InteractiveSession:
    """Run the prompt loop over ``stream`` (default stdin)."""
    sess = InteractiveSession(directory, out=out, base_config=base_config, device=device)
    stream = stream or sys.stdin
    print("tpusfm_torch interactive (help for commands)", file=out, flush=True)
    for line in stream:
        if not sess.handle(line):
            break
    return sess
