"""Stage spans and stage timings: one source for both.

``stage(name, timings, key)`` times a block on the host's clock and, while
a ``torch.profiler`` session records, opens a span of that name around it.
The span sits on the profiler's clock, beside the kernels its block
launched, so every idle stretch of the device in a trace falls inside a
named stage; the timing and the span have the same boundaries. With no
profiler running the cost is one flag check
(``torch.autograd._profiler_enabled``).

The span is a plain host event (``_RecordFunctionFast``, an operator's
scope), not ``record_function``'s user annotation: the profiler copies a
user annotation onto the device's timeline, and a trace reader that does
not tell that copy from a kernel (``_KinetoEvent`` has no activity type
in torch 2.11) then counts it as device work.

Span names share the prefix ``sfm.``:

* ``sfm.run`` (``SfMPipeline.run``, both paths, and
  ``CollectionPipeline.run``: one per run, holding every other span) and
  ``sfm.total`` (the ``total_s`` timing);
* a stage with a timing key is named after the key without ``_s``:
  ``sfm.features``, ``sfm.matching``, ``sfm.prune``, ``sfm.rank``,
  ``sfm.solve``, ``sfm.fetch``, ``sfm.baseline``, ``sfm.ba``;
  ``sfm.hostloop.*`` for the host loop's ``add_views``, ``find_2d3d``,
  ``pnp``, ``triangulate`` and ``merge``; ``sfm.collection.*`` for the
  collection pipeline's ``tracks``, ``pnp``, ``triangulate``,
  ``local_ba``, ``global_ba``, ``solve`` and ``priors``;
* spans with no timing: ``sfm.engine.baseline``, ``sfm.engine.capture``
  (a capture of the add-view step's CUDA graph by the graph runner,
  ``utils/cuda_graph.py::Graph``, once per process and key: the eager
  run before the capture, and the capture), ``sfm.engine.step`` (one per
  add-view step: on CUDA a replay) and ``sfm.engine.finish`` inside
  ``sfm.solve``; ``sfm.hostloop.view`` (one per pass of
  ``add_more_views``); and ``sfm.ba.lm_iter`` (one per LM iteration of
  ``ba/lm.py::lm_solve`` that runs eagerly, opened by ``ba/lm.py::lm_run``:
  none opens inside a replayed step);
* in the collection pipeline's ``sfm.prune``, ``sfm.prune.chunk``: one
  per epipolar-prune call of ``_PAIR_ROWS`` (128) pairs, ceil(P / 128) for
  P window pairs (the stats' ``prune_chunks``);
* in the collection pipeline given known poses (``run(known_poses=)``),
  ``sfm.collection.priors`` in the place of ``sfm.collection.solve``,
  holding the triangulation of every track from the priors
  (``sfm.collection.triangulate``) and the final polish's two
  ``sfm.collection.global_ba`` and its retriangulation; it opens no view
  span;
* in the collection pipeline, inside ``sfm.collection.solve``:
  ``sfm.collection.view``, one per pass of the registration loop, holding
  that pass's ``sfm.collection.pnp`` (on CUDA around the samples' draw and
  a replay of the row bucket's graph, and holding
  ``sfm.collection.pnp_capture`` when the graph runner captures that graph:
  once per process and key) and, when the view registers, its
  ``sfm.collection.triangulate`` and ``sfm.collection.local_ba``; the
  baseline's triangulation and local BA, and the ``sfm.collection.global_ba``
  and retriangulation of the periodic and stall rounds and of the final
  polish, lie outside every view span. Each iteration
  of ``ba/sparse.py::lm_solve_sparse`` that runs is one
  ``sfm.sparse.lm_iter``, inside its solve's ``local_ba`` or ``global_ba``
  span, opened by the same ``lm_run`` after the iteration's host-exit
  read, as ``sfm.ba.lm_iter``: on CUDA around one replay of the solve's
  bucket graph. Before its first iteration such a solve holds
  ``sfm.sparse.lm_capture`` when the graph runner captures that graph
  (the eager run before the capture, and the capture): once per process
  and key.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch


class stage:
    """``with stage(name, timings, key) as s:`` — the block's host-clock
    seconds go to ``s.seconds`` and, when ``timings`` is given, to
    ``timings[key]`` (added to what is there with ``add=True``, else in
    its place). Device work is asynchronous: a block whose timing must
    hold its kernels ends with a read-back or a synchronise."""

    __slots__ = ("name", "timings", "key", "add", "seconds", "_t0", "_span")

    def __init__(self, name: str, timings: Optional[Dict[str, float]] = None,
                 key: Optional[str] = None, add: bool = False):
        self.name, self.timings, self.key, self.add = name, timings, key, add
        self.seconds = 0.0
        self._span = None

    def __enter__(self) -> "stage":
        if torch.autograd._profiler_enabled():
            self._span = torch._C._profiler._RecordFunctionFast(self.name)
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        if self._span is not None:
            self._span.__exit__(*exc)
            self._span = None
        if self.timings is not None:
            self.timings[self.key] = self.seconds + (self.timings.get(self.key, 0.0)
                                                     if self.add else 0.0)
