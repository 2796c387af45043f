"""The port's one CUDA-graph runner: the key of a capture, the capture
protocol over static buffers, and a per-site cache. A site (the fused
engine's add-view step, the collection's PnP, an iteration of the COO LM)
gives a body that reads and writes only its buffers. A site whose sizes
change from call to call pads them to buckets (``pow2``).

The capture runs under ``torch.cuda.device(card)``, on a side stream of that
card: ``torch.cuda.graph``'s own stream lives on the card current at its
first use, and a capture on another card then fails. One eager run of the
body on that stream, over the buffers as the caller loaded them, comes
first, so that no library starts up inside the capture. Replays run under
the same guard.
"""
from __future__ import annotations

import collections

import torch

from tpusfm_torch.utils.profiling import stage


def pow2(n: int, floor: int) -> int:
    """The bucket of a size ``n``: the least ``floor * 2**k`` that holds it."""
    c = floor
    while c < n:
        c *= 2
    return c


def graph_key(device, *parts) -> tuple:
    """The card (a bare ``cuda`` is the current one), the site's ``parts``,
    and the float32 matmul settings that pick cuBLAS's kernels: everything a
    capture bakes in."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return (str(device), *parts, torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


class Graph:
    """``body(*buffers)`` captured on the buffers' card inside the span
    ``span``. ``buffers`` are the device tensors the body reads and writes,
    holding the first call's data; ``load`` copies a call's values into
    them. ``generator``, if given, is registered with the graph, and
    ``replay(seed)`` reseeds it first. ``replay`` returns the captured
    body's result, which the next replay overwrites. The graph keeps
    ``body``, and with it whatever the body closes over: the capture
    recorded those tensors' addresses too."""

    def __init__(self, body, buffers, span: str, generator=None):
        self.body, self.buffers, self.generator = body, tuple(buffers), generator
        self.device = self.buffers[0].device
        with stage(span), torch.cuda.device(self.device):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                body(*self.buffers)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            if generator is not None:
                self.graph.register_generator_state(generator)
            with torch.cuda.graph(self.graph, stream=side):
                self.out = body(*self.buffers)

    def load(self, *values):
        for buf, x in zip(self.buffers, values):
            buf.copy_(x)

    def replay(self, seed=None):
        if seed is not None:
            self.generator.manual_seed(seed)
        with torch.cuda.device(self.device):
            self.graph.replay()
        return self.out


class GraphCache:
    """A site's graphs by key, least recently used first, at most ``kept``.
    Process-level: every job builds a new engine or pipeline."""

    def __init__(self, kept: int):
        self.kept = kept
        self.graphs = collections.OrderedDict()

    def get(self, key, build):
        """The graph of ``key``, moved to the back; ``build()``'s on a miss."""
        graph = self.graphs.pop(key, None)
        if graph is None:
            graph = build()
        self.graphs[key] = graph
        while len(self.graphs) > self.kept:
            self.graphs.popitem(last=False)
        return graph
