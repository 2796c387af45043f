"""The graph runner's cache (``tpusfm_torch/utils/cuda_graph.py::GraphCache``)
on the CPU: a hit builds nothing, a miss past ``kept`` drops the least
recently used key, and a hit makes its key the most recent. The runner's
captures are held against the eager calls on the card
(``tests/test_torch_cuda.py``)."""
import pytest
import torch

from tpusfm_torch.utils.cuda_graph import GraphCache

torch.set_num_threads(1)


def _filled(keys, kept=2):
    cache, built = GraphCache(kept), []

    def build(key):
        def make():
            built.append(key)
            return object()
        return make

    graphs = {key: cache.get(key, build(key)) for key in keys}
    return cache, built, graphs, build


def _hit_builds_nothing():
    cache, built, graphs, build = _filled(["a"])
    assert cache.get("a", build("a")) is graphs["a"]
    assert built == ["a"] and list(cache.graphs) == ["a"]


def _least_recent_dropped():
    cache, built, graphs, _ = _filled(["a", "b", "c"])
    assert built == ["a", "b", "c"] and len(cache.graphs) == 2
    assert list(cache.graphs.items()) == [("b", graphs["b"]), ("c", graphs["c"])]


def _get_moves_to_back():
    cache, built, graphs, build = _filled(["a", "b"])
    assert cache.get("a", build("a")) is graphs["a"] and list(cache.graphs) == ["b", "a"]
    cache.get("c", build("c"))
    assert list(cache.graphs) == ["a", "c"] and built == ["a", "b", "c"]


@pytest.mark.parametrize("case", [_hit_builds_nothing, _least_recent_dropped,
                                  _get_moves_to_back], ids=lambda c: c.__name__.strip("_"))
def test_graph_cache(case):
    case()
