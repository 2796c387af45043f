"""The key of the add-view step's CUDA graph, on the CPU: two engines share a
graph only when everything a capture bakes in is equal, and off CUDA no
capture is attempted (the step runs eagerly). The graph itself is held bit
for bit against the eager step on the card (``tests/test_torch_cuda.py``)."""
import pytest
import torch

from tpusfm_torch import SfMConfig
from tpusfm_torch.pipeline import engine as fused
from tpusfm_torch.pipeline.engine import FusedEngine

BASE = dict(max_features=512, max_matches=256, engine_point_capacity=1024)


def _engine(V=5, cx=128.0, cy=96.0, **over):
    return FusedEngine(SfMConfig(**dict(BASE, **over)), V, 192, 256, 260.0, cx, cy,
                       device="cpu")


def _inputs(eng):
    """Zero inputs of the step's shapes: feat_xy, match_idx, match_valid,
    right_of, rdist, left_of."""
    V, F, M, P = eng.V, eng.F, eng.cfg.max_matches, eng.P
    return (torch.zeros(V, F, 2), torch.zeros(P, M, 2, dtype=torch.int64),
            torch.zeros(P, M, dtype=torch.bool), torch.zeros(P + 1, F + 1, dtype=torch.int64),
            torch.zeros(P + 1, F + 1), torch.zeros(P + 1, F + 1, dtype=torch.int64))


def _key(eng):
    return eng._step_graph_key(_inputs(eng))


def test_equal_engines_share_a_key():
    assert _key(_engine()) == _key(_engine())


# the whole configuration is keyed: a gate threshold the step reads, and a
# field it does not read
@pytest.mark.parametrize("field", [dict(pnp_threshold_px=8.0), dict(console_debug_level=5)])
def test_a_config_field_changes_the_key(field):
    assert _key(_engine(**field)) != _key(_engine())


@pytest.mark.parametrize("point", [dict(cx=129.0), dict(cy=95.5)])
def test_the_principal_point_changes_the_key(point):
    assert _key(_engine(**point)) != _key(_engine())


def test_the_view_count_changes_the_key():
    assert _key(_engine(V=6)) != _key(_engine())


def test_the_matmul_settings_change_the_key():
    eng = _engine()
    before = _key(eng)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not tf32
        assert _key(eng) != before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert _key(eng) == before


def test_no_capture_off_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a capture was attempted on the CPU")

    monkeypatch.setattr(FusedEngine, "_capture_step", refuse)
    kept = list(fused._STEP_GRAPHS.graphs)
    eng = _engine()
    assert eng._step_graph(_inputs(eng), eng._initial_state()) is None
    assert list(fused._STEP_GRAPHS.graphs) == kept
