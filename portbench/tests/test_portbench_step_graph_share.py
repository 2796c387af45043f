"""``engine.step_graph_share`` on recorded events: the share of the add-view
steps whose host copy holds a graph launch call, in both forms a program span
takes (``test_portbench_spans``), and nothing where the step spans do not
match the program."""
import pytest

from portbench import spans
from portbench.run import load_module
from portbench.tests.test_portbench_spans import _job

read = load_module("metrics", "engine.step_graph_share").read


def _with_graph_launches(ctx, n, name="cudaGraphLaunch"):
    """``ctx`` with a graph launch call inside the first ``n`` step host copies."""
    steps = spans.host_spans(ctx["events"], "sfm.engine.step")
    extra = [(name, "host", int(s) + 1, int(s) + 3) for s, _ in steps[:n]]
    return dict(ctx, events=ctx["events"] + extra)


@pytest.mark.parametrize("kind", ["annotation", "host"])
@pytest.mark.parametrize("n,share", [(5, 100.0), (0, 0.0), (2, 40.0)])
def test_share_of_steps_with_a_graph_launch(kind, n, share):
    assert read(_with_graph_launches(_job(kind=kind), n)) == pytest.approx(share)


def test_cu_graph_launch_counts_too():
    assert read(_with_graph_launches(_job(), 5, "cuGraphLaunch")) == 100.0


def test_a_graph_launch_outside_the_steps_does_not_count():
    ctx = _job()
    run = spans.host_spans(ctx["events"], "sfm.run")[0]
    ctx["events"] = ctx["events"] + [("cudaGraphLaunch", "host", int(run[1]) - 2,
                                      int(run[1]) - 1)]
    assert read(ctx) == 0.0


@pytest.mark.parametrize("case", ["steps", "no_calls", "no_run"])
def test_unsound_step_spans_read_nothing(case):
    ctx = _with_graph_launches(_job(n_steps=4) if case == "steps" else _job(), 5)
    if case == "no_calls":
        ctx["calls"] = {}
    elif case == "no_run":
        ctx["events"] = [e for e in ctx["events"] if e[0] != "sfm.run"]
    assert read(ctx) is None
    assert read(dict(ctx, events=None)) is None
