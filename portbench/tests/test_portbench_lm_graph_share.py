"""``sparse.lm_graph_share`` on recorded events: the share of the COO LM's
iteration spans whose host copy holds a graph launch call, in both forms a
program span takes (``test_portbench_spans``), and nothing where the spans
do not match the program."""
import pytest

from portbench import spans
from portbench.run import load_module
from portbench.tests.test_portbench_spans import _job

read = load_module("metrics", "sparse.lm_graph_share").read


def _lm_job(kind="annotation", n_steps=5):
    """``_job``'s five spans renamed as the COO LM's iterations."""
    ctx = _job(n_steps=n_steps, kind=kind)
    ctx["events"] = [(n.replace("sfm.engine.step", "sfm.sparse.lm_iter"), *rest)
                     for n, *rest in ctx["events"]]
    return ctx


def _with_graph_launches(ctx, n, name="cudaGraphLaunch"):
    """``ctx`` with a graph launch call inside the first ``n`` iterations' host copies."""
    iters = spans.host_spans(ctx["events"], "sfm.sparse.lm_iter")
    extra = [(name, "host", int(s) + 1, int(s) + 3) for s, _ in iters[:n]]
    return dict(ctx, events=ctx["events"] + extra)


@pytest.mark.parametrize("kind", ["annotation", "host"])
@pytest.mark.parametrize("n,share", [(5, 100.0), (0, 0.0), (3, 60.0)])
def test_share_of_iterations_with_a_graph_launch(kind, n, share):
    assert read(_with_graph_launches(_lm_job(kind=kind), n)) == pytest.approx(share)


def test_cu_graph_launch_counts_too():
    assert read(_with_graph_launches(_lm_job(), 5, "cuGraphLaunch")) == 100.0


def test_any_number_of_iterations_is_read():
    """A job's iteration count follows its solves, not its view count."""
    ctx = _with_graph_launches(_lm_job(n_steps=7), 7)
    ctx["calls"] = {}
    assert read(ctx) == 100.0


def test_a_graph_launch_outside_the_iterations_does_not_count():
    """A capture's eager run and a PnP replay lie outside every iteration."""
    ctx = _lm_job()
    run = spans.host_spans(ctx["events"], "sfm.run")[0]
    ctx["events"] = ctx["events"] + [("cudaGraphLaunch", "host", int(run[1]) - 2,
                                      int(run[1]) - 1)]
    assert read(ctx) == 0.0


@pytest.mark.parametrize("case", ["no_iterations", "no_run", "no_events"])
def test_unsound_iteration_spans_read_nothing(case):
    ctx = _with_graph_launches(_job() if case == "no_iterations" else _lm_job(), 5)
    if case == "no_run":
        ctx["events"] = [e for e in ctx["events"] if e[0] != "sfm.run"]
    elif case == "no_events":
        ctx["events"] = None
    assert read(ctx) is None
