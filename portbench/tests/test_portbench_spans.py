"""The span readers on a recorded list of events, in both forms a program
span takes: an operator-scope span, a host event alone (what tpusfm_torch
records), and a ``record_function`` span, a host copy and a copy on the
device's timeline under one name. Each launch and sync counts once, in the
host copies that hold it."""
import pytest

from portbench import spans
from portbench.run import load_module


def _job(n_steps=5, pairs=21, kind="annotation"):
    """A traced fused job of ``n_steps`` add-view steps (each: two LM
    iterations of two launches, one more launch, one sync) inside
    ``sfm.run``, its K1 call matching ``pairs`` pairs; spans of ``kind``
    ``annotation`` have device copies, of ``host`` none."""
    ev = [("portbench.job", "annotation", 0, 100_000)]
    t, k = 1_000, 50_000                 # host clock; device operations run later
    run0 = t
    for _ in range(n_steps):
        s0, d0 = t, k
        for _ in range(2):
            ev.append(("sfm.ba.lm_iter", "annotation", t, t + 40))
            for j in range(2):
                ev.append(("cudaLaunchKernel", "host", t + 5 + 10 * j, t + 10 + 10 * j))
                ev.append(("elementwise_kernel", "kernel", k, k + 30))
                k += 40
            ev.append(("sfm.ba.lm_iter", "annotation", k - 80, k - 10))   # device copy
            t += 50
        ev.append(("cuLaunchKernel", "host", t, t + 5))
        ev.append(("gemm", "kernel", k, k + 30))
        ev.append(("cudaStreamSynchronize", "host", t + 10, t + 20))
        ev.append(("Memcpy DtoH", "memcpy", k + 40, k + 50))
        k += 60
        t += 30
        ev.append(("sfm.engine.step", "annotation", s0, t))
        ev.append(("sfm.engine.step", "annotation", d0, k - 10))             # device copy
        t += 10
    ev.append(("cudaLaunchKernel", "host", t, t + 5))                        # outside the steps
    ev.append(("k_after", "kernel", k, k + 10))
    ev.append(("sfm.run", "annotation", run0 - 10, t + 20))
    ev.append(("sfm.run", "annotation", 50_000, k + 10))                      # device copy
    if kind == "host":
        ev = [e for e in ev if not (e[0].startswith("sfm.") and e[2] >= 50_000)]
        ev = [(n, "host" if n.startswith("sfm.") else k, s, e) for n, k, s, e in ev]
    ctx = {"events": ev, "calls": {"match_top2": [(pairs, 5120, 5120)]}, "jobs": [],
           "trace": None, "span": (0, 100_000)}
    return ctx


KINDS = pytest.mark.parametrize("kind", ["annotation", "host"])


@KINDS
def test_host_copies_are_told_from_device_copies(kind):
    ctx = _job(kind=kind)
    steps = spans.host_spans(ctx["events"], "sfm.engine.step")
    assert len(steps) == 5 and (steps[:, 0] < 50_000).all()
    assert len(spans.host_spans(ctx["events"], "sfm.ba.lm_iter")) == 10
    assert len(spans.host_spans(ctx["events"], "sfm.run")) == 1


@KINDS
def test_each_launch_and_sync_counts_once_in_its_span(kind):
    ctx = _job(kind=kind)
    steps = spans.host_spans(ctx["events"], "sfm.engine.step")
    launches = spans.host_call_starts(ctx["events"], spans.is_launch)
    syncs = spans.host_call_starts(ctx["events"], spans.is_sync)
    assert list(spans.counts_in(launches, steps)) == [5] * 5
    assert list(spans.counts_in(syncs, steps)) == [1] * 5
    run = spans.host_spans(ctx["events"], "sfm.run")
    assert spans.counts_in(launches, run)[0] == 26
    assert load_module("metrics", "engine.step_launches").read(ctx) == 5.0
    assert load_module("metrics", "ba.launches_per_iter").read(ctx) == 2.0


@KINDS
def test_host_loop_readers(kind):
    ctx = _job(kind=kind)
    ctx["events"] = [(n.replace("sfm.engine.step", "sfm.hostloop.view"), *rest)
                     for n, *rest in ctx["events"]]
    assert load_module("metrics", "hostloop.view_launches").read(ctx) == 5.0
    assert load_module("metrics", "hostloop.view_syncs").read(ctx) == 1.0
    assert load_module("metrics", "engine.step_launches").read(ctx) is None


@pytest.mark.parametrize("case", ["steps", "pairs", "no_calls", "no_run", "two_runs", "overlap"])
def test_spans_that_do_not_match_the_program_read_nothing(case):
    pairs = {"pairs": 20, "overlap": 28}.get(case, 21)        # 28 pairs: V = 8, 6 steps
    ctx = _job(n_steps=4) if case == "steps" else _job(pairs=pairs)
    ev = ctx["events"]
    if case == "no_calls":
        ctx["calls"] = {}
    elif case == "no_run":
        ctx["events"] = [e for e in ev if e[0] != "sfm.run"]
    elif case == "two_runs":
        ctx["events"] = ev + [("sfm.run", "annotation", 10, 20)]
    elif case == "overlap":        # a device copy taken for a host one: a sixth step
        ctx["events"] = ev + [("sfm.engine.step", "annotation", 1_005, 1_500)]   # on the first
    assert load_module("metrics", "engine.step_launches").read(ctx) is None
    if case in ("no_run", "two_runs"):
        assert load_module("metrics", "ba.launches_per_iter").read(ctx) is None
    else:
        assert load_module("metrics", "ba.launches_per_iter").read(ctx) == 2.0


def test_views_of_the_pairs_matched():
    assert spans.views_of({"match_top2": [(21, 5120, 5120)]}) == 7
    assert spans.views_of({"match_top2": [(15, 64, 64), (6, 64, 64)]}) == 7
    assert spans.views_of({"match_top2": [(20, 64, 64)]}) is None
    assert spans.views_of({}) is None and spans.views_of(None) is None


def test_find_2d3d_reads_the_host_loops_timing():
    read = load_module("metrics", "hostloop.find_2d3d_s").read
    ctx = {"jobs": [{"stats": {"find_2d3d_s": 0.5}}, {"stats": {"find_2d3d_s": 0.7}}],
           "events": None, "trace": None, "span": None, "calls": {}}
    assert read(ctx) == pytest.approx(0.6)
    assert read(dict(ctx, jobs=[{"stats": {"solve_s": 1.0}}])) is None
