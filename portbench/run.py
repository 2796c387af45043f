"""The benchmark of tpusfm_torch: one run of one cell.

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1
    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0 --device cpu --tiny

Run from the root of a checkout. A cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``portbench/configs/<name>.json``:
the scene, the pipeline's settings, the outcome bars) and its own file
``portbench/workloads/<cell>.json`` (the job kind, the listed jobs, the
limits of the comparison). The job kind is ``portbench/jobs/<kind>.py``, the scene
kind ``portbench/scenes/<kind>.py``, and each per-layer metric has its
reader ``portbench/metrics/<metric>.py``; the harness finds all of them by
name, so a new cell, configuration, job kind, scene or metric is new files
and new ``BENCHMARK.json`` entries.

Set-up (``setup_s``, from the start of this module to the window's opening):
CUDA start, the scenes of the cell's jobs rendered on the card, and one
warm-up job at the cell's shapes (it builds K1 and the native runtime into
``build/`` or loads them from there). A cell's jobs are a fixed list (the
workload's ``jobs``: job ``k`` reconstructs scene ``k % pool`` with a
pipeline seed drawn from ``k``, both from its ``scene_seed``), so every run
does the same work: ``--seed`` draws the
order of the list's first pass and which jobs' detector and matcher
outputs are checked, and the window then cycles through the list in one
order fixed by ``scene_seed``, so which jobs a window repeats depends on
how many it holds and not on the seed. The window is a closed loop: one
client, the next job sent when the last returns, no job started after
``--seconds``; it closes when the last job ends. With ``--trace 1`` the
list's first job runs once more under ``torch.profiler`` after the window
and the result line carries the per-layer metrics. Once the window has
closed the plain reference judges the jobs (``portbench.check``), the
numbers compared and their limits go to standard error and into the
result's ``checks``, and the result is the last line of standard output.

``--device cpu --tiny`` rehearses a cell on the CPU at the configuration's
``tiny`` sizes: it measures nothing, prints its result with no metrics and
exits with 3.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusfm")
NO_RESULT = 2


def set_env():
    """Build and kernel caches at fixed paths inside the checkout, and one
    thread for the host's math libraries: the port's host work is one Python
    thread, and a pool of them only adds contention to the runs' spread.
    Takes effect when it runs before numpy and torch are imported."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded by its path (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, tiny: bool = False):
    """Everything a run of cell ``name`` reads, from ``BENCHMARK.json`` and
    the files it names."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, conf_entry["file"])) as fh:
        conf = json.load(fh)
    with open(os.path.join(HERE, "workloads", f"{name}.json")) as fh:
        wl = json.load(fh)
    if tiny:
        conf = _merge(conf, conf.get("tiny", {}))
    listed = lambda m: name in m.get("workloads", [name])
    return {
        "name": name, "chips": entry["chips"], "config": conf, "workload": wl,
        "pipeline": dict(conf["pipeline"], **wl.get("pipeline", {})),
        "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
        "per_layer": [m for m in bench["per_layer"] if listed(m)],
    }


def card_label(torch) -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
        return out.strip().splitlines()[torch.cuda.current_device()]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0) + ", power limit not read"


def _seed(*words) -> int:
    import numpy as np

    return int(np.random.SeedSequence(list(words)).generate_state(1)[0])


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             tiny: bool = False, control: bool = False, log=print):
    """One run of cell ``name``. Returns the result dict (the last key,
    ``checks``, holds each number compared with its limit). ``control``
    runs the comparison's control, which the benchmark's own runs never
    run: the program with TF32 matmuls on, and the plain reference in
    bfloat16 put in the place of the program's detector and of its final
    bundle adjustment; the numbers compared are then the control's."""
    set_env()
    import numpy as np
    import torch

    cell = load_cell(name, tiny)
    conf, wl = cell["config"], cell["workload"]
    cuda = torch.device(device).type == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        raise SystemExit(f"cell {name} needs {cell['chips']} CUDA device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    import tpusfm_torch  # noqa: F401  (sets the precision the configuration states)

    from portbench import check, trace as tracing

    if control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    warnings.filterwarnings("ignore", category=RuntimeWarning)
    label = card_label(torch) if cuda else "cpu (rehearsal: nothing is measured)"
    log(f"# cell {name}, seed {seed}, {seconds} s, trace {int(trace)}, on {label}")

    job = load_module("jobs", wl["job"])
    scenes = load_module("scenes", conf["scene"]["kind"])
    sfm_cfg = job.make_config(cell)
    # every run does the same jobs (the cell's list): --seed orders the first pass
    pool_n, listed, fixed = wl["pool"], list(wl["jobs"]), wl["scene_seed"]
    n_list = len(listed)
    pool = {i: scenes.make(conf["scene"], fixed, i, pool_n, device)
            for i in sorted({k % pool_n for k in listed})}
    t_warm = time.perf_counter()
    try:
        job.run(pool[listed[0] % pool_n], sfm_cfg, _seed(fixed, 5), device, keep=False)
    except Exception:                          # judged in the window, where it repeats
        log("# warm-up job raised:\n" + traceback.format_exc())
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    warm_s = time.perf_counter() - t_warm
    setup_s = time.perf_counter() - _T0

    rng = np.random.default_rng(_seed(seed, 3))
    first_pass = rng.permutation(n_list)
    cycle = np.random.default_rng(_seed(fixed, 6)).permutation(n_list)
    first = {}
    for j, pos in enumerate(first_pass):
        first.setdefault(listed[pos] % pool_n, j)
    keep = set(first.values()) | {int(rng.integers(0, n_list))}
    jobs = []

    def one_job(j, pos=None):
        if pos is None:
            pos = first_pass[j] if j < n_list else cycle[(j - n_list) % n_list]
        k = listed[pos]
        scene_i = k % pool_n
        js = _seed(fixed, 4, k)
        t0 = time.perf_counter()
        try:
            out, error = job.run(pool[scene_i], sfm_cfg, js, device, keep=j in keep), None
        except Exception as exc:
            out, error = None, f"{type(exc).__name__}: {exc}"
        t1 = time.perf_counter()
        return {"index": j, "listed": k, "scene": scene_i, "seed": js, "start": t0, "end": t1,
                "seconds": t1 - t0, "out": out, "error": error,
                "calls": out["kept"]["calls"] if out else {}}

    t_open = time.perf_counter()
    while time.perf_counter() - t_open < seconds:
        jobs.append(one_job(len(jobs)))
    t_close = jobs[-1]["end"]
    window_s = t_close - t_open

    summary = traced = events = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("portbench.job"):
                traced = one_job(len(jobs), pos=0)
        events = tracing.events_of(prof)
        summary = tracing.summarize(events)
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    forbidden = forbidden_modules()

    # --- the plain reference judges every job, once the window has closed ---
    bars, huber = conf["bars"], conf.get("final_ba_huber_px", 0.0)
    judged = [j for j in jobs + ([traced] if traced else []) if j["out"] is not None]
    for j in judged:
        j["judge"] = check.judge_reconstruction(j["out"], pool[j["scene"]], bars, huber, device,
                                                control=control)
    good = [j for j in judged if j["judge"]["in_bars"]]
    ref_feats, low_feats, kp, desc, mbad, mtot, n_front = {}, {}, [], [], 0, 0, 0
    for j in judged:
        kept = j["out"]["kept"]
        if not kept["features"]:
            continue
        n_front += 1
        s = j["scene"]
        if s not in ref_feats:
            imgs = job.reference_images(cell, pool[s]["images"])
            ref_feats[s] = check.reference_features(imgs, sfm_cfg, device)
            if control:                      # the plain detector in bfloat16 in the port's place
                low_feats[s] = check.reference_features(imgs, sfm_cfg, device,
                                                        dtype=torch.bfloat16)
        f = kept["features"][0]
        k, d = check.compare_features(low_feats[s] if control else (f.xy, f.desc, f.valid),
                                      ref_feats[s])
        kp.append(k)
        desc.append(d)
        for pairs, m in kept["matches"]:
            b, t = check.compare_matches(f, pairs, m, sfm_cfg)
            mbad, mtot = mbad + b, mtot + t
        j["out"]["kept"] = None

    def solve_gap(key):
        """The solves of the jobs in the bars; with none, the least gap of all."""
        if good:
            return max(j["judge"][key] for j in good)
        return min((j["judge"][key] for j in judged), default=float("nan"))

    limits = wl["limits"]
    numbers = {
        "kp_miss": max(kp) if kp else float("nan"),
        "desc_miss": max(desc) if desc else float("nan"),
        "match_miss": mbad / mtot if mtot else float("nan"),
        "point_gap": solve_gap("point_gap"),
        "camera_gap": solve_gap("camera_gap"),
    }
    checks = {k: {"value": v if _finite(v) else None, "limit": limits[k]}
              for k, v in numbers.items()}
    correct = (all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
               and n_front > 0 and not forbidden)

    # --- outcomes and metrics ---
    failed = 0
    for j in jobs + ([traced] if traced else []):
        jd = j.get("judge")
        ok = jd is not None and jd["in_bars"]
        failed += not ok
        if jd is None:
            log(f"job {j['index']} scene {j['scene']} seed {j['seed']}: {j['seconds']:.4f} s, "
                f"FAILED: {j['error']}")
        else:
            log(f"job {j['index']} scene {j['scene']} seed {j['seed']}: {j['seconds']:.4f} s, "
                f"{jd['cameras']}/{jd['views']} cameras, {jd['points']} points, {jd['obs']} obs, "
                f"{jd['px']:.6f} px (reported {jd['reported_px']:.6f}), ATE {jd['ate']:.6f} of "
                f"{jd['spread']:.4f}, point gap {jd['point_gap']:.3e}, "
                f"camera gap {jd['camera_gap']:.3e}, "
                f"{'in the bars' if ok else 'MISSES THE BARS'}"
                + (" (traced)" if j is traced else ""))
    in_window = [j for j in jobs if j.get("judge")]
    metrics = {}
    if cuda and not trace:
        values = {
            "recon_s": window_s / len(in_window) if in_window else float("inf"),
            # each job of the list once, however often the window repeated it
            "reproj_px": (float(np.median(list({j["listed"]: j["judge"]["px"]
                                                for j in in_window}.values())))
                          if in_window else float("inf")),
            "setup_s": setup_s,
        }
        for m in cell["end_to_end"]:
            if _finite(values.get(m["name"])):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    elif cuda:
        ctx = {"jobs": [{"stats": j["out"]["stats"] if j["out"] else {}, "seconds": j["seconds"]}
                        for j in jobs],
               "trace": summary, "events": events,
               "span": tracing.span(events, "portbench.job") if events else None,
               "calls": traced["calls"] if traced else {}}
        for m in cell["per_layer"]:
            v = load_module("metrics", m["name"]).read(ctx)
            if v is not None and _finite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(correct and (not cuda or metrics)),
        "attempted": len(jobs) + (1 if traced else 0),
        "failed": failed,
        "metrics": metrics,
        "device": ({"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                    "count": cell["chips"], "memory_peak_bytes": int(peak)} if cuda else
                   {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}),
        "card": label,
        "window_s": window_s, "jobs_in_window": len(jobs), "warmup_s": warm_s,
        "forbidden_modules": forbidden,
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_ns"] / 1e9
        result["device"]["window_s"] = summary["window_ns"] / 1e9
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal that measures nothing")
    ap.add_argument("--tiny", action="store_true", help="the configuration's tiny sizes")
    args = ap.parse_args(argv)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      device=args.device, tiny=args.tiny)
    if result["forbidden_modules"]:
        print(f"loaded after the window: {', '.join(result['forbidden_modules'])}; "
              "the benchmark may not load JAX or the JAX package", file=sys.stderr)
        return NO_RESULT
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0 if result["device"]["platform"] == "gpu" else 3


if __name__ == "__main__":
    sys.exit(main())
