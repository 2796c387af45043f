"""Build, check and time the matcher kernel K1 on the GPU.

    python -m tpusfm_torch.tools.bench_match [--seed N] [--reps N] [--ablate] [--root DIR]

Builds the streaming top-2 matcher from tpusfm_torch/csrc, prints what ptxas
reported (registers, shared memory, spills), holds the kernel bit for bit
against the plain PyTorch version on a ladder of shapes (a distinct-row
tile, F1 != F2, ties within and across key tiles and quad threads,
all-invalid pairs, the operating point), then times it with CUDA events at P=21, F=5120 and P=210, F=2048 beside the bound
(2*P*F1*F2*256 int8 operations at 1,979 TOPS). One JSON line per shape.
A time is the median over ``--reps`` windows of 10 back-to-back launches
between two events, divided by 10, so that the host's work before a launch
hides behind the previous kernel. ``--ablate`` also times match_top2.cu built
with each subset of ABLATE_LOAD, ABLATE_PRODUCT and ABLATE_EPILOGUE, which
shows how far the key loads, the product and the epilogue overlap.
``--root DIR`` imports tpusfm_torch from DIR instead (another checkout of the
package, to time two versions on one card in one call). Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import statistics
import subprocess
import sys

PEAK_INT8_OPS = 1979e12     # H100 SXM data sheet, dense
PEAK_BYTES = 3.35e12


def make_case(P, F1, F2, invalid, seed, kind="random", device="cuda"):
    """±1 int8 descriptors and a validity mask from a seed, on ``device``.
    ``ties``: duplicate key rows inside one key tile; ``cross``: the best and
    its equal lie in different key tiles and in columns owned by different
    threads of a quad; ``none_valid``: pair 0 has no valid key row (``ties_none_valid``: both);
    ``extremes``: distances 0 and 256 (a query equal to a key row, and its
    negation)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    d1 = np.where(rng.standard_normal((P, F1, 256)) > 0, 1, -1).astype(np.int8)
    d2 = np.where(rng.standard_normal((P, F2, 256)) > 0, 1, -1).astype(np.int8)
    v2 = rng.uniform(0, 1, (P, F2)) >= invalid
    if kind in ("ties", "ties_none_valid"):
        d2[:, 11] = d2[:, 5]
        d1[:, :128] = d2[:, 5:6]
        v2[:, [5, 11]] = True
    elif kind == "cross":
        a, b = 6, F2 - 256 + 129          # thread 3 of the quad in tile 0, thread 0 in the last tile
        d2[:, b] = d2[:, a]
        d1[:, ::2] = d2[:, a:a + 1]
        d1[:, 1::4] = d2[:, 300:301]      # a single exact hit elsewhere
        v2[:, [a, b, 300]] = True
    if kind in ("none_valid", "ties_none_valid"):
        v2[0] = False
    elif kind == "extremes":
        d1[:, 0::2] = d2[:, 9:10]
        d1[:, 1::2] = -d2[:, 9:10]
        v2[:, 9] = True
    return tuple(torch.as_tensor(x).to(device) for x in (d1, d2, v2))


CHECK_LADDER = [
    # P, F1, F2, invalid share, kind
    (1, 256, 256, 0.0, "random"),
    (1, 256, 512, 0.0, "random"),
    (2, 512, 768, 0.1, "random"),
    (2, 512, 512, 0.1, "ties"),
    (2, 512, 768, 0.1, "cross"),
    (2, 256, 512, 0.5, "none_valid"),
    (1, 256, 256, 0.0, "extremes"),
    (1, 1536, 1536, 0.0, "random"),
    (1, 1792, 1792, 0.0, "random"),
    (21, 5120, 5120, 0.05, "random"),
    (210, 2048, 2048, 0.05, "random"),
]


BATCH = 10      # launches between two events


def cuda_time_ms(fn, reps, warmup=3):
    """(median, min) milliseconds per call of fn() on the card."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BATCH):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BATCH)
    return statistics.median(times), min(times)


def ablations(d1, d2, v2, reps):
    """Time match_top2.cu with each subset of its three parts left out."""
    import torch

    from tpusfm_torch import _build

    P, F1, _ = d1.shape
    F2 = d2.shape[1]
    out = [torch.empty(P, F1, dtype=torch.float32, device=d1.device) for _ in range(3)]
    stream = torch.cuda.current_stream().cuda_stream
    parts = ("LOAD", "PRODUCT", "EPILOGUE")
    row = {}
    for left_out in itertools.chain.from_iterable(itertools.combinations(parts, n) for n in range(3)):
        fn = _build.load("match_top2", tuple(f"ABLATE_{x}" for x in left_out)).tpusfm_match_top2
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def launch():
            err = fn(d1.data_ptr(), d2.data_ptr(), v2.data_ptr(), *(o.data_ptr() for o in out),
                     P, F1, F2, 256, stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        kept = "+".join(x.lower() for x in parts if x not in left_out)
        row[kept + "_ms"] = cuda_time_ms(launch, reps)[0]
    return row


def bound_ms(P, F1, F2):
    ops = 2.0 * P * F1 * F2 * 256
    nbytes = P * (F1 + F2) * 256 + P * F2 + 3 * 4 * P * F1
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--root", default=None)
    ap.add_argument("--no-check", action="store_true", help="time only")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if args.root:       # take the package from another checkout, also when run with -m
        for mod in [m for m in sys.modules if m.split(".")[0] == "tpusfm_torch"]:
            del sys.modules[mod]
        sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_match needs a CUDA device")
    import tpusfm_torch
    from tpusfm_torch import _build
    from tpusfm_torch.features import pallas_match as pm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"package {tpusfm_torch.__file__}", flush=True)

    _build.load("match_top2")
    if hasattr(_build, "build_log"):        # an older checkout (--root) keeps no log
        print(f"---- nvcc/ptxas on match_top2.cu\n{_build.build_log('match_top2')}", flush=True)
    failed = []
    if not args.no_check:
        for P, F1, F2, invalid, kind in CHECK_LADDER:
            d1, d2, v2 = make_case(P, F1, F2, invalid, args.seed + F1 + F2 + P, kind)
            want = pm.match_topk2_plain(d1, d2, v2)
            got = pm.match_topk2(d1, d2, v2)
            torch.cuda.synchronize()
            wrong = [int((g != w).sum()) for g, w in zip(got, want)]
            print(json.dumps({"check": "match_top2", "P": P, "F1": F1, "F2": F2, "kind": kind,
                              "wrong_best_second_idx": wrong}), flush=True)
            if any(wrong):
                failed.append((P, F1, F2, kind))
                for p, r in (got[0] != want[0]).nonzero()[:4].tolist():
                    print(f"   row ({p},{r}): got {[float(g[p, r]) for g in got]} "
                          f"want {[float(w[p, r]) for w in want]}", flush=True)
            del d1, d2, v2, want, got

    for P, F in ((21, 5120), (210, 2048)):
        d1, d2, v2 = make_case(P, F, F, 0.05, args.seed)
        row = {"time": {"P": P, "F": F}, "bound_ms": bound_ms(P, F, F), "card": card}
        row["match_top2_ms"], row["match_top2_min_ms"] = cuda_time_ms(
            lambda: pm.match_topk2(d1, d2, v2), args.reps)
        print(json.dumps(row), flush=True)
        if args.ablate:
            print(json.dumps({"ablate": {"P": P, "F": F}, "card": card,
                              **ablations(d1, d2, v2, args.reps)}), flush=True)
        del d1, d2, v2
    if failed:
        print(f"bench_match: FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
