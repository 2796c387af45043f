"""K1's bound as PERF.md states it."""
import pytest

from portbench.roofline import k1_bound_s, k1_work


@pytest.mark.parametrize("P,F,ms", [(21, 5120, 0.1424), (36, 2048, 0.0391), (256, 1024, 0.0694),
                                    (128, 5120, 0.8681), (210, 2048, 0.2279)])
def test_k1_bound_matches_perf_md(P, F, ms):
    assert k1_bound_s(P, F, F) * 1e3 == pytest.approx(ms, abs=6e-5)


def test_k1_work_counts_each_byte_once():
    ops, nbytes = k1_work(2, 256, 512)
    assert ops == 2 * 2 * 256 * 512 * 256
    assert nbytes == 2 * 256 * 256 + 2 * 512 * 256 + 2 * 512 + 12 * 2 * 256
    # a small call is bound by its bytes
    assert k1_bound_s(1, 256, 256) == pytest.approx(k1_work(1, 256, 256)[1] / 3.35e12)
