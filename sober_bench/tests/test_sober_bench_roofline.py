"""The roofline arithmetic against hand counts, two shapes a kernel."""
import sys

import pytest

from tiny import REPO

sys.path.insert(0, REPO)
from sober_bench import roofline as rf  # noqa: E402

HBM, FP32, FP64, INT8 = 3.35e12, 67e12, 34e12, 1979e12


@pytest.mark.parametrize("n,m,d,by", [
    # the 200k strip at d = 4: 4 B x (200,500 x 4 + 10^8) moved, 1.4e9 flops
    (200_000, 500, 4, "bytes"),
    # a small Gram at d = 100: 4 B x (128 x 200 + 16,384), 302 flops an entry
    (128, 128, 100, "flops"),
])
def test_rbf_gram(n, m, d, by):
    n_bytes = 4 * ((n + m) * d + n * m)
    flops = n * m * (3 * d + 2)
    want = n_bytes / HBM if by == "bytes" else flops / FP32
    assert rf.rbf_gram_s(n, m, d) == pytest.approx(want, rel=1e-12)
    assert rf.rbf_gram_s(n, m, d) == pytest.approx(max(n_bytes / HBM, flops / FP32))


def test_rbf_gram_hand_numbers():
    # 512 x 65,536 at d = 10: (66,048 x 10 + 33,554,432) x 4 B = 136,859,648 B
    assert rf.rbf_gram_s(512, 65_536, 10) == pytest.approx(136_859_648 / 3.35e12)
    # 1 x 1 at d = 1: 12 B, 5 flops
    assert rf.rbf_gram_s(1, 1, 1) == pytest.approx(max(12 / 3.35e12, 5 / 67e12))


def test_tanimoto_gram_hand_numbers():
    # the pi sweep: 133,303 x 512 over 2048 bits: 2.7956e11 bit operations
    ops = 2 * 133_303 * 512 * 2048
    assert ops == 279_556_653_056
    assert rf.tanimoto_gram_s(133_303, 512, 2048) == pytest.approx(ops / 1979e12)
    # 500 x 2,000: 640,000 B of bits and 4,000,000 B of Gram; 4.096e9 ops
    n_bytes = 2_500 * 256 + 4 * 1_000_000
    assert rf.tanimoto_gram_s(500, 2_000, 2048) == pytest.approx(
        max(n_bytes / 3.35e12, 4.096e9 / 1979e12))


def test_car_hand_numbers():
    # m = 200, q = 100, all 100 lanes eliminated: 2 x 200 x 5,050 flops
    flops = 2 * 200 * 5_050
    assert flops == 2_020_000
    t_ops = flops / FP64 + flops / FP32
    assert rf.car_s(200, 100, 100) == pytest.approx(max(4 * (200 * 100 + 800) / HBM, t_ops))
    # m = 400, q = 200, 3 eliminated: 2 x 400 x (200 + 199 + 198) flops
    flops = 2 * 400 * 597
    assert rf.car_s(400, 200, 3) == pytest.approx(
        max(4 * (400 * 200 + 1600) / HBM, flops / FP64 + flops / FP32))
    assert rf.car_s(400, 200, 0) == pytest.approx(4 * (400 * 200 + 1600) / HBM)
