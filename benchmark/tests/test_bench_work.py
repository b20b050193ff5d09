"""The yardstick's counts against the hand-worked numbers: 1.99 GFLOP a
trained bbc sample, 10.77 MFLOP a trained kdd seed-row, 37.0 GFLOP a kdd
Gibbs step over the test split, 334 MFLOP a scored bbc row; the bounds of
the two kernels."""

import pytest

from benchmark import inputs, work


def test_train_flops():
    # bbc: 1058 networks of 1058-111-111-111-111-20 and back: 313,242 MACs
    # a network and sample, x3 for forward and backward, plus 2*20*50 once
    assert work.dense_macs(inputs.config('bbc')) == 313_242
    assert work.train_flops_per_sample(inputs.config('bbc')) == (
        1058 * (6 * 313_242 + 2000))
    assert work.train_flops_per_sample(inputs.config('bbc')) == (
        pytest.approx(1.99e9, rel=1e-3))
    # kdd: 7,200 + 7,200 MACs a network, distance 2*10*4096 counted once
    assert work.train_flops_per_sample(inputs.config('kdd')) == (
        64 * (6 * 14_400 + 81_920))
    assert work.train_flops_per_sample(inputs.config('kdd')) == (
        pytest.approx(10.77e6, rel=1e-3))


def test_forward_flops():
    assert work.cmll_flops_per_step(inputs.config('kdd'), 11, 34955) == (
        pytest.approx(37.0e9, rel=2e-3))
    assert work.encode_flops_per_row(inputs.config('bbc')) == (
        pytest.approx(334e6, rel=2e-3))


def test_bounds():
    # kdd's Gibbs step: operations bound it
    assert work.vq_bound_s(11, 34955, 10, 4096) == pytest.approx(
        2 * 11 * 34955 * 10 * 4096 / 67e12)
    # bbc's train batch: bytes bound it
    assert work.vq_bound_s(1058, 25, 20, 50) == pytest.approx(
        4 * 1058 * (25 * 20 + 20 * 50 + 25) / 3.35e12)
    assert work.n_params(inputs.config('bbc')) == 333_490_064
    assert work.adam_bound_s(333_490_064) == pytest.approx(
        28 * 333_490_064 / 3.35e12)
