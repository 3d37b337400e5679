"""The traffic generator, the seeded checkpoint and the frozen copies of the
program's data modules."""
import numpy as np
import pytest
import torch

from perfbench import spec, traffic, weights
from perfbench.frozen import acoustic, features

SEED = 2**33 + 17  # larger than 32 bits hold, as the driver's seeds are


def _small(mix_name, **kw):
    return {**spec.traffic(mix_name), **dict(bank=6, scene_windows=6, block=5, ring=3), **kw}


def test_same_seed_same_bank_blocks_and_weights():
    mix = _small("archive_feat")
    a, b = traffic.seeds(SEED), traffic.seeds(SEED)
    bank_a, bank_b = traffic.make_bank(mix, a.bank), traffic.make_bank(mix, b.bank)
    assert np.array_equal(bank_a.rows, bank_b.rows)
    assert np.array_equal(bank_a.labels, bank_b.labels)
    assert bank_a.rows.shape == (6, features.MFCC20_DIM) and bank_a.rows.dtype == np.float32
    assert np.array_equal(traffic.make_bank(mix, a.bank).rows, bank_a.rows)  # seq reusable
    assert np.array_equal(traffic.draw_ring(mix, 6, a.blocks), traffic.draw_ring(mix, 6, b.blocks))
    assert a.weights == b.weights
    cnn = spec.config("shield8_int8")["cnn"]
    pa, pb = (weights.float_params(cnn, s.weights, "cpu") for s in (a, b))
    assert all(torch.equal(pa[n][k], pb[n][k]) for n in pa for k in ("w", "b"))


def test_another_seed_changes_the_values_not_the_sizes():
    mix = _small("archive_feat")
    a, b = traffic.seeds(SEED), traffic.seeds(SEED + 1)
    bank_a, bank_b = traffic.make_bank(mix, a.bank), traffic.make_bank(mix, b.bank)
    assert bank_a.rows.shape == bank_b.rows.shape
    assert not np.array_equal(bank_a.rows, bank_b.rows)
    ring = traffic.draw_ring(mix, 6, a.blocks)
    assert ring.shape == (3, 5) and ring.min() >= 0 and ring.max() < 6
    assert a.weights != b.weights and 0 <= a.weights < 2**63
    with pytest.raises(ValueError):
        traffic.seeds(-1)


def test_weights_take_the_model_shapes_and_he_scale():
    cnn = spec.config("shield8_int8")["cnn"]
    p = weights.float_params(cnn, 7, "cpu")
    assert p["conv0"]["w"].shape == (3, 1, 64) and p["conv2"]["w"].shape == (3, 128, 256)
    assert p["dense0"]["w"].shape == (35_072, 64) and p["dense1"]["b"].shape == (2,)
    std = float(p["dense0"]["w"].std())
    assert std == pytest.approx((2 / 35_072) ** 0.5, rel=0.02)
    # the last conv's channels: distinct L1 norms, 0.5-1.5 times their mean,
    # far enough apart that no rounding reorders the prune's ranking
    l1 = p["conv2"]["w"].to(torch.float64).abs().sum(dim=(0, 1)).sort().values
    assert float(l1[-1] / l1[0]) == pytest.approx(3.0, rel=1e-4)
    assert float(((l1[1:] - l1[:-1]) / l1[1:]).min()) > 1e-3


def test_raw_traffic_sends_the_windows():
    mix = _small("archive_raw")
    bank = traffic.make_bank(mix, traffic.seeds(SEED).bank)
    assert bank.input == "raw" and bank.rows.shape == (6, acoustic.N_SAMPLES)
    assert bank.rows.dtype == np.float32


def test_the_bank_does_not_depend_on_its_worker_count():
    mix = _small("archive_feat", bank=36, scene_windows=2)  # 18 scenes: two workers
    seq = traffic.seeds(SEED).bank
    pooled = traffic.make_bank(dict(mix, bank_workers=2), seq)
    inline = traffic.make_bank(dict(mix, bank_workers=1), seq)
    assert np.array_equal(pooled.rows, inline.rows)
    assert np.array_equal(pooled.labels, inline.labels) and pooled.rows.shape == (36, 1096)


def test_scene_proportions_follow_the_monitor():
    rng = np.random.default_rng(3)
    wins, labels = acoustic.scene_windows(20, rng)
    assert len(wins) == 20 and labels[0] == 0 and labels[-1] == 0
    on = labels.index(1)
    assert 1 <= on < 16 and 3 <= sum(labels) <= 10
    assert labels[on : on + sum(labels)] == [1] * sum(labels)  # one contiguous pass


def test_frozen_copies_equal_the_programs_data_modules():
    from repro_torch.data import acoustic as p_acoustic
    from repro_torch.data import features as p_features

    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    ours = [acoustic.synth_uav(r1), acoustic.synth_background(r1)]
    theirs = [p_acoustic.synth_uav(r2), p_acoustic.synth_background(r2)]
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    assert np.array_equal(features.batch_features(np.stack(ours)),
                          p_features.batch_features(np.stack(theirs), "mfcc20"))
