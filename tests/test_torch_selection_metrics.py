"""The port's ``data.selection`` bitwise the reference's (numpy copies:
the same DataPack in, the same DataPack out, ``flag_outliers`` on spiked
data included), its ``utils.metrics`` records equal the reference's key by
key (wall-clock fields aside), and ``profile_to`` writes a trace file."""
import numpy as np
import pytest
import torch

from ionotomo_tpu.data import selection as jsel
from ionotomo_tpu.data.datapack import DataPack as JDataPack
from ionotomo_tpu.data.radio_array import generate_lofar_like_array as jarr
from ionotomo_tpu.utils import metrics as jmetrics
from ionotomo_tpu_torch.data import selection as tsel
from ionotomo_tpu_torch.data.datapack import DataPack as TDataPack
from ionotomo_tpu_torch.data.radio_array import (
    generate_lofar_like_array as tarr)
from ionotomo_tpu_torch.utils import metrics as tmetrics

NA, NT, ND = 14, 9, 7


def datapacks(ref=0, seed=0, spikes=()):
    """The same DataPack in both packages: a LOFAR-like array, random
    dTEC as a smooth drift plus noise, some flags, ``spikes`` (antenna,
    time, direction) impulsive outliers."""
    rng = np.random.default_rng(seed)
    t = np.arange(NT)[None, :, None]
    dtec = (rng.normal(size=(NA, 1, ND)) * 5.0 + 0.3 * t
            + rng.normal(scale=0.05, size=(NA, NT, ND)))
    for i, k, d in spikes:
        dtec[i, k, d] += 40.0
    flags = rng.uniform(size=dtec.shape) < 0.1
    flags[3] = rng.uniform(size=(NT, ND)) < 0.8        # a bad antenna
    noise = rng.uniform(0.02, 0.06, size=dtec.shape)
    dirs = np.stack([rng.uniform(0.5, 0.6, ND), rng.uniform(0.9, 1.0, ND)],
                    -1)
    times = 58000.3 + np.arange(NT) * 30.0 / 86400.0
    out = []
    for make_array, DataPack in ((jarr, JDataPack), (tarr, TDataPack)):
        out.append(DataPack(make_array(n_core=6, n_remote=NA - 6, seed=seed),
                            dirs, times, dtec=dtec.copy(),
                            flags=flags.copy(), noise_std=noise.copy(),
                            ref_antenna=ref))
    return out


def assert_same(jdp, tdp):
    for name in ("dtec", "flags", "noise_std", "directions", "times"):
        np.testing.assert_array_equal(getattr(tdp, name),
                                      getattr(jdp, name), err_msg=name)
    np.testing.assert_array_equal(tdp.array.itrs, jdp.array.itrs)
    assert tdp.array.labels == jdp.array.labels
    assert tdp.ref_antenna == jdp.ref_antenna
    assert tdp.frequency_hz == jdp.frequency_hz


@pytest.mark.parametrize("fn", ["core_antenna_indices",
                                "remote_antenna_indices"])
@pytest.mark.parametrize("radius", [2.0, 5.0, 30.0])
def test_antenna_indices_bitwise(fn, radius):
    jdp, tdp = datapacks()
    np.testing.assert_array_equal(getattr(tsel, fn)(tdp, radius),
                                  getattr(jsel, fn)(jdp, radius))


@pytest.mark.parametrize("n,include_ref,ref", [
    (5, True, 0), (5, True, 9), (5, False, 9), (13, True, 4), (20, True, 2)])
def test_select_antennas_by_distance_bitwise(n, include_ref, ref):
    jdp, tdp = datapacks(ref=ref)
    assert_same(jsel.select_antennas_by_distance(jdp, n, include_ref),
                tsel.select_antennas_by_distance(tdp, n, include_ref))


@pytest.mark.parametrize("n", [1, 3, 7, 12])
def test_select_facets_max_spread_bitwise(n):
    jdp, tdp = datapacks(seed=1)
    assert_same(jsel.select_facets_max_spread(jdp, n),
                tsel.select_facets_max_spread(tdp, n))


@pytest.mark.parametrize("frac,ref", [(0.5, 0), (0.5, 3), (0.05, 3)])
def test_drop_flagged_bitwise(frac, ref):
    jdp, tdp = datapacks(ref=ref)
    assert_same(jsel.drop_flagged(jdp, frac), tsel.drop_flagged(tdp, frac))


@pytest.mark.parametrize("threshold,min_epochs", [(6.0, 4), (3.0, 4),
                                                  (6.0, 10)])
def test_flag_outliers_bitwise(threshold, min_epochs):
    """Four spikes (two in one series, one at an end): the same count and
    the same flags, OR'd in place; ``min_epochs`` past the series length
    flags nothing."""
    spikes = ((1, 4, 2), (5, 0, 3), (5, 6, 3), (8, NT - 1, 0))
    jdp, tdp = datapacks(spikes=spikes)
    before = tdp.flags.copy()
    nj = jsel.flag_outliers(jdp, threshold, min_epochs)
    nt = tsel.flag_outliers(tdp, threshold, min_epochs)
    assert nt == nj
    assert_same(jdp, tdp)
    assert np.all(tdp.flags | ~before)               # OR'd, never cleared
    if min_epochs > NT:
        assert nt == 0
    else:
        assert all(tdp.flags[s] for s in spikes)


RECORDS = [dict(timestep=0, residual=np.float32(3.25), solver="kalman",
                rays=40, lam=[1.5, np.float64(0.25)], retraces=0),
           dict(event="beam_noise", t=3, mean=0.125, max=np.float32(2.0)),
           dict(event="prior_auto_selected", chosen=dict(sigma=0.3,
                                                         kind="sqexp"),
                t_wall=12.0)]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_metrics_writer_records_equal_the_reference(tmp_path, i):
    """One record each and all of them, through each package's writer into
    its own stream: equal key by key once ``t_wall`` (the host clock,
    added where absent) is dropped; a given ``t_wall`` is kept."""
    out = []
    for mod, name in ((jmetrics, "j"), (tmetrics, "t")):
        w = mod.MetricsWriter(str(tmp_path / name / "m.jsonl"))
        for rec in RECORDS[:i + 1]:
            w.write(rec)
        out.append(w.read_all())
    jr, tr = out
    assert len(tr) == len(jr) == i + 1
    for a, b in zip(jr, tr):
        assert "t_wall" in a and "t_wall" in b
        assert {k: v for k, v in a.items() if k != "t_wall"} \
            == {k: v for k, v in b.items() if k != "t_wall"}
    if i == 2:
        assert tr[-1]["t_wall"] == jr[-1]["t_wall"] == 12.0
    assert tmetrics.MetricsWriter(str(tmp_path / "none.jsonl")).read_all() \
        == []


def test_timed_and_rates_equal_the_reference():
    rec_j, rec_t = {}, {}
    for mod, rec in ((jmetrics, rec_j), (tmetrics, rec_t)):
        with mod.timed(rec, "a"):
            pass
        with mod.timed(rec, "a"):
            pass
    assert set(rec_t) == set(rec_j) == {"a"} and rec_t["a"] >= 0
    for args in ((100, 64, 2.0), (5, 1, 0.0)):
        assert tmetrics.rates(*args) == jmetrics.rates(*args)


def test_profile_to_writes_a_trace(tmp_path):
    """``profile_to`` writes a torch.profiler trace file of the block,
    with ``trace``'s named span in it."""
    d = tmp_path / "trace"
    with tmetrics.profile_to(str(d)):
        with tmetrics.trace("the_block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(d.glob("*.json"))
    assert len(files) == 1
    assert "the_block" in files[0].read_text()
