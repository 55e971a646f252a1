"""The port's photon maps and photon query (``raytracer_tpu_torch.ops.
photon_grid``, ``ops.photon_query``) against the JAX package's, run as the
JAX tests run them on the CPU (the Pallas query in interpret mode). The
same numpy inputs go through both; on the CPU the port takes its plain
PyTorch query, the function its CUDA kernel is checked against on the card
(``chip_smoke.py``).

Tolerances:
- counts are exact (both test ``d2 <= r2`` on the same float32 values);
- flux within rtol = atol = 2e-2 against JAX, the JAX test's own band: the
  TPU kernel rounds each weight to bf16 for its flux matmul (~0.4%), the
  port keeps it in float32;
- flux within rtol 1e-4 against the float64 oracle of
  ``tests/test_pallas_photon.py`` fed the port's bf16-rounded payload
  (float32 sums of non-negative terms);
- the grids array-equal: the same float32 cell ids, the same stable sort.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.ops import pallas_photon as jpp  # noqa: E402
from raytracer_tpu.ops import photon_grid as jpg  # noqa: E402
from raytracer_tpu_torch.ops import photon_grid as tpg  # noqa: E402
from raytracer_tpu_torch.ops import photon_query as tpq  # noqa: E402
from test_pallas_photon import make, oracle  # noqa: E402

BMIN = np.full(3, -1.2, np.float32)
BMAX = np.full(3, 1.2, np.float32)


def case(seed):
    """The four cases of tests/test_pallas_photon.py: (pos, power, norm,
    valid, points, radius, cap), float32. Seed 2 queries the cell-sorted
    grid arrays; seed 3 has no valid photon."""
    if seed == 1:
        pos, power, norm, valid, points, _ = make(1, n_ph=2000, n_pts=100)
        radius, cap = np.full(100, 0.9), 0.9
    elif seed == 3:
        pos, power, norm, valid, points, radius = make(3, n_ph=500)
        valid, cap = np.zeros(500, bool), 0.3
    else:
        pos, power, norm, valid, points, radius = make(seed)
        cap = 0.35 if seed == 0 else 0.3
    f = np.float32
    pos, power, norm, points, radius = (np.asarray(x, f) for x in
                                        (pos, power, norm, points, radius))
    if seed == 2:
        g = jpg.build_grid(*(jnp.asarray(x) for x in (pos, power, norm,
                                                      valid, BMIN, BMAX)),
                           (8, 8, 8))
        valid = np.arange(len(pos)) < int(g.n_valid)
        pos, power, norm = (np.asarray(x, f) for x in (g.pos, g.power,
                                                        g.norm))
    return pos, power, norm, valid, points, radius, f(cap)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_query_matches_jax(seed):
    pos, power, norm, valid, points, radius, cap = case(seed)
    jq = jpp.query_photons(*(jnp.asarray(x) for x in
                             (pos, power, norm, valid, points, radius)), cap)
    tq = tpq.query_photons(*(t(x) for x in
                             (pos, power, norm, valid, points, radius)),
                           float(cap))
    for name in ("count_r", "count_cap"):
        np.testing.assert_array_equal(getattr(tq, name).numpy(),
                                      np.asarray(getattr(jq, name)))
    for name in ("flux_r", "flux_cap"):
        np.testing.assert_allclose(getattr(tq, name).numpy(),
                                   np.asarray(getattr(jq, name)),
                                   rtol=2e-2, atol=2e-2)
    if seed == 3:
        assert tq.count_cap.sum() == 0 and tq.flux_r.abs().sum() == 0
    else:
        assert tq.count_r.sum() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_query_matches_float64_oracle(seed):
    """Counts exact and flux to float32 summation against the direct sum
    in float64, with the payload rounded to bf16 as the port packs it."""
    pos, power, norm, valid, points, radius, cap = case(seed)
    bf = (lambda x: t(x).to(torch.bfloat16).double().numpy())
    fr, cr, fc, cc = oracle(pos.astype(np.float64), bf(power), bf(norm),
                            valid, points.astype(np.float64),
                            radius.astype(np.float64), float(cap))
    tq = tpq.query_photons(*(t(x) for x in
                             (pos, power, norm, valid, points, radius)),
                           float(cap))
    np.testing.assert_array_equal(tq.count_r.numpy(), cr)
    np.testing.assert_array_equal(tq.count_cap.numpy(), cc)
    np.testing.assert_allclose(tq.flux_r.numpy(), fr, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tq.flux_cap.numpy(), fc, rtol=1e-4,
                               atol=1e-4)


def test_query_counts_do_not_depend_on_cull_blocks(monkeypatch):
    """The cull drops no photon in reach: point blocks of 2048 and of 7
    (a cull box around few points) give the same counts, and photons in
    any order give the same counts."""
    pos, power, norm, valid, points, radius, cap = case(0)
    args = [t(x) for x in (pos, power, norm, valid, points, radius)]
    wide = tpq.query_photons(*args, float(cap))
    monkeypatch.setattr(tpq, "PLAIN_POINTS", 7)
    narrow = tpq.query_photons(*args, float(cap))
    perm = torch.from_numpy(np.random.default_rng(0).permutation(len(pos)))
    shuffled = tpq.query_photons(args[0][perm], args[1][perm], args[2][perm],
                                 args[3][perm], *args[4:], float(cap))
    for q in (narrow, shuffled):
        assert torch.equal(q.count_r, wide.count_r)
        assert torch.equal(q.count_cap, wide.count_cap)
        torch.testing.assert_close(q.flux_r, wide.flux_r, rtol=1e-5,
                                   atol=1e-5)


def test_pack_photons_matches_jax():
    pos, power, norm, valid, *_ = case(0)
    jp = jpp._pack_photons(*(jnp.asarray(x) for x in
                             (pos, power, norm, valid)), jpp.CHUNK)
    tp = tpq._pack_photons(*(t(x) for x in (pos, power, norm, valid)))
    np.testing.assert_array_equal(tp.posf.numpy(), np.asarray(jp[0]))
    np.testing.assert_array_equal(tp.payload.float().numpy(),
                                  np.asarray(jp[1], np.float32))
    np.testing.assert_array_equal(tp.cull.numpy(), np.asarray(jp[2]))
    # valid photons sit anywhere here: n_live is one past the last one
    assert int(tp.n_live[0]) == np.nonzero(valid)[0][-1] + 1
    assert (tpq.TILE, tpq.CHUNK, tpq.BIG) == (jpp.TILE, jpp.CHUNK, jpp.BIG)


def test_query_has_no_fallback_off_cpu():
    """A tensor on a device with no kernel raises; it never reaches the
    plain version."""
    pos, power, norm, valid, points, radius, cap = case(0)
    planes = tpq._pack_photons(*(t(x) for x in (pos, power, norm, valid)))
    meta = torch.empty((4, 3), device="meta")
    r2 = torch.empty((4,), device="meta")
    with pytest.raises(NotImplementedError, match="no kernel"):
        tpq.query_planes(planes, meta, r2, r2)


def grid_inputs(seed=0, n=5000):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    power = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    norm = rng.normal(size=(n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    return pos, power, norm, valid, np.zeros(3, np.float32), \
        np.full(3, 10.0, np.float32)


@pytest.mark.parametrize("compact,max_valid", [(False, None), (True, None),
                                               (True, 4200)])
def test_build_grid_matches_jax(compact, max_valid):
    args = grid_inputs()
    res = (8, 7, 9)
    jg = jpg.build_grid(*(jnp.asarray(x) for x in args), res,
                        compact=compact, max_valid=max_valid)
    tg = tpg.build_grid(*(t(x) for x in args), res, compact=compact,
                        max_valid=max_valid)
    for name in ("pos", "power", "norm", "cell_start", "inv_cell"):
        a, b = getattr(tg, name), np.asarray(getattr(jg, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.float().numpy(),
                                      b.astype(np.float32), err_msg=name)
    assert tg.power.dtype == (torch.bfloat16 if compact else torch.float32)
    assert tg.cell_start.dtype == torch.int32
    assert int(tg.n_valid) == int(jg.n_valid) == args[3].sum()


def test_choose_grid_resolution_matches_jax():
    for bmax, n, k in (((555.0,) * 3, 500_000, 100), ((555.0,) * 3, 20_000,
                                                      50),
                       ((10.0, 1.0, 300.0), 1000, 100)):
        lo, hi = np.zeros(3), np.asarray(bmax)
        assert tpg.choose_grid_resolution(lo, hi, n, k) == \
            jpg.choose_grid_resolution(lo, hi, n, k)
