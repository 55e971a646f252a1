"""The numbers that decide ``correct``, from the program's answers and the
reference's, and the sampling of what is compared.

Images (the path-tracer and gather cells): the program's passes give, for
each of B sampled blocks of pixels, the block's mean radiance per pass,
(P, B, 3). The reference renders the same blocks' pixels on its own
random numbers and gives each pixel's sum and sum of squares. Three
numbers:

- ``z_block``: the largest |program - reference| over the blocks and
  colour channels of the mean over all passes, in standard errors (the
  program's from the spread of its passes, the reference's from its
  samples' variance): a bias anywhere in the sampled image;
- ``z_pass``: the largest |program - reference| over the passes and
  channels of one pass's mean over all sampled blocks, in units of the
  spread of that mean from pass to pass (1.4826 median absolute
  deviations, with the reference's standard error): one answer altered;
- ``dup_passes``: passes whose block means equal another pass's bit for
  bit (independent draws never do): a pass that returns an earlier
  answer. An exact comparison, limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

MAD_SIGMA = 1.4826


def sample_blocks(rng: np.random.Generator, width: int, height: int,
                  block: int, count: int) -> np.ndarray:
    """``count`` distinct blocks of ``block`` x ``block`` pixels on the
    aligned grid, drawn from ``rng``: (count,) block ids, row-major."""
    nbx, nby = width // block, height // block
    count = min(count, nbx * nby)
    return np.sort(rng.choice(nbx * nby, size=count, replace=False))


def block_pixels(blocks: np.ndarray, width: int, block: int) -> np.ndarray:
    """The flat pixel ids (B * block^2,) of ``blocks``, block-major."""
    nbx = width // block
    by, bx = np.divmod(blocks, nbx)
    dy, dx = np.divmod(np.arange(block * block), block)
    ys = by[:, None] * block + dy[None]
    xs = bx[:, None] * block + dx[None]
    return (ys * width + xs).reshape(-1)


def reference_blocks(s1, s2, spp: int, n_blocks: int):
    """(mean, standard error) of each block's mean radiance, (B, 3) each,
    from the reference's per-pixel sums ``s1``, ``s2`` (B * k, 3) of
    ``spp`` samples a pixel (block-major)."""
    s1 = s1.double().reshape(n_blocks, -1, 3)
    s2 = s2.double().reshape(n_blocks, -1, 3)
    k = s1.shape[1]
    mu = s1 / spp
    var = torch.clamp(s2 / spp - mu * mu, min=0.0) * spp / max(spp - 1, 1)
    return mu.mean(1), torch.sqrt(var.sum(1) / spp) / k


def _block_scores(prog, ref_mean, ref_se, rel_floor: float):
    """(all-pass mean (B, 3), its standard error, the denominator) of the
    program's per-pass block means ``prog`` (P, B, 3), float64 on the
    CPU. ``rel_floor`` x |reference| joins the standard errors in
    quadrature: the float32 rounding of a value that no sample varies (a
    gather path whose first hit is diffuse returns its pixel's estimate
    exactly)."""
    P = prog.shape[0]
    mean = prog.mean(0)
    se = prog.std(0) / np.sqrt(P) if P > 1 else torch.zeros_like(mean)
    den = torch.sqrt(se * se + ref_se * ref_se + (rel_floor * ref_mean) ** 2)
    return mean, se, den


def image_numbers(prog, ref_mean, ref_se, rel_floor: float,
                  want=("z_block", "z_pass", "dup_passes")) -> dict:
    """The numbers ``want`` (module docstring) of the program's per-pass
    block means ``prog`` (P, B, 3) against the reference's (B, 3) means
    and standard errors."""
    prog = prog.double().cpu()
    ref_mean, ref_se = ref_mean.double().cpu(), ref_se.double().cpu()
    P = prog.shape[0]
    mean, _se, den = _block_scores(prog, ref_mean, ref_se, rel_floor)
    out = {"z_block": _z_max(mean - ref_mean, den)}
    g = prog.mean(1)                                  # (P, 3)
    g_ref = ref_mean.mean(0)
    g_ref_se = torch.sqrt((ref_se * ref_se).sum(0)) / ref_se.shape[0]
    mad = (g - g.median(0).values).abs().median(0).values * MAD_SIGMA
    den_p = torch.sqrt(mad * mad + g_ref_se * g_ref_se
                       + (rel_floor * g_ref) ** 2)
    out["z_pass"] = _z_max(g - g_ref[None], den_p[None])
    out["dup_passes"] = int(P - torch.unique(prog.reshape(P, -1),
                                             dim=0).shape[0])
    return {k: out[k] for k in want}


def worst_blocks(prog, ref_mean, ref_se, rel_floor: float, n: int = 3):
    """The ``n`` blocks of largest |z| (``image_numbers``' z_block): rows
    of (block index, channel, z, program mean, its standard error,
    reference mean, its standard error), for the run's log."""
    prog = prog.double().cpu()
    ref_mean, ref_se = ref_mean.double().cpu(), ref_se.double().cpu()
    mean, se, den = _block_scores(prog, ref_mean, ref_se, rel_floor)
    z = (mean - ref_mean).abs() / torch.clamp(den, min=1e-300)
    rows = []
    for j in torch.argsort(z.reshape(-1), descending=True)[:n].tolist():
        b, c = divmod(j, 3)
        rows.append((b, c, float(z[b, c]), float(mean[b, c]), float(se[b, c]),
                     float(ref_mean[b, c]), float(ref_se[b, c])))
    return rows


def _z_max(diff, den) -> float:
    """The largest |diff| / den; a difference over a zero denominator is
    infinite, none over none is 0."""
    z = torch.where(den > 0, diff.abs() / torch.where(den > 0, den, 1.0),
                    torch.where(diff != 0, torch.inf, 0.0))
    return float(z.max())


def sample_iterations(rng: np.random.Generator, job: int,
                      count: int) -> set:
    """``count`` pass indices of an SPPM iteration cell drawn from ``rng``:
    one a job's first iteration (from zeros), the rest later iterations,
    all among the first three jobs."""
    starts = [0, job, 2 * job]
    later = [k for k in range(1, 3 * job) if k % job]
    picked = {int(rng.choice(starts))}
    picked |= {int(k) for k in rng.choice(later, size=min(count - 1,
                                                          len(later)),
                                          replace=False)}
    return picked


STATE_QUANTITIES = ("n_g", "r2_g", "flux_g", "n_c", "r2_c", "flux_c")
GLOBAL_COLUMNS = 5        # n, r^2 and flux (3) of the global map


def state_blocks(state: dict, n_blocks: int):
    """Block means (B, 10) of a per-pixel SPPM state (block-major pixels):
    photons, r^2 and flux (3) of the global map, then of the caustic
    map."""
    cols = []
    for key in STATE_QUANTITIES:
        x = state[key].double()
        x = x.reshape(n_blocks, -1, *x.shape[1:]).mean(1)
        cols.append(x.reshape(n_blocks, -1))
    return torch.cat(cols, 1)


Z_OFF = 6.0


def state_numbers(prog, reps) -> dict:
    """The numbers of the program's block means ``prog`` (I, B, Q) after
    each sampled iteration against the reference's ``reps`` (I, R, B, Q),
    R replicas of the same iteration from the same state, each
    |program - replicas' mean| in units of the replicas' spread (times
    sqrt(1 + 1/R): the spread of one more replica):

    - ``blocks_off``: how many (iteration, block, quantity) of the global
      map lie more than ``Z_OFF`` spreads off. A count and not a largest
      score: a quantity that the state before nearly fixes (a job's first
      photon count is k wherever a point finds photons) has no spread in
      the replicas, and one rare event (a camera ray that leaves the box)
      puts it infinitely many spreads off;
    - ``z_total``: the largest over iterations and all ten quantities of
      the mean over the sampled blocks, where the caustic map's photons,
      which reach few pixels, are counted together."""
    prog, reps = prog.double().cpu(), reps.double().cpu()
    R = reps.shape[1]
    scale = np.sqrt(1.0 + 1.0 / R)
    g = slice(0, GLOBAL_COLUMNS)
    diff = prog[..., g] - reps[..., g].mean(1)
    den = reps[..., g].std(1) * scale
    z = torch.where(den > 0, diff.abs() / torch.where(den > 0, den, 1.0),
                    torch.where(diff != 0, torch.inf, 0.0))
    tot, tot_reps = prog.mean(1), reps.mean(2)
    z_total = _z_max(tot - tot_reps.mean(1), tot_reps.std(1) * scale)
    return {"blocks_off": int((z > Z_OFF).sum()), "z_total": z_total}
