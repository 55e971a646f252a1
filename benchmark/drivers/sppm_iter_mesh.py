"""SPPM iterations, one a pass, on a configuration whose mesh slot holds a
large mesh: the ``sppm_iter`` driver (its passes, state resets, sampled
iterations and comparison), with the program's scene and the reference
made for the mesh.

Set-up builds the program's scene through ``builtin.cornell_bunny`` (its
mesh slot holds the bunny), checks it against the configuration's mesh
(``"triangles"``, and the placed mesh's ``"bounds"`` within
``BOUNDS_ATOL``), and warms as ``sppm_iter`` does. The reference is
``reference.mesh`` (the configuration's scene, the mesh read from its
OBJ file, the closest hit with an exact chunk cull) and
``reference.sppm_mesh`` (one iteration), checked against the same mesh
entry.

Beside ``sppm_iter``'s numbers the comparison holds the geometry the
program traces to the reference's: ``hits_off`` counts the probe rays
(``PROBES`` from points of the room, drawn from ``--seed``, towards points
of the mesh's box) whose closest hit through the program's tables and
bounce (on the card the kernels of the timed path: the ordered walk over
the mesh) differs from ``reference.mesh``'s: a hit against a miss, or a
point more than ``HIT_ATOL`` or a shading normal more than
``NORMAL_ATOL`` away. The SPPM state's statistics cannot see a mesh
placed a little off or a walk that loses a few triangles; these rays
can.

``z_total`` is ``sppm_iter``'s over the global map's quantities, and
``caustic_z_less_one`` over the caustic map's, the larger of the two.

Traffic keys: ``job_iterations``, ``trace_passes``. Check keys:
``block``, ``blocks``, ``iterations``, ``replicas``, ``limits``."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from harness import registry, seeds, sppm_program
from reference import compare
from reference import mesh as ref_mesh
from reference import sppm as ref_sppm
from reference import sppm_mesh

base = registry.load_module(Path(__file__).with_name("sppm_iter.py"),
                            "bench_driver_sppm_iter")

BOUNDS_ATOL = 2e-3      # the file's 3 decimals and float32 vertices
PROBES = 1 << 16
# float32 hit points lie within ~1e-4 of float64's at the room's
# distances (t up to ~1,000, |d| ~ 100-900); a mesh one unit off moves
# them by about a unit
HIT_ATOL = 1e-2
# float32 interpolated and normalised vertex normals: ~1e-6 off
NORMAL_ATOL = 1e-3


def caustic_z_less_one(prog, reps) -> float:
    """``compare.state_numbers``' ``z_total`` of the caustic map's
    quantities (block means ``prog`` (I, B, Q), ``reps`` (I, R, B, Q)),
    with one sampled block left out of both sides: the block that lowers
    it most. A pixel's first caustic photon sets its count to k and its
    r^2 to the cap's (``reference.sppm``'s update), so one stray caustic
    photon moves every pixel of a block within the cap at once. Sixteen
    replicas seldom hold such a photon: that one block read 24.1 against
    them, and a replica against the other fifteen reads up to 16.6 on the
    caustic r^2 alone. A wrong answer moves more than one block."""
    caus = slice(compare.GLOBAL_COLUMNS, None)
    n = prog.shape[1]
    return min(compare.state_numbers(
        prog[:, keep, caus], reps[:, :, keep, caus])["z_total"]
        for keep in ([i for i in range(n) if i != b] for b in range(n)))


def check_mesh(spec: dict, count: int, lo, hi, who: str):
    """Raise unless ``count`` triangles with vertex bounds ``lo``, ``hi``
    are the mesh entry ``spec``'s."""
    want_lo, want_hi = (torch.tensor(b, dtype=torch.float64)
                        for b in spec["bounds"])
    if count != spec["triangles"] or not (
            torch.allclose(lo.double().cpu(), want_lo, rtol=0,
                           atol=BOUNDS_ATOL)
            and torch.allclose(hi.double().cpu(), want_hi, rtol=0,
                               atol=BOUNDS_ATOL)):
        raise ValueError(
            f"{who}: {count} triangles in {lo.tolist()}-{hi.tolist()}, the "
            f"configuration has {spec['triangles']} in {spec['bounds']}")


def build(cfg: dict, device):
    """``sppm_program.build``'s objects (its ``RenderConfig`` of the
    configuration) on the port's Cornell box with the bunny in its mesh
    slot, checked against the configuration's mesh."""
    from raytracer_tpu_torch.ops import dispatch
    from raytracer_tpu_torch.scene import builtin
    p = sppm_program.build(cfg, device)
    scene = builtin.cornell_bunny(
        aspect_ratio=cfg["width"] / cfg["height"]).to(device)
    tri = scene.triangles
    pts = torch.cat([tri.v0, tri.v0 + tri.e1, tri.v0 + tri.e2])
    check_mesh(cfg["scene"]["meshes"][0], int(tri.v0.shape[0]),
               pts.amin(0), pts.amax(0), "the program's scene")
    p.sppm.check_scene(scene)
    p.scene = scene
    p.tables = dispatch.route_tables(scene, p.config.intersector)
    p.kw = p.sppm.iteration_kwargs(scene, p.config)
    return p


def probe_rays(seed: int, lo, hi, mesh_box):
    """``PROBES`` rays (origins, directions; (P, 3) float32 numpy), drawn
    from ``seed``: from uniform points of the box [lo + 1, hi - 1] (the
    room) towards uniform points of ``mesh_box`` ((lo, hi) of the mesh)."""
    rng = seeds.numpy_rng(seed, seeds.SAMPLE, 1)
    o = rng.uniform(np.asarray(lo) + 1.0, np.asarray(hi) - 1.0, (PROBES, 3))
    d = rng.uniform(mesh_box[0], mesh_box[1], (PROBES, 3)) - o
    return o.astype(np.float32), d.astype(np.float32)


def program_hits(p, o, d, t_min: float):
    """(hit (P,), point (P, 3), normal (P, 3)) of rays ``o``, ``d`` through
    the program's tables and fused bounce, float64 on the CPU."""
    from raytracer_tpu_torch.ops.fused_bounce import bounce_tables
    dev = p.scene.bounds_min.device
    o_t, d_t = (torch.as_tensor(x.T.copy(), device=dev) for x in (o, d))
    n = o_t.shape[1]
    out = bounce_tables(p.tables, o_t, d_t, t_min,
                        torch.ones((n,), dtype=torch.bool, device=dev),
                        torch.zeros((4, n), device=dev))
    pt, nrm = out[5].T.double().cpu(), out[6].T.double().cpu()
    return (nrm * nrm).sum(1) > 0.25, pt, nrm         # a miss: zero normal


def reference_hits(ms, o, d, t_min: float):
    """``program_hits`` of the reference scene ``ms`` (its dtype)."""
    dev, dt = ms.sc.cam_origin.device, ms.sc.cam_origin.dtype
    o_r, d_r = (torch.as_tensor(x, dtype=torch.float64).to(dev, dt)
                for x in (o, d))
    valid, pt, nrm, _front, _mat = ref_mesh.hit(ms, o_r, d_r, t_min)
    return valid.cpu(), pt.double().cpu(), nrm.double().cpu()


def hits_off(a, b) -> int:
    """Probe rays whose hits ``a`` and ``b`` (``program_hits``) differ."""
    (va, pa, na), (vb, pb, nb) = a, b
    far = ((pa - pb).norm(dim=1) > HIT_ATOL) | (
        (na - nb).norm(dim=1) > NORMAL_ATOL)
    return int(((va != vb) | (va & vb & far)).sum())


class Driver(base.Driver):
    def setup(self):
        p = self.prog = build(self.cfg, self.device)
        self.npix = self.cfg["width"] * self.cfg["height"]
        state = p.sppm.init_state(self.npix, self.device)
        warm = seeds.derive(self.seed, seeds.WARM)
        for _ in range(2):          # the graphs' capture, then a replay
            state = p.sppm.sppm_iteration(p.scene, p.tables, state, warm,
                                          **p.kw)
        self.bad = torch.zeros((), dtype=torch.bool, device=self.device)
        self.state = None
        self.refs = {}                  # ``_reference``'s, a dtype

    def release(self):
        p = self.prog
        mesh = self.cfg["scene"]["meshes"][0]
        o, d = probe_rays(self.seed, p.scene.bounds_min.tolist(),
                          p.scene.bounds_max.tolist(), mesh["bounds"])
        t_min = self.cfg["sppm"]["photon_t_min"]
        self.probe = (o, d, t_min, program_hits(p, o, d, t_min))
        super().release()

    def _hits_off(self, hits) -> int:
        o, d, t_min, _prog = self.probe
        return hits_off(hits, reference_hits(self._reference(), o, d,
                                             t_min))

    def compare(self) -> dict:
        out = super().compare()
        out["hits_off"] = self._hits_off(self.probe[3])
        return out

    def control(self, passes: int, dtype) -> dict:
        out = super().control(passes, dtype)
        o, d, t_min, _prog = self.probe
        out["hits_off"] = self._hits_off(reference_hits(
            self._reference(dtype), o, d, t_min))
        return out

    def _reference(self, dtype=torch.float64):
        """The reference scene in ``dtype`` on the device: the OBJ read,
        checked against the configuration and culled once a run, and
        moved once a dtype."""
        if not self.refs:
            ms = ref_mesh.build(self.cfg, self.data_root)
            sc = ms.sc
            v0 = sc.tri_v0
            pts = torch.cat([v0, v0 + sc.tri_e1, v0 + sc.tri_e2])
            check_mesh(self.cfg["scene"]["meshes"][0],
                       sc.counts()["triangles"], pts.amin(0), pts.amax(0),
                       "the reference's scene")
            self.refs[None] = ms
        if dtype not in self.refs:
            self.refs[dtype] = self.refs[None].to(self.device, dtype)
        return self.refs[dtype]

    def _numbers(self, after_of) -> dict:
        """``sppm_iter``'s numbers, with ``z_total`` the larger of the
        global map's and ``caustic_z_less_one``."""
        if not self.kept:
            raise RuntimeError("the window reached no sampled iteration "
                               f"(sampled: {sorted(self.sampled)})")
        ms = self._reference()
        prog, reps, unchanged = [], [], 0
        for k, (before, _after) in sorted(self.kept.items()):
            after = after_of(k, before)
            unchanged += int(all(torch.equal(after[key], before[key])
                                 for key in ref_sppm.STATE_KEYS))
            prog.append(compare.state_blocks(after, self.n_blocks))
            reps.append(self._replicas(ms, before, k))
        prog, reps = torch.stack(prog), torch.stack(reps)
        out = compare.state_numbers(prog, reps)
        glob = slice(0, compare.GLOBAL_COLUMNS)
        out["z_total"] = max(
            compare.state_numbers(prog[..., glob], reps[..., glob])[
                "z_total"], caustic_z_less_one(prog, reps))
        out["unchanged"] = unchanged
        return out

    def _iterate(self, ms, before: dict, gen) -> dict:
        cfg = self.cfg
        return sppm_mesh.iteration(ms, before, self.pixels, cfg["width"],
                                   cfg["height"], cfg["sppm"], cfg["t_min"],
                                   cfg["spawn_eps_rel"], gen)
