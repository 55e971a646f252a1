"""The program's SPPM objects for a configuration with an ``"sppm"``
section: the Cornell scene as the port builds it, its tables on the
route, and ``sppm.iteration_kwargs`` of the configuration. The program is
imported here, inside the function, at set-up."""

from __future__ import annotations

from types import SimpleNamespace

STATE_FIELDS = (("flux_g", "glob", "flux"), ("r2_g", "glob", "radius2"),
                ("n_g", "glob", "photons"), ("flux_c", "caustic", "flux"),
                ("r2_c", "caustic", "radius2"),
                ("n_c", "caustic", "photons"))


def build(cfg: dict, device, gather_spp: int = None, gather_depth: int = None,
          spp_chunk: int = 1):
    from raytracer_tpu_torch.models import sppm
    from raytracer_tpu_torch.ops import dispatch
    from raytracer_tpu_torch.scene import builtin
    from raytracer_tpu_torch.utils.config import RenderConfig, SPPMConfig
    sp = cfg["sppm"]
    if cfg["scene"]["kind"] != "primitives" or not cfg["scene"].get(
            "meshes"):
        raise ValueError("the SPPM drivers run the port's Cornell box with "
                         "its mesh")
    rc = RenderConfig(
        width=cfg["width"], height=cfg["height"],
        samples_per_pixel=gather_spp or cfg["gather"]["spp"],
        max_depth=gather_depth or cfg["gather"]["max_depth"],
        spp_chunk=spp_chunk, t_min=cfg["t_min"],
        spawn_eps_rel=cfg["spawn_eps_rel"], intersector=cfg["route"],
        sppm=SPPMConfig(
            n_iterations=sp["iterations"],
            photons_per_iter=sp["photons_per_iteration"], alpha=sp["alpha"],
            k_global=sp["k_global"], k_caustic=sp["k_caustic"],
            max_photon_bounces=sp["max_photon_bounces"],
            max_camera_bounces=sp["max_camera_bounces"],
            max_photons_per_cell=sp["max_photons_per_cell"],
            query_impl=sp["query"]))
    scene = builtin.cornell_box(
        aspect_ratio=cfg["width"] / cfg["height"],
        with_mesh=True).to(device)
    sppm.check_scene(scene)
    tables = dispatch.route_tables(scene, rc.intersector)
    return SimpleNamespace(sppm=sppm, scene=scene, tables=tables, config=rc,
                           kw=sppm.iteration_kwargs(scene, rc))


def state_dict(state, pixels=None) -> dict:
    """The per-pixel state as a dict of ``reference.sppm.STATE_KEYS``,
    float64, at ``pixels`` if given."""
    out = {}
    for key, half, field in STATE_FIELDS:
        x = getattr(getattr(state, half), field)
        out[key] = (x if pixels is None else x[pixels]).double()
    return out


def finite(state):
    """A 0-d bool tensor: every number of the state is finite."""
    import torch
    ok = None
    for _key, half, field in STATE_FIELDS:
        f = torch.isfinite(getattr(getattr(state, half), field)).all()
        ok = f if ok is None else ok & f
    return ok
