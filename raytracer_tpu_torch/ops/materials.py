"""Texture evaluation and material scatter on (N, 3) tensors: the
counterpart of ``raytracer_tpu/ops/materials.py`` for the brute-force
route (``models/path_tracer.py``), and the image and noise texels that the
wavefront's unfused stage (``wavefront_soa.eval_texture_soa``) shares.

Every material model is evaluated for every lane and the result picked by
the material kind (material.rs):
- Lambertian: n + a unit-sphere point (near-zero guard), attenuation the
  albedo, Diffuse (:92-113);
- Metal: reflect(unit d) + fuzz x the same unit-sphere point, absorbed
  below the surface (:115-139);
- Dielectric: Schlick, total internal reflection and a drawn
  reflect-or-refract choice (:141-188);
- DiffuseLight: emits its texture and scatters diffusely with bsdf 1/pi
  (:191-212);
- Isotropic (media): the unit-sphere point itself, Diffuse (:213-231).

Textures (material.rs:48-84): constant; the world-space checker (colour 0
where sin(10x) sin(10y) sin(10z) < 0); an image at its nearest texel, u
and v clamped to [0, 1] and v flipped, each image read within its own
width and height in the padded atlas; and the marble noise of
``ops/noise.py``, whose scale is the texture's colour0[0].

The uniforms are rows (``scatter``'s ``uni``: the unit-sphere pair and
the dielectric's choice; ``scatter_photon``'s fourth row, the photon's
Russian roulette), drawn by the caller. SPPM's (N, 3) loops
(``models/sppm.py``) take ``scatter_photon`` and, for the measurement
point's colour, ``bsdf_from``; ``nee.sample_li`` takes ``bsdf``.
``emitted`` and ``eval_texture`` are the JAX module's API for Le by
material id (``scatter`` returns Le itself); only the tests call them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.ops import noise, vec
from raytracer_tpu_torch.ops.intersect import HitAttrs
from raytracer_tpu_torch.ops.sampling import uniform_sphere_from
from raytracer_tpu_torch.scene.types import (
    INTER_ABSORB, INTER_DIFFUSE, INTER_REFLECT, INTER_REFRACT,
    INTER_SPECULAR, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC,
    MAT_LAMBERTIAN, MAT_METAL, TEX_CHECKER, TEX_IMAGE, TEX_NOISE, Scene,
)

FRAC_1_PI = 0.3183098861837907


class Scatter(NamedTuple):
    interaction: torch.Tensor  # (N,) int32 INTER_*
    direction: torch.Tensor    # (N, 3) next direction (not unit length)
    attenuation: torch.Tensor  # (N, 3)
    emitted: torch.Tensor      # (N, 3) Le at the hit


class MatFeatures(NamedTuple):
    """Per-lane material and texture record."""
    kind: torch.Tensor       # (N,) int32
    fuzz: torch.Tensor       # (N,)
    ir: torch.Tensor         # (N,)
    tex_kind: torch.Tensor   # (N,) int32
    color0: torch.Tensor     # (N, 3)
    color1: torch.Tensor     # (N, 3)
    image_id: torch.Tensor   # (N,) int32
    tex_id: torch.Tensor     # (N,) int32


def fetch_mat_features(scene: Scene, mat_id) -> MatFeatures:
    """The material and texture record of each lane's ``mat_id``."""
    m, t = scene.materials, scene.textures
    mid = mat_id.long()
    tex = m.tex_id[mid].long()
    return MatFeatures(m.kind[mid], m.fuzz[mid], m.ir[mid], t.kind[tex],
                       t.color0[tex], t.color1[tex], t.image_id[tex],
                       tex.to(torch.int32))


def image_texel(scene: Scene, image_id, u, v):
    """The nearest texel (N, 3) of image ``image_id`` (N,) at (u, v) (N,):
    u, v clamped to [0, 1], v flipped, within the image's own size."""
    img = torch.clamp(image_id, min=0).long()
    wh = scene.image_wh[img].long()
    w = wh[:, 0].to(u.dtype)
    h = wh[:, 1].to(u.dtype)
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    x = torch.minimum(torch.clamp(torch.floor(w * uu).long(), min=0),
                      wh[:, 0] - 1)
    y = torch.minimum(torch.clamp(torch.floor(h * vv).long(), min=0),
                      wh[:, 1] - 1)
    return scene.images[img, y, x]


def _texture(scene: Scene, kind, c0, c1, image_id, p, uv):
    """Albedo (N, 3) of texture records (kind, colours, image) at points
    ``p`` (N, 3) and ``uv`` (N, 2)."""
    sines = (torch.sin(10.0 * p[:, 0]) * torch.sin(10.0 * p[:, 1])
             * torch.sin(10.0 * p[:, 2]))
    checker = torch.where((sines < 0.0)[:, None], c0, c1)
    out = torch.where((kind == TEX_CHECKER)[:, None], checker, c0)
    if scene.images.shape[0]:
        out = torch.where((kind == TEX_IMAGE)[:, None],
                          image_texel(scene, image_id, uv[:, 0], uv[:, 1]),
                          out)
    if scene.textures.noise_marker.shape[0]:
        out = torch.where((kind == TEX_NOISE)[:, None],
                          noise.marble(p, c0[:, 0])[:, None], out)
    return out


def eval_texture_from(scene: Scene, f: MatFeatures, p, uv):
    """Texture fetch from fetched features (material.rs:48-84)."""
    return _texture(scene, f.tex_kind, f.color0, f.color1, f.image_id, p, uv)


def eval_texture(scene: Scene, tex_id, p, uv):
    """Texture fetch by texture id (material.rs:48-84)."""
    t = scene.textures
    i = tex_id.long()
    return _texture(scene, t.kind[i], t.color0[i], t.color1[i],
                    t.image_id[i], p, uv)


def bsdf_from(scene: Scene, f: MatFeatures, p, uv):
    """Material::bsdf from fetched features: the albedo texture, 1/pi for
    diffuse lights."""
    albedo = eval_texture_from(scene, f, p, uv)
    return torch.where((f.kind == MAT_DIFFUSE_LIGHT)[:, None], FRAC_1_PI,
                       albedo)


def bsdf(scene: Scene, mat_id, p, uv):
    """Material::bsdf by material id (material.rs:106, 127, 158, 202)."""
    if scene.materials.kind.shape[0] == 0:
        return torch.zeros_like(p)
    return bsdf_from(scene, fetch_mat_features(scene, mat_id), p, uv)


def emitted(scene: Scene, attrs: HitAttrs):
    """Le: a diffuse light's emit texture on valid hits, else 0
    (material.rs:24-26, 209-211)."""
    m = scene.materials
    if m.kind.shape[0] == 0:
        return torch.zeros_like(attrs.p)
    mid = attrs.mat_id.long()
    e = eval_texture(scene, m.tex_id[mid], attrs.p, attrs.uv)
    lit = (m.kind[mid] == MAT_DIFFUSE_LIGHT) & attrs.valid
    return torch.where(lit[:, None], e, 0.0)


def scatter(scene: Scene, uni, d_in, attrs: HitAttrs,
            feats: MatFeatures = None) -> Scatter:
    """Material::scatter for every lane (material.rs:92-231). ``uni``
    (>= 3, N) uniform rows: 0-1 the unit-sphere pair (the diffuse bounce,
    the metal fuzz and the isotropic phase: kinds are exclusive per lane),
    2 the dielectric's reflect choice. ``feats``: fetched features, else
    fetched from ``attrs.mat_id``."""
    n = d_in.shape[0]
    if scene.materials.kind.shape[0] == 0:      # empty scene: all absorb
        z = torch.zeros((n, 3), device=d_in.device)
        return Scatter(torch.full((n,), INTER_ABSORB, dtype=torch.int32,
                                  device=d_in.device), d_in, z, z)
    f = feats if feats is not None else fetch_mat_features(scene,
                                                           attrs.mat_id)
    normal = attrs.normal
    sph = uniform_sphere_from(uni[0], uni[1]).T
    albedo = eval_texture_from(scene, f, attrs.p, attrs.uv)

    diff_dir = normal + sph
    diff_dir = torch.where(vec.near_zero(diff_dir)[:, None], normal,
                           diff_dir)
    unit_d = vec.unit(d_in)
    refl = vec.reflect(unit_d, normal)
    metal_dir = refl + f.fuzz[:, None] * sph
    metal_ok = vec.dot(metal_dir, normal) > 0.0
    ir = torch.clamp(f.ir, min=1e-6)
    ratio = torch.where(attrs.front_face, 1.0 / ir, ir)
    cos_theta = torch.clamp(vec.dot(-unit_d, normal), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta,
                                       min=0.0))
    cannot = ratio * sin_theta > 1.0
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    do_reflect = cannot | (reflectance > uni[2])
    diel_dir = torch.where(do_reflect[:, None], refl,
                           vec.refract(unit_d, normal, ratio))

    kind = f.kind
    is_metal = kind == MAT_METAL
    is_diel = kind == MAT_DIELECTRIC
    is_light = kind == MAT_DIFFUSE_LIGHT
    diffish = (kind == MAT_LAMBERTIAN) | is_light
    direction = torch.where(diffish[:, None], diff_dir, torch.where(
        is_metal[:, None], metal_dir,
        torch.where(is_diel[:, None], diel_dir, sph)))
    attenuation = torch.where(is_light[:, None], FRAC_1_PI, albedo)
    inter = torch.where(
        diffish | (kind == MAT_ISOTROPIC), INTER_DIFFUSE,
        torch.where(is_metal,
                    torch.where(metal_ok, INTER_SPECULAR, INTER_ABSORB),
                    torch.where(do_reflect, INTER_REFLECT, INTER_REFRACT)))
    inter = torch.where(attrs.valid, inter, INTER_ABSORB).to(torch.int32)
    le = torch.where((is_light & attrs.valid)[:, None], albedo, 0.0)
    return Scatter(inter, direction, attenuation, le)


def scatter_photon(scene: Scene, uni, d_in, attrs: HitAttrs, power,
                   feats: MatFeatures = None):
    """Photon bounce with Russian roulette (material.rs:27-45): the
    photon survives with probability h = max(attenuation) and then
    carries power * attenuation / h. ``uni`` (>= 4, N) uniform rows: 0-2
    as for ``scatter``, 3 the roulette. Returns (``Scatter`` whose
    interaction is Absorb where the roulette kills, the new power (N, 3);
    a killed photon keeps its power)."""
    s = scatter(scene, uni[:3], d_in, attrs, feats)
    h = s.attenuation.amax(-1)
    survive = uni[3] <= h
    inter = torch.where(survive, s.interaction, INTER_ABSORB).to(torch.int32)
    new_power = power * s.attenuation / torch.clamp(h, min=1e-12)[:, None]
    new_power = torch.where(survive[:, None], new_power, power)
    return Scatter(inter, s.direction, s.attenuation, s.emitted), new_power
