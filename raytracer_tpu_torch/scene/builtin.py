"""Built-in scenes.

``cornell_box()`` reproduces the reference's single hard-coded scene
(scene.rs:16-112) exactly: red/blue/white walls, XZ rect light at y=554 with
flux (1,1,1) scale 1e6, glass + mirror spheres, the OBJ cube mesh under a
Transform(scale 50, translate (100,50,100)), and a white box.
"""

from __future__ import annotations

import os

import numpy as np

from raytracer_tpu_torch.scene.builder import SceneBuilder, trs_matrix
from raytracer_tpu_torch.utils.obj import load_obj

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data")


def cornell_box(aspect_ratio: float = 1.0, with_mesh: bool = True,
                data_dir: str = _DATA):
    """The Cornell-box scene, scene.rs:16-112."""
    b = SceneBuilder()
    red = b.lambertian(b.constant_texture((0.75, 0.25, 0.25)))
    white = b.lambertian(b.constant_texture((0.75, 0.75, 0.75)))
    blue = b.lambertian(b.constant_texture((0.25, 0.25, 0.75)))

    # Walls (scene.rs:33-69)
    b.add_yz_rect(0.0, 0.0, 555.0, 555.0, 555.0, red)    # x=555 wall
    b.add_yz_rect(0.0, 0.0, 555.0, 555.0, 0.0, blue)     # x=0 wall
    b.add_xz_rect(0.0, 0.0, 555.0, 555.0, 0.0, white)    # floor
    b.add_xz_rect(0.0, 0.0, 555.0, 555.0, 555.0, white)  # ceiling
    b.add_xy_rect(0.0, 0.0, 555.0, 555.0, 555.0, white)  # back wall

    # Spheres (scene.rs:70-85)
    glass = b.dielectric(1.5, b.constant_texture((0.999, 0.999, 0.999)))
    b.add_sphere((140.0, 100.0, 240.0), 100.0, glass)
    mirror = b.metal(b.constant_texture((0.999, 0.999, 0.999)), 0.0)
    b.add_sphere((400.0, 100.0, 360.0), 100.0, mirror)

    # Area light: (213,227)-(343,332) @ y=554, flux (1,1,1), scale 1e6
    # (scene.rs:26-32); re-added as geometry (scene.rs:86).
    b.add_xzrect_light(213.0, 227.0, 343.0, 332.0, 554.0,
                       (1.0, 1.0, 1.0), 1e6, add_geometry=True)

    if with_mesh:
        # OBJ cube under Transform(rotate 0, scale 50, translate (100,50,100))
        # (scene.rs:87-92)
        mesh = load_obj(os.path.join(data_dir, "mesh", "cube.obj"))
        m = trs_matrix((0.0, 0.0, 0.0), (50.0, 50.0, 50.0), (100.0, 50.0, 100.0))
        b.add_triangles(mesh.positions, mesh.indices, white,
                        normals=mesh.normals, transform=m)

    # White box (scene.rs:93-97)
    b.add_box((300.0, 0.0, 100.0), (380.0, 100.0, 180.0), white)

    # Camera (scene.rs:102-109)
    b.set_camera(look_from=(278.0, 278.0, -800.0), look_at=(278.0, 278.0, 278.0),
                 vup=(0.0, 1.0, 0.0), vfov=50.0, aspect_ratio=aspect_ratio,
                 aperture=0.0, focus_dist=10.0)
    return b.compile()


def cornell_smoke(aspect_ratio: float = 1.0):
    """Cornell walls + light with the two boxes replaced by constant-
    density smoke volumes (book-2 cornell_smoke class; EXTENSION — the
    reference's only hard-coded scene is scene.rs:16-112, but its
    ConstantMedium type, medium.rs:7-61, supports exactly this). Exercises
    ops/media.py at full render scale on the SoA kernel path (round 5:
    apply_media_soa free-flight override per bounce) —
    media_path_bench.py publishes the measured cost vs plain Cornell."""
    b = SceneBuilder()
    red = b.lambertian(b.constant_texture((0.75, 0.25, 0.25)))
    white = b.lambertian(b.constant_texture((0.75, 0.75, 0.75)))
    blue = b.lambertian(b.constant_texture((0.25, 0.25, 0.75)))
    b.add_yz_rect(0.0, 0.0, 555.0, 555.0, 555.0, red)
    b.add_yz_rect(0.0, 0.0, 555.0, 555.0, 0.0, blue)
    b.add_xz_rect(0.0, 0.0, 555.0, 555.0, 0.0, white)
    b.add_xz_rect(0.0, 0.0, 555.0, 555.0, 555.0, white)
    b.add_xy_rect(0.0, 0.0, 555.0, 555.0, 555.0, white)
    b.add_xzrect_light(213.0, 227.0, 343.0, 332.0, 554.0,
                       (1.0, 1.0, 1.0), 1e6, add_geometry=True)
    # dark and light smoke boxes (book-2 final-scene densities)
    b.add_constant_medium_box((265.0, 0.0, 295.0), (430.0, 330.0, 460.0),
                              0.01, b.constant_texture((0.0, 0.0, 0.0)))
    b.add_constant_medium_box((130.0, 0.0, 65.0), (295.0, 165.0, 230.0),
                              0.01, b.constant_texture((1.0, 1.0, 1.0)))
    b.set_camera(look_from=(278.0, 278.0, -800.0),
                 look_at=(278.0, 278.0, 278.0), vup=(0.0, 1.0, 0.0),
                 vfov=50.0, aspect_ratio=aspect_ratio, aperture=0.0,
                 focus_dist=10.0)
    return b.compile()


def sphere_field(n: int = 65536, aspect_ratio: float = 4.0 / 3.0,
                 seed: int = 0):
    """Large-scene stress bench: an n-sphere jittered grid field over a
    ground sphere, mixed lambertian/metal/glass, plus a sky light — the
    scene class the reference's O(log N) BVH (bvh.rs:60-101) handles
    trivially and a dense O(N) scan does not. Used by bench.py to publish
    the >16k-primitive throughput story."""
    import numpy as np
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    ground = b.lambertian(b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.add_sphere((0.0, -10000.0, 0.0), 10000.0, ground)
    side = int(np.ceil(np.sqrt(n)))
    xs, zs = np.meshgrid(np.arange(side), np.arange(side))
    xs = (xs.reshape(-1)[:n] - side / 2) * 1.0
    zs = (zs.reshape(-1)[:n] - side / 2) * 1.0
    jit = rng.uniform(-0.35, 0.35, (2, n))
    r = rng.uniform(0.12, 0.32, n)
    kind = rng.uniform(0.0, 1.0, n)
    albedo = rng.uniform(0.2, 0.95, (n, 3))
    # a few deduped materials (the kernel denormalizes per primitive; 64
    # distinct records keep the build fast while exercising the table path)
    mats = []
    for i in range(64):
        a = tuple(albedo[i * (n // 64) % n])
        if i % 4 == 3:
            mats.append(b.metal(b.constant_texture(a), float(r[i]) % 0.3))
        elif i % 16 == 5:
            mats.append(b.dielectric(1.5))
        else:
            mats.append(b.lambertian(b.constant_texture(a)))
    for i in range(n):
        b.add_sphere((float(xs[i] + jit[0, i]), float(r[i]),
                      float(zs[i] + jit[1, i])), float(r[i]),
                     mats[int(kind[i] * 64) % 64])
    b.add_sphere_light((0.0, 60.0, 0.0), 20.0, (4.0, 4.0, 4.0), 100.0)
    b.set_camera(look_from=(0.0, 6.0, float(side) * 0.55),
                 look_at=(0.0, 0.5, 0.0), vfov=55.0,
                 aspect_ratio=aspect_ratio, aperture=0.0, focus_dist=20.0)
    return b.compile()


def three_spheres(aspect_ratio: float = 16.0 / 9.0):
    """Small book-1-style test scene: ground + lambertian/metal/glass,
    with a sphere light for PT testability (no reference analog; used by
    unit tests and quick benchmarks)."""
    b = SceneBuilder()
    ground = b.lambertian(b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    center = b.lambertian(b.constant_texture((0.7, 0.3, 0.3)))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, center)
    left = b.dielectric(1.5)
    b.add_sphere((-1.0, 0.0, -1.0), 0.5, left)
    right = b.metal(b.constant_texture((0.8, 0.6, 0.2)), 0.1)
    b.add_sphere((1.0, 0.0, -1.0), 0.5, right)
    b.add_sphere_light((0.0, 3.0, -1.0), 1.0, (4.0, 4.0, 4.0), 10.0)
    b.set_camera(look_from=(0.0, 0.5, 1.5), look_at=(0.0, 0.0, -1.0),
                 vfov=60.0, aspect_ratio=aspect_ratio, aperture=0.0,
                 focus_dist=2.5)
    return b.compile()


def bunny_field(n_bunnies: int = 25, aspect_ratio: float = 4.0 / 3.0,
                data_dir: str = _DATA):
    """Large-MESH stress bench: an n x n grid of Stanford bunnies
    (bun315.obj, 4,968 tris each — 25 bunnies = 124,200 triangles) over a
    ground sphere with a sky light. Exercises the triangle-slab chain
    (pallas_intersect.TRI_SLAB) the way sphere_field exercises the sphere
    slabs — the "100k-tri mesh" scene class the reference's O(log N) BVH
    (bvh.rs:60-101) handles and one VMEM-resident kernel cannot."""
    mesh = load_obj(os.path.join(data_dir, "mesh", "bun315.obj"))
    b = SceneBuilder()
    ground = b.lambertian(b.checker_texture((0.2, 0.3, 0.1),
                                            (0.9, 0.9, 0.9)))
    b.add_sphere((0.0, -10000.0, 0.0), 10000.0, ground)
    side = int(np.ceil(np.sqrt(n_bunnies)))
    rng = np.random.default_rng(0)
    mats = [b.lambertian(b.constant_texture(tuple(c)))
            for c in rng.uniform(0.3, 0.9, (8, 3))]
    mats += [b.metal(b.constant_texture((0.8, 0.8, 0.85)), 0.05),
             b.dielectric(1.5)]
    for i in range(n_bunnies):
        gx = (i % side) - (side - 1) / 2.0
        gz = (i // side) - (side - 1) / 2.0
        # bun315 spans y in [0.033, 0.187]; scale 8 makes each bunny ~1.2
        # units tall on a 2-unit grid pitch, feet on the ground.
        # trs_matrix signature is (rotate_deg, scale, translate).
        m = trs_matrix((0.0, float(rng.uniform(0.0, 360.0)), 0.0),
                       (8.0, 8.0, 8.0), (2.0 * gx, -0.26, 2.0 * gz))
        b.add_triangles(mesh.positions, mesh.indices, mats[i % len(mats)],
                        normals=mesh.normals, transform=m)
    b.add_sphere_light((0.0, 30.0, 0.0), 10.0, (4.0, 4.0, 4.0), 60.0)
    b.set_camera(look_from=(0.0, 3.5, float(side) * 1.6),
                 look_at=(0.0, 0.3, 0.0), vfov=50.0,
                 aspect_ratio=aspect_ratio, aperture=0.0, focus_dist=10.0)
    return b.compile()


def motion_field(n: int = 1000, aspect_ratio: float = 4.0 / 3.0,
                 seed: int = 0):
    """Motion-blur stress/bench scene (extension — the reference Ray is
    timeless, ray.rs:3-6): n moving spheres with random velocities over a
    checker ground, lit by a sphere light, camera shutter [0, 1].
    Exercises the kernel's velocity rows + shutter-dilated culls
    (ops/pallas_intersect.SPH_VEL_ROW) and the regen wavefront's
    per-sample time state."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    ground = b.lambertian(b.checker_texture((0.2, 0.3, 0.1),
                                            (0.9, 0.9, 0.9)))
    b.add_sphere((0.0, -10000.0, 0.0), 10000.0, ground)
    side = int(np.ceil(np.sqrt(n)))
    r = rng.uniform(0.12, 0.32, n)
    jit = rng.uniform(-0.35, 0.35, (2, n))
    vel = rng.uniform(-0.6, 0.6, (n, 3))
    vel[:, 1] = np.abs(vel[:, 1]) * 0.5          # hop upward, book-2 style
    albedo = rng.uniform(0.2, 0.95, (n, 3))
    mats = [b.lambertian(b.constant_texture(tuple(albedo[i])))
            for i in range(0, n, max(1, n // 48))]
    for i in range(n):
        x = (i % side) - side / 2 + jit[0, i]
        z = (i // side) - side / 2 + jit[1, i]
        c0 = (float(x), float(r[i]), float(z))
        c1 = tuple(float(a + v) for a, v in zip(c0, vel[i]))
        b.add_moving_sphere(c0, c1, float(r[i]), mats[i % len(mats)])
    b.add_sphere_light((0.0, 60.0, 0.0), 20.0, (4.0, 4.0, 4.0), 100.0)
    b.set_camera(look_from=(0.0, 6.0, float(side) * 0.55),
                 look_at=(0.0, 0.5, 0.0), vfov=55.0,
                 aspect_ratio=aspect_ratio, aperture=0.0, focus_dist=20.0,
                 time0=0.0, time1=1.0)
    return b.compile()
