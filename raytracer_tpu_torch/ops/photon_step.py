"""One step of the regenerating photon pass after the bounce, in one
kernel: Russian roulette, the deposit and its flags, the continuing
photons' next ray and renormalised power, and, inside the spawn window,
each retiring lane's rank among the retiring lanes, the budget test, the
emission of the next photon into the lanes that spawn and the spawn
counter.

The CUDA kernel lives in ``csrc/photon_step.cu``; its plain twin is
``models/wavefront_soa.py::PhotonPass._step_plain``, which the CPU runs.
``PhotonPass.step`` launches the kernel (``photon_step``) on CUDA tensors,
whatever route the bounce took, and nothing falls back: a bad input or a
refused launch raises. The kernel replaces no Pallas kernel: the JAX
package's step is elementwise code that XLA fuses.

The step reads the bounce's outputs (``wavefront_soa.Bounce``), the
step's (4, L) draw ``U`` (row 3: Russian roulette) and, inside the
window, the (7, L) emission draw ``E`` (``EMIT_ROWS``, as
``emit_photons_soa`` draws it); it updates the pass's buffers in place:
the lanes (o, d, w, alive, has_spec, has_diff, depth), slot ``step`` of
the deposits and their flags, the counter, and the pass's scratch words
(two tickets and one look-back word a block of ``BLOCK`` lanes), which
the kernel leaves zero.
"""

from __future__ import annotations

import ctypes

import torch

from raytracer_tpu_torch.kernels import launch
from raytracer_tpu_torch.ops.fused_bounce import _check
from raytracer_tpu_torch.ops.lights import light_cdf
from raytracer_tpu_torch.scene.types import LIGHT_SPHERE, Lights

EMIT_ROWS = 7        # the emission's draw: pick, sphere (2), hemisphere
                     # (2), rect uv (2)
BLOCK = 256          # lanes a block (csrc/photon_step.cu)
LIGHT_W = 12         # a row of ``emission_table``
MAX_LANES = 2 ** 30  # a look-back word's count


def scratch_words(lanes: int) -> int:
    """The kernel's scratch words for ``lanes`` lanes: two tickets and
    one look-back word a block."""
    return 2 + -(-lanes // BLOCK)


def emission_table(lights: Lights) -> torch.Tensor:
    """The lights as the kernel reads them, (n_lights, 12) f32: p0 (3),
    p1 (3), r0, the power ``flux * scale`` (3), 1 for a sphere light, and
    the pick's cumulative probability (``light_cdf``), each computed as
    ``emit_photons_soa`` computes it."""
    f32 = torch.float32
    return torch.cat([
        lights.p0.to(f32), lights.p1.to(f32), lights.r0.to(f32)[:, None],
        (lights.flux * lights.scale[:, None]).to(f32),
        (lights.kind == LIGHT_SPHERE).to(f32)[:, None],
        light_cdf(lights)[:, None]], 1).contiguous()


_P = ctypes.c_void_p
_I = ctypes.c_int
# inter no nd att p nrm U E; o d w alive has_spec has_diff depth dep flags
# counter scratch lights; n_lights L S step max_bounces; B; the stream
ARGTYPES = ([_P] * 8 + [_P] * 12 + [_I] * 5 + [ctypes.c_longlong, _P])
_WRITTEN = ("o", "d", "w", "alive", "has_spec", "has_diff", "depth", "dep",
            "flags", "counter", "scratch")


def step_args(pas, U, b, E, step: int) -> list:
    """The kernel's arguments but the stream (``ARGTYPES``), for step
    ``step`` of the pass ``pas`` (``wavefront_soa.PhotonPass``) after its
    bounce ``b``: every tensor checked for its device, dtype, shape and
    contiguity, and no written buffer sharing memory with another
    operand."""
    dev = pas.o.device
    L, S = pas.L, pas.S
    f32, u8 = torch.float32, torch.bool
    who = "photon step"
    if not 0 <= step < S:
        raise ValueError(f"{who}: step {step} outside [0, {S})")
    if L >= MAX_LANES:
        raise ValueError(f"{who}: {L} lanes, at most {MAX_LANES - 1}")
    n_lights = pas.light_table.shape[0]
    if n_lights == 0:
        raise ValueError(f"{who}: the scene has no light to emit from")
    want = dict(o=(f32, (3, L)), d=(f32, (3, L)), w=(f32, (3, L)),
                alive=(u8, (L,)), has_spec=(u8, (L,)), has_diff=(u8, (L,)),
                depth=(torch.int32, (L,)), dep=(f32, (9, S, L)),
                flags=(u8, (2, S, L)), counter=(torch.int64, ()),
                scratch=(torch.int32, (scratch_words(L),)),
                light_table=(f32, (n_lights, LIGHT_W)))
    for name, (dtype, shape) in want.items():
        _check(name, getattr(pas, name), dev, dtype, shape, who)
    _check("inter", b.inter, dev, torch.int32, (L,), who)
    for name in ("no", "nd", "att", "p", "n"):
        _check(name, getattr(b, name), dev, f32, (3, L), who)
    _check("U", U, dev, f32, (4, L), who)
    if E is not None:
        _check("E", E, dev, f32, (EMIT_ROWS, L), who)
    # each thread reads its own lane before it writes it: safe only while
    # no written buffer shares memory with another operand
    written = [getattr(pas, k).untyped_storage().data_ptr()
               for k in _WRITTEN]
    read = [x.untyped_storage().data_ptr()
            for x in (b.inter, b.no, b.nd, b.att, b.p, b.n, U,
                      pas.light_table) + (() if E is None else (E,))]
    if len(set(written)) < len(written) or set(written) & set(read):
        raise ValueError(f"{who}: the buffers it writes must not share "
                         "memory with each other or with its inputs")
    return [b.inter.data_ptr(), b.no.data_ptr(), b.nd.data_ptr(),
            b.att.data_ptr(), b.p.data_ptr(), b.n.data_ptr(), U.data_ptr(),
            None if E is None else E.data_ptr(),
            *(getattr(pas, k).data_ptr() for k in _WRITTEN),
            pas.light_table.data_ptr(), n_lights, L, S, int(step),
            int(pas.max_bounces), int(pas.B)]


def launch_step(args: list, dev):
    """Launch ``rt_photon_step`` with ``args`` (``step_args``) on the
    current stream of ``dev``."""
    with torch.cuda.device(dev):
        args.append(torch.cuda.current_stream(dev).cuda_stream)
        launch("photon_step", "photon_step", "rt_photon_step", ARGTYPES,
               args, "photon step kernel")


def photon_step(pas, U, b, E, step: int):
    """Step ``step`` of the photon pass ``pas`` after its bounce ``b``,
    in one kernel launch that updates ``pas``'s buffers in place; ``E``:
    the emission's (7, L) draw inside the spawn window, else None. CUDA
    tensors only: there is no fallback."""
    dev = pas.o.device
    if dev.type != "cuda":
        raise ValueError(f"photon step kernel: the pass's buffers are on "
                         f"{dev}, the kernel takes CUDA tensors (the plain "
                         "twin is PhotonPass._step_plain)")
    launch_step(step_args(pas, U, b, E, step), dev)
