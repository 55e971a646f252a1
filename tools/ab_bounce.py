"""Hold every kernel that includes ``csrc/sweep.cuh`` in this checkout
against the same kernel of another checkout, in one process: the outputs
bit for bit, the times in turns, and both builds' registers, spills and
resident blocks. The check that a change to the sweep or the walk left
every lane's result as it was, and what it did to the time. Two more
modes measure what limits those kernels and what each design element buys.

    python3 tools/ab_bounce.py OTHER_CHECKOUT [--kernels bounce,...]
                               [--reps 10] [--burst 5]
    python3 tools/ab_bounce.py --limits [OTHER_CHECKOUT]
    python3 tools/ab_bounce.py --variants
    python3 tools/ab_bounce.py --renders OTHER_CHECKOUT [--repeats 3]

A/B (the default). ``OTHER_CHECKOUT`` is a directory with another tree
of the repository (for example ``git archive`` of the parent commit,
unpacked). Its ``raytracer_tpu_torch`` package is imported beside this one
(each package calls its own kernels through its own wrappers, so their C
interfaces may differ) and builds its ``csrc`` into its own ``_build``.
Inputs, made once by this checkout's code (``chip_smoke.py``'s helpers)
and given to both:
- scene_500: the 800x600 image rays (480,000 lanes) and a second bounce
  (``bounce``, ``closest``), the shadow rays of a NEE step (``closest``),
  and the leaf tables (``leaf``);
- field64k (sphere_field(65536)): camera rays and a second bounce through
  the walk (``bounce_ordered``, ``closest_ordered``) and the flat kernels,
  and a NEE step's shadow rays (``closest_ordered``);
- bunny_field(25): camera rays and a second bounce (the triangle walk);
- motion_field(1000) and (65536): camera rays with per-lane shutter times
  and a second bounce (the motion forms, flat and walked);
- the regen step captured from a render of scene_500, field64k,
  bunny_field, motion_field(1000) and motion_field(65536) (``regen``,
  ``regen_ordered`` and their motion forms), each launch on a fresh copy
  of the lanes.
Every (input, kernel) is timed in turns, other, this, this, other, each
turn the median of ``--reps`` (10) CUDA-event timings, each timing a
burst of ``--burst`` (5) launches back to back (divided by the burst), so
that the
host's work for one launch overlaps the kernel before it and the time is
the card's; the spread is the larger gap between one version's two turns.
``--kernels`` keeps only the named kernels (all by default). ``stats`` is
not compared (its shape follows the design). Where outputs differ, the
first lanes are printed with both winners, the flat tables' winner and
each winner's float64 t. Exits 1 if any output differs.

``--limits``: for this checkout's kernels (and first for those of
``OTHER_CHECKOUT``, given):
- each kernel's ptxas registers, shared memory and spills, and the blocks
  of 128 threads an SM holds at those numbers (65,536 registers allocated
  per warp in units of 256, 228 KB of shared memory with 1 KB reserved per
  block, 16 blocks of 128 threads);
- the loops of each kernel's SASS (``cuobjdump -sass``, written to
  ``OUT/sass/this`` and ``OUT/sass/other``): every
  backward branch whose body reads shared memory, with its length and its
  instructions by opcode;
- the SM clock and power while the flat bounce runs on 480,000 scene_500
  camera rays for a few seconds (``nvidia-smi`` every 0.1 s);
- the root-path share of that sweep: of the (warp, sphere) pairs, the share
  in which some alive lane has disc >= 0 (the warp then runs the square
  root and the root checks), beside the share of (lane, sphere) pairs;
- the ordered walk's chunk bodies on the step of a field64k render that
  ``chip_smoke.py`` captures (``regen_capture``), from ``walk_plain`` per
  warp of 32 and per block of 128 lanes, with the dead lanes in live
  groups.

``--renders``: the scene_500 renders whose time the host holds most (800x600,
32 spp, RR off, with NEE and through ``--intersector leaf``), each
checkout's ``chip_smoke.timed_render`` in a process of its own, in turns
(other, this, this, other), ``--repeats`` renders of each per turn after a
1-spp warm-up; the medians per version and the spread of the turns.

``--variants``: for each design element, a copy of this checkout's
package with that element taken out (one substitution in its CUDA
sources, ``VARIANTS``), in ``output/variants/<name>/`` (``output/`` is not
committed), held against this checkout by the A/B on the kernels the
element touches. The outputs must stay bit-identical; the speed-up of
"this" over the copy is what the element buys.

Every mode needs a CUDA device. Files go to ``--out`` (OUT, by default
``output/ab_bounce``): the A/B's rows as JSON, the SASS dumps.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (it imports the package lazily)

PKG = "raytracer_tpu_torch"
NAMES = ("bounce", "closest", "regen", "bounce_ordered", "closest_ordered",
         "regen_ordered", "leaf")
MODULES = ("kernels.build", "ops.fused_bounce", "ops.closest_hit",
           "ops.regen", "ops.leaf")


def log(msg):
    print(msg, flush=True)


def _purge():
    for k in [k for k in sys.modules if k == PKG or k.startswith(PKG + ".")]:
        del sys.modules[k]


def import_tree(root: Path) -> SimpleNamespace:
    """The kernel modules of ``root``'s package, imported apart from this
    checkout's (their module objects keep their own imports)."""
    _purge()
    sys.path.insert(0, str(root))
    try:
        mods = {m.split(".")[-1]: importlib.import_module(f"{PKG}.{m}")
                for m in MODULES}
    finally:
        sys.path.remove(str(root))
        _purge()
    if Path(mods["build"].__file__).resolve().parents[2] != root.resolve():
        raise RuntimeError(f"imported {mods['build'].__file__}, not {root}")
    return SimpleNamespace(**mods)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def differ(a, b) -> list:
    return [k for k, (x, y) in enumerate(zip(a, b))
            if not torch.equal(bits(x), bits(y))]


REPS, BURST = 10, 5      # timings per turn, launches per timing
OUT = ROOT / "output" / "ab_bounce"   # --out: where files are written
KERNELS = None          # --kernels: the kernel names to run, None for all


def turn(fn, prep) -> float:
    """Median of REPS CUDA-event timings of BURST calls ``fn(prep())``
    back to back, per call, after one warm call; ``prep`` is not timed."""
    fn(prep())
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        args = [prep() for _ in range(BURST)]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for arg in args:
            fn(arg)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / BURST)
    return float(np.median(times))


def lane_rows(outs, lane) -> list:
    """Each output's value(s) at ``lane`` (the last axis)."""
    return [x[..., lane].tolist() for x in outs]


def agree(out, ref) -> torch.Tensor:
    """Per lane (the last axis): does every row of ``out`` agree with
    ``ref`` (integer and bool rows equal, float rows within
    ``chip_smoke``'s ATOL + RTOL |ref|)?"""
    n = out[0].shape[-1]
    ok = torch.ones(n, dtype=torch.bool, device=out[0].device)
    for x, y in zip(out, ref):
        y = y.to(x.dtype)
        if x.dtype.is_floating_point:
            bad = (x - y).abs() > chip_smoke.ATOL + chip_smoke.RTOL * y.abs()
        else:
            bad = x != y
        ok &= ~bad.reshape(-1, n).any(0)
    return ok


def ab_case(label, kernel, run_this, run_other, prep=lambda: None,
            rows=None, explain=None):
    """Compare and time one input on one kernel; ``run_*(arg)`` launch it
    and return its outputs. ``explain(lanes, out_this)``, for the walk's
    kernels, prints the lanes that differ and returns which of them are
    explained by a float32 false hit of the other version
    (``explainer``)."""
    if KERNELS is not None and kernel not in KERNELS:
        return True
    out_this = [x.clone() for x in run_this(prep())]
    out_other = [x.clone() for x in run_other(prep())]
    torch.cuda.synchronize()
    bad = differ(out_this, out_other)
    where = torch.zeros(out_this[0].shape[-1], dtype=torch.bool,
                        device=out_this[0].device)
    for k in bad:
        ne = bits(out_this[k]) != bits(out_other[k])
        where |= ne.reshape(-1, ne.shape[-1]).any(0)
    lanes = int(where.sum())
    for lane in torch.nonzero(where)[:4, 0].tolist():
        log(f"  lane {lane}: this {lane_rows(out_this, lane)}, other "
            f"{lane_rows(out_other, lane)}")
    false = 0
    if lanes and explain is not None:
        expl = explain(torch.nonzero(where)[:, 0], out_this)
        if bool(expl.all()):
            false, bad = lanes, []
    t = [turn(run_other, prep), turn(run_this, prep), turn(run_this, prep),
         turn(run_other, prep)]
    other, this = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    spread = max(abs(t[0] - t[3]), abs(t[1] - t[2]))
    log(f"{label}: {kernel}: "
        + ("bit-identical" if not bad
           else f"outputs {bad} DIFFER on {lanes} lanes")
        + (f" but for {false} lane(s) where the other's winner is a "
           "float32 false hit outside its chunk's box" if false else "")
        + f"; other {t[0]:.4f}, {t[3]:.4f} ms, this {t[1]:.4f}, "
        f"{t[2]:.4f} ms; x{other / this:.3f} (spread {spread:.4f} ms)")
    if rows is not None:
        rows.append({"input": label, "kernel": kernel, "same": not bad,
                     "lanes_differing": lanes, "false_hit_lanes": false,
                     "other_ms": [t[0], t[3]],
                     "this_ms": [t[1], t[2]], "speedup": other / this,
                     "spread_ms": spread})
    return not bad


def false_hits(tab, flat, o, d, win, lanes, tm=None) -> torch.Tensor:
    """Per lane of ``lanes``: is the winner ``win`` (a closest-hit result)
    a sphere that the float32 test hits but float64 misses (disc < 0:
    cancellation in |o - c|^2 - r^2 far from the sphere), at a float32 t
    whose point lies outside the sphere's chunk box? The walk culls such a
    chunk for the lane, so the lane keeps it only if another lane of its
    group ran the chunk: its winner depends on the grouping, and no cull
    is conservative for it."""
    t, ty, ix = (x[lanes] for x in win[:3])
    k = ix.clamp(min=0).long()
    c = flat.sph[k, :3]
    if tm is not None and flat.sph_vel is not None:
        c = c + flat.sph_vel[k, :3] * tm[lanes][:, None]
    c, r2 = c.double(), flat.sph[k, 3].double()
    ol, dl = o[:, lanes].T.double(), d[:, lanes].T.double()
    oc = ol - c
    a, hb = (dl * dl).sum(1), (oc * dl).sum(1)
    disc = hb * hb - a * ((oc * oc).sum(1) - r2)
    st = tab.osph
    real = st.orig >= 0
    slot = torch.empty(flat.sph.shape[0], dtype=torch.long, device=o.device)
    slot[st.orig[real].long()] = torch.nonzero(real)[:, 0]
    box = st.cull[slot[k] // st.chunk].double()
    p = ol + t.double()[:, None] * dl
    inside = ((p >= box[:, :3]) & (p <= box[:, 3:])).all(1)
    return (ty == 0) & (disc < 0) & ~inside


def explainer(this, other, tab, flat, o, d, t_min, alive, tm, outputs_ok):
    """``explain`` for a walk's outputs on these rays: both versions'
    closest hits (the same launch as the A/B's), the flat tables'
    winner and each winner's float64 t, printed for the first lanes. A
    lane is explained where the other version's winner is one of
    ``false_hits``, this version's is another and is the plain walk's
    (``closest_ordered_plain``, groups of 32: type and index), and
    ``outputs_ok(lanes, out_this, win_this, win_plain)`` (per lane) holds:
    this version's outputs are the plain version's for that winner."""
    def explain(lanes, out_this):
        w = {tag: m.closest_hit.closest_tables(
            tab, o, d, t_min, float("inf"), alive, time=tm)
             for tag, m in (("this", this), ("other", other))}
        from raytracer_tpu_torch.ops import fused_bounce as fb
        ref = fb._closest_plain(flat, o[:, lanes], d[:, lanes], t_min,
                                alive[lanes], time=None if tm is None
                                else tm[lanes])
        ref = [torch.where(ref[1] >= 0, ref[0], float("inf")), ref[1],
               torch.where(ref[1] >= 0, ref[2], -1)]
        fh = {tag: false_hits(tab, flat, o, d, x, lanes, tm)
              for tag, x in w.items()}
        show = lanes[:4]
        on, dn = o[:, show].cpu().numpy(), d[:, show].cpu().numpy()
        for tag, win in (("this", [x[show] for x in w["this"][:3]]),
                         ("other", [x[show] for x in w["other"][:3]]),
                         ("plain flat", [x[:4] for x in ref])):
            t, ty, ix = (x.cpu().numpy() for x in win)
            t64 = chip_smoke.hit_t64(
                flat, on, dn, ty, ix.astype(np.int64),
                np.nan_to_num(t, posinf=0.0),
                None if tm is None else tm[show].cpu().numpy())
            extra = (f", float32 false hit outside its box "
                     f"{fh[tag][:4].tolist()}" if tag in fh else "")
            log(f"  {tag}: t {t.tolist()}, ty {ty.tolist()}, ix "
                f"{ix.tolist()}, float64 t {t64.tolist()}{extra}")
        pw = this.closest_hit.closest_ordered_plain(
            tab, o, d, t_min, float("inf"), alive, time=tm)
        walked = ((w["this"].ty[lanes] == pw.ty[lanes])
                  & (w["this"].ix[lanes] == pw.ix[lanes]))
        rows_ok = outputs_ok(lanes, out_this, w["this"], pw)
        log(f"  {int(walked.sum())} of {len(lanes)} lane(s) with the plain "
            f"walk's winner, {int(rows_ok.sum())} with the plain outputs "
            "for this version's winner")
        return (fh["other"] & (w["this"].ix[lanes] != w["other"].ix[lanes])
                & walked & rows_ok)
    return explain


# ---- --limits: what bounds the kernels

SM_REGS, SM_SMEM, SMEM_RESERVED, MAX_BLOCKS = 65536, 233472, 1024, 16


def blocks_per_sm(regs: int, smem: int, threads: int = 128) -> int:
    """Resident blocks of ``threads`` threads at ``regs`` registers per
    thread and ``smem`` bytes of shared memory per block."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = SM_REGS // (per_warp * warps)
    by_smem = SM_SMEM // (smem + SMEM_RESERVED)
    return min(by_regs, by_smem, MAX_BLOCKS)


def ptxas_table(name: str, build_mod) -> list:
    """(entry, registers, smem bytes, spill stores) per kernel of ``name``
    (built by ``build_mod``, a checkout's ``kernels.build``)."""
    rows, entry, spill = [], None, 0
    for ln in build_mod.build_log(name).splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif "Used" in ln and "registers" in ln and entry:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            rows.append((entry, regs, int(m.group(1)) if m else 0, spill))
            entry = None
    return rows


def form(entry: str) -> str:
    return ("motion" if "ILb1E" in entry else
            "static" if "ILb0E" in entry else "")


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                       r"([^;]*);")


def sass_loops(text: str) -> list:
    """(function, start, end, opcodes) of each backward branch whose body
    reads shared memory."""
    out, fn, ins = [], None, []
    for ln in text.splitlines() + ["Function : <end>"]:
        if "Function :" in ln:
            if fn is not None:
                addr = {a: k for k, (a, _, _) in enumerate(ins)}
                for k, (a, op, rest) in enumerate(ins):
                    m = re.search(r"0x([0-9a-f]+)", rest)
                    if op.startswith("BRA") and m and int(m.group(1), 16) < a:
                        j = addr.get(int(m.group(1), 16))
                        if j is None:
                            continue
                        body = [o for _, o, _ in ins[j:k + 1]]
                        if any(o.startswith("LDS") for o in body):
                            out.append((fn, ins[j][0], a, body))
            fn, ins = ln.split("Function :")[1].strip(), []
            continue
        m = SASS_LINE.search(ln)
        if m:
            ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def report_build(build_mod, tag: str, sass_dir: Path):
    """Build a checkout's kernels; their ptxas numbers and SASS loops."""
    with ThreadPoolExecutor(len(NAMES)) as pool:
        list(pool.map(build_mod.build, NAMES))
    sass_dir.mkdir(parents=True, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(build_mod.find_nvcc()),
                             "cuobjdump")
    for name in NAMES:
        for entry, regs, smem, spill in ptxas_table(name, build_mod):
            log(f"{tag}: {name} [{form(entry)}]: {regs} registers, {smem} B "
                f"static smem, {spill} B spill stores; "
                f"{blocks_per_sm(regs, smem)} blocks of 128 per SM at that "
                "smem")
        text = subprocess.run([cuobjdump, "-sass",
                               str(build_mod.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        (sass_dir / f"{name}.sass").write_text(text)
        for fn, a, b, body in sass_loops(text):
            hist = Counter(o.split(".")[0] for o in body)
            log(f"  {tag}: {name} {form(fn) or fn[:40]} loop {a:#x}-{b:#x}: "
                f"{len(body)} instructions; "
                + ", ".join(f"{k} {v}" for k, v in hist.most_common()))


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout


def report_clock(fb, tag, tab, o, d, alive, uni):
    """The SM clock while ``fb.bounce_tables`` (a checkout's) runs."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(smi().strip())
            time.sleep(0.1)

    fb.bounce_tables(tab, o, d, chip_smoke.T_MIN, alive, uni)
    torch.cuda.synchronize()
    th = threading.Thread(target=sample)
    th.start()
    t0, launches = time.perf_counter(), 0
    while time.perf_counter() - t0 < 3.0:
        for _ in range(200):
            fb.bounce_tables(tab, o, d, chip_smoke.T_MIN, alive, uni)
        torch.cuda.synchronize()
        launches += 200
    dt = time.perf_counter() - t0
    stop.set()
    th.join()
    clocks = [float(s.split(",")[0].split()[0]) for s in samples if s]
    log(f"clock, {tag}: {launches} bounce launches in {dt:.3f} s "
        f"({dt / launches * 1e3:.4f} ms each, host clock); SM clock MHz "
        f"min {min(clocks):.0f} median {np.median(clocks):.0f} max "
        f"{max(clocks):.0f} over {len(clocks)} samples; last: {samples[-1]}")


def report_root_share(tab, o, d, alive):
    """(warp, sphere) and (lane, sphere) shares with disc >= 0."""
    sph = tab.sph
    n = o.shape[1]
    a = (d * d).sum(0)
    warp_any = lane_any = warps = 0
    step = 32 * 1024
    for i0 in range(0, n, step):
        oc = o[:, i0:i0 + step, None] - sph[None, :, :3].permute(2, 0, 1)
        half_b = (d[:, i0:i0 + step, None] * oc).sum(0)
        c = (oc * oc).sum(0) - sph[None, :, 3]
        disc = half_b * half_b - a[i0:i0 + step, None] * c
        hit = (disc >= 0) & alive[i0:i0 + step, None]
        w = hit.reshape(-1, 32, sph.shape[0])
        live_w = alive[i0:i0 + step].reshape(-1, 32).any(1)
        warp_any += int(w.any(1)[live_w].sum())
        warps += int(live_w.sum())
        lane_any += int(hit.sum())
    n_alive = int(alive.sum())
    log(f"root path, scene_500 {n} camera rays x {sph.shape[0]} spheres: "
        f"(warp, sphere) share {warp_any / (warps * sph.shape[0]):.6f} over "
        f"{warps} live warps; (lane, sphere) share "
        f"{lane_any / (n_alive * sph.shape[0]):.6f} over {n_alive} alive "
        "lanes")


def report_walk(dev):
    from raytracer_tpu_torch.ops import fused_bounce as fb
    from raytracer_tpu_torch.ops import ordered
    scene = chip_smoke.large_scene("field64k").to(dev)
    tab, _, _, _, lanes, kw = chip_smoke.regen_capture(scene, dev)
    n, alive = lanes.o.shape[1], lanes.alive
    chunk = tab.osph.chunk
    for group in (ordered.GROUP, ordered.BLOCK):
        g = -(-n // group)
        stats = torch.zeros((g, 2), dtype=torch.int64, device=dev)
        fb._closest_plain(tab, lanes.o, lanes.d, kw["t_min"], alive,
                          ordered=True, stats=stats, group=group)
        a = torch.zeros(g * group, device=dev)
        a[:n] = alive.float()
        live = a.reshape(g, group).sum(1)
        body = stats[:, 0].double()
        on = live > 0
        slots = float(body.sum()) * group * chunk
        pairs = float((body * live).sum()) * chunk
        log(f"walk, field64k step {chip_smoke.REGEN_STEP} ({int(alive.sum())} "
            f"of {n} lanes alive), groups of {group}: chunk bodies per live "
            f"group {float(body[on].mean()):.4f} (max {int(body.max())}), "
            f"{int(body.sum())} in all; lane-pair slots {slots:.6g}, alive "
            f"pairs {pairs:.6g} ({pairs / slots:.4f} of the slots); dead "
            f"lanes in live groups {float((group - live[on]).sum() / (on.sum() * group)):.4f}")



# ---- the A/B

def report_builds(trees):
    for tag, m in trees.items():
        for name in NAMES:
            for entry, regs, smem, spill in ptxas_table(name, m.build):
                extra = ""
                if name.endswith("_ordered") and smem < 1024:
                    # the warp walk's dynamic shared memory at field64k's
                    # 33 superchunks: 4 warps x (buffer + keys and order)
                    smem += 4 * (-(-(2560 + 8 * 33) // 16) * 16)
                    extra = " (with field64k's dynamic smem)"
                log(f"build {tag}: {name} [{form(entry) or 'one form'}]: "
                    f"{regs} registers, {spill} B spill stores, {smem} B "
                    f"smem{extra}; {blocks_per_sm(regs, smem)} blocks of 128 "
                    "per SM")


def flat_cases(trees, rows, dev):
    cs = chip_smoke
    from raytracer_tpu_torch.ops import fused_bounce as fb
    from raytracer_tpu_torch.ops import leaf as leaf_ops
    this, other = trees["this"], trees["other"]
    inf = float("inf")
    ok = True

    def both(label, kernel, call, prep=lambda: None, explain=None):
        return ab_case(label, kernel, lambda a: call(this, a),
                       lambda a: call(other, a), prep, rows, explain)

    def rays_cases(label, tab, o, d, alive, uni, tm=None, seed=0,
                   flat=None):
        nonlocal ok
        for b in (1, 2):
            tag = f"{label} bounce {b}"
            walks = flat is not None and tab.osph is not None

            def explain(outputs_ok):
                return (explainer(this, other, tab, flat, o, d, cs.T_MIN,
                                  alive, tm, outputs_ok) if walks else None)

            def epilogue_ok(lanes, out, win, _):
                # the plain epilogue on this version's own winner
                sub = (lambda x: x[..., lanes])
                ref = fb._bounce_values(
                    tab, sub(o), sub(d), sub(uni), sub(win.t), sub(win.ty),
                    sub(win.ix).long(), sub(win.b1), sub(win.b2),
                    time=None if tm is None else sub(tm))
                return agree([sub(x) for x in out], ref)
            ok &= both(tag, "bounce" + ("_ordered" if tab.ordered else "")
                       + ("_motion" if tm is not None else ""),
                       lambda m, _: m.fused_bounce.bounce_tables(
                           tab, o, d, cs.T_MIN, alive, uni, time=tm),
                       explain=explain(epilogue_ok))
            ok &= both(tag, "closest" + ("_ordered" if tab.ordered else "")
                       + ("_motion" if tm is not None else ""),
                       lambda m, _: list(m.closest_hit.closest_tables(
                           tab, o, d, cs.T_MIN, inf, alive, time=tm)),
                       explain=explain(lambda lanes, out, _, pw: agree(
                           [x[lanes] for x in out],
                           [x[lanes] for x in pw])))
            if b == 1:
                out = fb.bounce_tables(tab, o, d, cs.T_MIN, alive, uni,
                                       time=tm)
                o, d, alive, uni = cs.next_bounce(out, alive, uni, seed + 1)

    def shadow_case(label, scene):
        nonlocal ok
        args, kw = cs.shadow_inputs(scene, dev)
        ok &= both(label, "closest" + ("_ordered" if args[0].ordered else ""),
                   lambda m, _: list(m.closest_hit.closest_tables(*args,
                                                                  **kw)))

    s500 = cs.load("scene_500", cs.WIDTH / cs.HEIGHT)
    tab = fb.pack_tables(s500.to(dev))
    o, d, alive, uni = cs.image_rays(s500, 7, dev)
    rays_cases("scene_500", tab, o, d, alive, uni, seed=7)
    shadow_case("scene_500 NEE shadow rays", s500)
    ltab = fb.pack_tables(leaf_ops.with_leaf_tables(s500).to(dev))
    ok &= both("scene_500 camera rays", "leaf",
               lambda m, _: list(m.leaf.leaf_closest(ltab, o, d, cs.T_MIN,
                                                     inf, alive)))

    for name, seed in (("field64k", 20), ("bunny_field", 21)):
        scene = cs.large_scene(name)
        tab = fb.pack_tables(scene.to(dev))
        flat = fb.pack_tables(scene.to(dev), order=False)
        o, d, alive, uni = cs.image_rays(scene, seed, dev)
        rays_cases(name, tab, o, d, alive, uni, seed=seed, flat=flat)
        if name == "field64k":
            ok &= both(f"{name} camera rays, flat tables", "bounce",
                       lambda m, _: m.fused_bounce.bounce_tables(
                           flat, o, d, cs.T_MIN, alive, uni))
            shadow_case(f"{name} NEE shadow rays", scene)

    for n_mov, seed in ((1000, 40), (65536, 41)):
        scene = cs.motion_scene(n_mov)
        tab = fb.pack_tables(scene.to(dev))
        o, d, alive, uni = cs.image_rays(scene, seed, dev)
        tm = cs.shutter_times(scene, seed, o.shape[1], dev)
        rays_cases(f"motion{n_mov}", tab, o, d, alive, uni, tm, seed,
                   fb.pack_tables(scene.to(dev), order=False)
                   if tab.ordered else None)
    return ok


def regen_cases(trees, rows, dev):
    cs = chip_smoke
    this, other = trees["this"], trees["other"]
    ok = True
    for label, scene in (
            ("scene_500", cs.load("scene_500", cs.WIDTH / cs.HEIGHT)),
            ("field64k", cs.large_scene("field64k")),
            ("bunny_field", cs.large_scene("bunny_field")),
            ("motion1000", cs.motion_scene(1000)),
            ("motion65536", cs.motion_scene(65536))):
        kernel = ("regen" + ("_ordered" if label not in ("scene_500",
                                                        "motion1000") else "")
                  + ("_motion" if label.startswith("motion") else ""))
        if KERNELS is not None and kernel not in KERNELS:
            continue
        tab, cam, U, eps, lanes, kw = cs.regen_capture(scene.to(dev), dev)

        def call(m, work):
            m.regen.regen_step_tables(tab, cam, U, eps, work, **kw)
            return [getattr(work, k) for k in cs.lane_fields(work)]

        def step_ok(sel, *_):
            # chip_smoke's own hold of this version's step on
            # regen_step_plain (its tolerances and decision edges)
            try:
                cs.compare_regen(f"{label} regen step", scene.to(dev), tab,
                                 cam, U, eps, lanes, kw, cs.PLAIN_EDGE)
            except AssertionError:
                return torch.zeros(len(sel), dtype=torch.bool,
                                   device=sel.device)
            return torch.ones(len(sel), dtype=torch.bool, device=sel.device)

        explain = None
        if tab.osph is not None:
            from raytracer_tpu_torch.ops import fused_bounce as fb
            explain = explainer(this, other, tab,
                                fb.pack_tables(scene.to(dev), order=False),
                                lanes.o, lanes.d, kw["t_min"], lanes.alive,
                                lanes.time, step_ok)

        ok &= ab_case(f"{label} regen step {cs.REGEN_STEP} "
                      f"({int(lanes.alive.sum())} of {lanes.o.shape[1]} "
                      "alive)", kernel, lambda w: call(this, w),
                      lambda w: call(other, w),
                      lambda: cs.clone_lanes(lanes), rows, explain)
    return ok


# ---- --variants: what each design element buys

# name -> (substitutions (file under csrc, old, new), kernels to run)
VARIANTS = {
    # one ray per thread in the flat kernels (256-lane tiles become 128)
    "one_ray": ([(f, "constexpr int RAYS = 2;", "constexpr int RAYS = 1;")
                 for f in ("bounce.cu", "closest.cu", "regen.cu")],
                "bounce,closest,regen,bounce_motion,regen_motion"),
    # one sphere per group: a branch per pair, in the sweep and the walk
    "no_group": ([("sweep.cuh", "constexpr int UNROLL = 4;",
                   "constexpr int UNROLL = 1;")],
                 "bounce,regen,bounce_ordered,regen_ordered"),
}


def make_variant(name: str) -> Path:
    """``output/variants/<name>``: this package with ``name``'s
    substitutions (every occurrence, at least one each)."""
    root = ROOT / "output" / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, old, new in VARIANTS[name][0]:
        path = root / PKG / "csrc" / fname
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not in {fname}")
        path.write_text(text.replace(old, new))
    return root



def run_variants() -> int:
    rc = 0
    for name in VARIANTS:
        root = make_variant(name)
        log(f"== variant {name}: this checkout against it")
        rc |= subprocess.run(
            [sys.executable, __file__, str(root),
             "--kernels", VARIANTS[name][1],
             "--out", str(OUT), "--json", str(OUT / f"ab_{name}.json")]
        ).returncode
    return rc


# ---- --renders: whole renders of both checkouts, in turns

RENDER_TURN = """
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
dev = torch.device("cuda")
scene = cs.load("scene_500", cs.WIDTH / cs.HEIGHT).to(dev)
leaf = cs.leaf_scene_500(dev)
cs.timed_render("warm", scene, dev, spp=1, rr=False, nee=True)
cs.timed_render("warm", leaf, dev, spp=1, rr=False, intersector="leaf")
for _ in range({repeats}):
    cs.timed_render("scene_500_nee", scene, dev, spp=cs.SPP, rr=False,
                    nee=True)
    cs.timed_render("scene_500_leaf", leaf, dev, spp=cs.SPP, rr=False,
                    intersector="leaf")
"""
RENDER_LINE = re.compile(r"render (scene_500_\w+): .* in ([0-9.]+) s")


def run_renders(other, repeats: int) -> int:
    times = {}
    for k, (tag, root) in enumerate((("other", Path(other)), ("this", ROOT),
                                     ("this", ROOT), ("other", Path(other)))):
        res = subprocess.run([sys.executable, "-c",
                              RENDER_TURN.format(repeats=repeats)],
                             cwd=root, capture_output=True, text=True)
        for ln in res.stdout.splitlines():
            m = RENDER_LINE.search(ln)
            if m:
                log(f"turn {k} ({tag}): {ln}")
                times.setdefault((m.group(1), tag, k), []).append(
                    float(m.group(2)))
        if res.returncode != 0:
            log(res.stdout[-2000:] + res.stderr[-4000:])
            return 1
    for name in sorted({key[0] for key in times}):
        med = {k: float(np.median(v)) for (n, _, k), v in times.items()
               if n == name}
        other_s, this_s = (med[0] + med[3]) / 2, (med[1] + med[2]) / 2
        log(f"{name}: other {med[0]:.4f}, {med[3]:.4f} s, this "
            f"{med[1]:.4f}, {med[2]:.4f} s (medians of {repeats}); "
            f"x{other_s / this_s:.3f} (spread "
            f"{max(abs(med[0] - med[3]), abs(med[1] - med[2])):.4f} s)")
    return 0


def run_limits(other) -> int:
    dev = torch.device("cuda")
    log(smi().strip() + " (clock MHz, power W, limit W)")
    trees = []
    if other:
        trees.append(("other", import_tree(Path(other))))
    from raytracer_tpu_torch.kernels import build as this_build
    from raytracer_tpu_torch.ops import fused_bounce as fb
    trees.append(("this", SimpleNamespace(build=this_build, fused_bounce=fb)))
    for tag, m in trees:
        report_build(m.build, tag, OUT / "sass" / tag)
    scene = chip_smoke.load("scene_500", chip_smoke.WIDTH / chip_smoke.HEIGHT)
    tab = fb.pack_tables(scene.to(dev))
    o, d, alive, uni = chip_smoke.image_rays(scene, 7, dev)
    for tag, m in trees:
        report_clock(m.fused_bounce, tag, tab, o, d, alive, uni)
    report_root_share(tab, o, d, alive)
    report_walk(dev)
    return 0


def run_ab(other, json_path: str) -> int:
    dev = torch.device("cuda")
    other = import_tree(Path(other))
    this = SimpleNamespace(**{m.split(".")[-1]: importlib.import_module(
        f"{PKG}.{m}") for m in MODULES})
    trees = {"this": this, "other": other}
    with ThreadPoolExecutor(2 * len(NAMES)) as pool:
        list(pool.map(lambda job: job[0].build.build(job[1]),
                      [(m, n) for m in trees.values() for n in NAMES]))
    report_builds(trees)
    rows = []
    ok = flat_cases(trees, rows, dev)
    ok &= regen_cases(trees, rows, dev)
    Path(json_path).parent.mkdir(parents=True, exist_ok=True)
    Path(json_path).write_text(json.dumps(rows, indent=1))
    log(f"{sum(r['same'] for r in rows)} of {len(rows)} (input, kernel) "
        "cases bit-identical")
    return 0 if ok else 1


def main() -> int:
    global KERNELS, OUT, REPS, BURST
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--limits", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--renders", action="store_true")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--burst", type=int, default=BURST)
    ap.add_argument("--kernels", default=None)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available() or not (args.other or args.limits
                                             or args.variants):
        print(__doc__, file=sys.stderr)
        return 2
    KERNELS = None if args.kernels is None else args.kernels.split(",")
    OUT = Path(args.out)
    REPS, BURST = args.reps, args.burst
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    if args.variants:
        return run_variants()
    if args.limits:
        return run_limits(args.other)
    if args.renders:
        return run_renders(args.other, args.repeats)
    return run_ab(args.other, args.json or str(OUT / "ab.json"))


if __name__ == "__main__":
    sys.exit(main())
