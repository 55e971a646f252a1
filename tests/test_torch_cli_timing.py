"""The port's stage timing, progress line, profiler hook, ``--preset ci``
and ``--debug-nans`` (``raytracer_tpu_torch.utils.timing``,
``utils.nans``, ``cli.py``) against the JAX package's
``utils/timing.py``, ``utils/config.py::ci_preset`` and ``cli.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from raytracer_tpu.utils import timing as jtiming  # noqa: E402
from raytracer_tpu.utils.config import RenderConfig as JConfig  # noqa
from raytracer_tpu_torch.models import path_tracer, sppm  # noqa: E402
from raytracer_tpu_torch.ops.bvh import build_bvh  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.utils import nans, timing  # noqa: E402
from raytracer_tpu_torch.utils.config import (  # noqa: E402
    RenderConfig, SPPMConfig)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: run torch
    on this worker's share of them."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def test_stage_timer_summary_matches_jax(monkeypatch):
    """The same stages and counters give the same summary lines."""
    now = 1000.0
    monkeypatch.setattr(time, "time", lambda: now)
    ours, ref = timing.StageTimer(), jtiming.StageTimer()
    for timer in (ours, ref):
        timer._start = now - 12.5
        timer.stages.update({"Scene build": 0.25, "SPPM": 11.0})
        with timer.stage("Save"):
            pass
        timer.count("traced_rays", 123_456_789)
        timer.count("photons", 4_000_000)
        timer.count("photons", 1)
    assert ours.summary() == ref.summary()
    assert ours.summary().splitlines()[0] == "Total: 12.50s"
    assert "traced_rays: 123.46M (9.88 Mrays/s)" in ours.summary()


def test_progress_silent_off_a_tty(capsys):
    """Off a TTY (pytest captures stderr) nothing is printed unless
    forced; forced, the line is the JAX class's."""
    prog = timing.Progress(total=3, label="pt spp")
    assert not prog.enabled
    prog.tick(1, rays=1e6)
    assert capsys.readouterr().err == ""
    forced = timing.Progress(total=2, label="sppm iter", force=True)
    ref = jtiming.Progress(total=2, label="sppm iter", force=True)
    ref._start = forced._start
    forced.tick(2)
    ours = capsys.readouterr().err
    ref.tick(2)
    assert capsys.readouterr().err == ours
    assert ours.startswith("\rsppm iter: 2/2 [") and ours.endswith("\n")


def test_ci_preset_is_jax_preset():
    ours = dataclasses.asdict(RenderConfig.ci_preset())
    ref = dataclasses.asdict(JConfig.ci_preset())
    assert ours == ref
    assert (ours["width"], ours["height"], ours["samples_per_pixel"],
            ours["max_depth"]) == (200, 200, 16, 16)
    assert (ours["sppm"]["n_iterations"],
            ours["sppm"]["photons_per_iter"]) == (2, 20_000)


def test_maybe_profile_writes_a_trace(tmp_path):
    with timing.maybe_profile(str(tmp_path / "p"), "cpu"):
        torch.ones(64).cumsum(0).sum()
    trace = json.loads((tmp_path / "p" / timing.TRACE_FILE).read_text())
    assert trace["traceEvents"]
    with timing.maybe_profile(None):
        pass                                # no directory: a no-op


def nan_scene(route="pallas"):
    """Cornell with its white walls' texture fed a NaN."""
    s = tbuiltin.cornell_box()
    c0 = s.textures.color0.clone()
    white = s.materials.tex_id[s.rects.mat_id[2]].long()
    c0[white, 0] = float("nan")
    s = s._replace(textures=s.textures._replace(color0=c0))
    return build_bvh(s) if route == "bvh" else s


TINY = RenderConfig(width=8, height=8, samples_per_pixel=2, spp_chunk=2,
                    max_depth=4,
                    sppm=SPPMConfig(n_iterations=1, photons_per_iter=800,
                                    max_photon_bounces=3,
                                    max_camera_bounces=4))


def render(kind, scene, route):
    cfg = TINY.replace(intersector=route, nee=kind == "nee")
    if kind == "sppm":
        return sppm.render(scene, cfg, 0, device="cpu")[0]
    return path_tracer.render(scene, cfg, 0, device="cpu")[0]


@pytest.mark.parametrize("kind,route", [
    ("pt", "pallas"), ("nee", "pallas"), ("pt", "bruteforce"),
    ("pt", "bvh"), ("sppm", "pallas"), ("sppm", "bruteforce")])
def test_debug_nans_raises_where_a_nan_appears(kind, route):
    """With the checks on, a NaN in the scene raises
    ``FloatingPointError`` naming the step; off (the default), the render
    runs and its image holds the NaN; a clean scene passes with them
    on."""
    with nans.debug_nans():
        with pytest.raises(FloatingPointError, match="NaN in .* after"):
            render(kind, nan_scene(route), route)
        clean = render(kind, nan_scene(route)._replace(
            textures=tbuiltin.cornell_box().textures), route)
    assert torch.isfinite(clean).all()
    assert not nans.enabled()
    assert torch.isnan(render(kind, nan_scene(route), route)).any()


def test_cli_debug_nans_on_a_clean_render(tmp_path):
    out = tmp_path / "clean.png"
    res = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "render", "--scene",
         "cornell", "--integrator", "sppm", "--debug-nans", "--width", "8",
         "--height", "8", "--spp", "1", "--max-depth", "4",
         "--sppm-iters", "1", "--sppm-photons", "1000", "--device", "cpu",
         "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert "SPPM:" in res.stdout and "traced_rays:" in res.stdout
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.isfinite(float(res.stdout.split("Total: ")[1].split("s")[0]))
