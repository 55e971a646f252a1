"""A run with the timed path broken underneath comes out not correct:
for each fault the cell can have, a step that returns its state (or an
earlier answer) unchanged, half of the batch left out with the mean of
the rest in its place, and an answer altered where it is produced. The
harness's look for a card is skipped; the run is on the CPU at a tiny
size. (Every cell runs on one chip, so no exchange between chips can be
left out.)"""

import pytest
import torch

from conftest import ROOT


def _image_faults(fn_name, module):
    """Wrappers of an image entry (``render_fn`` or ``gather_fn``), by
    fault."""
    orig = getattr(module, fn_name)
    seen = {}

    def stale(*a, **k):
        img, rays = orig(*a, **k)
        seen.setdefault("first", img.clone())
        return seen["first"].clone(), rays

    def half(*a, **k):
        img, rays = orig(*a, **k)
        img = img.clone()
        img[1::2] = img[0::2].mean((0, 1))        # odd rows: the rest's mean
        return img, rays

    def altered(*a, **k):
        img, rays = orig(*a, **k)
        seen["n"] = seen.get("n", 0) + 1
        return (img * 3.0 if seen["n"] == 4 else img), rays

    return {"stale": stale, "half": half, "altered": altered}


def _run(root, name, seconds=3.0):
    import run
    return run.run_cell(name, 424242, seconds, False, "cpu", root=root,
                        data_root=ROOT)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("kind", ["pt", "gather"])
def test_image_faults(tiny, monkeypatch, kind, fault):
    from raytracer_tpu_torch.models import path_tracer, sppm
    module, fn = ((path_tracer, "render_fn") if kind == "pt"
                  else (sppm, "gather_fn"))
    root, name = tiny(kind)
    monkeypatch.setattr(module, fn, _image_faults(fn, module)[fault])
    line = _run(root, name, 4.0 if kind == "pt" else 2.0)
    assert line["attempted"] >= 5
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_sppm_iteration_faults(tiny, monkeypatch, fault):
    from raytracer_tpu_torch.models import sppm
    orig = sppm.sppm_iteration

    def broken(scene, tables, state, seed, **kw):
        new = orig(scene, tables, state, seed, **kw)
        if fault == "unchanged":
            return state._replace(iteration=new.iteration)
        if fault == "altered":
            return new._replace(glob=new.glob._replace(
                flux=new.glob.flux * 2.0))
        w = kw["width"]
        keep = (torch.arange(new.glob.photons.shape[0]) // w) % 2 == 1

        def mix(a, b):
            return sppm.SPPMHalf(*(torch.where(
                keep.view(-1, *([1] * (x.dim() - 1))), x, y)
                for x, y in zip(a, b)))
        return sppm.SPPMState(mix(state.glob, new.glob),
                              mix(state.caustic, new.caustic),
                              new.iteration)

    monkeypatch.setattr(sppm, "sppm_iteration", broken)
    root, name = tiny("iter")
    line = _run(root, name)
    assert line["correct"] is False, line["compared"]
