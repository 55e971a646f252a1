"""Builds the CUDA sources under ``csrc/`` with nvcc and loads them
(``build``), and reads the kernel wrappers' launch counts: each wrapper
adds one to its module's count where it launches its kernel."""


def _counted():
    from raytracer_tpu_torch.experiments import bf16_rate_bench as probe
    from raytracer_tpu_torch.ops import closest_hit, fused_bounce, leaf
    from raytracer_tpu_torch.ops import photon_query, regen
    return ((("leaf", leaf), ("photon_query", photon_query),
             ("fma_rate", probe)),
            (("bounce", fused_bounce), ("closest", closest_hit),
             ("regen", regen)))


_FORMS = (("", "LAUNCHES"), ("_ordered", "ORDERED_LAUNCHES"),
          ("_motion", "MOTION_LAUNCHES"),
          ("_ordered_motion", "ORDERED_MOTION_LAUNCHES"))


def _slots() -> dict:
    """{launch_counts key: (wrapper module, count attribute)}."""
    single, forms = _counted()
    out = {name: (mod, "LAUNCHES") for name, mod in single}
    for name, mod in forms:
        for suffix, attr in _FORMS:
            out[name + suffix] = (mod, attr)
    return out


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by library and form."""
    return {k: getattr(mod, attr) for k, (mod, attr) in _slots().items()}


def launches_since(before: dict) -> dict:
    """The launches made since ``before`` (``launch_counts()``), those
    that are not 0."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def add_launches(counts: dict, times: int = 1):
    """Add ``counts`` (``launch_counts`` keys) ``times`` times to the
    wrappers' counts: a CUDA graph's replay launches what its capture
    counted, though no wrapper runs (``utils/graphs.py``)."""
    slots = _slots()
    for k, v in counts.items():
        mod, attr = slots[k]
        setattr(mod, attr, getattr(mod, attr) + v * times)


def zero_launch_counts():
    """Set every wrapper's launch counts to 0."""
    for mod, attr in _slots().values():
        setattr(mod, attr, 0)
