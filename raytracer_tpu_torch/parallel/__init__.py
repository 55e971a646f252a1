"""Multi-device rendering over ``torch.distributed``: the counterpart of
``raytracer_tpu/parallel/`` (a ("px", "spp") mesh of ranks)."""
