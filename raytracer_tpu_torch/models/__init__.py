"""Integrators: the path-regeneration wavefront and its entry points."""
