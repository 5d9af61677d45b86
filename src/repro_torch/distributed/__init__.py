"""Spatial placement: the device mesh and the cross-pod collectives."""

from .mesh import Mesh, make_mesh  # noqa: F401
