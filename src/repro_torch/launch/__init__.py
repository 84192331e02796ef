"""Command-line entry points of the port, and the meshes they run on."""
from .mesh import make_local_mesh, make_mesh, make_production_mesh  # noqa: F401
