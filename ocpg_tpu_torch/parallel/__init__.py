"""Device placement of batches (one GPU; the multi-GPU mesh is not ported yet)."""
from .mesh import prefetch_to_mesh  # noqa: F401
