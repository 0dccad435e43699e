"""Multi-GPU detection: meshes of ranks over torch.distributed (mesh.py)
and the window-sharded and frame-data-parallel face cascade (sharded.py)."""

from pigo_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from pigo_tpu_torch.parallel.sharded import ShardedFaceCascade

__all__ = ["Mesh", "init_distributed", "make_mesh", "ShardedFaceCascade"]
