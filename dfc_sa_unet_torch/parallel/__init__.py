from dfc_sa_unet_torch.parallel.mesh import ProcessMesh, data_parallel_mesh, serving_mesh
from dfc_sa_unet_torch.parallel import multihost

__all__ = ["ProcessMesh", "data_parallel_mesh", "serving_mesh", "multihost"]
