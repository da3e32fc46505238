"""Launch helpers of the port: the LM meshes and the PHY cell-serving mesh
(:mod:`repro_torch.launch.mesh`)."""
from repro_torch.launch.mesh import (CellMesh, local_devices, make_cell_mesh,
                                     make_host_mesh, make_mesh,
                                     make_production_mesh)
