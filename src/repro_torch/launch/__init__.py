"""Launch layer of the port (twin of ``repro.launch``): the logical
production meshes (``mesh``), the train and serve drivers (``train``,
``serve``), and the dry-run tools — the cells (``cells``), the op cost
counter (``op_cost``, the twin of ``hlo_cost``), the H100 roofline
(``roofline``), the flash substitution (``flashsub``), the dry-run
(``dryrun``) and its report (``report``)."""
from repro_torch.launch.mesh import make_mesh, make_production_mesh
__all__ = ["make_mesh", "make_production_mesh"]
