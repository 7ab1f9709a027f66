"""Device meshes of the port (``repro.launch``'s mesh helpers)."""
from .mesh import DeviceMesh, as_device_mesh, make_host_mesh, make_mesh
