"""Output writers (npz / metadata.json / VTK) and checkpointing."""

from gmpnp_tpu_torch.io.writers import RunPaths, save_metadata, save_npz, make_run_dir
from gmpnp_tpu_torch.io.vtk import write_vtu

__all__ = ["RunPaths", "save_metadata", "save_npz", "make_run_dir", "write_vtu"]
