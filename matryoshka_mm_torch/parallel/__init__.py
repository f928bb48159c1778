"""Running the port over several ranks: ``mesh.py`` (torch.distributed
from torchrun's environment, a (data, model) grid of ranks, this rank's
rows of a batch), ``collectives.py`` (tensor-parallel groups by name) and
``tp_decode.py`` (tensor-parallel inference with the kernels kept,
``TPEngine``)."""

from .mesh import initialize_distributed, make_mesh, put_batch  # noqa: F401
