"""Small host-side helpers (copies of the JAX package's ``utils``)."""
from daft_exprt_torch.utils.misc import chunker
from daft_exprt_torch.utils.plots import plot_2d_data
