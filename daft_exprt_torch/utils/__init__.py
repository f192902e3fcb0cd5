"""Small host-side helpers (copies of the JAX package's ``utils``; the
profiling helpers in ``utils/profiling.py``)."""
from daft_exprt_torch.utils.misc import chunker, estimate_required_time
from daft_exprt_torch.utils.multiproc import get_nb_jobs, launch_multi_process
from daft_exprt_torch.utils.plots import plot_2d_data
