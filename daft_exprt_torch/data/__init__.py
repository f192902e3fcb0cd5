"""Training data: dataset, collation, iterators and the dynamic
per-speaker stats (copies of the JAX package's numpy-only modules)."""
from daft_exprt_torch.data.dataset import (
    DaftExprtDataset, collate_batch, BatchIterator, PrefetchIterator,
    prepare_data_iterators,
)
from daft_exprt_torch.data.dynamic_stats import DynamicSpeakerStatsManager
