"""Symbol table and English text cleaners (copies of the JAX package's)."""
from daft_exprt_torch.text.cleaners import (
    collapse_whitespace, english_cleaners, text_cleaner,
)
