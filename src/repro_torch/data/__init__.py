"""The synthetic training data (numpy only), as ``repro.data``."""
from .pipeline import SyntheticTokens, batch_iterator, make_batch  # noqa: F401
