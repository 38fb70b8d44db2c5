"""The model stack (recurrentgemma-2b, qwen2-1.5b, gemma3-4b, xlstm-350m):
config, layers, model assembly with the training loss, prefill and greedy
decode."""
from .config import ArchConfig, SHAPE_CELLS, ShapeCell, shape_cell  # noqa: F401
from .model import (  # noqa: F401
    Model,
    decode_step,
    init_cache,
    init_params,
    layer_kinds,
    loss_fn,
    param_leaves,
    prefill,
)
