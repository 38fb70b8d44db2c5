"""The prefill and serve steps of the serving path."""
from .trainstep import make_prefill_step, make_serve_step  # noqa: F401
