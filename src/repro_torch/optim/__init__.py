"""The in-house AdamW and LR schedule (a port of ``repro/optim``)."""
from .adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
