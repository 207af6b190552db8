"""Architecture configs the port runs (``--arch <id>``)."""
from .registry import ARCHS, get_config, get_smoke_config
