"""Architecture configs of the port.  ``get_config(name)`` / ``--arch <id>``.

Only the ported families' configs are registered: tinyllama-1.1b (dense)
and rwkv6-3b (ssm).
"""

from .base import ModelConfig, get_config, list_configs, reduced, register
from . import rwkv6_3b, tinyllama_1_1b  # noqa: F401  (register the configs)
