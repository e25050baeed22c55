"""Architecture configs of the port.  ``get_config(name)`` / ``--arch <id>``.

Only the dense family is ported so far, so only its configs are registered.
"""

from .base import ModelConfig, get_config, list_configs, reduced, register
from . import tinyllama_1_1b  # noqa: F401  (registers the config)
