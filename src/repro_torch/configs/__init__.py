"""Architecture configs of the port.  ``get_config(name)`` / ``--arch <id>``.

Only the ported families' configs are registered: the dense family
(tinyllama-1.1b, olmo-1b, qwen1.5-32b, nemotron-4-340b), the ssm family
(rwkv6-3b), the moe family (deepseek-moe-16b, mixtral-8x22b), the
hybrid family (zamba2-2.7b), the audio family (whisper-base) and the vlm
family (phi-3-vision-4.2b): every config the reference registers.  Each is
the port's own copy of the reference's config, held field by field against
it in ``tests/test_torch_model.py``.
"""

from .base import ModelConfig, get_config, list_configs, reduced, register
from . import (deepseek_moe_16b, mixtral_8x22b,  # noqa: F401
               nemotron_4_340b, olmo_1b, phi_3_vision_4_2b,
               qwen1_5_32b, rwkv6_3b, tinyllama_1_1b, whisper_base,
               zamba2_2_7b)  # (register the configs)
