"""Plain PyTorch references of the benchmark's configurations.

Float32 throughout with TF32 off, no kernel, cache or batching of the
program's, and nothing imported from the program: each takes the weights
and inputs ``bench.weights`` made and works out everything the program
derives from them again.  One module per architecture; a configuration
names its module under ``reference``.  The module also lays out the
weights of its blocks (``layer_leaves``, ``FLOAT32_LEAVES``) and counts
their work (``layer_matrices``, ``mixer_fwd_flops``), so a new family
comes in as a new module.
"""

import importlib


def module(cfg: dict):
    """The reference module that configuration ``cfg`` names; a family
    that module does not implement is refused."""
    mod = importlib.import_module(f"bench.reference.{cfg['reference']}")
    if cfg["family"] not in mod.FAMILIES:
        raise ValueError(f"{cfg['name']}: family {cfg['family']!r} is not "
                         f"one of reference/{cfg['reference']}.py's "
                         f"{mod.FAMILIES}")
    return mod
