"""The prefill window's model FLOPs over its time, against the bf16 peak:
every prompt's layer matrices, its attention forward and the head at its
last position."""

from bench import counts

RANGES = {}


def read(view):
    if view.kind != "prefill" or not view.window.get("requests"):
        return None
    chunk = view.cfg.get("train", {}).get("ssm_chunk", 0)
    flops = sum(counts.prefill_flops(view.cfg, s, chunk)
                for s in view.window["lengths"])
    return (100.0 * flops / view.window["seconds"]
            / counts.PEAK_BF16_FLOPS)
