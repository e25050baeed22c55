"""The training window's model FLOPs over its time, against the bf16 peak:
6 x (layer matrices + head) x tokens, plus the sequence mixer's forward
and backward (3 x its forward); recompute not counted."""

from bench import counts

RANGES = {}


def read(view):
    if view.kind != "train" or not view.window.get("steps"):
        return None
    tr = view.traffic
    flops = counts.train_step_flops(view.cfg, tr["batch"], tr["seq"],
                                    view.cfg["train"]["ssm_chunk"])
    return (100.0 * flops * view.window["steps"] / view.window["seconds"]
            / counts.PEAK_BF16_FLOPS)
