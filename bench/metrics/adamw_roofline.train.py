"""AdamW's share of its roofline: float32 p, g, m and v read and p, m and
v written once at the memory rate, over the device time of every kernel
launched under the range around ``adamw_update`` as the train step calls
it."""

from bench import counts, readers

RANGES = {"bench.adamw": "repro_torch.train.train_step:adamw_update"}


def read(view):
    calls = view.calls("bench.adamw")
    if view.kind != "train" or not calls:
        return None
    least = sum(counts.adamw_bytes(params["numel"]) / counts.PEAK_BYTES
                for _grads, _state, params, _cfg in calls)
    return readers.share(least, view.device_seconds("bench.adamw"))
