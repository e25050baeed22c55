"""The recurrence forward's share of its roofline: least time of every
call (its float32 products as 3xTF32 and its elementwise float32 work, or
q, k, v, decay and output bytes at the memory rate) over the device time
of every kernel launched under the range around ``_Rwkv6Mix.forward``."""

from bench import readers

RANGES = {"bench.rwkv6_fwd": "repro_torch.kernels.ops:_Rwkv6Mix.forward"}


def read(view):
    calls = view.calls("bench.rwkv6_fwd")
    if view.kind != "train" or not calls:
        return None
    least = sum(readers.rwkv6_least(q, v, bonus, chunk)
                for _ctx, q, _k, v, _ld, bonus, _s0, chunk in calls)
    return readers.share(least, view.device_seconds("bench.rwkv6_fwd"))
