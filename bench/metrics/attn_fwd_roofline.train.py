"""The attention forward's share of its roofline in the train cells: least
time of every call (max of its FLOPs at the peak rate and q, k, v, o
bytes at the memory rate) over the device time of every kernel launched
under the range around ``_FlashAttention.forward``."""

from bench import readers

RANGES = {"bench.attn_fwd":
          "repro_torch.kernels.ops:_FlashAttention.forward"}


def read(view):
    calls = view.calls("bench.attn_fwd")
    if view.kind != "train" or not calls:
        return None
    least = sum(readers.attn_least(q, k, causal, window)
                for _ctx, q, k, _v, causal, window in calls)
    return readers.share(least, view.device_seconds("bench.attn_fwd"))
