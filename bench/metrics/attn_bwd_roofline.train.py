"""The attention backward's share of its roofline: least time of its four
products (twice the forward's FLOPs) and of q, k, v, o, dO read and dq,
dk, dv written, over the device time of every kernel launched under the
range around ``_FlashAttention.backward``; its recompute is the
program's cost, not counted as work."""

from bench import readers

RANGES = {"bench.attn_bwd":
          "repro_torch.kernels.ops:_FlashAttention.backward"}


def read(view):
    calls = view.calls("bench.attn_bwd")
    if view.kind != "train" or not calls:
        return None
    least = sum(readers.attn_least(ctx["saved"][0], ctx["saved"][1],
                                   ctx["causal"], ctx["window"],
                                   backward=True)
                for ctx, _g in calls)
    return readers.share(least, view.device_seconds("bench.attn_bwd"))
