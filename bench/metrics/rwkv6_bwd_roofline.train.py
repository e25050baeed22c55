"""The recurrence backward's share of its roofline: least time of the
grads' products and bytes from the call's shapes, over the device time of
every kernel launched under the range around ``_Rwkv6Mix.backward``; its
recompute is not counted as work."""

from bench import readers

RANGES = {"bench.rwkv6_bwd": "repro_torch.kernels.ops:_Rwkv6Mix.backward"}


def read(view):
    calls = view.calls("bench.rwkv6_bwd")
    if view.kind != "train" or not calls:
        return None
    least = sum(readers.rwkv6_least(ctx["saved"][0], ctx["saved"][2],
                                    ctx["saved"][4], ctx["chunk"],
                                    backward=True)
                for ctx, _g_out, _g_state in calls)
    return readers.share(least, view.device_seconds("bench.rwkv6_bwd"))
