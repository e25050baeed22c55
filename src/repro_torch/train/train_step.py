"""train_step: loss -> (accumulated) grads -> clipped AdamW update.

The port of ``repro/train/train_step.py``.  The loss is ``lm_loss`` on the
float32 master tree, whose leaves the step marks ``requires_grad``;
``torch.autograd.grad`` takes the grad of every leaf and raises if one is
not reached (a cut graph).  With ``k`` microbatches the batch is split
along its first axis, the grads are summed into float32 accumulators and
divided by ``k``, and so is the loss (``train_step.py:71-89``).  The
batch's frontend inputs, ``patch_embeds`` (vlm) and ``frame_embeds``
(audio), go to ``lm_loss`` beside the tokens and are split with them
(``_batch_extras``, ``train_step.py:28-34``).  Optional int8 gradient
compression with error feedback (``compression.py``) comes before the
update.

Under a mesh (``ctx.mesh``) the params are DTensors (``bridge.
place_params``), the step lays each microbatch's rows out over the
data-parallel axes (``ctx.placements("dp", ...)``; every rank holds the
same global batch, as ``SyntheticSource`` gives it) and pins each grad to
its ``grad_shardings`` entry, by default its leaf's own placements, so the
accumulators and the optimizer see the params' layout (a partial grad is
reduce-scattered there, as the reference pins its fp32 accumulator to the
FSDP layout, ``train_step.py:38-57``).  The metrics come back as plain
tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..device import is_dtensor
from ..models.context import NULL_CTX, ModelContext
from ..models.transformer import lm_loss
from .compression import ef_compress
from .optimizer import OptimizerConfig, adamw_update
from .tree import Tree, leaves, tree_map, unflatten


EXTRAS = ("patch_embeds", "frame_embeds")


def _batch_extras(batch, dev) -> Dict[str, torch.Tensor]:
    """The frontend inputs of ``batch`` (numpy arrays or tensors) that it
    holds, on ``dev`` in their own dtype: ``lm_loss`` casts them to the
    compute dtype, as the reference's ``forward`` does."""
    return {n: torch.as_tensor(batch[n]).to(dev) for n in EXTRAS
            if n in batch}


def loss_and_grads(cfg, params: Tree, tokens: torch.Tensor,
                   labels: torch.Tensor, *, ctx: ModelContext = NULL_CTX,
                   **extras: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    """(loss, grads shaped like ``params``) of ``lm_loss``; ``extras`` are
    its ``patch_embeds`` / ``frame_embeds``."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _ = lm_loss(params, cfg, tokens, labels, ctx=ctx, **extras)
    with ctx.scope():
        grads = torch.autograd.grad(loss, ps)
    return loss.detach(), unflatten(params, grads)


def _plain(x):
    """A metric as a plain tensor (a replicated DTensor's full value)."""
    return x.full_tensor() if is_dtensor(x) else x


def make_train_step(cfg, opt_cfg: OptimizerConfig, *,
                    ctx: ModelContext = NULL_CTX, microbatches: int = 1,
                    grad_compression: bool = False,
                    grad_shardings=None) -> Callable:
    """Returns train_step(params, opt_state, ef_state, batch) ->
    (params, opt_state, ef_state, {"loss", "lr", "grad_norm"}).

    ``grad_shardings``: a tree of ``parallel.sharding.NamedSharding`` like
    the params (``launch.dryrun.sharded_param_specs``) that each grad is
    pinned to under a mesh; None pins each to its leaf's placements."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def pin(grads, params):
        if ctx.mesh is None:
            return grads
        if grad_shardings is None:
            return tree_map(lambda g, p: g.redistribute(p.device_mesh,
                                                        p.placements),
                            grads, params)
        return tree_map(lambda g, s: g.redistribute(s.device_mesh,
                                                    s.placements),
                        grads, grad_shardings)

    def rows(x):
        """A global batch tensor laid out over the data-parallel axes."""
        if ctx.mesh is None:
            return x
        from ..parallel.sharding import distribute_local
        return distribute_local(x, ctx.dmesh, ctx.placements(
            "dp", *[None] * (x.dim() - 1)))

    def grads_of(params, tokens, labels, extras):
        if microbatches == 1:
            loss, grads = loss_and_grads(
                cfg, params, rows(tokens), rows(labels), ctx=ctx,
                **{n: rows(e) for n, e in extras.items()})
            return loss, pin(grads, params)
        k = microbatches
        if tokens.shape[0] % k:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{k} microbatches")
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        split = {n: e.chunk(k) for n, e in extras.items()}
        for i, (t, l) in enumerate(zip(tokens.chunk(k), labels.chunk(k))):
            loss, grads = loss_and_grads(
                cfg, params, rows(t), rows(l), ctx=ctx,
                **{n: rows(parts[i]) for n, parts in split.items()})
            grads = pin(grads, params)
            tree_map(lambda a, g: a.add_(g.float()), acc, grads)
            loss_acc = loss_acc + _plain(loss)
            del grads
        return loss_acc / k, tree_map(lambda a: a / k, acc)

    def train_step(params, opt_state, ef_state, batch):
        """``batch``: numpy arrays (``SyntheticSource``) or tensors;
        ``tokens`` and ``labels``, and ``patch_embeds`` / ``frame_embeds``
        where the model's frontend takes them."""
        first = leaves(params)[0]
        dev = first.to_local().device if is_dtensor(first) else first.device
        tokens, labels = (torch.as_tensor(batch[n]).to(dev, torch.long)
                          for n in ("tokens", "labels"))
        loss, grads = grads_of(params, tokens, labels,
                               _batch_extras(batch, dev))
        if grad_compression:
            grads, ef_state = ef_compress(grads, ef_state)
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, ef_state, {
            "loss": _plain(loss), **{n: _plain(m) for n, m in om.items()}}

    return train_step
