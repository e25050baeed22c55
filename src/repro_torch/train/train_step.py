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
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

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
    return loss.detach(), unflatten(params, torch.autograd.grad(loss, ps))


def make_train_step(cfg, opt_cfg: OptimizerConfig, *,
                    ctx: ModelContext = NULL_CTX, microbatches: int = 1,
                    grad_compression: bool = False) -> Callable:
    """Returns train_step(params, opt_state, ef_state, batch) ->
    (params, opt_state, ef_state, {"loss", "lr", "grad_norm"})."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def grads_of(params, tokens, labels, extras):
        if microbatches == 1:
            return loss_and_grads(cfg, params, tokens, labels, ctx=ctx,
                                  **extras)
        k = microbatches
        if tokens.shape[0] % k:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{k} microbatches")
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        split = {n: e.chunk(k) for n, e in extras.items()}
        for i, (t, l) in enumerate(zip(tokens.chunk(k), labels.chunk(k))):
            loss, grads = loss_and_grads(
                cfg, params, t, l, ctx=ctx,
                **{n: parts[i] for n, parts in split.items()})
            tree_map(lambda a, g: a.add_(g.float()), acc, grads)
            loss_acc = loss_acc + loss
            del grads
        return loss_acc / k, tree_map(lambda a: a / k, acc)

    def train_step(params, opt_state, ef_state, batch):
        """``batch``: numpy arrays (``SyntheticSource``) or tensors;
        ``tokens`` and ``labels``, and ``patch_embeds`` / ``frame_embeds``
        where the model's frontend takes them."""
        dev = leaves(params)[0].device
        tokens, labels = (torch.as_tensor(batch[n]).to(dev, torch.long)
                          for n in ("tokens", "labels"))
        loss, grads = grads_of(params, tokens, labels,
                               _batch_extras(batch, dev))
        if grad_compression:
            grads, ef_state = ef_compress(grads, ef_state)
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, ef_state, {"loss": loss, **om}

    return train_step
