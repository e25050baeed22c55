"""train_step: loss -> (accumulated) grads -> clipped AdamW update.

The port of ``repro/train/train_step.py``.  The loss is ``lm_loss`` on the
float32 master tree, whose leaves the step marks ``requires_grad``;
``torch.autograd.grad`` takes the grad of every leaf and raises if one is
not reached (a cut graph).  With ``k`` microbatches the batch is split
along its first axis, the grads are summed into float32 accumulators and
divided by ``k``, and so is the loss (``train_step.py:71-89``).  Optional
int8 gradient compression with error feedback (``compression.py``) comes
before the update.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..models.context import NULL_CTX, ModelContext
from ..models.transformer import lm_loss
from .compression import ef_compress
from .optimizer import OptimizerConfig, adamw_update
from .tree import Tree, leaves, tree_map, unflatten


def loss_and_grads(cfg, params: Tree, tokens: torch.Tensor,
                   labels: torch.Tensor, *, ctx: ModelContext = NULL_CTX
                   ) -> Tuple[torch.Tensor, Tree]:
    """(loss, grads shaped like ``params``) of ``lm_loss``."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _ = lm_loss(params, cfg, tokens, labels, ctx=ctx)
    return loss.detach(), unflatten(params, torch.autograd.grad(loss, ps))


def make_train_step(cfg, opt_cfg: OptimizerConfig, *,
                    ctx: ModelContext = NULL_CTX, microbatches: int = 1,
                    grad_compression: bool = False) -> Callable:
    """Returns train_step(params, opt_state, ef_state, batch) ->
    (params, opt_state, ef_state, {"loss", "lr", "grad_norm"})."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def grads_of(params, tokens, labels):
        if microbatches == 1:
            return loss_and_grads(cfg, params, tokens, labels, ctx=ctx)
        k = microbatches
        if tokens.shape[0] % k:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{k} microbatches")
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for t, l in zip(tokens.chunk(k), labels.chunk(k)):
            loss, grads = loss_and_grads(cfg, params, t, l, ctx=ctx)
            tree_map(lambda a, g: a.add_(g.float()), acc, grads)
            loss_acc = loss_acc + loss
            del grads
        return loss_acc / k, tree_map(lambda a: a / k, acc)

    def train_step(params, opt_state, ef_state, batch):
        """``batch``: numpy arrays (``SyntheticSource``) or tensors."""
        dev = leaves(params)[0].device
        tokens, labels = (torch.as_tensor(batch[n]).to(dev, torch.long)
                          for n in ("tokens", "labels"))
        loss, grads = grads_of(params, tokens, labels)
        if grad_compression:
            grads, ef_state = ef_compress(grads, ef_state)
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg)
        return params, opt_state, ef_state, {"loss": loss, **om}

    return train_step
