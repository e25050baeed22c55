"""Float64 runs of the port on the CPU: telling a rounding gap from a fault.

Test harness only; no model or training code enters it.  The port computes
in its config's dtype (``models.common.compute_dtype``: float32 or bf16) and
upcasts with ``Tensor.float()`` where the reference upcasts to float32.
Inside :class:`float64_compute` both widen: the compute dtype is float64 and
``float()`` leaves a float64 tensor as it is, so a model whose params are
float64 runs in float64 from the embedding to the loss.  Two paths that
compute the same function (a sharded run and the single device) then agree
to float64's rounding, while in float32 a model that amplifies rounding
(random Mamba2 blocks) can keep them apart by more than a fixed tolerance.
CPU only: the card's kernels take bf16 and float32.  The context patches
``models.transformer.compute_dtype`` and the ``torch.Tensor.float`` method
in this process, and restores both when it exits.
"""

from __future__ import annotations

import torch


class float64_compute:
    """Context: the port computes in float64 (see the module's text)."""

    def __enter__(self):
        from ..models import transformer
        real_float = torch.Tensor.float

        def wide_float(t, *args, **kwargs):
            if t.dtype == torch.float64:
                return t
            return real_float(t, *args, **kwargs)

        self._saved = (transformer, transformer.compute_dtype, real_float)
        transformer.compute_dtype = lambda cfg: torch.float64
        torch.Tensor.float = wide_float
        return self

    def __exit__(self, *exc) -> bool:
        transformer, compute_dtype, real_float = self._saved
        transformer.compute_dtype = compute_dtype
        torch.Tensor.float = real_float
        return False
