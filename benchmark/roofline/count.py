"""A frozen copy of chip_smoke.count_ops: the operations a function
performs, counted at PyTorch's dispatcher."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

NAMES = {"add", "sub", "mul", "div", "neg", "abs", "sign", "minimum",
         "maximum", "where", "gt", "ge", "lt", "le", "eq", "ne",
         "logical_and", "logical_or", "logical_not", "bitwise_and",
         "bitwise_or", "bitwise_not", "rsub", "reciprocal", "clamp"}


def count_ops(fn, split=False):
    """Arithmetic, compare and select operations of fn(): the elements
    produced by each such aten op (clamp counts 2), and 2*M*N*K for each
    matrix product (mm, bmm) of M x K by K x N.  split: (all operations,
    those of the matrix products)."""

    class Count(TorchDispatchMode):
        ops = 0
        mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in ("mm", "bmm"):
                self.ops += 2 * out.numel() * args[0].shape[-1]
                self.mm += 2 * out.numel() * args[0].shape[-1]
            elif name in NAMES and isinstance(out, torch.Tensor):
                self.ops += out.numel() * (2 if name == "clamp" else 1)
            return out

    with Count() as c:
        fn()
    return (c.ops, c.mm) if split else c.ops
