"""The precision of float32 products on CUDA.

The JAX package computes its small float32 MLPs (KiloNeRF's grouped layers,
the deformation, coefficient and motion MLPs, img_fit) as XLA dots in full
float32. On the card PyTorch may run float32 products in TF32 (a 10-bit
mantissa) when the process asks for it, so these products run inside
``full_float32`` in the forward and in the backward.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products on CUDA with TF32 (``tf32``) or in full float32
    inside the block, whatever the caller set; the setting is put back as it
    was, read and written through one API (``fp32_precision`` where torch
    has it, whose "none" means: inherit the process-wide precision)."""
    mm = torch.backends.cuda.matmul
    if hasattr(mm, "fp32_precision"):
        prev = mm.fp32_precision
        mm.fp32_precision = "tf32" if tf32 else "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = prev
    else:
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)


def full_float32():
    """Full float32 products (no TF32)."""
    return matmul_precision(False)


class _Linear(torch.autograd.Function):
    """x [..., in] @ w [in, out] + b [out] (JAX's layout), with the products
    of the forward and of the backward in full float32."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with full_float32():
            return torch.matmul(x, w) + b

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        with full_float32():
            if ctx.needs_input_grad[0]:
                gx = torch.matmul(g, w.t())
            if ctx.needs_input_grad[1]:
                gw = torch.matmul(x.reshape(-1, x.shape[-1]).t(), g.reshape(-1, g.shape[-1]))
        if ctx.needs_input_grad[2]:
            gb = g.reshape(-1, g.shape[-1]).sum(0)
        return gx, gw, gb


def linear(x: torch.Tensor, layer) -> torch.Tensor:
    """``x @ layer["w"] + layer["b"]`` in full float32, forward and backward."""
    return _Linear.apply(x, layer["w"], layer["b"])
