"""The one attention call site of the port's transformers.

``attention`` serves the ViT trunk's self-attention and the HaMeR
decoder's self- and cross-attention (``hocon_torch.models.vit``,
``hocon_torch.models.hamer``). It is ``F.scaled_dot_product_attention``;
on CUDA its backends are pinned to flash and memory-efficient attention,
so an input that neither can run raises instead of falling back to the
math backend, which materialises the score matrix. On the CPU PyTorch
picks the backend. Over a single key (the decoder's self-attention on its
one query token) the softmax is exactly 1: the call returns the values
without a kernel, so the queries and keys take exactly zero gradient,
where a kernel's backward leaves rounding noise that Adam would scale to
full steps.

Each call is a ``model.attn`` span (``hocon_torch.utils.trace``) and counts
in ``attention.calls``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hocon_torch.utils.trace import span


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, heads, L, d) queries and
    (B, heads, S, d) keys and values; (B, heads, L, d)."""
    attention.calls += 1
    with span("model.attn"):
        if k.shape[-2] == 1:
            return v.expand(q.shape[:-1] + v.shape[-1:])
        if not q.is_cuda:
            return F.scaled_dot_product_attention(q, k, v)
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v)


attention.calls = 0
