"""Attention modules of the CAM heads (NHWC at the surface).

Mirror of ``wseg_tpu/models/heads/attention.py``: CBAM-style
``ChannelAttention`` / ``SpatialAttention``, the windowed multi-head
self-attention (no talking heads, no cross query) and ``GlobalSRA``,
global attention over spatially reduced keys and values.  The parameter
layout follows the reference torch modules, so state_dicts carry the
reference names and shapes.  Attention logits, softmax and the
attention-weighted sum run in float32, under autocast too, as the JAX
version's ``preferred_element_type=float32`` products do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wseg_tpu_torch.ops.activations import relu

def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 whatever the autocast state."""
    with torch.autocast(a.device.type, enabled=False):
        return torch.matmul(a.float(), b.float())


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(..., N, C) -> (..., heads, N, C / heads)."""
    *lead, n, c = t.shape
    return t.reshape(*lead, n, num_heads, c // num_heads).transpose(-2, -3)


def pad_to_multiple(x: torch.Tensor, mult_h: int, mult_w: int):
    """Zero-pad NHWC bottom/right so H, W divide the window size."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = (mult_h - h % mult_h) % mult_h, (mult_w - w % mult_w) % mult_w
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    return x, (h, w)


class ChannelAttention(nn.Module):
    """SE-style gate from avg- and max-pooled descriptors.

    fc1/fc2 are 1x1 convs in the reference, so their weights keep the
    (out, in, 1, 1) conv shape; they are applied as linears.
    """

    def __init__(self, features: int):
        super().__init__()
        mid = features // 16
        self.fc1 = nn.Conv2d(features, mid, 1, bias=False)
        self.fc2 = nn.Conv2d(mid, features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, 1, 1, C) sigmoid gate."""
        w1 = self.fc1.weight.flatten(1)
        w2 = self.fc2.weight.flatten(1)

        def mlp(v):
            return F.linear(relu(F.linear(v, w1)), w2)

        avg = torch.mean(x, dim=(1, 2))
        mx = torch.amax(x, dim=(1, 2))
        return torch.sigmoid(mlp(avg) + mlp(mx))[:, None, None, :]


class SpatialAttention(nn.Module):
    """7x7 conv over channel-mean || channel-max.

    Returns (sigmoid weight (B, H, W, 1), softmax map over H*W (B, H*W)).
    """

    def __init__(self, kernel: int = 7):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, kernel, padding=kernel // 2,
                               bias=False)

    def forward(self, x: torch.Tensor):
        pool = torch.stack([torch.mean(x, dim=-1), torch.amax(x, dim=-1)],
                           dim=1)                           # (B, 2, H, W)
        s = self.conv1(pool).permute(0, 2, 3, 1)            # (B, H, W, 1)
        weight = torch.sigmoid(s)
        attn_map = torch.softmax(s.reshape(s.shape[0], -1).float(), dim=-1)
        return weight, attn_map


class WindowAttention(nn.Module):
    """MHSA within non-overlapping ws x ws windows.

    Input/output NHWC with H, W divisible by ``ws``.
    """

    def __init__(self, dim: int, num_heads: int = 8, ws: int = 2,
                 qkv_bias: bool = True):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.ws = ws
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = self.ws
        b, h, w, c = x.shape
        if h % ws or w % ws:
            raise ValueError(f"({h}, {w}) not divisible by window {ws}")
        hg, wg = h // ws, w // ws
        nh = self.num_heads
        hd = self.dim // nh
        scale = hd ** -0.5

        t = x.reshape(b, hg, ws, wg, ws, c).transpose(2, 3)
        t = t.reshape(b, hg * wg, ws * ws, c)               # (B, G, N, C)
        qkv = self.qkv(t).reshape(b, hg * wg, ws * ws, 3, nh, hd)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).unbind(0)   # (B,G,h,N,hd)

        attn = matmul_f32(q, k.transpose(-1, -2)) * scale
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = matmul_f32(attn, v)                           # (B,G,h,N,hd)
        out = out.transpose(2, 3).reshape(b, hg * wg, ws * ws, self.dim)
        out = self.proj(out.to(x.dtype))

        out = out.reshape(b, hg, wg, ws, ws, self.dim).transpose(2, 3)
        return out.reshape(b, h, w, self.dim)


class GlobalSRA(nn.Module):
    """Global MHSA whose keys and values come from the input reduced by
    a strided ``sr`` conv (with bias) and a LayerNorm at ``sr_ratio >
    1`` (PVT's spatial reduction).  The LayerNorm's epsilon is Flax's
    1e-6, as in ``wseg_tpu``.  Input/output NHWC."""

    def __init__(self, dim: int, num_heads: int = 8, sr_ratio: int = 1,
                 qkv_bias: bool = True):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nh = self.num_heads
        scale = (self.dim // nh) ** -0.5
        q = self.q(x.reshape(b, h * w, c))
        if self.sr_ratio > 1:
            xr = self.sr(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
            xr = self.norm(xr)
        else:
            xr = x.reshape(b, h * w, c)
        k, v = self.kv(xr).chunk(2, dim=-1)
        q, k, v = _heads(q, nh), _heads(k, nh), _heads(v, nh)
        attn = matmul_f32(q, k.transpose(-1, -2)) * scale
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = matmul_f32(attn, v).transpose(1, 2).reshape(b, h * w, self.dim)
        out = self.proj(out.to(x.dtype))
        return out.reshape(b, h, w, self.dim)
