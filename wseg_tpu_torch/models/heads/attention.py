"""Attention modules of the CAM_CASA_WGAP_tf head (NHWC at the surface).

Mirror of ``wseg_tpu/models/heads/attention.py`` for the flagship:
CBAM-style ``ChannelAttention`` / ``SpatialAttention`` and the windowed
multi-head self-attention (no talking heads, no cross query).  The
parameter layout follows the reference torch modules, so state_dicts
carry the reference names and shapes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
            return F.linear(F.relu(F.linear(v, w1)), w2)

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

    Input/output NHWC with H, W divisible by ``ws``.  Attention logits,
    softmax and the attention-weighted sum run in float32, as the JAX
    version's ``preferred_element_type=float32`` products do.
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

        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn.float(), v.float())         # (B,G,h,N,hd)
        out = out.transpose(2, 3).reshape(b, hg * wg, ws * ws, self.dim)
        out = self.proj(out.to(x.dtype))

        out = out.reshape(b, hg, wg, ws, ws, self.dim).transpose(2, 3)
        return out.reshape(b, h, w, self.dim)
