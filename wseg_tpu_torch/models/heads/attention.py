"""Attention modules of the CAM heads (NHWC at the surface).

Mirror of ``wseg_tpu/models/heads/attention.py``: CBAM-style
``ChannelAttention`` / ``SpatialAttention``; ``WindowAttention``,
multi-head self-attention within ws x ws windows, optionally with
talking heads (head-mixing matrices before and after the softmax), a
cross query (q and k from a second input, v from x), a projection to
another width, the softmax over the query axis and a per-call window
size; ``GlobalSRA``, global attention over spatially reduced keys and
values; ``GridAttention``, attention within a fixed g x g grid of large
windows.  The parameter layout follows the reference torch modules, so
state_dicts carry the reference names and shapes.  Attention logits,
the talking-heads mixing, the softmax and the attention-weighted sum
run in float32, under autocast too, as the JAX version's
``preferred_element_type=float32`` products and float32 mixers do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wseg_tpu_torch.models.backbones.common import _without_casts
from wseg_tpu_torch.ops.activations import relu


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 whatever the autocast state."""
    with torch.autocast(a.device.type, enabled=False):
        return torch.matmul(a.float(), b.float())


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(..., N, C) -> (..., heads, N, C / heads)."""
    *lead, n, c = t.shape
    return t.reshape(*lead, n, num_heads, c // num_heads).transpose(-2, -3)


def pad_to_multiple(x: torch.Tensor, mult_h: int, mult_w: int,
                    buggy_full_pad: bool = False):
    """Zero-pad NHWC bottom/right so H, W divide the window size.

    ``buggy_full_pad`` is tf_v6's pad (reference tf_v6.py:197-199, as
    ``wseg_tpu`` reproduces it): a whole extra window where the size
    already divides, and the H and W amounts swapped (the W-derived
    amount pads H)."""
    h, w = x.shape[1], x.shape[2]
    if buggy_full_pad:
        ph, pw = mult_h - w % mult_h, mult_w - h % mult_w
    else:
        ph, pw = (mult_h - h % mult_h) % mult_h, \
            (mult_w - w % mult_w) % mult_w
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


class TalkingMixer(nn.Linear):
    """A (heads, heads) head-mixing matrix of talking-heads attention, in
    torch ``Linear`` layout (out, in) without bias: ``forward`` mixes
    the heads axis (2) of (B, G, heads, N, M) float32 attention as
    ``einsum("bghnm,ih->bginm")``.  It stays float32 through a cast of
    the model (Flax never casts a bare ``self.param``) and mixes in
    float32 under autocast."""

    def __init__(self, heads: int):
        super().__init__(heads, heads, bias=False)

    def _apply(self, fn, recurse=True):
        return super()._apply(_without_casts(fn), recurse)

    def forward(self, attn: torch.Tensor) -> torch.Tensor:
        with torch.autocast(attn.device.type, enabled=False):
            return torch.einsum("bghnm,ih->bginm", attn.float(),
                                self.weight.float())


class WindowAttention(nn.Module):
    """MHSA within non-overlapping ws x ws windows.

    Input/output NHWC with H, W divisible by the window.  ``talking``
    adds ``pre_softmax_proj`` and ``post_softmax_proj``; ``cross`` takes
    q and k from ``query`` (NHWC, ``dim`` channels) through ``qk`` and v
    from x through ``v``; ``out_dim`` (0 = ``dim``) is the width
    of q, k, v and the output, and sets the scale; ``softmax_query_axis``
    normalises over the queries instead of the keys (tf_v10); ``ws`` of
    ``forward`` overrides the module's window (tf_v10 shares the weights
    across window sizes).
    """

    def __init__(self, dim: int, num_heads: int = 8, ws: int = 2,
                 qkv_bias: bool = True, talking: bool = False,
                 cross: bool = False, out_dim: int = 0,
                 softmax_query_axis: bool = False):
        super().__init__()
        self.dim = dim
        self.dim_out = out_dim or dim
        self.num_heads = num_heads
        self.ws = ws
        self.cross = cross
        self.softmax_query_axis = softmax_query_axis
        if cross:
            self.qk = nn.Linear(dim, 2 * self.dim_out, bias=qkv_bias)
            self.v = nn.Linear(dim, self.dim_out, bias=qkv_bias)
        else:
            self.qkv = nn.Linear(dim, 3 * self.dim_out, bias=qkv_bias)
        self.proj = nn.Linear(self.dim_out, self.dim_out)
        self.talking = talking
        if talking:
            self.pre_softmax_proj = TalkingMixer(num_heads)
            self.post_softmax_proj = TalkingMixer(num_heads)

    def forward(self, x: torch.Tensor, query: Optional[torch.Tensor] = None,
                ws: Optional[int] = None) -> torch.Tensor:
        ws = ws or self.ws
        b, h, w, c = x.shape
        if h % ws or w % ws:
            raise ValueError(f"({h}, {w}) not divisible by window {ws}")
        hg, wg = h // ws, w // ws
        nh, d = self.num_heads, self.dim_out
        hd = d // nh

        def windows(t):
            tc = t.shape[-1]
            t = t.reshape(b, hg, ws, wg, ws, tc).transpose(2, 3)
            return t.reshape(b, hg * wg, ws * ws, tc)       # (B, G, N, C)

        def heads(t):                                       # (B,G,h,N,hd)
            return t.reshape(b, hg * wg, ws * ws, nh, hd).transpose(2, 3)

        if self.cross:
            if query is None:
                raise ValueError("cross attention needs a query input")
            q, k = self.qk(windows(query)).chunk(2, dim=-1)
            v = self.v(windows(x))
        else:
            q, k, v = self.qkv(windows(x)).chunk(3, dim=-1)
        q, k, v = heads(q), heads(k), heads(v)

        attn = matmul_f32(q, k.transpose(-1, -2)) * hd ** -0.5
        if self.talking:
            attn = self.post_softmax_proj(torch.softmax(
                self.pre_softmax_proj(attn), dim=-1))
        else:
            attn = torch.softmax(attn,
                                 dim=-2 if self.softmax_query_axis else -1)
        out = matmul_f32(attn.to(v.dtype), v)               # (B,G,h,N,hd)
        out = out.transpose(2, 3).reshape(b, hg * wg, ws * ws, d)
        out = self.proj(out.to(x.dtype))

        out = out.reshape(b, hg, wg, ws, ws, d).transpose(2, 3)
        return out.reshape(b, h, w, d)


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


class GridAttention(nn.Module):
    """MHSA within a fixed g x g grid of large windows (H/g x W/g each;
    H and W must divide by g).  Input/output NHWC."""

    def __init__(self, dim: int, num_heads: int = 8, group_nums: int = 3,
                 qkv_bias: bool = True):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.group_nums = group_nums
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.group_nums
        b, h, w, c = x.shape
        if h % g or w % g:
            raise ValueError(f"({h}, {w}) not divisible by the {g} x {g} "
                             "grid")
        hd, wd = h // g, w // g
        nh = self.num_heads
        t = x.reshape(b, g, hd, g, wd, c).transpose(2, 3)
        t = t.reshape(b, g * g, hd * wd, c)
        q, k, v = (_heads(u, nh) for u in self.qkv(t).chunk(3, dim=-1))
        attn = matmul_f32(q, k.transpose(-1, -2)) * (c // nh) ** -0.5
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = matmul_f32(attn, v).transpose(2, 3).reshape(
            b, g * g, hd * wd, self.dim)
        out = self.proj(out.to(x.dtype))
        out = out.reshape(b, g, g, hd, wd, c).transpose(2, 3)
        return out.reshape(b, h, w, c)
