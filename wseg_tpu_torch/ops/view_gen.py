"""Device-side multi-scale view generation (resize / flip / pad).

Mirror of ``wseg_tpu/ops/view_gen.py``: the original image is uploaded
once as uint8 and every scale/flip view is made on the device as two
cubic-resampling matrix products (rows, then columns), with PIL
``resize(..., BICUBIC)`` semantics: Keys kernel (a = -0.5), half-pixel
sampling over the source window, kernel support stretched by the
downscale factor, edge weights cropped to the window and renormalised.
Window parameters are tensors, so one code path serves every geometry.
"""

from __future__ import annotations

import torch


def _cubic_kernel(x: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    """Keys bicubic kernel (PIL BICUBIC, a=-0.5)."""
    ax = x.abs()
    near = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    far = a * (((ax - 5.0) * ax + 8.0) * ax - 4.0)
    return torch.where(ax <= 1.0, near,
                       torch.where(ax < 2.0, far, torch.zeros_like(ax)))


def cubic_matrix(dst_n: int, src_n: int, dst_start, dst_len, src_start,
                 src_len, flip=False, device=None) -> torch.Tensor:
    """(..., dst_n, src_n) cubic-resampling matrices.

    Maps the src window [src_start, src_start+src_len) onto the dst
    window [dst_start, dst_start+dst_len).  The window parameters and
    ``flip`` are numbers or tensors of broadcastable shape (...); rows
    outside the dst window and columns outside the src window get zero
    weight, so padding comes out 0.  ``flip`` mirrors the sampling in
    src coordinates.
    """
    def param(v, dtype=torch.float32):
        return torch.as_tensor(v, device=device).to(dtype)[..., None, None]

    ds, dl = param(dst_start), param(dst_len)
    ss, sl = param(src_start), param(src_len)
    flip = param(flip, torch.bool)
    dev = ds.device
    i = torch.arange(dst_n, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(src_n, dtype=torch.float32, device=dev)[None, :]
    y = (i - ds + 0.5) * (sl / dl) - 0.5
    y = torch.where(flip, sl - 1.0 - y, y)
    y = y + ss
    f = torch.clamp(dl / sl, max=1.0)
    w = _cubic_kernel((y - j) * f) * f
    inside = (j >= ss) & (j < ss + sl) & (i >= ds) & (i < ds + dl)
    w = torch.where(inside, w, torch.zeros_like(w))
    s = torch.sum(w, dim=-1, keepdim=True)
    return w / torch.clamp(s, min=1e-8)


def resize_window_cubic(img: torch.Tensor, src_win, dst_win, dst_hw,
                        flip=False) -> torch.Tensor:
    """Cubic-resample ``img``'s src window into a (dst_h, dst_w) canvas.

    Args:
      img: (..., Hs, Ws, C) source canvas.
      src_win / dst_win: (..., 4) (top, left, h, w).
      dst_hw: (dst_h, dst_w).
      flip: bool or (...) bool tensor — mirror within the window.
    Leading dims broadcast.  Returns (..., dst_h, dst_w, C) float32,
    zero outside the dst window.
    """
    hs, ws, c = img.shape[-3:]
    oh, ow = int(dst_hw[0]), int(dst_hw[1])
    dev = img.device
    src_win = torch.as_tensor(src_win, device=dev).float()
    dst_win = torch.as_tensor(dst_win, device=dev).float()
    A_h = cubic_matrix(oh, hs, dst_win[..., 0], dst_win[..., 2],
                       src_win[..., 0], src_win[..., 2], False, dev)
    A_w = cubic_matrix(ow, ws, dst_win[..., 1], dst_win[..., 3],
                       src_win[..., 1], src_win[..., 3], flip, dev)
    t = torch.matmul(A_h, img.float().flatten(-2))          # (..., oh, ws*c)
    t = t.unflatten(-1, (ws, c)).transpose(-3, -2)          # (..., ws, oh, c)
    out = torch.matmul(A_w, t.flatten(-2))                  # (..., ow, oh*c)
    return out.unflatten(-1, (oh, c)).transpose(-3, -2)     # (..., oh, ow, c)


def build_views_u8(orig_u8: torch.Tensor, owin: torch.Tensor,
                   vwin: torch.Tensor, *, out_hw, flip_pair: bool = True,
                   round_u8: bool = True) -> torch.Tensor:
    """uint8 original canvases -> one scale's view canvases.

    Args:
      orig_u8: (B, Hc, Wc, 3) uint8 originals, zero-padded into a canvas.
      owin: (B, 4) int original-pixel windows (top, left, h, w).
      vwin: (B, 4) int view windows inside the (out_h, out_w) canvas.
      out_hw: (out_h, out_w) view canvas.
      flip_pair: emit [view, flipped] per image (reference view order).
      round_u8: round each view to uint8 like PIL.
    Returns:
      (B*2 if flip_pair else B, out_h, out_w, 3) uint8 views, zeroed
      padding.
    """
    b = orig_u8.shape[0]
    flips = torch.tensor([False, True] if flip_pair else [False],
                         device=orig_u8.device)
    # the row pass is shared by both flips: broadcast over a flip axis
    v = resize_window_cubic(orig_u8[:, None], owin[:, None], vwin[:, None],
                            out_hw, flips[None, :])
    v = torch.clamp(v, 0.0, 255.0)
    if round_u8:
        v = torch.round(v)
    v = v.to(torch.uint8)
    return v.reshape(b * flips.numel(), *v.shape[2:])
