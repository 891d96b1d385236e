"""The int8 serving kernels (``csrc/qconv.cu`` through ``ops/qconv.py``).

On the CPU: the conv kernel's host plan covers every output pixel and
channel once within the kernel's shared-memory and TMA limits, at the
flagship bucket's 18 distinct convs, the two extra shapes of
``chip_smoke.py`` and ragged planes; the quantize kernel's division rule
(``x * RN(1/s)``, IEEE division near a half-integer) equals IEEE
division over every finite bfloat16 value at many scales.

On the card (marked ``gpu``): both kernels bit-equal to their plain
versions over strides, dilations, channel counts, ragged planes, both
activation modes and biases.  Imports no JAX, so it runs where JAX is
missing: ``python -m pytest tests/test_torch_qconv_kernels.py -m gpu
--noconftest``.
"""

import numpy as np
import pytest
import torch

from wseg_tpu_torch.ops import qconv as Q

# (B, cin, H, W, cout, k, stride, dilation): the flagship's 18 distinct
# quantized convs on one bucket (16 views of 384x512; WRN38 b2-b7)
FLAGSHIP = [
    (16, 64, 384, 512, 128, 1, 2, 1), (16, 64, 384, 512, 128, 3, 2, 1),
    (16, 128, 192, 256, 128, 3, 1, 1), (16, 128, 192, 256, 256, 1, 2, 1),
    (16, 128, 192, 256, 256, 3, 2, 1), (16, 256, 96, 128, 256, 3, 1, 1),
    (16, 256, 96, 128, 512, 1, 2, 1), (16, 256, 96, 128, 512, 3, 2, 1),
    (16, 512, 48, 64, 512, 3, 1, 1), (16, 512, 48, 64, 1024, 1, 1, 1),
    (16, 512, 48, 64, 1024, 3, 1, 2), (16, 1024, 48, 64, 512, 3, 1, 2),
    (16, 1024, 48, 64, 2048, 1, 1, 1), (16, 1024, 48, 64, 512, 1, 1, 1),
    (16, 512, 48, 64, 1024, 3, 1, 4), (16, 2048, 48, 64, 4096, 1, 1, 1),
    (16, 2048, 48, 64, 1024, 1, 1, 1), (16, 1024, 48, 64, 2048, 3, 1, 4),
]
# chip_smoke.py's QCONV_EXTRA: VGG16 fc6 at dilation 12, ResNet-50's
# stride-2 3x3
EXTRA = [(8, 512, 48, 64, 1024, 3, 1, 12), (8, 128, 192, 256, 128, 3, 2, 1)]
# ragged planes: host views of 375x500 and 960x1280, odd channel counts
RAGGED = [
    (1, 64, 375, 500, 128, 3, 2, 1), (1, 64, 960, 1280, 128, 1, 2, 1),
    (1, 1024, 120, 160, 2048, 3, 1, 4), (2, 512, 47, 63, 1024, 3, 1, 2),
    (3, 96, 7, 5, 130, 3, 1, 24), (1, 32, 3, 200, 8, 1, 1, 1),
    (1, 48, 300, 2, 72, 3, 2, 1), (2, 16, 33, 17, 63, 3, 1, 1),
]


@pytest.mark.parametrize("shape", FLAGSHIP + EXTRA + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_output_once(shape):
    b, cin, h, w, cout, k, stride, dil = shape
    pad = (k - 1) // 2 * dil
    cp = Q.padded_channels(cin)
    plan = Q.qconv_plan(h, w, cp, cout, k, k, stride, pad, dil)
    ho, wo = Q.out_size(h, k, stride, pad, dil), Q.out_size(w, k, stride,
                                                             pad, dil)
    # the kernel's limits (csrc/qconv.cu wseg_qconv_s8 checks the same)
    assert plan.bn in Q.TILE_N and plan.bk in (32, 64, 128)
    assert cp % plan.bk == 0
    assert plan.mh * plan.mw == Q.TILE_M and (plan.mh, plan.mw) in Q.PATCHES
    assert 4 <= plan.stages <= Q.MAX_STAGES
    assert plan.smem == Q.qconv_smem(plan.bn, plan.stages) <= Q.SMEM_LIMIT
    assert Q.qconv_smem(plan.bn, plan.stages + 1) > Q.SMEM_LIMIT or \
        plan.stages == Q.MAX_STAGES
    # TMA boxes: A (bk, mw*stride, mh*stride, 1), B (bk, bn), the store
    # (64, w, 64 // w, 1); element strides <= 8; swizzled inner boxes no
    # wider than their swizzle (bk bytes, 128 bytes of bf16)
    assert max(plan.mw * stride, plan.mh * stride, plan.bn) <= Q.TMA_BOX
    assert stride <= Q.TMA_ELEM_STRIDE
    assert (plan.bk * plan.mw * plan.mh) % 16 == 0
    # the N tiles split [0, Cout) once
    cols = np.zeros(-(-cout // plan.bn) * plan.bn, np.int32)
    for n0 in range(0, cout, plan.bn):
        cols[n0:n0 + plan.bn] += 1
    assert (cols == 1).all()
    # tiles in walk order, N fastest; the warpgroups' store boxes clipped
    # to the plane cover each output pixel of an image once
    tiles = list(Q.qconv_tiles(plan, b, ho, wo, cout))
    nt = -(-cout // plan.bn)
    assert len(tiles) == b * -(-ho // plan.mh) * -(-wo // plan.mw) * nt
    assert all(t[3] == (i % nt) * plan.bn for i, t in enumerate(tiles))
    seen = np.zeros((b, ho, wo), np.int32)
    for bi, ho0, wo0, n0 in tiles:
        if n0:
            continue
        for x0, y0, bw, bh in Q.qconv_store_boxes(plan, ho0, wo0):
            assert bw * bh == 64
            seen[bi, y0:y0 + bh, x0:x0 + bw] += 1
    assert (seen == 1).all()


def test_plan_picks_wide_tiles_for_wide_convs():
    # 128-channel convs take one 128-wide N tile, the 512-4096-channel
    # ones 256; the 48x64 planes fit 2 x 64 patches, 192x256 1 x 128
    p = Q.qconv_plan(192, 256, 128, 128, 3, 3, 1, 1, 1)
    assert (p.bn, p.bk, p.mh, p.mw, p.stages) == (128, 128, 1, 128, 6)
    p = Q.qconv_plan(48, 64, 1024, 2048, 3, 3, 1, 4, 4)
    assert (p.bn, p.mh, p.mw, p.stages) == (256, 2, 64, 4)
    p = Q.qconv_plan(384, 512, 64, 128, 1, 1, 2, 0, 1)
    assert (p.bk, p.mh, p.mw) == (64, 1, 128)
    assert Q.qconv_plan(7, 5, 96, 130, 3, 3, 1, 24, 24).bk == 32


def test_quantize_slots_keep_the_images_in_l2():
    # b2's 25 MB input images go one at a time, b3's 12.6 MB two, b5's
    # 6.3 MB four; static mode waits on nothing and takes every image
    assert Q.quantize_slots(16, 64, 384, 512, True) == 1
    assert Q.quantize_slots(16, 128, 192, 256, True) == 2
    assert Q.quantize_slots(16, 1024, 48, 64, True) == 4
    assert Q.quantize_slots(2, 16, 8, 8, True) == 2
    assert Q.quantize_slots(16, 64, 384, 512, False) == 16


def _finite_bf16() -> np.ndarray:
    bits = np.arange(1 << 16, dtype=np.uint32)
    bits = bits[((bits >> 7) & 0xFF) != 0xFF]  # drop inf and NaN
    return (bits << 16).view(np.float32)


def _kernel_codes(x: np.ndarray, s: np.float32) -> np.ndarray:
    """csrc/qconv.cu quant_code in float32: rint(x * RN(1/s)) unless the
    product lies within 2^-12 of a half-integer, then rint(RN(x / s));
    clipped to +-127."""
    with np.errstate(over="ignore", invalid="ignore"):  # x * inv = inf
        inv = np.float32(1.0) / s
        r = x * inv
        q = np.rint(r)
        near = np.abs(np.abs(r - q) - np.float32(0.5)) < \
            np.float32(2.0 ** -12)
        q = np.where(near, np.rint(x / s), q)
    return np.clip(q, -127, 127)


def _scales(kind: str) -> np.ndarray:
    rng = np.random.RandomState(7)
    if kind == "dynamic":
        # per-image scales of |x| maxima spread over bf16's exponents
        amax = np.abs(_finite_bf16()[rng.randint(0, 65280, 160)])
        amax = np.concatenate([amax, np.float32([0, 1, 448, 3.3895e38])])
        return Q.amax_scale(torch.from_numpy(amax)).numpy()
    if kind == "static":
        # calibrated per-channel scales, log-uniform over 1e-9..1e5
        return (10.0 ** rng.uniform(-9, 5, 160)).astype(np.float32)
    # awkward mantissas: 1 + k ulp and 2 - k ulp near powers of two
    base = np.float32(2.0) ** np.arange(-20, 20, 5).astype(np.float32)
    ulps = np.float32(1.0) + np.arange(-8, 9).astype(np.float32) * \
        np.float32(2.0 ** -23)
    return (base[:, None] * ulps[None, :]).ravel().astype(np.float32)


@pytest.mark.parametrize("kind", ["dynamic", "static", "mantissas"])
def test_division_rule_is_ieee_division(kind):
    x = _finite_bf16()
    xt = torch.from_numpy(x)
    for s in _scales(kind):
        s = np.float32(s)
        want = torch.clamp(torch.round(torch.div(
            xt, torch.full_like(xt, float(s)))), -127, 127).numpy()
        np.testing.assert_array_equal(_kernel_codes(x, s), want,
                                      err_msg=f"scale {s!r}")


def test_cpu_tensors_use_the_plain_versions():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 20, 6, 7).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(rng.randn(9, 20, 3, 3).astype(np.float32))
    before = (Q.quantize_act.launches, Q.qconv_s8.launches)
    xq, sx = Q.quantize_act(x)
    rxq, rsx = Q.quantize_act_reference(x)
    assert torch.equal(xq, rxq) and torch.equal(sx, rsx)
    wq, sw = Q.quantize_weight(w)
    y = Q.qconv_s8(xq, wq, sx, sw, None, 1, 1, 1)
    assert torch.equal(y, Q.qconv_s8_reference(xq, wq, sx, sw, None, 1, 1,
                                               1))
    assert (Q.quantize_act.launches, Q.qconv_s8.launches) == before


# ---- on the card ------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _act(rng, b, c, h, w, dev, layout="channels_last"):
    x = rng.randn(b, c, h, w).astype(np.float32)
    x *= (10.0 ** rng.uniform(-2, 2, (b, 1, 1, 1))).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).to(dev)
    if layout == "channels_last":
        return x.contiguous(memory_format=torch.channels_last)
    return x


# (B, cin, H, W, cout, k, stride, dilation, static, bias)
CONV_CASES = [
    (1, 32, 9, 11, 8, 1, 1, 1, False, False),
    (3, 64, 17, 23, 64, 3, 1, 1, True, True),
    (1, 96, 13, 29, 72, 3, 2, 1, False, True),
    (3, 256, 12, 20, 130, 3, 1, 2, True, False),
    (1, 256, 31, 9, 256, 3, 1, 4, False, False),
    (3, 64, 40, 70, 129, 3, 1, 12, False, True),
    (1, 128, 50, 50, 64, 3, 1, 24, True, True),
    (3, 64, 33, 65, 128, 1, 2, 1, False, False),
    (1, 256, 5, 3, 512, 1, 1, 1, True, False),
    (3, 32, 130, 3, 24, 3, 2, 1, False, True),
    (1, 512, 24, 32, 1024, 3, 1, 2, False, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_qconv_kernel_is_bit_equal(case):
    dev = _card()
    b, cin, h, w, cout, k, stride, dil, static, with_bias = case
    pad = (k - 1) // 2 * dil
    rng = np.random.RandomState(sum(case[:8]))
    x = _act(rng, b, cin, h, w, dev)
    wt = torch.from_numpy(rng.randn(cout, cin, k, k).astype(np.float32)).to(
        dev)
    bias = (torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dev)
            if with_bias else None)
    sc = (Q.amax_scale(x.float().abs().amax(dim=(0, 2, 3)) * 0.8)
          if static else None)
    wq, sw = Q.quantize_weight(wt, sc)
    xq, sx = Q.quantize_act(x, sc)
    before = Q.qconv_s8.launches
    acc = Q.qconv_s8(xq, wq, sx, sw, bias, stride, pad, dil, acc_only=True)
    racc = Q.qconv_acc_reference(xq, wq, stride, pad, dil)
    torch.cuda.synchronize()
    assert torch.equal(acc, racc), (acc.long() - racc.long()).abs().max()
    y = Q.qconv_s8(xq, wq, sx, sw, bias, stride, pad, dil)
    ry = Q.dequantize_reference(racc, sx, sw, bias)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, ry)
    assert torch.equal(Q.qconv_s8(xq, wq, sx, sw, bias, stride, pad, dil), y)
    assert Q.qconv_s8.launches == before + 3


# (B, C, H, W, static, layout); dynamic channels_last runs stage in
# shared memory with two buffers (small images), one (2 x 64 x 384 x
# 512) or none (a 960 x 1280 host view: the L2 path)
QUANT_CASES = [
    (3, 64, 17, 23, False, "channels_last"),
    (2, 64, 384, 512, False, "channels_last"),
    (1, 64, 960, 1280, False, "channels_last"),
    (3, 64, 17, 23, True, "channels_last"),
    (2, 40, 9, 31, False, "channels_last"),
    (2, 40, 9, 31, True, "channels_last"),
    (3, 96, 12, 10, False, "channels_last"),  # 6 groups: (pixel, group)
    (2, 96, 9, 7, True, "channels_last"),     # items, not a fixed group
    (3, 48, 11, 13, False, "nchw"),
    (2, 256, 6, 5, True, "nchw"),
    (4, 96, 8, 8, False, "unaligned"),
    (2, 1024, 48, 64, False, "channels_last"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", QUANT_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_quantize_kernel_is_bit_equal(case):
    dev = _card()
    b, c, h, w, static, layout = case
    rng = np.random.RandomState(b * c + h)
    x = _act(rng, b, c, h, w, dev, layout)
    if layout == "unaligned":
        # a channels_last view one element into its storage
        flat = torch.empty(b * c * h * w + 1, dtype=torch.bfloat16,
                           device=dev)
        x = flat[1:].view(b, h, w, c).copy_(x.permute(0, 2, 3, 1)).permute(
            0, 3, 1, 2)
    t = b - 1  # the image that gets values at rounding ties
    if b > 1:
        x[0].zero_()  # an all-zero image: the 1e-12 floor
    x[t, 0, 1, 1] = 2 * x[t].float().abs().max()  # image t's |x| max
    sc = (Q.amax_scale(x.float().abs().amax(dim=(0, 2, 3)) * 0.7)
          if static else None)
    # values at (k + 0.5) * s (to bf16), either sign, in image t
    st = (sc if static else Q.quantize_act_reference(x)[1][t].expand(c))
    k = torch.arange(c, device=dev) % 120
    sign = 1.0 - 2.0 * (torch.arange(c, device=dev) % 2)
    x[t, :, 0, 0] = (sign * (k + 0.5) * st.to(dev)).to(torch.bfloat16)
    before = Q.quantize_act.launches
    xq, sx = Q.quantize_act(x, sc)
    rxq, rsx = Q.quantize_act_reference(x, sc)
    torch.cuda.synchronize()
    assert Q.quantize_act.launches == before + 1
    assert torch.equal(xq, rxq), (xq.int() - rxq.int()).abs().max()
    assert (sx is None) == static and (rsx is None) == static
    if not static:
        assert torch.equal(sx, rsx)
    xq2, _ = Q.quantize_act(x, sc)
    assert torch.equal(xq2, xq)
