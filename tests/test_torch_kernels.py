"""The bilateral-message wrapper: CPU dispatch to the plain version, and
(marked ``gpu``) the CUDA kernel against it on the card.

Imports no JAX, so it also runs where JAX is missing:
``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch


def _bf16(rng, shape):
    return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(
        torch.bfloat16)


def test_cpu_tensors_use_the_plain_version():
    from wseg_tpu_torch.ops.crf_bilateral import (
        bilateral_message_cm,
        bilateral_message_cm_reference,
    )

    rng = np.random.RandomState(1)
    taps = [(-2, 3), (0, -1), (20, 0)]  # the last falls outside entirely
    q = torch.from_numpy(rng.rand(1, 3, 8, 10).astype(np.float32))
    w = _bf16(rng, (1, 3, 8, 10))
    before = bilateral_message_cm.launches
    got = bilateral_message_cm(q, w, taps)
    assert bilateral_message_cm.launches == before  # no kernel on CPU
    assert torch.equal(got, bilateral_message_cm_reference(q, w, taps))
    # the plain version is the zero-filled shifted sum, tap by tap
    want = np.zeros((1, 3, 8, 10), np.float32)
    qn, wn = q.numpy(), w.float().numpy()
    for k, (dy, dx) in enumerate(taps):
        for y in range(8):
            for x in range(10):
                if 0 <= y + dy < 8 and 0 <= x + dx < 10:
                    want[0, :, y, x] += wn[0, k, y, x] * qn[0, :, y + dy,
                                                            x + dx]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_bad_inputs():
    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm

    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.rand(1, 3, 8, 10).astype(np.float32))
    w = _bf16(rng, (1, 2, 8, 10))
    with pytest.raises(TypeError):
        bilateral_message_cm(q, w.float(), [(0, 1), (1, 0)])
    with pytest.raises(TypeError):
        bilateral_message_cm(q.double(), w, [(0, 1), (1, 0)])
    with pytest.raises(ValueError):
        bilateral_message_cm(q, w, [(0, 1)])
    with pytest.raises(ValueError):
        bilateral_message_cm(q[0], w, [(0, 1), (1, 0)])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,sxy", [((3, 21, 37, 53), 8.0),
                                       ((2, 1, 96, 128), 40.0),
                                       ((8, 21, 192, 256), 40.0)])
def test_kernel_matches_plain_on_card(shape, sxy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wseg_tpu_torch.ops.crf import _bilateral_taps
    from wseg_tpu_torch.ops.crf_bilateral import (
        bilateral_message_cm,
        bilateral_message_cm_reference,
    )

    b, c, h, w = shape
    taps = [(-dy, -dx) for dy, dx in _bilateral_taps(sxy, 2.0)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.rand((b, c, h, w), generator=gen, device="cuda")
    wt = torch.rand((b, len(taps), h, w), generator=gen,
                    device="cuda").to(torch.bfloat16)
    before = bilateral_message_cm.launches
    got = bilateral_message_cm(q, wt, taps)
    torch.cuda.synchronize()
    assert bilateral_message_cm.launches == before + 1
    want = bilateral_message_cm_reference(q, wt, taps)
    # same bf16 weights and f32 products; only the sum order differs
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-5, err


@pytest.mark.gpu
def test_postprocess_launches_twelve_kernels_on_card():
    """One fast-CRF postprocess call (coarse stage: norm + 9 iterations,
    refine stage: norm + 1) is 12 kernel launches, and its label maps
    match the same call on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from wseg_tpu_torch.engine.infer import make_device_postprocess
    from wseg_tpu_torch.ops.crf_bilateral import bilateral_message_cm

    rng = np.random.RandomState(3)
    s, h, w, c = 2, 96, 128, 21
    sums = torch.from_numpy(rng.rand(s, h, w, c).astype(np.float32) * 8)
    labels = np.zeros((s, c - 1), np.float32)
    labels[:, [3, 7]] = 1
    windows = np.asarray([[0, 0, 90, 120], [4, 8, 80, 100]], np.int32)
    imgs = torch.from_numpy((rng.rand(s, h, w, 3) * 255).astype(np.uint8))
    pp = make_device_postprocess((0.0,), (0.0,), crf_iters=10,
                                 crf_dtype="float32", crf_stride=2,
                                 crf_full_stride=2, crf_refine_iters=1)
    before = bilateral_message_cm.launches
    on_card = pp.dispatch_group(sums.cuda(), labels, windows, imgs.cuda(),
                                8).cpu()
    assert bilateral_message_cm.launches == before + 12
    on_cpu = pp.dispatch_group(sums, labels, windows, imgs, 8)
    assert float((on_card == on_cpu).float().mean()) >= 0.99
