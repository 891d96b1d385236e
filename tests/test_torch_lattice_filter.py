"""The exact CRF's filter as one call: the splat's split table, the
chunked splat, the all-axes blur and the whole filter, against their
plain versions and the JAX package.

CPU cases: the split table covers every CSR entry once, in order, in
chunks of at most ``SPLAT_CHUNK`` (empty rows and a 1,086-entry row
included), and the tables' CSR row pointers are the host build's; the
chunked plain splat against the dense float64 S'^T q and the row-order
plain splat; the all-axes plain blur bit-equal to the per-axis chain;
the port's filter against ``wseg_tpu.ops.crf_mm.mm_filter`` (Pallas in
interpret mode, bf16 weights: 3e-4) and against
``wseg_tpu.ops.crf_lattice.lattice_filter`` (float32: 1e-5); CPU
dispatch and the refusal of other devices.  The ``gpu`` cases hold the
kernels against the plain versions on the card, on a lattice with a
row of more than 1,000 entries; JAX is imported inside the CPU cases
only, so ``python -m pytest tests/test_torch_lattice_filter.py -m gpu
--noconftest`` runs there.
"""

import numpy as np
import pytest
import torch

LONG_ROW = 1086  # the longest bilateral CSR row of a photo-like VOC image


def _flat_image(rng, h, w):
    """A flat-colour image with a noisy band: the flat part maps many
    pixels onto few bilateral vertices (rows of > 1,000 entries at 48x64),
    the band gives short rows."""
    img = np.full((h, w, 3), (90, 140, 200), np.uint8)
    band = slice(h // 2, h // 2 + max(h // 8, 1))
    img[band] = rng.randint(0, 256, img[band].shape)
    return img


def _features(kind, h, w, seed=0):
    from wseg_tpu_torch.ops.crf_lattice import (
        bilateral_features,
        gaussian_features,
    )

    if kind == "bilateral":
        img = _flat_image(np.random.RandomState(seed), h, w)
        return bilateral_features(img, 80.0, 13.0)
    return gaussian_features((h, w), 3.0)


def _tables(kind, h, w, canvas=None, seed=0):
    """The CPU lattice tables of a flat-colour image (bilateral) or of
    its grid (Gaussian), alone or at (1, 2) in a padded canvas."""
    from wseg_tpu_torch.ops.crf_exact import build_exact_lattice

    feats = _features(kind, h, w, seed)
    if canvas is None:
        return build_exact_lattice(feats)
    hc, wc = canvas
    valid = np.zeros((hc, wc), bool)
    valid[1:1 + h, 2:2 + w] = True
    return build_exact_lattice(feats, hc * wc, valid.reshape(-1))


def _bilateral_tables(h, w, canvas=None, seed=0):
    return _tables("bilateral", h, w, canvas, seed)


def _row_ptr_cases():
    from wseg_tpu_torch.ops.crf_lattice import SPLAT_CHUNK as K

    rng = np.random.RandomState(3)
    lens = rng.randint(0, 150, 40)
    lens[[0, 7, 39]] = 0                      # empty rows, first and last
    lens[20] = LONG_ROW                       # one flat-colour row
    cases = {"random rows": lens, "no rows": [], "one long row": [LONG_ROW],
             "rows of one chunk": [K] * 5,
             "rows of a chunk and one": [K + 1] * 5,
             "empty rows only": [0] * 6, "rows of one entry": [1] * 9,
             "long rows back to back": [LONG_ROW, 3 * K, LONG_ROW]}
    return {key: np.concatenate([[0], np.cumsum(np.asarray(v, np.int64))])
            for key, v in cases.items()}


@pytest.mark.parametrize("case", list(_row_ptr_cases()))
def test_split_table_covers_every_entry_once_in_order(case):
    from wseg_tpu_torch.ops.crf_lattice import SPLAT_CHUNK as k
    from wseg_tpu_torch.ops.crf_lattice import split_table

    row_ptr = _row_ptr_cases()[case]
    m, e = row_ptr.size - 1, int(row_ptr[-1])
    chunk_ptr, chunk_row, splits = split_table(row_ptr)
    assert chunk_ptr.dtype == chunk_row.dtype == splits.dtype == np.int32
    assert chunk_ptr.size == chunk_row.size + 1
    assert chunk_ptr[0] == 0 and chunk_ptr[-1] == e
    lens = np.diff(chunk_ptr)
    assert (lens >= 0).all() and (lens <= k).all()
    # every entry once, in order, in a chunk of its own row
    owner = np.repeat(chunk_row, lens)
    np.testing.assert_array_equal(
        owner, np.repeat(np.arange(m), np.diff(row_ptr)))
    # every row and the zero slot m have a chunk; rows in order
    np.testing.assert_array_equal(np.unique(chunk_row), np.arange(m + 1))
    assert (np.diff(chunk_row) >= 0).all()
    assert chunk_row[-1] == m and lens[-1] == 0
    # a row is split iff it has several chunks; splits name their ranges
    n_ch = np.bincount(chunk_row, minlength=m + 1)
    want = np.flatnonzero(n_ch > 1)
    np.testing.assert_array_equal(chunk_row[splits[:, 0]], want)
    np.testing.assert_array_equal(splits[:, 1] - splits[:, 0], n_ch[want])
    assert (chunk_row[splits[:, 1] - 1] == want).all()
    np.testing.assert_array_equal(
        n_ch[:m], np.maximum(1, -(-np.diff(row_ptr) // k)))


@pytest.mark.parametrize("kind", ["bilateral", "gaussian"])
def test_tables_row_ptr_is_the_host_csr(kind):
    """The tables keep the split table, not the CSR row pointers; those
    come back from it as the host build gave them."""
    from wseg_tpu_torch.ops.crf_lattice import split_table
    from wseg_tpu_torch.ops.crf_native import build_lattice_tables

    feats = _features(kind, 24, 32)
    host = build_lattice_tables(feats, None)
    tables = _tables(kind, 24, 32)
    np.testing.assert_array_equal(tables.row_ptr.numpy(), host.row_ptr)
    for got, want in zip((tables.chunk_ptr, tables.chunk_row, tables.splits),
                         split_table(host.row_ptr)):
        np.testing.assert_array_equal(got.numpy(), want)
    meta = tables.to("meta")
    assert meta.m == tables.m
    assert all(t.device.type == "meta" for t in meta[:-1])


def _dense_splat(tables):
    """S (Np, m+1) float64 from the pixel-major table."""
    ids, w = tables.ids.numpy(), tables.w.numpy().astype(np.float64)
    s = np.zeros((ids.shape[0], tables.m + 1))
    np.add.at(s, (np.repeat(np.arange(ids.shape[0]), ids.shape[1]),
                  ids.reshape(-1)), w.reshape(-1))
    return s


@pytest.mark.parametrize("c", [1, 21])
@pytest.mark.parametrize("lattice", ["bilateral", "bilateral on a canvas",
                                     "gaussian on a canvas"])
def test_chunked_plain_splat_matches_dense_and_row_order(lattice, c):
    """The chunked plain splat equals the dense float64 S'^T q and the
    row-order plain splat within 1e-5 relative; the zero slot is 0.  The
    bilateral lattices have rows of > 1,000 entries (split into up to 34
    chunks)."""
    from wseg_tpu_torch.ops import crf_lattice_cuda as k_

    kind = lattice.split()[0]
    tables = _tables(kind, 48, 64,
                     canvas=(52, 68) if "canvas" in lattice else None)
    if kind == "bilateral":
        assert int(torch.diff(tables.row_ptr).max()) > 1000
        assert tables.splits.shape[0] > 0
    rng = np.random.RandomState(c)
    q = torch.from_numpy(rng.rand(tables.ids.shape[0], c).astype(np.float32))
    got = k_.lattice_splat_split_reference(
        tables.chunk_ptr, tables.chunk_row, tables.entries, tables.w_csr, q,
        tables.d1)
    assert got.shape == (tables.m + 1, c)
    assert (got[-1] == 0).all()
    dense = _dense_splat(tables).T @ q.numpy().astype(np.float64)
    rows = k_.lattice_splat_reference(tables.row_ptr, tables.entries,
                                      tables.w_csr, q, tables.d1)
    scale = np.abs(dense).max()
    assert np.abs(got.numpy() - dense).max() / scale <= 1e-5
    assert float((got - rows).abs().max()) / scale <= 1e-5
    # the wrapper on CPU tensors is this plain version
    assert torch.equal(k_.lattice_splat(tables, tables.w_csr, q), got)


@pytest.mark.parametrize("kind", ["bilateral", "gaussian"])
def test_blur_axes_plain_is_the_per_axis_chain_bit_for_bit(kind):
    from wseg_tpu_torch.ops import crf_lattice_cuda as k
    from wseg_tpu_torch.ops.crf_exact import build_exact_lattice
    from wseg_tpu_torch.ops.crf_lattice import gaussian_features

    if kind == "bilateral":
        tables = _bilateral_tables(40, 48)
    else:
        tables = build_exact_lattice(gaussian_features((40, 48), 3.0))
    rng = np.random.RandomState(1)
    lat = torch.from_numpy(rng.randn(tables.m + 1, 21).astype(np.float32))
    lat[-1] = 0
    chain = lat
    for j in range(tables.d1):
        chain = k.lattice_blur_reference(chain, tables.nbr[j])
    assert torch.equal(k.lattice_blur_axes_reference(lat, tables.nbr), chain)
    assert torch.equal(k.lattice_blur(lat, tables.nbr), chain)
    assert torch.equal(k.lattice_blur(lat, tables.nbr[0]),
                       k.lattice_blur_reference(lat, tables.nbr[0]))


@pytest.mark.parametrize("d", [2, 5])
def test_filter_matches_the_jax_mm_filter(d):
    """The port's filter against the JAX serving filter
    ``crf_mm.mm_filter`` with its Pallas kernels in interpret mode,
    values packed by ``pack3`` as tests/test_crf_mm.py runs it: 3e-4
    (the JAX path's bf16 weights)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from wseg_tpu.ops.crf_mm import build_mm_lattice, gen_oh, mm_filter, pack3
    from wseg_tpu_torch.ops.crf_exact import build_exact_lattice
    from wseg_tpu_torch.ops.crf_lattice import lattice_filter

    rng = np.random.RandomState(d)
    n, c = 256, 5  # interpret mode: ~40 s at d = 5
    feats = rng.rand(n, d).astype(np.float32) * 6.0
    vals = rng.rand(n, c).astype(np.float32) + 0.1
    mm = build_mm_lattice(feats, K=64, R0=128, Km=64, blk_quantum=16)
    with pltpu.force_tpu_interpret_mode():
        oh = gen_oh(mm)
        want = np.asarray(mm_filter(pack3(jnp.asarray(vals)), mm, oh, c))[:n]
    tables = build_exact_lattice(feats)
    got = lattice_filter(torch.from_numpy(vals), tables).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_matches_the_jax_lattice_filter(seed):
    """On a flat-colour image's bilateral lattice (rows of > 1,000
    entries) embedded in a padded canvas: the port's filter against the
    JAX package's float32 ``crf_lattice.lattice_filter`` on the real
    pixels within 1e-5 relative, padded pixels 0."""
    import jax.numpy as jnp

    from wseg_tpu.ops.crf_lattice import build_tables_host
    from wseg_tpu.ops.crf_lattice import lattice_filter as jax_filter
    from wseg_tpu_torch.ops.crf_lattice import (
        bilateral_features,
        lattice_filter,
    )

    h, w, hc, wc = 48, 64, 52, 68
    tables = _bilateral_tables(h, w, canvas=(hc, wc), seed=seed)
    assert int(torch.diff(tables.row_ptr).max()) > 1000
    feats = bilateral_features(
        _flat_image(np.random.RandomState(seed), h, w), 80.0, 13.0)
    rng = np.random.RandomState(10 + seed)
    vals = rng.rand(h * w, 21).astype(np.float32)
    canvas = np.full((hc, wc, 21), 5.0, np.float32)
    canvas[1:1 + h, 2:2 + w] = vals.reshape(h, w, 21)
    got = lattice_filter(torch.from_numpy(canvas.reshape(-1, 21)),
                         tables).numpy().reshape(hc, wc, 21)
    want = np.asarray(jax_filter(jnp.asarray(vals), build_tables_host(
        feats, quantum=256))).reshape(h, w, 21)
    err = np.abs(got[1:1 + h, 2:2 + w] - want).max() / np.abs(want).max()
    assert err <= 1e-5, err
    inside = np.zeros((hc, wc), bool)
    inside[1:1 + h, 2:2 + w] = True
    assert (got[~inside] == 0).all()


def test_filter_on_cpu_is_the_plain_filter_and_counts_nothing():
    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    tables = _bilateral_tables(24, 32)
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.rand(tables.ids.shape[0], 3).astype(np.float32))
    wn_pix = tables.w * 0.5
    wn_csr = tables.w_csr * 0.5
    counted = (k.lattice_weights, k.lattice_splat, k.lattice_blur,
               k.lattice_slice)
    before = [f.launches for f in counted]
    got = k.lattice_filter_cuda(q, tables, wn_pix, wn_csr)
    assert [f.launches for f in counted] == before
    want = k.lattice_slice_reference(
        k.lattice_blur_axes_reference(
            k.lattice_splat_split_reference(
                tables.chunk_ptr, tables.chunk_row, tables.entries, wn_csr,
                q, tables.d1), tables.nbr), tables.ids, wn_pix, tables.alpha)
    assert torch.equal(got, want)
    assert torch.equal(got, k.lattice_filter_reference(q, tables, wn_pix,
                                                       wn_csr))


def test_new_wrappers_refuse_other_devices_and_bad_shapes():
    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    tables = _bilateral_tables(16, 20)
    meta = tables.to("meta")
    n_pix = tables.ids.shape[0]
    ones = torch.ones((n_pix, 1), device="meta")
    lat = torch.ones((meta.m + 1, 4), device="meta")
    for call in (lambda: k.lattice_splat(meta, meta.w_csr, ones),
                 lambda: k.lattice_blur(lat, meta.nbr),
                 lambda: k.lattice_filter_cuda(ones, meta, meta.w,
                                               meta.w_csr)):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
    q = torch.ones((n_pix, 2))
    with pytest.raises(ValueError, match="lattice_filter"):
        k.lattice_filter_cuda(q, tables, tables.w[:-1], tables.w_csr)
    with pytest.raises(ValueError, match="1 to 32 channels"):
        k.lattice_filter_cuda(torch.ones((n_pix, 33)), tables, tables.w,
                              tables.w_csr)
    with pytest.raises(ValueError, match="lattice_blur"):
        k.lattice_blur(torch.ones((tables.m, 4)), tables.nbr)
    with pytest.raises(TypeError, match="int32"):
        k.lattice_splat(tables._replace(chunk_row=tables.chunk_row.long()),
                        tables.w_csr, q)


# ------------------------------------------------------------ the card
def _card_tables(kind):
    """A 96x128 canvas: the bilateral lattice of a flat-colour image (a
    row of > 1,000 entries) or the Gaussian lattice, on the card."""
    tables = _tables(kind, 90, 120, canvas=(96, 128))
    if kind == "bilateral":
        assert int(torch.diff(tables.row_ptr).max()) >= 1000
    return tables.to("cuda")


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bilateral", "gaussian"])
def test_new_kernels_match_plain_on_card(kind):
    """Split splat (C = 21 and the norm's C = 1), all-axes blur and the
    one-call filter against their plain versions on the same card
    tensors: 1e-5 relative, the blur bit-equal to the per-axis chain;
    one launch of each kernel per call, one blur per filter; two runs
    bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    tables = _card_tables(kind)
    gen = torch.Generator(device="cuda").manual_seed(7)
    n_pix = tables.ids.shape[0]
    for c in (21, 1):
        q = torch.rand((n_pix, c), generator=gen, device="cuda")
        before = k.lattice_splat.launches
        lat = k.lattice_splat(tables, tables.w_csr, q)
        torch.cuda.synchronize()
        assert k.lattice_splat.launches == before + 1
        want = k.lattice_splat_split_reference(
            tables.chunk_ptr, tables.chunk_row, tables.entries, tables.w_csr,
            q, tables.d1)
        assert _rel(lat, want) <= 1e-5
        assert (lat[-1] == 0).all()
        assert torch.equal(lat, k.lattice_splat(tables, tables.w_csr, q))

    lat = torch.rand((tables.m + 1, 21), generator=gen, device="cuda")
    before = k.lattice_blur.launches
    got = k.lattice_blur(lat, tables.nbr)
    torch.cuda.synchronize()
    assert k.lattice_blur.launches == before + 1
    chain = lat
    for j in range(tables.d1):
        chain = k.lattice_blur_reference(chain, tables.nbr[j])
    assert torch.equal(got, chain)

    q = torch.rand((n_pix, 21), generator=gen, device="cuda")
    counted = (k.lattice_splat, k.lattice_blur, k.lattice_slice)
    before = [f.launches for f in counted]
    out = k.lattice_filter_cuda(q, tables, tables.w, tables.w_csr)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counted, before)] == [1, 1, 1]
    want = k.lattice_filter_reference(q, tables, tables.w, tables.w_csr)
    assert _rel(out, want) <= 1e-5
    assert torch.equal(out, k.lattice_filter_cuda(q, tables, tables.w,
                                                  tables.w_csr))


@pytest.mark.gpu
def test_refused_cooperative_launch_raises_on_card():
    """A grid the card cannot hold co-resident is refused and raises
    through the wrappers' launch path (the C entries take the grid; the
    wrappers pass 0, as many blocks as fit); the refusal leaves no error
    behind for the next launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    tables = _card_tables("bilateral")
    n_pix, c, m, d1 = tables.ids.shape[0], 21, tables.m, tables.d1
    q = torch.rand((n_pix, c), device="cuda")
    lat = torch.rand((m + 1, c), device="cuda")
    out = torch.empty((2, m + 1, c), device="cuda")
    part = torch.empty((tables.chunk_row.numel(), c), device="cuda")
    lib, too_many = k._library(), 1 << 20
    with pytest.raises(RuntimeError, match="lattice_blur kernel launch"):
        k._launch(lib.wseg_lattice_blur, "lattice_blur", lat.device,
                  lat.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                  tables.nbr.data_ptr(), m, c, d1, too_many)
    with pytest.raises(RuntimeError, match="lattice_splat kernel launch"):
        k._launch(lib.wseg_lattice_splat, "lattice_splat", q.device,
                  tables.chunk_ptr.data_ptr(), tables.chunk_row.data_ptr(),
                  tables.splits.data_ptr(), tables.chunk_row.numel(),
                  tables.splits.shape[0], tables.entries.data_ptr(),
                  tables.w_csr.data_ptr(), q.data_ptr(), c, d1,
                  out[0].data_ptr(), part.data_ptr(), too_many)
    out = k.lattice_filter_cuda(q, tables, tables.w, tables.w_csr)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


def _slice_inputs(n_pix, d1, c, m, seed):
    """A lattice (m+1, C) with a zero row m, and a pixel table of n_pix
    rows: random vertex ids and weights, every seventh pixel padded (all
    slots on row m, weight 0), some real pixels with a slot on row m."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lat = torch.rand((m + 1, c), generator=gen, device="cuda")
    lat[m] = 0
    ids = torch.randint(0, m, (n_pix, d1), generator=gen, device="cuda",
                        dtype=torch.int32)
    wn = torch.rand((n_pix, d1), generator=gen, device="cuda")
    ids[::7] = m
    wn[::7] = 0
    ids[3::11, -1] = m
    return lat, ids, wn


@pytest.mark.gpu
@pytest.mark.parametrize("d1", [3, 6])
@pytest.mark.parametrize("c", [1, 7, 21, 33])
def test_slice_kernel_matches_plain_on_card(d1, c):
    """d+1 of 3 and 6; C of 1, 21, 7 and 33 (not multiples of 4, one
    above a warp); 1,013 pixels (not a multiple of a block's pixels),
    padded pixels: within 1e-5 of the plain version, padded pixels 0,
    two runs bit-equal, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    lat, ids, wn = _slice_inputs(1013, d1, c, 300, d1 * 100 + c)
    before = k.lattice_slice.launches
    got = k.lattice_slice(lat, ids, wn, 0.75)
    again = k.lattice_slice(lat, ids, wn, 0.75)
    want = k.lattice_slice_reference(lat, ids, wn, 0.75)
    torch.cuda.synchronize()
    assert k.lattice_slice.launches == before + 2
    assert got.shape == (1013, c)
    assert torch.equal(got, again)
    assert _rel(got, want) <= 1e-5
    assert (got[::7] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 21])
def test_slice_kernel_takes_row_m_as_zero_on_card(c):
    """The zero-row condition ``lattice_slice`` states: with a non-zero
    row m, the kernel gives what the plain version gives on the same
    lattice with row m set to zero (padded pixels 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    lat, ids, wn = _slice_inputs(1013, 6, c, 300, 7 + c)
    lat[300] = 1.0 + torch.rand(c, device="cuda")
    wn[::7] = 1.0
    got = k.lattice_slice(lat, ids, wn, 0.75)
    zeroed = lat.clone()
    zeroed[300] = 0
    want = k.lattice_slice_reference(zeroed, ids, wn, 0.75)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5
    assert (got[::7] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bilateral", "gaussian"])
@pytest.mark.parametrize("c", [1, 7, 21])
def test_filter_slices_with_the_new_kernel_on_card(kind, c):
    """The one-call filter on a 97x129 canvas (12,513 pixels, padded
    border): its slice is the kernel the step call launches, bit-equal;
    within 1e-5 of the plain filter; padded pixels 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    tables = _tables(kind, 90, 120, canvas=(97, 129)).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(c)
    q = torch.rand((tables.ids.shape[0], c), generator=gen, device="cuda")
    before = k.lattice_slice.launches
    out = k.lattice_filter_cuda(q, tables, tables.w, tables.w_csr)
    lat = k.lattice_blur(k.lattice_splat(tables, tables.w_csr, q),
                         tables.nbr)
    steps = k.lattice_slice(lat, tables.ids, tables.w, tables.alpha)
    want = k.lattice_filter_reference(q, tables, tables.w, tables.w_csr)
    torch.cuda.synchronize()
    assert k.lattice_slice.launches == before + 2
    assert torch.equal(out, steps)
    assert _rel(out, want) <= 1e-5
    padded = (tables.ids == tables.m).all(1)
    assert padded.any() and (out[padded] == 0).all()


@pytest.mark.gpu
def test_slice_kernel_refuses_more_slots_than_its_instances():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from wseg_tpu_torch.ops import crf_lattice_cuda as k

    lat, ids, wn = _slice_inputs(64, 9, 4, 50, 0)
    with pytest.raises(ValueError, match="1 to 8"):
        k.lattice_slice(lat, ids, wn, 1.0)
