"""Port parity, operand slicing: the plain version of the slicing kernel
(`slicemm.slice_operand_plain`, csrc/slicing.cu on the card) and of its
pair mode (`slicemm.slice_pair_operand_plain`: K10's window, and K11)
against the JAX reference's `precision._pow2_row_scales` and
`precision._int_slices` on the same numpy inputs, and the layout, tile
walks and k-piece plan that the wgmma tile of K1, K2, K4, K7, K8, K10 and
K12 reads, emulated tile by tile against the plain versions.  The CUDA kernels are held to these
plain versions bit for bit on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from andvaranaut_tpu.gp import precision as jprecision
from andvaranaut_torch.gp import panel, precision, slicemm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs in parallel
    workers, and a multi-threaded intra-op pool in each oversubscribes
    the cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _untile(tiled, rows_p, kp):
    """(rows_p / 64, kp / 32, ns, 2048) -> (ns, rows_p, kp), the inverse
    of `slicemm.tile_layout` written from its byte formula."""
    nrt, nkc, ns, _ = tiled.shape
    r = np.arange(rows_p)[:, None]
    b = np.arange(kp)[None, :]
    off = ((r % 64 // 8) * 2 + (b % 32) // 16) * 128 + (r % 8) * 16 + b % 16
    t = tiled.numpy()
    return np.stack([t[r // 64, b // 32, s, off] for s in range(ns)])


def _reference(M, axis, ns):
    """JAX's scales and slices of M's rows (axis 1) or columns (axis 0),
    the slices in row layout of the sliced dimension."""
    Mj = jnp.asarray(M)
    sc = jprecision._pow2_row_scales(Mj, axis)
    sl = np.stack([np.asarray(c) for c in jprecision._int_slices(Mj / sc,
                                                                 ns)])
    sc = np.asarray(sc).reshape(-1)
    return sc, (sl if axis == 1 else sl.transpose(0, 2, 1))


def _operand(rows, k, seed, zero_rows=(), carry_rows=()):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, k)) * np.exp2(
        rng.integers(-30, 30, size=(rows, 1)))
    for r in zero_rows:
        X[r] = 0.0
    for r in carry_rows:
        # the row maximum rounds up to the next power of two in f32
        X[r] = rng.uniform(-0.5, 0.5, size=k) * 2.0 ** (r % 7)
        X[r, r % k] = 2.0 ** (r % 7) * (1 - 2.0 ** -30)
    return X


CASES = [
    # rows, k, transposed layout, nslices, zero rows, f32-carry rows
    (64, 32, False, 6, (), ()),
    (37, 33, False, 6, (3,), (5,)),
    (100, 1000, False, 8, (0, 99), (7, 50)),
    (130, 70, True, 6, (1,), (4, 129)),
    (65, 129, True, 8, (64,), (2,)),
    (1, 1, False, 8, (), ()),
]


@pytest.mark.parametrize("rows,k,trans,ns,zero,carry", CASES)
def test_slice_operand_plain_matches_reference(rows, k, trans, ns, zero,
                                               carry):
    X = _operand(rows, k, seed=rows + k, zero_rows=zero, carry_rows=carry)
    if trans:
        # X is the transpose of a (k, rows) matrix B: column scales of B
        B = np.ascontiguousarray(X.T)
        Xt = torch.as_tensor(B).T
        sc_ref, sl_ref = _reference(B, 0, ns)
    else:
        Xt = torch.as_tensor(X)
        sc_ref, sl_ref = _reference(X, 1, ns)
    rows_p = -(-rows // 64) * 64
    kp = -(-k // 32) * 32
    tiled, sc = slicemm.slice_operand(Xt, ns)
    assert tiled.dtype == torch.int8
    assert tuple(tiled.shape) == (rows_p // 64, kp // 32, ns, 2048)
    np.testing.assert_array_equal(sc.numpy(), sc_ref)
    planes = _untile(tiled, rows_p, kp)
    np.testing.assert_array_equal(planes[:, :rows, :k], sl_ref)
    assert not planes[:, rows:].any() and not planes[:, :, k:].any()


def test_f32_carry_scale_differs_from_frexp():
    """A row whose maximum rounds up to a power of two in f32 takes the
    next scale, as the reference does (frexp on the f64 maximum would
    not)."""
    X = np.full((1, 4), 0.25)
    X[0, 0] = 1 - 2.0 ** -30
    _, sc = slicemm.slice_operand(torch.as_tensor(X), 6)
    sc_ref, _ = _reference(X, 1, 6)
    assert sc.numpy()[0] == sc_ref[0] == 4.0
    assert np.ldexp(1.0, np.frexp(X[0, 0])[1] + 1) == 2.0


def test_tile_layout_bytes():
    rng = np.random.default_rng(3)
    P = torch.as_tensor(rng.integers(-127, 128, size=(6, 128, 96)),
                        dtype=torch.int8)
    np.testing.assert_array_equal(
        _untile(slicemm.tile_layout(P), 128, 96), P.numpy())


def test_slice_operand_strided_view():
    """A strided view (a column block of a larger matrix, transposed) is
    sliced as its contiguous copy is."""
    rng = np.random.default_rng(4)
    L = torch.as_tensor(rng.normal(size=(300, 300)))
    V = L[100:200, :100].T
    assert not V.is_contiguous()
    a = slicemm.slice_operand(V, 6, rows_p=128, kp=128)
    b = slicemm.slice_operand(V.contiguous(), 6, rows_p=128, kp=128)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("kw", [dict(nslices=7), dict(rows_p=65),
                                dict(kp=48), dict(rows_p=0)])
def test_slice_operand_refusals(kw):
    X = torch.ones((64, 64), dtype=torch.float64)
    ns = kw.pop("nslices", 6)
    with pytest.raises(ValueError):
        slicemm.slice_operand(X, ns, **kw)


def _tn_blocks(nt, nkc, w_lower):
    """The blocks of the tn product's kernel (csrc/slicemm.cu
    `syrk_tn_wgmma_kernel`, shared by K6 and K7) as (rt, ct, piece, first
    chunk, end chunk), in launch order: piece 0 of every live lower
    64-tile in K8's walk (`_lower_walk`), then pieces 1.. of the tiles in
    the first nd tile rows and columns (`_deep_tiles`' nd), piece by
    piece, row by row; blocks that return at once (upper tiles, tiles of
    fewer pieces) are left out.  Pieces are _K_CHUNK deep, from each
    tile's first chunk."""
    dc = slicemm._K_CHUNK // 32
    nd = slicemm._deep_tiles(nt * 64, nkc * 32, w_lower)
    npieces = -(-nkc // dc)
    assert (nd == 0) == (npieces == 1)
    first = [min(2 * t, nkc) if w_lower else 0 for t in range(nt)]
    assert nd == sum(nkc - kcb > dc for kcb in first)
    extra = [(1 + b // (nd * nd), b % (nd * nd) // nd, b % nd)
             for b in range(nd * nd * (npieces - 1))]
    for p, rt, ct in [(0, rt, ct) for rt, ct in _lower_walk(nt)] + extra:
        if rt // 4 < ct // 4:
            continue
        kcb = max(first[rt], first[ct])
        np_ = -(-(nkc - kcb) // dc) if kcb < nkc else 1
        if p >= np_:
            continue
        if np_ > 1:
            assert rt < nd and ct < nd  # the tile has a slot
        k0 = min(kcb + p * dc, nkc)
        yield rt, ct, p, k0, min(k0 + dc, nkc)


def _k7_by_pieces(W, w_lower, C=None):
    """C = W^T W the way the tn product's kernels form it, from
    `slice_operand(W.T)` (K7's operand; K5's for K6 is the same layout):
    per block of `_tn_blocks`, the piece's exact group sums, added over a
    tile's pieces and combined in ascending s (the combine kernel, for the
    tiles of several pieces), and piece 0 of every off-diagonal tile
    zeroing its mirrored upper tile.  Written into C (m, m) where given,
    so that what the kernels leave unwritten shows; returns C and the
    blocks."""
    k, m = W.shape
    ns = slicemm.TN_NSLICES
    tiled, sW = slicemm.slice_operand(W.T, ns)
    nt, nkc = tiled.shape[:2]
    planes = torch.as_tensor(_untile(tiled, nt * 64, nkc * 32),
                             dtype=torch.float64)
    mp = nt * 64
    Cp = torch.zeros((mp, mp), dtype=torch.float64)
    if C is not None:
        Cp[:m, :m] = C
    sp = torch.ones(mp, dtype=torch.float64)
    sp[:m] = sW
    blocks = list(_tn_blocks(nt, nkc, w_lower))
    G = {}
    for rt, ct, p, k0, k1 in blocks:
        a = planes[:, rt * 64:rt * 64 + 64, k0 * 32:k1 * 32]
        b = planes[:, ct * 64:ct * 64 + 64, k0 * 32:k1 * 32]
        g = G.setdefault((rt, ct), torch.zeros((ns, 64, 64),
                                               dtype=torch.float64))
        for s in range(ns):
            g[s] += sum(a[i] @ b[s - i].T for i in range(s + 1))
        if p == 0 and rt // 4 != ct // 4:
            Cp[ct * 64:ct * 64 + 64, rt * 64:rt * 64 + 64] = 0.0
    for (rt, ct), g in G.items():
        o = torch.zeros((64, 64), dtype=torch.float64)
        for s in range(ns):
            o = o + g[s] * 2.0 ** (-7 * (s + 2))
        r, c = slice(rt * 64, rt * 64 + 64), slice(ct * 64, ct * 64 + 64)
        Cp[r, c] = o * (sp[r, None] * sp[None, c])
    C = Cp[:m, :m].clone()
    return C, blocks


@pytest.mark.parametrize("k,m,w_lower,chunk", [
    (200, 200, True, None), (255, 255, False, None), (300, 300, True, 64),
    (130, 130, False, 64), (400, 300, True, 256)])
def test_k7_piece_plan_matches_plain(k, m, w_lower, chunk, monkeypatch):
    """The piece plan covers every live tile's k range once, keeps every
    piece within _K_CHUNK (lowered here so the split also stands for the
    k-chunked contract), splits only the tiles deeper than it (the tall
    lower W's tiles start their k ranges off the piece grain) and gives
    syrk_tn_lower_plain's result bit for bit."""
    if chunk is not None:
        monkeypatch.setattr(slicemm, "_K_CHUNK", chunk)
    rng = np.random.default_rng(m)
    W = rng.normal(size=(k, m))
    if w_lower:
        W = np.tril(W)
    W = torch.as_tensor(W)
    assert torch.equal(_k7_by_pieces(W, w_lower)[0],
                       slicemm.syrk_tn_lower_plain(W, w_lower))


@pytest.mark.parametrize("m,w_lower,chunk", [
    (300, True, None), (300, False, None), (1100, True, None),
    (300, True, 64), (256, False, 128)])
def test_tn_walk_matches_plain(m, w_lower, chunk, monkeypatch):
    """The tn product's grid (K6 and K7): K8's walk over the live lower
    64-tiles (two groups of tile rows at m 1100), then the deep tiles'
    further pieces, visits every live tile once per piece, and no other;
    the producers of piece 0 zero exactly the strictly-upper 256-tiles;
    C, every element written over a NaN start, equals
    syrk_tn_lower_plain's bit for bit, with w_lower on and off and with
    _K_CHUNK lowered so that the deep tiles run in several pieces."""
    if chunk is not None:
        monkeypatch.setattr(slicemm, "_K_CHUNK", chunk)
    rng = np.random.default_rng(m + 3)
    W = rng.normal(size=(m, m)) * np.exp(rng.normal(size=(m, 1)))
    if w_lower:
        W = np.tril(W)
    W = torch.as_tensor(W)
    C, blocks = _k7_by_pieces(
        W, w_lower, torch.full((m, m), np.nan, dtype=torch.float64))
    nt, nkc = -(-m // 64), -(-m // 32)
    dc = slicemm._K_CHUNK // 32
    want = []
    for rt in range(nt):
        for ct in range(nt):
            if rt // 4 >= ct // 4:
                kcb = min(2 * max(rt, ct), nkc) if w_lower else 0
                want += [(rt, ct, p) for p in range(
                    max(-(-(nkc - kcb) // dc), 1))]
    got = [(rt, ct, p) for rt, ct, p, _, _ in blocks]
    assert sorted(got) == sorted(want)
    assert (chunk is not None) == any(p > 0 for _, _, p in got)
    zeroed = sorted((ct, rt) for rt, ct, p, _, _ in blocks
                    if p == 0 and rt // 4 != ct // 4)
    assert zeroed == [(a, b) for a in range(nt) for b in range(nt)
                      if a // 4 < b // 4]
    assert not C.isnan().any()
    assert torch.equal(C, slicemm.syrk_tn_lower_plain(W, w_lower))


@pytest.mark.parametrize("m", [256, 512])
def test_k5_pair_mode_matches_row_planes(m):
    """K5 as the slicing kernel's pair mode on (Whi^T, Wlo^T): through
    `untile_layout` its planes equal, bit for bit, the row-major W^T-layout
    planes that K5 wrote before it moved onto the pair mode (the exact hi
    + lo over the hi plane's column scales, cut by `int_slices`), and its
    scales those column scales; the wrapper, its plain version and the
    pair mode itself agree."""
    rng = np.random.default_rng(m)
    W = np.tril(rng.normal(size=(m, m)) * np.exp2(
        rng.integers(-20, 20, size=(m, 1))))
    hi, lo = precision._pair_split(torch.as_tensor(W))
    sW = slicemm.pow2_row_scales(hi, 0).reshape(-1).double()
    rows = slicemm.int_slices(((hi.double() + lo.double()) / sW).T,
                              slicemm.TN_NSLICES)
    for w_sl, sc in (panel.pair_to_slices_cols(hi, lo),
                     panel.pair_to_slices_cols_plain(hi, lo),
                     slicemm.slice_pair_operand(hi.T, lo.T,
                                                slicemm.TN_NSLICES)):
        assert w_sl.shape == (m // 64, m // 32, slicemm.TN_NSLICES, 2048)
        assert torch.equal(slicemm.untile_layout(w_sl), rows)
        assert torch.equal(sc, sW)


def _k4_by_tiles(Rhi, Rlo, A, B, row_start, col_end):
    """(Rhi, Rlo) -= A B the way K4's kernels form it, in place: A[r0:]
    and B[:, :nc]^T sliced by `_k4_operands` (the slicing kernel's plain
    version on the views), per 64-tile of the live rectangle the exact
    group sums of the planes read back from `tile_layout`, combined in
    ascending s, then K4's epilogue: hi + lo in f64, minus the combine
    times sa[r] * sb[c], split into an f32 pair."""
    m, n = Rhi.shape
    r0, nc = slicemm._live_rect(m, n, row_start, col_end)
    a_t, sa, b_t, sb = slicemm._k4_operands(A, B, r0, nc)
    kp = a_t.shape[1] * 32
    a = torch.as_tensor(_untile(a_t, m - r0, kp), dtype=torch.float64)
    b = torch.as_tensor(_untile(b_t, nc, kp), dtype=torch.float64)
    for rt in range((m - r0) // 64):
        for ct in range(nc // 64):
            ra, cb = slice(rt * 64, rt * 64 + 64), slice(ct * 64, ct * 64 + 64)
            o = torch.zeros((64, 64), dtype=torch.float64)
            for s in range(slicemm.INT_NSLICES):
                G = sum(a[i, ra] @ b[s - i, cb].T for i in range(s + 1))
                o = o + G * 2.0 ** (-7 * (s + 2))
            prod = o * (sa[ra, None] * sb[None, cb])
            rows = slice(r0 + rt * 64, r0 + rt * 64 + 64)
            v = (Rhi[rows, cb].double() + Rlo[rows, cb].double()) - prod
            nh = v.to(torch.float32)
            Rhi[rows, cb] = nh
            Rlo[rows, cb] = (v - nh.double()).to(torch.float32)


@pytest.mark.parametrize("step", [1, 2])
def test_k4_tile_path_matches_plain(step):
    """K4 on the wgmma tile: at the middle (1) and the last (2) step of a
    1024-row identity solve at block 256, with A = L[:, lo:hi] a strided
    view and B the solved block-row (zero from col_end on), the tile
    path's result equals mm_sub_pair_plain_ bit for bit, every element
    outside the live rectangle included."""
    rng = np.random.default_rng(40 + step)
    n, blk = 1024, 256
    lo, hi = step * blk, step * blk + blk
    L = torch.as_tensor(np.tril(rng.normal(size=(n, n))))
    A = L[:, lo:hi]
    B = torch.as_tensor(rng.normal(size=(blk, n)) * np.exp2(
        rng.integers(-20, 20, size=(blk, 1))))
    B[:, hi:] = 0.0
    Rhi, Rlo = (torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32)
                for _ in range(2))
    Rlo *= 2.0 ** -24
    h1, l1, h2, l2 = Rhi.clone(), Rlo.clone(), Rhi.clone(), Rlo.clone()
    _k4_by_tiles(h1, l1, A, B, hi, hi)
    slicemm.mm_sub_pair_plain_(h2, l2, A, B, row_start=hi, col_end=hi)
    assert torch.equal(h1, h2) and torch.equal(l1, l2)
    assert not torch.equal(h1[hi:, :hi], Rhi[hi:, :hi])
    assert torch.equal(h1[:hi], Rhi[:hi]) and torch.equal(h1[:, hi:],
                                                          Rhi[:, hi:])


def _pair_carry(m, seed):
    """An (m, m) f32 pair carry with row-varying magnitudes."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(m, m)) * np.exp2(rng.integers(-20, 20, size=(m, 1)))
    hi, lo = precision._pair_split(torch.as_tensor(V))
    return rng, hi, lo


@pytest.mark.parametrize("m,lo,rs", [(512, 256, 300), (768, 0, 256)])
def test_slice_pair_operand_plain_matches_k11(m, lo, rs):
    """The pair mode's plain version on the window view equals
    `tile_layout` of K11's slices in row layout (the exact hi + lo over
    the hi-plane scales, rows above row_start zero, cut by `int_slices`)
    and K11's plain version, which is that pair mode; the scales are the
    JAX reference's `_pow2_row_scales` of the hi plane."""
    block = 256
    _, hi, lo_ = _pair_carry(m, seed=m + lo)
    c0 = rs // 256 * 256
    cols = slice(lo, lo + block)
    got, sa = slicemm.slice_pair_operand(hi[c0:, cols], lo_[c0:, cols], 6,
                                         zero_rows=rs - c0)
    ref = jprecision._pow2_row_scales(jnp.asarray(hi[c0:, cols].numpy()), 1)
    np.testing.assert_array_equal(sa.numpy(), np.asarray(ref, np.float64)[:, 0])
    V = (hi[c0:, cols].double() + lo_[c0:, cols].double()) / sa[:, None]
    V[:rs - c0] = 0.0
    assert torch.equal(got, slicemm.tile_layout(slicemm.int_slices(V, 6)))
    p_sl, psa = panel.pair_to_slices_plain(hi, lo_, lo, rs, block)
    assert torch.equal(got, p_sl) and torch.equal(sa, psa)


@pytest.mark.parametrize("m,lo,rs", [(512, 0, 256), (768, 256, 700),
                                     (512, 256, 512)])
def test_pair_to_slices_plain_is_pair_mode(m, lo, rs):
    """K11's plain version, and its wrapper on CPU tensors, equal the pair
    mode's plain version on the window bit for bit, in its tiled layout,
    also where no row is live (row_start at m: empty slices)."""
    block = 256
    _, hi, lo_ = _pair_carry(m, seed=m + rs)
    c0 = min(rs // 256 * 256, m)
    cols = slice(lo, lo + block)
    want = slicemm.slice_pair_operand_plain(hi[c0:, cols], lo_[c0:, cols], 6,
                                            rs - c0, m - c0, block)
    for got in (panel.pair_to_slices_plain(hi, lo_, lo, rs, block),
                panel.pair_to_slices(hi, lo_, lo, rs, block)):
        assert got[0].shape == ((m - c0) // 64, block // 32, 6, 2048)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_untile_layout_round_trip():
    """`untile_layout` inverts `tile_layout` both ways, and agrees with
    the byte formula (`_untile`)."""
    rng = np.random.default_rng(5)
    P = torch.as_tensor(rng.integers(-127, 128, size=(6, 192, 96)),
                        dtype=torch.int8)
    T = slicemm.tile_layout(P)
    assert torch.equal(slicemm.untile_layout(T), P)
    assert torch.equal(slicemm.tile_layout(slicemm.untile_layout(T)), T)
    np.testing.assert_array_equal(slicemm.untile_layout(T).numpy(),
                                  _untile(T, 192, 96))


def test_slice_pair_scale_from_hi_plane():
    """A row whose pair maximum rounds up across a power of two in f32
    (hi = 1 - 2^-24, lo = 2^-24: hi + lo = 1) while its hi maximum does
    not: the scale is the hi plane's, 2, not 4, and the planes cut the
    exact value 1 / 2 = 0.5 below it."""
    hi = torch.full((64, 32), 0.25, dtype=torch.float32)
    lo = torch.zeros_like(hi)
    hi[5, 3] = 1 - 2.0 ** -24
    lo[5, 3] = 2.0 ** -24
    assert float(hi[5].double().add(lo[5].double()).abs().max()
                 .float()) == 1.0
    tiled, sa = slicemm.slice_pair_operand(hi, lo, 6)
    assert sa[5] == 2.0 and sa[0] == 1.0
    assert torch.equal(sa, slicemm.pow2_row_scales(hi, 1).double().reshape(-1))
    planes = torch.as_tensor(_untile(tiled, 64, 32))
    w = 2.0 ** (-7.0 * torch.arange(1, 7, dtype=torch.float64))
    rec = torch.tensordot(w, planes.double(), 1) * sa[:, None]
    assert torch.equal(rec, hi.double() + lo.double())


def _k10_by_tiles(Ahi, Alo, Linv, lo, rs, block):
    """K10 the way its kernels form it, in place: the window sliced by the
    pair mode and Linv by `slice_operand` (`panel._k10_operands`), per
    64-tile of the live (m - c0) x block rectangle (tiles wholly above
    row_start skipped) the exact group sums combined in ascending s, then
    the epilogue: rows >= row_start get out * (sa[r] * sb[c]) as an f32
    pair."""
    m = Ahi.shape[0]
    c0 = rs // 256 * 256
    a_t, sa, b_t, sb = panel._k10_operands(Ahi, Alo, Linv, lo, rs, block)
    a = torch.as_tensor(_untile(a_t, m - c0, block), dtype=torch.float64)
    b = torch.as_tensor(_untile(b_t, block, block), dtype=torch.float64)
    for rt in range((m - c0) // 64):
        if c0 + rt * 64 + 64 <= rs:
            continue
        for ct in range(block // 64):
            ra, cb = slice(rt * 64, rt * 64 + 64), slice(ct * 64, ct * 64 + 64)
            o = torch.zeros((64, 64), dtype=torch.float64)
            for s in range(slicemm.INT_NSLICES):
                G = sum(a[i, ra] @ b[s - i, cb].T for i in range(s + 1))
                o = o + G * 2.0 ** (-7 * (s + 2))
            v = o * (sa[ra, None] * sb[None, cb])
            live = torch.arange(c0 + rt * 64, c0 + rt * 64 + 64) >= rs
            rows = torch.arange(c0 + rt * 64, c0 + rt * 64 + 64)[live]
            h = v[live].to(torch.float32)
            Ahi[rows, lo + ct * 64:lo + ct * 64 + 64] = h
            Alo[rows, lo + ct * 64:lo + ct * 64 + 64] = (
                v[live] - h.double()).to(torch.float32)


@pytest.mark.parametrize("lo,rs", [(0, 256), (512, 768)])
def test_k10_tile_path_matches_plain(lo, rs):
    """K10 on the wgmma tile at two steps of a 1024^2 carry at block 256:
    the tile path's carry equals panel_into_carry_plain_'s bit for bit,
    and everything outside the window [row_start:, lo:lo + 256] is left
    as it was."""
    rng, hi, lo_ = _pair_carry(1024, seed=50 + lo)
    Linv = torch.as_tensor(np.tril(rng.normal(size=(256, 256))))
    h1, l1, h2, l2 = hi.clone(), lo_.clone(), hi.clone(), lo_.clone()
    _k10_by_tiles(h1, l1, Linv, lo, rs, 256)
    panel.panel_into_carry_plain_(h2, l2, Linv, lo, rs, 256)
    assert torch.equal(h1, h2) and torch.equal(l1, l2)
    win = torch.zeros_like(hi, dtype=torch.bool)
    win[rs:, lo:lo + 256] = True
    assert torch.equal(h1[~win], hi[~win]) and torch.equal(l1[~win],
                                                           lo_[~win])
    assert not torch.equal(h1[win], hi[win])


def _lower_walk(nt, group=16):
    """K8's block walk (csrc/slicemm.cu `lower_tile`): groups of `group`
    tile rows from r0, first the r0 columns left of the group (every row
    live) column by column, then the group's diagonal part, one 256-column
    q of tile columns at a time over rows r0 + 4q on."""
    for r0 in range(0, nt, group):
        R = min(group, nt - r0)
        for b in range(R * r0):
            yield r0 + b % R, b // R
        for q in range(-(-R // 4)):
            rows = R - 4 * q
            for b in range(min(4, rows) * rows):
                yield r0 + 4 * q + b % rows, r0 + 4 * q + b // rows


def _k8_by_tiles(P, row_start, a_upper, C, sub):
    """K8 the way its kernel forms it: P[c0:] sliced once
    (`slicemm._k8_operands`, both sides of the product), the lower 64-tiles
    of the trailing square in the kernel's walk, each tile's k chunks from
    c0 + max(row0, col0) with a_upper, exact group sums combined in
    ascending s and scaled by sa[r] * sa[c]; stored into C (every other
    element of C exact zero), or with sub subtracted from C for rows and
    columns from row_start."""
    m, k = P.shape
    rs = row_start or 0
    c0 = rs // 256 * 256
    nr = m - c0
    sl, sa = slicemm._k8_operands(P, c0)
    nt, nkc = sl.shape[:2]
    planes = torch.as_tensor(_untile(sl, nt * 64, nkc * 32),
                             dtype=torch.float64)
    walk = list(_lower_walk(nt))
    assert sorted(walk) == [(r, c) for r in range(nt) for c in range(nt)
                            if r // 4 >= c // 4]
    if not sub:
        C.zero_()
    for rt, ct in walk:
        k0 = min(c0 + 64 * max(rt, ct), nkc * 32) if a_upper else 0
        a = planes[:, rt * 64:rt * 64 + 64, k0:]
        b = planes[:, ct * 64:ct * 64 + 64, k0:]
        o = torch.zeros((64, 64), dtype=torch.float64)
        for s in range(slicemm.INT_NSLICES):
            o = o + sum(a[i] @ b[s - i].T for i in range(s + 1)) * 2.0 ** (
                -7 * (s + 2))
        r = torch.arange(rt * 64, rt * 64 + 64)
        c = torch.arange(ct * 64, ct * 64 + 64)
        keep = (r[:, None] < nr) & (c[None, :] < nr)
        if sub:
            keep &= (r[:, None] >= rs - c0) & (c[None, :] >= rs - c0)
        rr, cc = torch.nonzero(keep, as_tuple=True)
        v = o[rr, cc] * (sa[r[rr]] * sa[c[cc]])
        idx = (c0 + r[rr], c0 + c[cc])
        C[idx] = C[idx] - v if sub else v


@pytest.mark.parametrize("kw", [{}, {"row_start": 300}, {"a_upper": True}])
def test_k8_tile_path_matches_plain(kw):
    """K8 on the wgmma tile at m 1000 (off the 64 and 256 grains), k 300
    (320 in the slices): the walk visits every lower 64-tile of the
    trailing square once, and the result equals syrk_lower_plain bit for
    bit, its a_upper chunk starts included; the in-place form equals
    syrk_sub_lower_plain_ bit for bit and leaves everything outside rows
    and columns from row_start as it was."""
    rng = np.random.default_rng(60)
    m, k = 1000, 300
    P = torch.as_tensor(rng.normal(size=(m, k)) * np.exp(
        rng.normal(size=(m, 1))))
    rs = kw.get("row_start", 0)
    P[:rs] = 0.0
    if kw.get("a_upper"):
        P = torch.triu(P)
    C = torch.full((m, m), np.nan, dtype=torch.float64)
    _k8_by_tiles(P, kw.get("row_start"), kw.get("a_upper", False), C, False)
    assert torch.equal(C, slicemm.syrk_lower_plain(P, **kw))
    if kw.get("a_upper"):
        return
    A0 = torch.as_tensor(rng.normal(size=(m, m)))
    A1, A2 = A0.clone(), A0.clone()
    _k8_by_tiles(P, rs, False, A1, True)
    slicemm.syrk_sub_lower_plain_(A2, P, rs)
    assert torch.equal(A1, A2)
    assert torch.equal(A1[:rs], A0[:rs]) and torch.equal(A1[:, :rs],
                                                         A0[:, :rs])


def _k1_by_tiles(Ahi, Alo, ops, c0):
    """K1's (and K12's) product the way its kernel forms it, in place:
    from the tiled slices and scales of P's rows from c0 (`ops`, both
    sides of the product), the lower 64-tiles of the trailing square in
    K8's walk, each tile's exact group sums over the whole k range
    combined in ascending s, then the pair epilogue on every entry of the
    tile: hi + lo in f64, minus the combine times sa[r] * sa[c], split
    into an f32 pair."""
    sl, sa = ops
    nt, nkc = sl.shape[:2]
    assert nt * 64 == Ahi.shape[0] - c0
    planes = torch.as_tensor(_untile(sl, nt * 64, nkc * 32),
                             dtype=torch.float64)
    walk = list(_lower_walk(nt))
    assert sorted(walk) == [(r, c) for r in range(nt) for c in range(nt)
                            if r // 4 >= c // 4]
    for rt, ct in walk:
        ra, cb = slice(rt * 64, rt * 64 + 64), slice(ct * 64, ct * 64 + 64)
        o = torch.zeros((64, 64), dtype=torch.float64)
        for s in range(slicemm.INT_NSLICES):
            G = sum(planes[i, ra] @ planes[s - i, cb].T for i in range(s + 1))
            o = o + G * 2.0 ** (-7 * (s + 2))
        prod = o * (sa[ra, None] * sa[None, cb])
        rows = slice(c0 + rt * 64, c0 + rt * 64 + 64)
        cols = slice(c0 + ct * 64, c0 + ct * 64 + 64)
        v = (Ahi[rows, cols].double() + Alo[rows, cols].double()) - prod
        nh = v.to(torch.float32)
        Ahi[rows, cols] = nh
        Alo[rows, cols] = (v - nh.double()).to(torch.float32)


@pytest.mark.parametrize("kind,m,rs", [
    ("k1", 768, 256), ("k1", 768, 300), ("k1", 1024, 512), ("k1", 1024, 700),
    ("k12", 1024, 300)])
def test_k1_tile_path_matches_plain(kind, m, rs):
    """K1 on the wgmma tile: the panel (m, 200, rows above row_start zero;
    k off the 32 grain) sliced once by `_k8_operands`, the lower tiles in
    K8's walk, the pair epilogue: the carry equals syrk_sub_pair_plain_'s
    bit for bit, and every element outside the live 256-tiles is left as it
    was.  K12 on K11's slices of the carry's window (`panel.
    pair_to_slices`, the tiled layout) through the same path equals
    syrk_sub_pair_presliced_plain_ bit for bit."""
    rng, hi, lo_ = _pair_carry(m, seed=70 + m + rs)
    c0 = rs // 256 * 256
    h1, l1, h2, l2 = hi.clone(), lo_.clone(), hi.clone(), lo_.clone()
    if kind == "k1":
        P = torch.as_tensor(rng.normal(size=(m, 200)) * np.exp2(
            rng.integers(-20, 20, size=(m, 1))))
        P[:rs] = 0.0
        ops = slicemm._k8_operands(P, c0)
        _k1_by_tiles(h1, l1, ops, c0)
        slicemm.syrk_sub_pair_plain_(h2, l2, P, row_start=rs)
    else:
        ops = panel.pair_to_slices(hi, lo_, 256, rs, 256)
        _k1_by_tiles(h1, l1, ops, c0)
        slicemm.syrk_sub_pair_presliced_plain_(h2, l2, *ops, row_start=rs)
    assert torch.equal(h1, h2) and torch.equal(l1, l2)
    t = torch.arange(m) // 256
    live = (t[:, None] >= t[None, :]) & (t[None, :] >= c0 // 256)
    assert torch.equal(h1[~live], hi[~live]) and torch.equal(l1[~live],
                                                             lo_[~live])
    assert not torch.equal(h1[live], hi[live])
