"""Port parity, the slicing kernel's design (csrc/slicing.cu, S, its pair
mode SP = K5/K11, and its batch Sb) emulated in numpy on the CPU:

- the cut by integer operations on the f64 bit pattern (the mantissa
  shifted by the row scale's exponent, plane i its i-th 7-bit field),
  held bit for bit against `slicemm.int_slices`, `slice_operand_plain`,
  `slice_pair_operand_plain` and the JAX reference's
  `_pow2_row_scales`/`_int_slices`, on seeded rows and the edge values;
- the strip and cluster plan (`slicemm.slice_plan`): every (strip, k
  part) covered once, shared memory within the card's, clusters within
  16 (the non-portable attribute above 8), a grid that gives every SM a
  CTA at the main path's shapes;
- the whole kernel, CTA by CTA (each part's maxima, their exchange, the
  cut of 16-column units and their tiled stores), against
  `slice_operand_plain` with every byte of the output written once.

The CUDA kernel is held to the plain versions bit for bit on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from andvaranaut_tpu.gp import precision as jprecision
from andvaranaut_torch.gp import slicemm

SOURCE = (Path(slicemm.__file__).resolve().parent.parent / "csrc"
          / "slicing.cu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the suite runs in parallel
    workers).  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the kernel's arithmetic, transcribed -----------------------------------

def pow2_exp(mx):
    """The kernel's `pow2_exp`: (e, clamped) of each row maximum, scale 2^e,
    clamped where the unclamped exponent passed 120."""
    m32 = np.maximum(np.asarray(mx, dtype=np.float64).astype(np.float32),
                     np.float32(1e-30))
    e = ((m32.view(np.uint32) >> 23) & 0xFF).astype(np.int64) - 127 + 2
    return np.clip(e, -120, 120), e > 120


def _shift(m, s):
    """floor(m 2^-s) mod 2^64 for uint64 m and int64 s of any sign."""
    out = np.zeros_like(m)
    r = (s >= 0) & (s < 64)
    out[r] = m[r] >> s[r].astype(np.uint64)
    left = (s < 0) & (s > -64)
    out[left] = m[left] << (-s[left]).astype(np.uint64)
    return out


def _fields(V, e, ns):
    """(mantissa, sign, shift) of the kernel's `digits`: floor(|V| / 2^e
    2^(7 ns)) = mantissa >> shift."""
    b = np.ascontiguousarray(V, dtype=np.float64).view(np.uint64)
    x = ((b >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
    m = (b & np.uint64(0xFFFFFFFFFFFFF)) | (
        (x != 0).astype(np.uint64) << np.uint64(52))
    neg = (b >> np.uint64(63)).astype(bool)
    sh = 1075 + np.asarray(e, dtype=np.int64) - np.maximum(x, 1) - 7 * ns
    return m, neg, np.broadcast_to(sh, m.shape).astype(np.int64)


def cut_fast(V, e, ns):
    """The kernel's cut of an unclamped row (|V / 2^e| <= 0.5): each
    element's planes as unsigned 7-bit fields of the shifted mantissa,
    packed four columns to a 32-bit word, then the negative elements'
    bytes negated in the word by ((w ^ 0x7F..) + 0x01..) ^ 0x80.. (no
    carry crosses a byte).  V (rows, k), k a multiple of 4; e (rows, 1).
    Returns (ns, rows, k) int8."""
    m, neg, sh = _fields(V, e, ns)
    d = _shift(m, sh)
    rows, k = V.shape
    sg = np.where(neg, np.uint32(0xFF), np.uint32(0)).reshape(rows, k // 4, 4)
    sg = (sg << (8 * np.arange(4, dtype=np.uint32))).sum(
        axis=2, dtype=np.uint32)
    out = []
    for s in range(ns):
        p = ((d >> np.uint64(7 * (ns - 1 - s))) & np.uint64(127)).astype(
            np.uint32).reshape(rows, k // 4, 4)
        w = (p << (8 * np.arange(4, dtype=np.uint32))).sum(
            axis=2, dtype=np.uint32)
        w = ((w ^ (sg & np.uint32(0x7F7F7F7F))) + (sg & np.uint32(0x01010101))
             ) ^ (sg & np.uint32(0x80808080))
        out.append(w.view(np.int8).reshape(rows, k))
    return np.stack(out)


def cut_clamped(V, e, ns):
    """The kernel's `clamped_bytes`: plane 1 floor(|R| 128) with its sign,
    saturated to int32 and wrapped to int8, planes 2.. the digits below it
    (any |R|)."""
    m, neg, sh = _fields(V, e, ns)
    sh1 = sh + 7 * (ns - 1)
    p1 = np.where(sh1 >= -10, _shift(m, sh1), np.uint64(1 << 63))
    low = _shift(m, sh)
    big = p1 >= np.uint64(1 << 31)
    c1 = np.where(neg, -p1.astype(np.int64), p1.astype(np.int64))
    c1 = np.where(big, np.where(neg, -(1 << 31), (1 << 31) - 1), c1)
    out = [(c1 & 0xFF).astype(np.uint8).view(np.int8)]
    for s in range(1, ns):
        p = ((low >> np.uint64(7 * (ns - 1 - s))) & np.uint64(127)).astype(
            np.int64)
        out.append((np.where(neg, -p, p) & 0xFF).astype(np.uint8)
                   .view(np.int8))
    return np.stack(out)


def cut(V, e, clamped, ns):
    """The kernel's cut of rows V (rows, k) at exponents e (rows,), the
    clamped rows by `cut_clamped`."""
    e = np.asarray(e).reshape(-1, 1)
    out = cut_fast(np.where(clamped[:, None], 0.0, V), e, ns)
    if clamped.any():
        out[:, clamped] = cut_clamped(V[clamped], e[clamped], ns)
    return out


def _int_slices(R, ns):
    return slicemm.int_slices(torch.as_tensor(R), ns).numpy()


# the edge values of R = X / scale: +-0.5, +-0, the last nonzero digits
# of 8 planes (2^-56) and just below (2^-57), subnormals, 0.5 - 2^-54,
# values whose digits sit at 7-bit field boundaries
EDGES = np.array([0.5, -0.5, 0.0, -0.0, 2.0 ** -56, -(2.0 ** -56),
                  2.0 ** -57, 2.0 ** -42, 2.0 ** -43, 5e-324, -5e-324,
                  2.0 ** -1022, 1e-310, 0.5 - 2.0 ** -54, -(0.5 - 2.0 ** -54),
                  0.25, 2.0 ** -7, 2.0 ** -7 - 2.0 ** -60, 127 / 256,
                  -(2.0 ** -14) * 3, 0.1, -0.3, 1 / 3, 2.0 ** -35 * 5,
                  0.49999999999999994, 2.0 ** -49, 2.0 ** -50])


@pytest.mark.parametrize("ns", [6, 8])
def test_bit_cut_matches_int_slices(ns):
    """Both cuts on 300k seeded values of R in [-0.5, 0.5] (uniform and
    log-uniform down to 2^-70) and the edge values, bit for bit with
    `int_slices` (the plain version's exact f64 steps)."""
    rng = np.random.default_rng(ns)
    R = np.concatenate([
        rng.uniform(-0.5, 0.5, 100000),
        np.sign(rng.normal(size=100000)) * np.exp2(
            rng.uniform(-70, -1, 100000)),
        rng.integers(-2 ** 52, 2 ** 52, 100000) * 2.0 ** -53,
        np.resize(EDGES, 124)])
    R = R.reshape(-1, 4)
    want = _int_slices(R, ns)
    zero = np.zeros((R.shape[0], 1), dtype=np.int64)
    np.testing.assert_array_equal(cut_fast(R, zero, ns), want)
    np.testing.assert_array_equal(cut_clamped(R, zero, ns), want)


@pytest.mark.parametrize("ns", [6, 8])
def test_clamped_cut_past_one_half(ns):
    """The clamped rows' cut where |R| reaches 0.5 and beyond (scale 2^120,
    max |X| up to f32's largest): plane 1 wraps to int8 as the plain
    version's conversion does, bit for bit with `int_slices` while
    |R| 128 < 2^31."""
    rng = np.random.default_rng(5)
    R = np.concatenate([
        np.sign(rng.normal(size=4000)) * np.exp2(rng.uniform(-3, 8, 4000)),
        [0.5, 1.0, -1.0, 1.5, 255.99, -200.7, 3.0, -3.0]]).reshape(-1, 4)
    zero = np.zeros((R.shape[0], 1), dtype=np.int64)
    np.testing.assert_array_equal(cut_clamped(R, zero, ns),
                                  _int_slices(R, ns))


def _rows(rows, k, seed):
    """Seeded rows over 2^-40..2^40, a zero row, f32-carry rows, rows at
    the scale clamps (max below 1e-30; max in [2^118, 2^119), scale
    2^120) and subnormal entries."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, k)) * np.exp2(
        rng.integers(-40, 40, size=(rows, 1)))
    X[0] = 0.0
    X[1] = rng.uniform(-0.25, 0.25, k)
    X[1, k // 2] = 1 - 2.0 ** -30
    X[2] = rng.normal(size=k) * 1e-32
    X[3] = rng.uniform(-1, 1, k) * 2.0 ** 118
    X[3, 0] = 2.0 ** 119 * (1 - 2.0 ** -40)
    X[4, ::3] = 5e-324
    return X


@pytest.mark.parametrize("rows,k,ns", [(64, 32, 6), (37, 100, 8),
                                       (130, 1000, 6), (9, 256, 8)])
def test_bit_cut_matches_plain_and_reference(rows, k, ns):
    """Scales from the row maxima by `pow2_exp` and planes by the bit cut
    (zero-padded to the 64 and 32 grains, in `tile_layout`) bit for bit
    with `slice_operand_plain` and with the JAX reference's
    `_pow2_row_scales`/`_int_slices` on the same seed."""
    X = _rows(rows, k, seed=rows * k)
    rows_p, kp = -(-rows // 64) * 64, -(-k // 32) * 32
    e, clamped = pow2_exp(np.abs(X).max(axis=1))
    Xp = np.zeros((rows_p, kp))
    Xp[:rows, :k] = X
    ep = np.zeros(rows_p, dtype=np.int64)
    ep[:rows] = e
    cp = np.zeros(rows_p, dtype=bool)
    cp[:rows] = clamped
    planes = cut(Xp, ep, cp, ns)
    tiled, sc = slicemm.slice_operand_plain(torch.as_tensor(X), ns, rows_p,
                                            kp)
    np.testing.assert_array_equal(np.exp2(e.astype(np.float64)), sc.numpy())
    np.testing.assert_array_equal(
        slicemm.tile_layout(torch.as_tensor(planes)).numpy(), tiled.numpy())
    Xj = jnp.asarray(X)
    sj = jprecision._pow2_row_scales(Xj, 1)
    ref = np.stack([np.asarray(c) for c in jprecision._int_slices(Xj / sj,
                                                                  ns)])
    np.testing.assert_array_equal(np.asarray(sj).reshape(-1), sc.numpy())
    np.testing.assert_array_equal(planes[:, :rows, :k], ref)


# -- the strip plan -----------------------------------------------------

def _constants():
    """The kernel's integer constants, read from its source: the
    namespace's, and each operand's row pad."""
    src = SOURCE.read_text()
    c = {n: eval(v, {}) for n, v in
         re.findall(r"\nconstexpr int (\w+) = ([0-9 +*/-]+);", src)}
    for name in ("F64Rows", "PairRows"):
        c[f"{name}.PAD"] = int(re.search(
            rf"struct {name} {{\n  static constexpr int PAD = (\d+);",
            src).group(1))
    return c


def test_plan_constants_match_kernel():
    """The plan's limits are the kernel's: row pads, tallest strip and
    largest cluster, shared memory; the kernel allows clusters above 8
    (the non-portable attribute)."""
    c = _constants()
    assert c["HMAX"] == max(slicemm.STRIP_HEIGHTS) == 16
    assert c["CLMAX"] == slicemm.CLUSTER_MAX == 16
    assert c["SMEM_MAX"] == slicemm.STRIP_SMEM_MAX
    assert slicemm.strip_smem(8, 1024) == 8 * (1024 + c["F64Rows.PAD"]) * 8
    assert slicemm.strip_smem(8, 1024, True) == 8 * (
        1024 + c["PairRows.PAD"]) * 8
    src = SOURCE.read_text()
    assert re.search(r"err = cudaFuncSetAttribute\(\s+kernel, "
                     r"cudaFuncAttributeNonPortableClusterSizeAllowed, 1\)",
                     src)
    # 227 KB a block, less the kernel's static arrays (wmax, cmax, rexp,
    # rclamp: 1280 bytes)
    assert slicemm.STRIP_SMEM_MAX + 1280 <= 232448


def valid_plan(rows_p, kp, h, cl, kpart, nbatch=1, pair=False):
    """The kernel's `bad_plan`, negated."""
    return (h in (1, 2, 4, 8, 16) and 1 <= cl <= 16 and kpart > 0
            and kpart % 32 == 0 and cl * kpart >= kp
            and (cl - 1) * kpart < kp
            and slicemm.strip_smem(h, kpart, pair) <= slicemm.STRIP_SMEM_MAX
            and rows_p // h * cl < 2 ** 31 and 1 <= nbatch <= 65535)


# the slicing calls of the main paths at 16384, block 1024 (and path A at
# N 16000 / 17000, block 1000; the chains' batch): rows_p, kp, batch, rows
# side by side, pair
INVENTORY = [
    (15360, 1024, 1, False, False),  # K2's first panel, A[1024:]; K1's P
    (1024, 1024, 1, True, False),    # K2's B^T = Linv^T; L[lo:hi, :lo].T
    (1024, 1024, 1, False, False),   # K10's Linv; L[hi:, lo:hi] blocks
    (1024, 256, 1, True, False),     # a column block of a solve's X
    (64, 1024, 1, False, False),     # a whitened solve's vector block
    (15360, 1024, 1, False, True),   # K10's window, K11 (pair mode)
    (8192, 1024, 1, False, True),    # a middle window
    (16384, 16384, 1, True, True),   # K5: (Whi^T, Wlo^T) (pair mode)
    (17408, 17408, 1, True, True),   # K5 at 17408
    (15040, 1024, 1, False, False),  # path A's panel (N 16000, block 1000)
    (16000, 16000, 1, True, False),  # K7 at 16000: W^T
    (17024, 17024, 1, True, False),  # K7 at 17000
    (1024, 1024, 1, True, False),    # K7 at n = 1000
    (256, 256, 8, True, False), (256, 256, 64, True, False),  # Sb
    (512, 512, 8, True, False), (512, 512, 64, True, False),
]


def _parts(kp, cl, kpart):
    return [(p * kpart, min((p + 1) * kpart, kp)) for p in range(cl)]


@pytest.mark.parametrize("rows_p,kp,nb,side,pair", INVENTORY)
def test_plan_covers_and_fits(rows_p, kp, nb, side, pair):
    """At the main path's shapes: a valid plan, its parts partition the
    depth (none empty), each strip part within 72 KB (three CTAs an SM),
    strips of 16 rows side by side and of 4 along k where the depth
    allows, the cluster within 8 unless the depth needs more, and at
    least 132 CTAs from 2^20 elements where the operand has the rows for
    them (below it, one CTA a strip at these depths)."""
    h, cl, kpart = slicemm.slice_plan(rows_p, kp, nb, side, pair)
    assert valid_plan(rows_p, kp, h, cl, kpart, nb, pair)
    cover = np.zeros(kp, dtype=np.int64)
    for a, b in _parts(kp, cl, kpart):
        assert b > a
        cover[a:b] += 1
    assert (cover == 1).all()
    assert slicemm.strip_smem(h, kpart, pair) <= slicemm.STRIP_SMEM_TARGET
    assert h == ((16 if kp <= 16 * 544 else 8) if side else 4)
    assert cl <= 8 or kp > 8 * {16: 544, 8: 1120, 4: 2272}[h]
    ctas = nb * rows_p // h * cl
    if nb * rows_p * kp >= slicemm.FILL_MIN:
        assert ctas >= slicemm.SMS or cl == min(8, kp // 32)
    else:
        assert cl == 1


def test_plan_depths():
    """The plan across depths: one CTA a strip to 2272 columns (4 rows
    along k; 544 for 16 rows side by side), clusters of 2..16 beyond,
    shorter strips past 16 parts, the largest cluster of the largest part
    at the limit, and no plan past it; a 1024 x 1024 operand on 256 CTAs
    (every SM) along k and on 256 of 16-row strips side by side, K5's
    16384 on 16 CTAs of 1024 columns; the fill from 2^20 elements."""
    assert slicemm.slice_plan(15360, 2272) == (4, 1, 2272)
    assert slicemm.slice_plan(15360, 2304) == (4, 2, 1152)
    assert slicemm.slice_plan(15360, 2272, 1, False, True) == (4, 1, 2272)
    assert slicemm.slice_plan(15360, 2304, 1, False, True) == (4, 2, 1152)
    assert slicemm.slice_plan(15360, 544, 1, True) == (16, 1, 544)
    assert slicemm.slice_plan(15360, 576, 1, True) == (16, 2, 288)
    assert slicemm.slice_plan(1024, 1024) == (4, 1, 1024)
    assert slicemm.slice_plan(1024, 1024, 1, True) == (16, 4, 256)
    assert slicemm.slice_plan(16384, 16384, 1, True, True) == (8, 16, 1024)
    assert slicemm.slice_plan(17024, 17024, 1, True) == (8, 16, 1088)
    assert slicemm.slice_plan(64, 16 * 544, 1, True) == (16, 16, 544)
    assert slicemm.slice_plan(64, 16 * 544 + 32, 1, True)[0] == 8
    assert slicemm.slice_plan(512, 2048) == (4, 2, 1024)
    assert slicemm.slice_plan(512, 1024) == (4, 1, 1024)
    assert slicemm.slice_plan(256, 256, 8, True) == (16, 1, 256)
    assert slicemm.slice_plan(64, 16 * 2272) == (4, 16, 2272)
    assert slicemm.slice_plan(64, 16 * 2272 + 32)[0] == 2
    deepest = 16 * ((slicemm.STRIP_SMEM_MAX // 8 - 4) // 32 * 32)
    for side in (False, True):
        for pair in (False, True):
            h, cl, kpart = slicemm.slice_plan(64, deepest, 1, side, pair)
            assert (h, cl) == (1, 16)
            assert valid_plan(64, deepest, h, cl, kpart, 1, pair)
    with pytest.raises(ValueError):
        slicemm.slice_plan(64, deepest + 16 * 32 * 2)
    with pytest.raises(ValueError):
        slicemm.slice_plan(65, 32)
    rng = np.random.default_rng(0)
    for _ in range(2000):
        rows_p = int(rng.integers(1, 300)) * 64
        kp = int(rng.integers(1, deepest // 32 + 1)) * 32
        nb = int(rng.integers(1, 70))
        side, pair = bool(rng.integers(2)), bool(rng.integers(2))
        plan = slicemm.slice_plan(rows_p, kp, nb, side, pair)
        assert valid_plan(rows_p, kp, *plan, nb, pair)
        assert all(b > a for a, b in _parts(kp, plan[1], plan[2]))


# -- the kernel, CTA by CTA -------------------------------------------------

def _tile_offset(r, b):
    return ((r >> 3) * 2 + (b >> 4)) * 128 + (r & 7) * 16 + (b & 15)


def emulate(value, mag, rows, k, ns, rows_p, kp, plan, zero_rows=0):
    """slice_strip_kernel on the operand (value, mag: (rows, k) f64, the
    value cut and the magnitude the scale is taken from), CTA by CTA:
    each part's row maxima from its columns only, their maximum across
    the cluster, the scales written by part 0, then units of 16 columns
    of one row (u % h, 16 (u / h)) stored at the kernel's byte offsets.
    Returns (tiled planes, scales, how often each output byte was
    written)."""
    h, cl, kpart = plan
    nkc = kp // 32
    out = np.zeros(rows_p * kp * ns, dtype=np.int8)
    hits = np.zeros(rows_p * kp * ns, dtype=np.int64)
    scale = np.full(rows, np.nan)
    V = np.zeros((rows_p, kp))
    V[:rows, :k] = value
    G = np.zeros((rows_p, kp))
    G[:rows, :k] = mag
    for r0 in range(0, rows_p, h):
        parts = _parts(kp, cl, kpart)
        cmax = [G[r0:r0 + h, a:b].max(axis=1) for a, b in parts]
        m = np.max(cmax, axis=0)
        e, clamped = pow2_exp(m)
        live = np.arange(r0, r0 + h) < rows
        scale[r0:r0 + h][live[:len(scale[r0:r0 + h])]] = np.exp2(
            e[live].astype(np.float64))
        for a, b in parts:
            planes = cut(V[r0:r0 + h, a:b], e, clamped, ns)
            for u in range(h * (b - a) // 16):
                ur, hk = u % h, u // h
                gr, kk = r0 + ur, a + 16 * hk
                dst = ((gr // 64 * nkc + kk // 32) * ns * 2048
                       + _tile_offset(gr % 64, kk & 16))
                for s in range(ns):
                    sl = slice(dst + s * 2048, dst + s * 2048 + 16)
                    ok = gr < rows and gr >= zero_rows
                    out[sl] = planes[s, ur, 16 * hk:16 * hk + 16] if ok else 0
                    hits[sl] += 1
    shape = (rows_p // 64, nkc, ns, 2048)
    return out.reshape(shape), scale, hits


@pytest.mark.parametrize("rows,k,ns,plan", [
    (64, 32, 6, None), (100, 1000, 8, None), (37, 300, 6, (8, 3, 128)),
    (130, 70, 8, (4, 2, 64)), (9, 257, 6, (2, 5, 64)),
    (65, 96, 8, (1, 3, 32)), (200, 512, 6, (8, 16, 32)),
    (300, 600, 8, (16, 3, 224))])
def test_kernel_emulation_matches_plain(rows, k, ns, plan):
    """The kernel, emulated CTA by CTA under the plan (`slice_plan`'s, or
    smaller parts and strips to exercise every height and clusters of
    2..16 at small sizes), equals `slice_operand_plain` bit for bit,
    scales and tiled planes, and writes every output byte exactly once."""
    X = _rows(rows, k, seed=k)
    rows_p, kp = -(-rows // 64) * 64, -(-k // 32) * 32
    plan = plan or slicemm.slice_plan(rows_p, kp)
    assert valid_plan(rows_p, kp, *plan)
    got, sc, hits = emulate(X, np.abs(X), rows, k, ns, rows_p, kp, plan)
    tiled, want_sc = slicemm.slice_operand_plain(torch.as_tensor(X), ns,
                                                 rows_p, kp)
    assert (hits == 1).all()
    np.testing.assert_array_equal(sc, want_sc.numpy())
    np.testing.assert_array_equal(got, tiled.numpy())


@pytest.mark.parametrize("rows,k,zero,plan", [
    (100, 256, 0, None), (300, 200, 44, (8, 2, 128)), (130, 300, 5,
                                                       (16, 2, 160)),
    (65, 1000, 3, (4, 4, 256))])
def test_kernel_emulation_pair_mode(rows, k, zero, plan):
    """The pair mode emulated (the value hi + lo in f64, the scale from
    the hi plane, the first `zero` rows zero planes) against
    `slice_pair_operand_plain`, with a row whose maximum of hi + lo
    rounds across a power of two in f32 where that of hi does not."""
    rng = np.random.default_rng(rows + k)
    V = rng.normal(size=(rows, k)) * np.exp(rng.normal(size=(rows, 1)))
    hi = V.astype(np.float32)
    lo = (V - hi.astype(np.float64)).astype(np.float32)
    hi[5] = rng.uniform(-0.5, 0.5, k).astype(np.float32)
    lo[5] = 0.0
    hi[5, 7] = np.float32(1 - 2.0 ** -24)
    lo[5, 7] = np.float32(2.0 ** -24)
    rows_p, kp = -(-rows // 64) * 64, -(-k // 32) * 32
    plan = plan or slicemm.slice_plan(rows_p, kp, 1, False, True)
    val = hi.astype(np.float64) + lo.astype(np.float64)
    got, sc, hits = emulate(val, np.abs(hi).astype(np.float64), rows, k, 8,
                            rows_p, kp, plan, zero_rows=zero)
    tiled, want_sc = slicemm.slice_pair_operand_plain(
        torch.as_tensor(hi), torch.as_tensor(lo), 8, zero, rows_p, kp)
    assert (hits == 1).all()
    np.testing.assert_array_equal(sc, want_sc.numpy())
    np.testing.assert_array_equal(got, tiled.numpy())
    # the pair's maximum would give row 5 another scale
    assert pow2_exp(np.abs(val[5]).max())[0] != pow2_exp(
        np.abs(hi[5]).max())[0]
