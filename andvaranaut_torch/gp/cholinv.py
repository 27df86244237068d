"""K3: diagonal-block Cholesky and its inverse in one launch
(counterpart of andvaranaut_tpu/gp/pallas_cholinv.py).

`chol_inv_block(Ajj)` equilibrates the SPD block with exact power-of-two
scales d ~ sqrt(diag), factors the equilibrated block, inverts the
factor and undoes the scaling: L = Ls d, X = Ls^-1 / d.  `ok` is False
when any entry of Ls or Xs is not finite or min diag(Ls) <= 1e-6; the
caller then falls back to f64 (precision._chol_inv_fused).

On a CUDA tensor the whole of it, equilibration included, is one launch
of the hand-written kernel csrc/cholinv.cu: a cluster of 1, 2, 4 or 8
thread blocks on as many SMs, sharing the factor through distributed
shared memory, its products on the f64 tensor cores (native f64 where
the TPU kernel carried f32 pairs; see the source note).  Which block owns
which 32-row block-row and which 16-column strip of the inverse is
`cluster_plan`'s table; the cluster's size is `cluster_size`'s rule.  On
a CPU tensor the plain version runs (`chol_inv_block_plain`):
`pow2_sqrt_scales`, f64 `torch.linalg.cholesky_ex` and a triangular
solve.  `chol_inv_block.launches` counts kernel launches.

`chol_inv_blocks(A)` takes a batch (C, b, b) of such blocks (the chains
of the small-n MCMC objective, where the reference ran K3 under
jax.vmap) in ONE launch of C clusters, one per block, and returns `ok`
of shape (C,), so the caller reads every block's gate with one host
sync.  Each cluster computes exactly what a launch on its block alone
would, bit for bit, at any cluster size (the kernel fixes every sum's
order by the block's indices); the plain version is
`chol_inv_block_plain` per block, stacked.  `chol_inv_blocks.launches`
counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

#: largest block the kernel takes (larger blocks recurse 2x2 above it)
MAX_BLOCK = 512
_GRAIN = 32
#: columns of an inverse strip (csrc/cholinv.cu SW)
STRIP = 16
#: the cluster sizes the kernel takes, largest first (csrc/cholinv.cu)
CLUSTERS = (8, 4, 2, 1)
#: the largest cluster, a single block's (csrc/cholinv.cu MAXCL)
CLUSTER = CLUSTERS[0]
#: SMs of the card the rule fills (H100 SXM)
SMS = 132
#: staging blocks beside an owner's rows, and the dynamic shared memory a
#: block may use beside the kernel's static bytes (csrc/cholinv.cu NSLOT,
#: SMEM_MAX)
NSLOT = 9
SMEM_MAX = 232448 - 256

_VP, _I, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_LL = ctypes.c_longlong
_SIGS = {"chol_inv_block": [_VP, _I] + [_VP] * 4 + [_I, _I, _IP, _VP],
         "chol_inv_blocks": [_VP, _I, _LL] + [_VP] * 4 + [_I, _I, _I, _IP,
                                                          _VP],
         "chol_inv_info": [_I, _I, _IP, _IP]}
_ROWS = MAX_BLOCK // _GRAIN
_STRIPS = MAX_BLOCK // STRIP
_PLANS: dict = {}


def _lib():
    return _build.library("cholinv", _SIGS)


def _lpt(weights, bins: int):
    """Owners of the items by longest processing time first: each item,
    heaviest first (ties by index), to the least loaded bin (ties by
    rank).  The largest load is at most 4/3 of the best possible."""
    load = [0] * bins
    owner = [0] * len(weights)
    for i in sorted(range(len(weights)), key=lambda i: -weights[i]):
        c = min(range(bins), key=lambda c: load[c])
        owner[i] = c
        load[c] += weights[i]
    return owner


@functools.lru_cache(maxsize=None)
def _plan(b: int, cluster: int):
    nb = b // _GRAIN
    per = _GRAIN // STRIP
    return (_lpt([i + 1 for i in range(nb)], cluster),
            _lpt([(nb - s // per) ** 2 for s in range(per * nb)], cluster))


def cluster_plan(b: int, cluster: int = CLUSTER):
    """(row owners, strip owners) of a b-block on a cluster of `cluster`
    CTAs: the CTA that holds and updates each 32-row block-row of the
    factor (weight: its i + 1 blocks of the lower triangle) and the CTA
    that solves each 16-column strip s of the inverse (in column block j
    = s // 2, weight (b / 32 - j)^2, the blocks below it times their
    depth)."""
    rows, strips = _plan(b, cluster)
    return list(rows), list(strips)


@functools.lru_cache(maxsize=None)
def smem_bytes(b: int, cluster: int):
    """Dynamic shared memory per CTA of a b-block on `cluster` CTAs (the
    largest owner's blocks and the staging blocks, 8 KB each, and the b
    scales and their reciprocals), or None where that exceeds SMEM_MAX."""
    rows, _ = cluster_plan(b, cluster)
    blocks = [sum(i + 1 for i, o in enumerate(rows) if o == c)
              for c in range(cluster)]
    nbytes = ((max(blocks) + NSLOT) * _GRAIN * _GRAIN + 2 * b) * 8
    return nbytes if nbytes <= SMEM_MAX else None


@functools.lru_cache(maxsize=None)
def cluster_size(b: int, batch: int) -> int:
    """The cluster size of a batch of `batch` b-blocks: among the sizes
    whose plan fits and that have a block-row for every CTA, the largest
    whose clusters all fit the card's SMs at once (one wave), else the
    smallest (the fewest waves).  A function of (b, batch) alone, so a
    chain's block gets the same cluster size in every call of the same
    shape (the results do not depend on it anyway)."""
    nb = b // _GRAIN
    fits = [c for c in CLUSTERS
            if (c <= nb or c == 1) and smem_bytes(b, c) is not None]
    if not fits:
        raise ValueError(f"no cluster size fits a block of {b}")
    one_wave = [c for c in fits if batch * c <= SMS]
    return max(one_wave) if one_wave else min(fits)


def _table(b: int, cluster: int):
    """`cluster_plan(b, cluster)` as the kernel's int table (row owners,
    _ROWS entries, then strip owners, _STRIPS entries), cached."""
    key = (b, cluster)
    if key not in _PLANS:
        rows, strips = cluster_plan(b, cluster)
        _PLANS[key] = (ctypes.c_int * (_ROWS + _STRIPS))(
            *rows, *[0] * (_ROWS - len(rows)),
            *strips, *[0] * (_STRIPS - len(strips)))
    return _PLANS[key]


def launch_info(b: int, cluster: int = CLUSTER):
    """(thread blocks of the cluster, dynamic shared memory per block in
    bytes) of the kernel's launch for a b-block on `cluster` CTAs."""
    info = (ctypes.c_int * 2)()
    _build.check(_lib().chol_inv_info(b, cluster, _table(b, cluster), info),
                 "chol_inv_info")
    return info[0], info[1]


def pow2_sqrt_scales(v):
    """Exact power-of-two scales ~ sqrt(v): 2^((e+1)>>1) from the f32
    exponent field, as the JAX reference builds them."""
    m32 = torch.clamp(v.to(torch.float32), min=1e-30)
    u = m32.view(torch.int32)
    e = ((u >> 23) & 0xFF) - 127
    eh = torch.clamp((e + 1) >> 1, -60, 60)
    return ((eh + 127) << 23).view(torch.float32).to(v.dtype)


def _ok(Ls, Xs):
    return (torch.isfinite(Ls).all() & torch.isfinite(Xs).all()
            & (torch.diagonal(Ls).min() > 1e-6))


def chol_inv_plain(As):
    """Plain PyTorch version of the kernel on an equilibrated block:
    (Ls, Xs = Ls^-1, ok) in f64."""
    Ls, info = torch.linalg.cholesky_ex(As)
    eye = torch.eye(As.shape[0], dtype=As.dtype, device=As.device)
    Xs = torch.linalg.solve_triangular(Ls, eye, upper=False)
    return Ls, Xs, _ok(Ls, Xs) & (info == 0)


def chol_inv_block_plain(Ajj):
    """Plain PyTorch version of the whole wrapper: `pow2_sqrt_scales`,
    the equilibration, `chol_inv_plain` and the scaling back."""
    d = pow2_sqrt_scales(torch.diagonal(Ajj))
    Ls, Xs, ok = chol_inv_plain(Ajj / d[:, None] / d[None, :])
    # row-major, as the kernel writes them (LAPACK's factor is
    # column-major, and the layout steers the later products' sums)
    return ((Ls * d[:, None]).contiguous(),
            (Xs * (1.0 / d)[None, :]).contiguous(), ok)


def _check_block(b: int, name: str):
    if b > MAX_BLOCK or b % _GRAIN:
        raise ValueError(
            f"{name} takes b <= {MAX_BLOCK}, b % {_GRAIN} == 0; got {b}")


def _launch(A, lda: int, sa: int, batch: int, cluster=None):
    """One launch of the kernel on `batch` blocks (b, b) at A's data,
    row stride lda, batch stride sa: (L, X, ok), each with the batch
    dimension.  cluster: the cluster size, by default `cluster_size`'s
    (the card tests force the others: the bits are the same)."""
    b = A.shape[-1]
    cl = cluster_size(b, batch) if cluster is None else int(cluster)
    if cl not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}, got {cl}")
    L = torch.empty((batch, b, b), dtype=A.dtype, device=A.device)
    X = torch.empty_like(L)
    # the diagonal 32-blocks' inverses, shared by the cluster's blocks
    dinv = torch.empty((batch, b // _GRAIN, _GRAIN, _GRAIN), dtype=A.dtype,
                       device=A.device)
    ok = torch.empty(batch, dtype=torch.bool, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().chol_inv_blocks(
            A.data_ptr(), lda, sa, L.data_ptr(), X.data_ptr(),
            dinv.data_ptr(), ok.data_ptr(), b, batch, cl, _table(b, cl),
            stream)
    _build.check(err, "chol_inv_blocks")
    return L, X, ok


def chol_inv_block(Ajj):
    """(L, X = L^-1, ok) of an SPD diagonal block (f64, b <= 512).  On
    the card Ajj may be a view with unit column stride (a diagonal block
    of a larger matrix), read in place."""
    if Ajj.dtype != torch.float64 or Ajj.dim() != 2 \
            or Ajj.shape[0] != Ajj.shape[1]:
        raise ValueError("chol_inv_block takes a square float64 block")
    if Ajj.device.type == "cpu":
        return chol_inv_block_plain(Ajj)
    if Ajj.device.type != "cuda":
        raise ValueError(f"unsupported device {Ajj.device}")
    _check_block(Ajj.shape[0], "chol_inv_block")
    if Ajj.stride(1) != 1:
        raise ValueError("chol_inv_block needs unit column stride")
    L, X, ok = _launch(Ajj, Ajj.stride(0), 0, 1)
    chol_inv_block.launches += 1
    return L[0], X[0], ok[0]


chol_inv_block.launches = 0


def chol_inv_blocks_plain(A):
    """Plain PyTorch version of `chol_inv_blocks`: `chol_inv_block_plain`
    of each block, stacked."""
    outs = [chol_inv_block_plain(a) for a in A]
    return tuple(torch.stack(t) for t in zip(*outs))


def chol_inv_blocks(A):
    """(L, X = L^-1, ok) of each SPD block of a batch A (C, b, b) f64,
    b <= 512: `chol_inv_block` of every block, with ok of shape (C,).
    On the card the batch is one launch of C clusters of
    `cluster_size(b, C)` CTAs; A may be a view whose blocks have unit
    column stride and equal strides (each block read in place)."""
    if A.dtype != torch.float64 or A.dim() != 3 \
            or A.shape[1] != A.shape[2] or A.shape[0] == 0:
        raise ValueError("chol_inv_blocks takes a (C, b, b) float64 batch")
    if A.device.type == "cpu":
        return chol_inv_blocks_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    _check_block(A.shape[1], "chol_inv_blocks")
    if A.stride(2) != 1:
        raise ValueError("chol_inv_blocks needs unit column stride")
    out = _launch(A, A.stride(1), A.stride(0), A.shape[0])
    chol_inv_blocks.launches += 1
    return out


chol_inv_blocks.launches = 0
