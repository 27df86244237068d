#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (andvaranaut_torch) on one NVIDIA GPU.

Phases, each printed as it runs:
  1. the card (nvidia-smi name and power limit) and the kernels' build;
  2. every CUDA kernel of the main paths (K1 syrk_sub_pair, K2
     slice_matmul, K3 chol_inv_block; K4 mm_sub_pair, K5
     pair_to_slices_cols, K6 syrk_tn_lower_presliced, K7 syrk_tn_lower)
     against its plain PyTorch version on the card, at the shapes the 16k
     factorisation and MAP gradient give it, with kernel, plain and
     library times and the bound from its shapes (K6 also at 17408,
     where its first tile rows contract in two k pieces).  K1, K2, K4,
     K5, K6 and K7 are held bit for bit at their paths' shapes (K1: the
     16k first step; K2: the panels, the compose, the serving and BO
     solves, path A's panel, views of L; K4: the 16k middle step on a
     view of L; K5: 16384^2, the slicing kernel's pair mode on W^T; K6:
     8192 on K5's slices, and 17408 in row blocks; K7: n=1000 and path
     A's N=16000), with the slicing kernel (csrc/slicing.cu) bit for bit
     on their operands, the product kernel timed alone beside the
     wrapper (K6 held to at least twice the speed of f64 W^T W), and a
     profile of 10 wrapper calls that must show only the port's kernels
     (K5: the pair mode only; K6: the tn product only, which K7 shares);
     K3 (one launch on a cluster
     of 8 SMs) at b = 128..512 on
     bench Gram blocks and noise-floor blocks, with its cluster size,
     shared memory and profile;
  3. the bench.py workload through the port: Gram plus mixed NLML at
     N=16384, nx=2, RBF, block 1024, against f64 Cholesky on the card,
     with each kernel's launch count in that run;
  4. GPState serving on the mixed route (gpmcmc.FORCE_MIXED; exact f64 is
     the default, as in the reference off a TPU): condition on 16384 rows
     once, answer 3 requests of 2048 points, against the exact f64 path;
  5. the MAP fit: value+grad at N=16384 (K1-K6), at n=17408 (K6 with its
     contraction in two chunks) and at n=1000 (one block, K7) against f64
     autograd of the exact NLML on the card, each with its launch counts,
     and big_map_fit at n=4096 against an L-BFGS-B fit of the same priors
     and bounds on the f64 autograd value+grad, both run to convergence;
  6. K9 (gram_tiles, the acquisitions' fused f32 cross-Gram) against its
     plain version for all five kernels at (16384, 10000, d=2) and at a
     shape off every tile edge, with kernel, plain and torch.cdist times;
  7. the GPMCMC facade at 16384 rows with the bench data and hypers, on
     the mixed route (FORCE_MIXED): a facade predict against the exact
     f64 path, the batch EI acquisition over 10000 LHC candidates and the
     design point at argmin(y) through K9 against the exact f64 Gram, the
     DE program, then one BO iteration (predict mode, refine, the target,
     the exact f64 refit at 16385 rows) and a facade predict at its
     17408-row padded state against exact f64; then `routes`: 16k serving
     on both routes, exact f64 and mixed, in turns (f64, mixed, mixed,
     f64), and one 16k BO iteration on each, with the default route
     checked f64;
  8. K8 (syrk_lower) against its plain version at the first step of the
     f64-carry factorisation (16000 x 1000, row_start 1000), at an
     all-dead call and with a_upper on an upper-triangular 4096^2 operand,
     and its in-place step (syrk_sub_lower_, what the factorisation runs)
     against the two-step form; K10 (panel_into_carry_) with the slicing
     kernel's pair mode (slice_pair_operand), K11 (pair_to_slices, the
     pair mode on the finished panel) and K12 (syrk_sub_pair_presliced_,
     K1's kernel on K11's slices) against theirs at the fused panel stage's
     first step (16384^2 carry, block 1024, lo 0, row_start 1024) and at a
     mid-matrix step, each with kernel, plain and library times and the
     bound (K8 and K10 also their product kernel alone, and a profile of
     10 wrapper calls that must show the slicing kernels and the product
     and nothing else);
  9. `offgrain`, the f64-carry route: bench.py's data at N=16000, block
     1000 (off the 256 grain, no padding), the NLML against f64 and the
     value+grad against f64 autograd and the same factor's f64 inverse,
     with launches per kernel, a profile, and the factorisation's peak
     memory beyond its carry (no (m, m) product per step);
 10. `fused`, the fused panel stage: the 16k NLML with
     ANDVARANAUT_FUSED_PANEL=1 against f64, its factor against the unfused
     route's, its launches, and both routes timed in turns with a profile
     each;
 11. MCMC (`McmcPhases`): `mcmc_small`, the small-n mixed objective's
     batched kernels, K3b (`chol_inv_blocks`, b = 128-512) and K7b
     (`syrk_tn_lower_batched`, with the batched slicing Sb, one kernel
     that reads each operand once, n = 48-512), at C = 1, 8, 17, 64 against C single launches bit for bit
     and their plain versions (K3b at K3's grade, K7b bit for bit), K3b
     also against the same blocks at C = 1, a permuted batch and every
     cluster size that fits (bit for bit), and the batched slicing Sb
     against its plain version; their times (K3b at b = 256 with C = 8
     and 64 and at b = 128 and 512 with C = 8, K7b at n = 256 with C = 8
     and 64 and at n = 512 with C = 8; K3 and K3b with the latency estimate
     of their dependent steps), the batched value+grad at n=256, C=8
     (launch counts, a profile with one K3, one Sb and one K7 launch,
     one host sync for the chains' ok gates, equal bit
     for bit to the per-chain serial value+grad and timed against it),
     then sample_model(mixed=True, sampler='hmc_host', chains=8) at n=256
     held to the f64 route's posterior mean (ms per leapfrog, ESS/s; the
     K3b/K7b/Sb launches of the kernels line are from this run);
     `mcmc16k`, host HMC on the 16k bench data with 2 chains from the
     bench hypers (curvature mass, budget 8): ms per leapfrog, accept,
     finite lp, K1-K6 launches per chain value+grad; `mcmc_fit`, the
     facade's fit(method='mcmc_mean', return_data=True), mcmc_map and a
     BO iteration with opt_method='mcmc_map' at tests/test_nuts.py's toy
     (default f64 NUTS);
 12. the facade's forward UQ and inverse problem (`FacadePhases`) at the
     16k bench facade of phase 7: `uq`, on the f64 and the mixed route in
     turns, y_dist over 10000 LHC points (its propagation without the
     plot where matplotlib or seaborn is missing), test_plots(method=
     'none') on a fixed 90/10 split and a save_object/load_object round
     trip with predictions equal bit for bit, the routes' propagations
     and held-out metrics against each other and the mixed route's
     launches (one conditioning in y_dist, K2 in its predict), then the
     tutorial (`python -m andvaranaut_torch.tutorial`) on the card;
     `inverse`, the inverse objective on the conditioned state (nobs 1;
     nobs 4 with yvarobs) against the joint (N + nobs) Cholesky written
     out on the card, value and gradient, both timed, and on the mixed
     route against the f64 route with no K1 or K3 launch in any
     evaluation, inverse_opt(method='map') on both routes (wall,
     evaluations, the mean at xopt within 3 sd of yobs, two
     conditionings on the mixed route), and a short
     inverse_opt(method='mcmc_mean', sampler='hmc_host', chains=4);
 13. the learnable warpings (`WarpedPhases`, `warped`) on bench.py's data
     with input 0 warped by wgp(uniform, kumaraswamy) and y by
     wgp(meanstd, sinharcsinh): bigfit.make_warped_vg at N=16384, block
     1024, with iwgp and cwgp and with each alone, against f64 autograd
     of the warped engine.build_objective on the card (value 1e-6,
     gradient 5e-4 normwise), its launches (K1-K6, no K7, no plain
     version called) and warped_vg_16k_ms; big_warped_map_fit at 4096
     against a converged f64 L-BFGS-B fit (logpost 1e-5); the facade's
     fit(method='map', iwgp=True, cwgp=True) at 4096 on the mixed and the
     f64 route (the warpers written back equal the hypers, predictions
     within the reference test's bound of the latent function); and
     sample_model(mixed=True, sampler='hmc_host', chains=2) on a cwgp
     configuration at n=256;
 14. the row-sharded paths (`ShardedPhases`, `sharded`): 2 ranks spawned
     by distributed.RankPool share the card over gloo (NCCL refuses two
     ranks of one communicator on one device): the 16k value+grad of
     sharded.make_sharded_mixed_objective at block 256 against f64
     autograd and the single-device value+grad (map_vg's limits), both
     ranks bit for bit, each rank's launches (K1, K2, K3 and S; no K4-K7,
     no plain version), sharded_vg_16k_ms with its collective time and
     peak memory per rank, and K2 bit for bit at the path's four shapes
     (panel, trailing update, L^-1 pipeline, K^-1) with its times and
     bound; at 4096 rows make_sharded_predict against exact f64,
     sharded_big_map_fit against bigfit.big_map_fit, the facade's
     fit(precision='distributed', cwgp=True) and sample_model(mesh=);
     dryrun_multichip(2); then the 16k value+grad on one rank over NCCL;
 15. chain sharding (`ChainPhases`, `chains`): sample_model(mixed=True)
     at n=256 with 8 chains, 'nuts' and 'hmc', unsharded, over two
     in-process shards on the card (devices=['cuda:0'] * 2) and over 2
     gloo ranks sharing it, the draws equal bit for bit, one K3b and K7b
     launch a share of at most 4 rows, one all_gather a round, no plain
     version, ms a round per route and the all_gather's share; n=2048
     (K1-K6 chain by chain) with 2 chains unsharded and over the ranks;
     dryrun_multichip(2)'s chain-sharded run.

The last two lines are a {"kernels": [...]} JSON line (K1-K12, the
slicing kernel S and its pair mode SP, K3b, K7b and Sb; K1, K2, K3, K4,
K6, K7, K8, K10, K12, K3b and K7b with their kernel's time alone, K6 also
its times at 17408, K8 also its in-place step's times; the kernels of
the 16k warped value+grad with their launches there, `warped_launches`;
K1, K2, K3 and S with their launches per rank in one 16k value+grad over
2 ranks, `sharded_launches`, and K2 with its `sharded_shapes`; K3b
and K7b with their launches per shard and per rank in the chain-sharded
n=256 run, K1-K6 and S per rank in the n=2048 one, `chains_launches`)
and
{"ok": true, "device": {...}}.  Any failure exits non-zero without the
ok line; so does a machine without CUDA or a directory without the port.

    python3 chip_smoke.py

The full 16k MAP fit (bench data, maxiter 200, ftol 1e-7) beside an f64
autograd fit, with each objective evaluated at the other's optimum, is
not part of the smoke run; it reports without a limit:

    python3 -c "import chip_smoke; chip_smoke.fit16k()"

Likewise 2 'hmc_host' chains on the 16k data for 15 + 30 transitions,
each chain's acceptance:

    python3 -c "import chip_smoke; chip_smoke.mcmc16k_long()"
"""

import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

N = 16384
NX = 2
BLOCK = 1024
REPS = 3
L_SCALES = (0.5, 0.7)
KV, GV, JITTER = 1.0, 1e-4, 1e-6
SERVE_REQUESTS = 3
SERVE_POINTS = 2048
# the value+grad whose K6 contraction (depth n) passes the exact int32
# depth 2^14 and runs in chunks: 17 blocks, the padded size of a 16k
# dataset after one BO step
MAP_N_CHUNKED = 17 * BLOCK
# BO: predict_samps of the batch acquisition and of the BO iteration, and
# the seed of the acquisition check's LHC candidates (the check's min(y)
# case no longer rests on it: `Phases._bo_acquisitions`)
BO_CANDIDATES = 10000
BO_SEED = 0
# the f64-carry route (path A): bench.py's problem at N=16000 and block 1000,
# 16 steps with no padding, off the 256 grain of the pair carry
N_OFF, BLOCK_OFF = 16000, 1000
# K7 just deeper than the exact int32 depth 2^14, so that its tiles of
# depth above 2^14 (the first 10 of 266 tile rows) run in k pieces
K7_DEEP_M = 17000
# K8's a_upper case: an upper-triangular square operand
K8_UPPER_M = 4096
# K3's largest block (the 1024 diagonal blocks of the 16k factorisation
# recurse into two of them)
MAX_K3 = 512
# K9 against its plain version: |d| <= K9_ATOL + K9_RTOL |plain|.  The
# batch acquisition through K9 against the exact f64 Gram: the exact-path
# EI at K9's argmax within EI_RTOL max |EI| of the exact maximum, and
# each candidate's |dEI| within the Lipschitz bound of its mean and sd
# errors (`Phases._bo_acquisitions`)
K9_RTOL = K9_ATOL = 1e-6
EI_RTOL = 1e-3
# The facade's predictions are of standardised outputs (a meanstd
# conversion), whose mean crosses zero: the mean is held normwise,
# max |dmu| <= MU_RTOL max |mu|.  After the BO step the hypers are the
# refit's (kv/gv ~3e4, three times the bench's), and the mixed variance's
# error, cancellation in kss - |L^-1 k*|^2, scales with kss = sum(kv):
# there it is held on that scale, max |dvar| <= VAR_PRIOR_RTOL kss (at
# such hypers and n=2048 the port's mixed path reaches 1.5e-9 kss and the
# reference's own 2.8e-7: tests/test_torch_engine.py::
# test_mixed_variance_grade_at_fitted_hypers)
VAR_PRIOR_RTOL = 1e-8

# MCMC: the small-n mixed objective (one block: one batched K3 and K7
# launch per leapfrog for all chains) at n = MCMC_N with MCMC_CHAINS chains,
# the batch sizes and sizes of the batched kernels' checks, and the 16k run
# (chains, transitions, max_treedepth 3: a budget of 8 leapfrogs)
MCMC_N, MCMC_CHAINS = 256, 8
MCMC_BATCHES = (1, 8, 17, 64)
K3B_SIZES, K7B_SIZES = (128, 256, 512), (48, 256, 512)
# the timed K3b and K7b rows: (block or n, chains); the kernels line's row
# is the first (the main path's shape)
K3B_ROWS = ((256, 8), (256, 64), (128, 8), (512, 8))
K7B_ROWS = ((256, 8), (256, 64), (512, 8))
MCMC16K_CHAINS, MCMC16K_TUNE, MCMC16K_DRAWS = 2, 3, 3
# posterior means of two routes of one sampler (tests/test_nuts.py's
# test_sample_model_mixed_path tolerance)
POST_RTOL, POST_ATOL = 0.35, 0.05

# the facade's forward UQ and inverse problems at the 16k bench facade
# (`FacadePhases`): y_dist's LHC size and its numpy seed (the same draw
# on both routes); the held-out split's training share and seed; the
# held-out metrics of the two routes within METRIC_RTOL of each other.
# The inverse problem: the true input x* (interior), the inverse
# objective at INV_Z_COUNT seeded z against the joint-Cholesky algebra on
# the card (value INV_VALUE_RTOL, gradient normwise INV_GRAD_RTOL), the
# mixed route's against the f64 route's at NLML_RTOL plus VAR_RTOL of the
# predictive variance through du/ds2 (value) and VG_GRAD_RTOL (gradient),
# the MAP solve's mean at xopt within INV_SD predictive sd of yobs, and a
# short hmc_host run (chains, tune, draws, max_treedepth)
UQ_SAMPLES, UQ_SEED = 10000, 3
UQ_TRAIN_FRAC, UQ_SPLIT_SEED = 0.9, 5
METRIC_RTOL = 1e-6
INV_XSTAR = (0.37, 0.61)
INV_Z_COUNT, INV_Z_SEED = 3, 7
INV_VALUE_RTOL, INV_GRAD_RTOL, INV_SD = 1e-9, 1e-6, 3.0
INV_MCMC = dict(chains=4, tune=15, draws=15, max_treedepth=4)

# the learnable warpings (`WarpedPhases`) on bench.py's data: input 0
# warped by wgp(['uniform', 'kumaraswamy']), y by wgp(['meanstd',
# 'sinharcsinh']).  The 16k value+grad at z0 + WARP_Z_SCALE N(0, 1)
# (numpy seed WARP_Z_SEED) against f64 autograd at map_vg's limits
# (VG_VALUE_RTOL, VG_GRAD_F64_RTOL); big_warped_map_fit at WARP_FIT_N
# (maxiter WARP_FIT_MAXITER) against a converged f64 L-BFGS-B fit at
# FIT_LP_RTOL; the facade at WARP_FIT_N; the mixed warped MCMC objective at
# WARP_MCMC_N.  The facade's predictions are held to the latent function
# at its design points within tests/test_gpmcmc.py:155's bound (5e-2 on
# its noise-free toy) scaled by the ratio of the latent ranges (bench
# data carry 0.01 noise, the toy none).
WARP_Z_SEED, WARP_Z_SCALE = 11, 0.05
WARP_FIT_N, WARP_FIT_MAXITER = 4096, 200
WARP_MCMC_N = 256
WARP_PRED_TOY = 5e-2

# the row-sharded paths (`ShardedPhases`, `sharded`): bench.py's problem at
# N rows over SHARD_RANKS ranks that share the card over gloo (spawned by
# distributed.RankPool), then over one rank on NCCL, at SHARD_BLOCK (the
# reference's sharded default), each at map_vg's z and limits; the
# predict of SHARD_POINTS points (tests/test_sharded.py:239-243's mixed
# tolerances: mean SHARD_MU_RTOL, variance SHARD_VAR_RTOL, atol ATOL),
# sharded_big_map_fit against bigfit.big_map_fit (log posterior
# SHARD_FIT_LP_RTOL / SHARD_FIT_LP_ATOL, lengthscales SHARD_FIT_L_RTOL:
# tests/test_sharded.py:197-212), the facade's cwgp fit (maxiter
# SHARD_FACADE_MAXITER, tests/test_gpmcmc_variants.py:178-190) and
# sample_model(mesh=) (SHARD_MCMC) at SHARD_N_SMALL rows
SHARD_RANKS, SHARD_BLOCK = 2, 256
SHARD_N_SMALL, SHARD_POINTS, SHARD_Q_SEED = 4096, 2048, 21
SHARD_MU_RTOL, SHARD_VAR_RTOL = 1e-7, 1e-4
SHARD_FIT_LP_RTOL, SHARD_FIT_LP_ATOL, SHARD_FIT_L_RTOL = 1e-4, 1e-3, 5e-2
SHARD_FIT_MAXITER, SHARD_FACADE_MAXITER = 50, 15
SHARD_MCMC = dict(chains=2, tune=3, draws=3, max_treedepth=2)

# chain sharding (`ChainPhases`, `chains`): sample_model(mixed=True) on
# make_data(CHAINS_N) (one block: K3b and K7b) with CHAINS_C chains, 'nuts'
# and 'hmc' (CHAINS_RUN), unsharded, over CHAINS_SHARDS in-process shards
# on the card (devices=['cuda:0'] * CHAINS_SHARDS, a thread and a CUDA
# stream each) and over CHAINS_SHARDS gloo ranks sharing it; then
# make_data(CHAINS_BIG_N) at sample_model's block there (256: K1-K6 and S
# chain by chain), 2 'nuts' chains of CHAINS_BIG_RUN, unsharded and over
# the ranks.  The draws are held equal bit for bit across the routes.
CHAINS_N, CHAINS_C, CHAINS_SHARDS = 256, 8, 2
CHAINS_RUN = dict(draws=20, tune=20, max_treedepth=4, random_seed=3)
CHAINS_BIG_N = 2048
CHAINS_BIG_RUN = dict(draws=3, tune=3, max_treedepth=3, random_seed=3)
# mcmc16k_long(): 'hmc_host' at 16k from the bench hypers (curvature
# mass), 2 chains, budget 8, MCMC16K_LONG transitions of warmup + draws
MCMC16K_LONG = dict(tune=15, draws=30)

# published H100 SXM peaks (dense): int8 tensor cores, f64 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth
PEAK_INT8_OPS = 1979e12
PEAK_F64_FLOPS = 67e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

NLML_RTOL = 1e-6
# MAP value+grad.  The value against f64 autograd of the exact NLML on the
# card.  Gradients are held normwise, max |g - g_ref| / max |g_ref|, to two
# references: (1) the same closed form with K^-1 from an f64 triangular
# inverse of the SAME mixed factor, which isolates this path's kernels
# (K4-K7) and contraction, at 1e-4; (2) f64 autograd of the exact NLML,
# which adds the factorisation's grade: at 16k the closed form through the
# f64 inverse of the mixed factor is itself 1.8e-4 from it (PERF.md,
# Findings), so (2) is held at 5e-4.  Entrywise errors are printed
# too.
VG_VALUE_RTOL, VG_GRAD_RTOL, VG_GRAD_F64_RTOL = 1e-6, 1e-4, 5e-4
# big_map_fit, run to convergence, against the f64 MAP (the grade of
# tests/test_precision.py's engine-MAP comparison for l and kv)
FIT_N = 4096
FIT_LP_RTOL, FIT_L_RTOL, FIT_KV_RTOL = 1e-5, 2e-2, 5e-2
MAP_N1 = 1000
# Predictions: the mean at the 1e-8 grade of tests/test_gp_engine.py;
# the variance at 1e-5, not that test's 1e-6: kss - |L^-1 k*|^2 cancels
# against the 1e-4 noise floor, and the whitened solve's 6-slice products
# (~2^-42 of their operands' maxima) accumulate over the block steps.
# The JAX reference's own mixed path misses 1e-6 the same way
# (tests/test_torch_engine.py::test_mixed_variance_grade_matches_reference);
# PERF.md gives the measured values.
MU_RTOL, VAR_RTOL, ATOL = 1e-8, 1e-5, 1e-10

# profile labels of the port's kernels (the first tag found in a kernel's
# name gives its label)
SLICING = "slicing (operands of K1, K2, K4, K7, K8, K10)"
PAIR_SLICING = "slicing, pair mode (K5, K10's window, K11)"
PROFILE_LABELS = (
    # the slicing kernel, slice_strip_kernel<NS, Src>: its pair mode, its
    # batch Sb (K7b's operand), then S
    ("PairRows", PAIR_SLICING),
    ("F64Batch", "Sb"),
    ("slice_strip_kernel", SLICING),
    ("slice_matmul_wgmma_kernel", "K2"),
    # the tn product: K7, and K6 on K5's slices
    ("syrk_tn_wgmma_kernel", "K6/K7"),
    ("syrk_tn_combine_kernel", "K6/K7 combine"),
    ("cholinv_cluster_kernel", "K3"),
    ("mm_sub_pair_wgmma_kernel", "K4"),
    # the lower-tile product's pair epilogue (Epi PAIR = 2): K1 and K12
    ("syrk_lower_wgmma_kernel<2>", "K1/K12"),
    ("syrk_lower_wgmma_kernel", "K8"),
    ("gram_kernel", "K9"),
    ("panel_wgmma_kernel", "K10"))

FAILURES = []


def check(name, ok, detail):
    print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        FAILURES.append(name)


def make_data(n, nx=NX, seed=0):
    """bench.py's inputs: uniform X, y = sin(3 x0) + x1^2 + noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, nx))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.01 * rng.normal(size=n)
    return X, y


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = out.strip().splitlines()
    return lines[0] if lines else "nvidia-smi gave no output"


def bound(ops, nbytes, peak_ops):
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_fns():
    """{label: wrapper} of every kernel's launch counter (`.launches`)."""
    import andvaranaut_torch.gp.cholinv as cholinv
    import andvaranaut_torch.gp.ops as ops
    import andvaranaut_torch.gp.panel as panel
    import andvaranaut_torch.gp.slicemm as sm

    return {"K1": sm.syrk_sub_pair_, "K2": sm.slice_matmul,
            "K3": cholinv.chol_inv_block, "K4": sm.mm_sub_pair_,
            "K5": panel.pair_to_slices_cols,
            "K6": sm.syrk_tn_lower_presliced, "K7": sm.syrk_tn_lower,
            "K8": sm.syrk_lower, "K9": ops.gram_tiles,
            "K10": panel.panel_into_carry_, "K11": panel.pair_to_slices,
            "K12": sm.syrk_sub_pair_presliced_, "S": sm.slice_operand,
            "SP": sm.slice_pair_operand, "K3b": cholinv.chol_inv_blocks,
            "K7b": sm.syrk_tn_lower_batched, "Sb": sm.slice_operand_batched}


def reset_kernel_counts():
    import andvaranaut_torch.gp.precision as precision

    for fn in kernel_fns().values():
        fn.launches = 0
    precision._chol_fallback.calls = 0


def kernel_counts():
    import andvaranaut_torch.gp.precision as precision

    c = {k: fn.launches for k, fn in kernel_fns().items()}
    c["K3_fallback"] = precision._chol_fallback.calls
    return c


@contextlib.contextmanager
def plain_calls():
    """Counts calls of every kernel's plain version (the module-level
    `*_plain*` functions the wrappers take for CPU tensors) while the
    block runs; yields the {name: calls} dict, restored after."""
    import andvaranaut_torch.gp.cholinv as cholinv
    import andvaranaut_torch.gp.ops as ops_mod
    import andvaranaut_torch.gp.panel as panel
    import andvaranaut_torch.gp.slicemm as slicemm

    calls = {}
    saved = []
    for mod in (slicemm, panel, cholinv, ops_mod):
        for name, fn in list(vars(mod).items()):
            if not (name.endswith("_plain") or name.endswith("_plain_")):
                continue
            if not callable(fn):
                continue

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)

            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class McmcPhases:
    """The MCMC slice on the card: the batched K3 and K7 (`mcmc_small`),
    host HMC at 16k (`mcmc16k`) and the facade's MCMC fits
    (`mcmc_fit`).  Mixed into Phases."""

    def _spd_batch(self, C, b, seed):
        """C bench Gram blocks (RBF on uniform points, bench hypers)."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        X = torch.rand(C, b, NX, generator=g, device=self.dev,
                       dtype=torch.float64)
        l = torch.tensor(L_SCALES, dtype=torch.float64, device=self.dev)
        kv = torch.tensor([KV], dtype=torch.float64, device=self.dev)
        K = torch.stack([self.kernels.gram(("RBF",), (), X[c], None, l, kv)
                         for c in range(C)])
        K.diagonal(dim1=1, dim2=2).add_(JITTER + GV)
        return K

    def _k3b_checks(self):
        """The batched K3 against C single launches (bit for bit) and its
        plain version (K3's grade: the kernel sums in another order than
        LAPACK), at every b and C; at the largest C, bit for bit against
        the same blocks launched one by one at C = 1, the batch permuted
        and every cluster size whose plan fits."""
        torch, ci = self.torch, self.cholinv
        errs = []
        for b in K3B_SIZES:
            for C in MCMC_BATCHES:
                A = self._spd_batch(C, b, seed=b + C)
                L, X, ok = ci.chol_inv_blocks(A)
                singles = [ci.chol_inv_block(A[c]) for c in range(C)]
                Lp, Xp, okp = ci.chol_inv_blocks_plain(A)
                torch.cuda.synchronize()
                same = all(torch.equal(L[c], s[0]) and torch.equal(X[c], s[1])
                           and bool(ok[c]) == bool(s[2])
                           for c, s in enumerate(singles))
                rL = float((L - Lp).abs().max() / Lp.abs().max())
                rX = float((X - Xp).abs().max() / Xp.abs().max())
                errs.append(max(float((L - Lp).abs().max()),
                                float((X - Xp).abs().max())))
                check(f"K3b b={b} C={C} (cluster {ci.cluster_size(b, C)}) "
                      "vs single launches and plain",
                      same and bool(ok.all()) and bool(okp.all())
                      and rL <= 1e-10 and rX <= 1e-8,
                      f"bit_exact_vs_single={same} L rel={rL:.3e} (limit "
                      f"1e-10) X rel={rX:.3e} (limit 1e-8) ok={bool(ok.all())}")
            C = MCMC_BATCHES[-1]
            A = self._spd_batch(C, b, seed=b + C)
            L, X, ok = ci.chol_inv_blocks(A)
            perm = torch.randperm(C, generator=torch.Generator().manual_seed(
                b)).to(self.dev)

            def same_as(out, idx=None):
                Lq, Xq, okq = out
                ref = (L, X, ok) if idx is None else (L[idx], X[idx], ok[idx])
                return all(torch.equal(u, v) for u, v in zip((Lq, Xq, okq),
                                                             ref))
            ones = all(same_as(ci.chol_inv_blocks(A[c:c + 1]), [c])
                       for c in range(C))
            permuted = same_as(ci.chol_inv_blocks(A[perm]), perm)
            sizes = [cl for cl in ci.CLUSTERS
                     if ci.smem_bytes(b, cl) is not None]
            by_size = {cl: same_as(ci._launch(A, A.stride(1), A.stride(0),
                                              C, cl)) for cl in sizes}
            check(f"K3b b={b} C={C} bit for bit at C=1, permuted and at "
                  "every cluster size",
                  ones and permuted and all(by_size.values()),
                  f"cluster by the rule {ci.cluster_size(b, C)}; C=1 "
                  f"{ones}; permuted {permuted}; by cluster size {by_size}")
        A = self._spd_batch(3, 256, seed=5)
        A[1] -= 4.0 * torch.eye(256, dtype=torch.float64, device=self.dev)
        _, _, ok = ci.chol_inv_blocks(A)
        check("K3b ok gate per block", ok.tolist() == [True, False, True],
              f"ok={ok.tolist()} (block 1 not positive definite)")
        return max(errs)

    def _k7b_checks(self):
        """The batched K7 (Sb, then the batched tn product) against C
        single launches and the plain version, and Sb against its plain
        version, bit for bit."""
        torch, sm = self.torch, self.slicemm
        for n in K7B_SIZES:
            for C in MCMC_BATCHES:
                W = torch.tril(self.f64(C, n, n, seed=n + C))
                n0 = (sm.syrk_tn_lower_batched.launches,
                      sm.slice_operand_batched.launches)
                Cb = sm.syrk_tn_lower_batched(W, w_lower=True)
                launched = (sm.syrk_tn_lower_batched.launches - n0[0],
                            sm.slice_operand_batched.launches - n0[1])
                sl, sc = sm.slice_operand_batched(W.transpose(1, 2),
                                                  sm.TN_NSLICES)
                single = torch.stack([sm.syrk_tn_lower(W[c], w_lower=True)
                                      for c in range(C)])
                plain = sm.syrk_tn_lower_batched_plain(W)
                slp = sm.slice_operand_batched_plain(W.transpose(1, 2),
                                                     sm.TN_NSLICES)
                torch.cuda.synchronize()
                same = torch.equal(Cb, single) and torch.equal(Cb, plain)
                same_s = torch.equal(sl, slp[0]) and torch.equal(sc, slp[1])
                check(f"K7b n={n} C={C} vs single launches and plain",
                      same and same_s and launched == (1, 1),
                      f"bit_exact={same} Sb bit_exact={same_s} launches "
                      f"(K7b, Sb)={launched} (expected (1, 1))")

    def _k3_latency_est(self, b, C, cl):
        """The latency estimate of a batch of C b-blocks on clusters of
        cl: the waves times the chain of dependent steps, t(32) + (b / 32
        - 1) (t(64) - t(32)), with t the kernel alone on one block of 32
        and of 64 at the same cluster size (one panel step, one lookahead
        factor and one inverse step each), timed here.  A step priced at
        b = 64 is an estimate, not a floor: a step's cost grows with b."""
        torch, ci = self.torch, self.cholinv
        ts = {}
        for bb in (32, 64):
            A = self._spd_batch(1, bb, seed=bb)
            ts[bb] = self._k3_kernel_ms(A, cl, reps=50)
        waves = -(-C * cl // ci.SMS)
        return waves * (ts[32] + (b // 32 - 1) * (ts[64] - ts[32])), ts

    def _k3_kernel_ms(self, A, cl, reps):
        """The K3 kernel alone (the C call on buffers allocated
        beforehand) on the batch A at cluster size cl."""
        torch, ci = self.torch, self.cholinv
        C, b = A.shape[0], A.shape[1]
        L = torch.empty((C, b, b), dtype=torch.float64, device=self.dev)
        X = torch.empty_like(L)
        dinv = torch.empty((C, b // 32, 32, 32), dtype=torch.float64,
                           device=self.dev)
        okb = torch.empty(C, dtype=torch.bool, device=self.dev)
        lib, table = ci._lib(), ci._table(b, cl)
        stream = torch.cuda.current_stream().cuda_stream
        return self.ms(lambda: lib.chol_inv_blocks(
            A.data_ptr(), A.stride(1), A.stride(0), L.data_ptr(),
            X.data_ptr(), dinv.data_ptr(), okb.data_ptr(), b, C, cl, table,
            stream), reps=reps)

    def _k3b_row(self, errs):
        torch, ci = self.torch, self.cholinv
        rows = []
        for b, C in K3B_ROWS:
            A = self._spd_batch(C, b, seed=11)
            cl = ci.cluster_size(b, C)
            ms = self.ms(lambda: ci.chol_inv_blocks(A), reps=20)
            kernel_ms = self._k3_kernel_ms(A, cl, reps=20)
            plain_ms = self.ms(lambda: ci.chol_inv_blocks_plain(A),
                               reps=5 if C <= 8 else 2)
            eye = torch.eye(b, dtype=torch.float64, device=self.dev)
            lib_ms = self.ms(lambda: torch.linalg.solve_triangular(
                torch.linalg.cholesky(A), eye, upper=False), reps=20)
            b_ms, b_by = bound(C * 2 * b ** 3 / 3, C * 3 * b * b * 8,
                               PEAK_F64_FLOPS)
            lat_ms, ts = self._k3_latency_est(b, C, cl)
            row = dict(b=b, batch=C, cluster=cl, ms=ms, kernel_ms=kernel_ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by, latency_est_ms=lat_ms,
                       step_kernel_ms={32: ts[32], 64: ts[64]})
            if (b, C) == (MCMC_N, MCMC_CHAINS):
                row["single_launches_ms"] = self.ms(
                    lambda: [ci.chol_inv_block(A[c]) for c in range(C)],
                    reps=10)
            rows.append(row)
            print(f"  K3b C={C} b={b} cluster={cl} ms={ms:.4f} kernel_ms="
                  f"{kernel_ms:.4f} plain_ms={plain_ms:.3f} library_ms("
                  f"batched f64 cholesky+solve_triangular)={lib_ms:.4f} "
                  f"bound_ms={b_ms:.5f} ({b_by}) latency_est_ms="
                  f"{lat_ms:.4f} (kernel alone at b=32 {ts[32]:.4f}, 64 "
                  f"{ts[64]:.4f}, cluster {cl})"
                  + (f" {C} single launches ms="
                     f"{row['single_launches_ms']:.4f}"
                     if "single_launches_ms" in row else ""), flush=True)
        head = rows[0]
        self.rows["K3b"] = dict(
            name="K3b chol_inv_blocks (batched K3)",
            source="andvaranaut_torch/csrc/cholinv.cu",
            replaces="andvaranaut_tpu/gp/pallas_cholinv.py:362",
            max_abs_err=errs,
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "kernel_ms",
                                    "single_launches_ms", "latency_est_ms",
                                    "cluster", "batch", "b")},
            sizes=rows)

    def _k7b_rows(self):
        torch, sm = self.torch, self.slicemm
        ns = sm.TN_NSLICES
        lib, slib = sm._lib(), sm._slicing_lib()
        rows = []
        for n, C in K7B_ROWS:
            W = torch.tril(self.f64(C, n, n, seed=12))
            Wt = W.transpose(1, 2)
            ms = self.ms(lambda: sm.syrk_tn_lower_batched(W, w_lower=True),
                         reps=20)
            # the kernels alone: Sb's and the product's C calls on buffers
            # allocated beforehand
            sl, sc = sm.slice_operand_batched(Wt, ns)
            kp = sl.shape[2] * 32
            out = torch.empty((C, n, n), dtype=torch.float64, device=self.dev)
            stream = torch.cuda.current_stream().cuda_stream

            plan = sm.slice_plan(sl.shape[1] * 64, kp, C, True)

            def sb_kernel():
                slib.slice_rows_batched(
                    Wt.data_ptr(), Wt.stride(0), Wt.stride(1), Wt.stride(2),
                    C, n, n, sl.shape[1] * 64, kp, ns, *plan, sc.data_ptr(),
                    sl.data_ptr(), stream)

            def tn_kernel():
                lib.syrk_tn_tiled_batched(sl.data_ptr(), sc.data_ptr(),
                                          out.data_ptr(), n, kp, ns, 1, C,
                                          stream)

            sb_kernel_ms = self.ms(sb_kernel, reps=20)
            tn_kernel_ms = self.ms(tn_kernel, reps=20)
            kernel_ms = self.ms(lambda: (sb_kernel(), tn_kernel()), reps=20)
            plain_ms = self.ms(lambda: sm.syrk_tn_lower_batched_plain(W),
                               reps=3 if C <= 8 else 1)
            lib_ms = self.ms(lambda: torch.matmul(W.transpose(1, 2), W),
                             reps=20)
            b_ms, b_by = bound(
                C * self._syrk_tn_macs(n) * 2 * ns * (ns + 1) // 2,
                C * n * n * 8 * 2, PEAK_INT8_OPS)
            row = dict(n=n, batch=C, ms=ms, kernel_ms=kernel_ms,
                       sb_kernel_ms=sb_kernel_ms, tn_kernel_ms=tn_kernel_ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            if (n, C) == (MCMC_N, MCMC_CHAINS):
                row["single_launches_ms"] = self.ms(
                    lambda: [sm.syrk_tn_lower(W[c], w_lower=True)
                             for c in range(C)], reps=10)
            rows.append(row)
            print(f"  K7b C={C} n={n} ms={ms:.4f} kernel_ms={kernel_ms:.4f} "
                  f"(Sb {sb_kernel_ms:.4f}, product {tn_kernel_ms:.4f}) "
                  f"plain_ms={plain_ms:.3f} library_ms(batched f64 W^T W)="
                  f"{lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by})"
                  + (f" {C} single launches ms="
                     f"{row['single_launches_ms']:.4f}"
                     if "single_launches_ms" in row else ""), flush=True)
        head = rows[0]
        self.rows["K7b"] = dict(
            name="K7b syrk_tn_lower_batched (batched K7 on Sb's planes; "
                 "kernel_ms: Sb and the product)",
            source="andvaranaut_torch/csrc/slicemm.cu",
            replaces="andvaranaut_tpu/gp/pallas_slicemm.py:988",
            max_abs_err=0.0,
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "kernel_ms",
                                    "single_launches_ms", "batch", "n")},
            sizes=rows)
        C, n = MCMC_CHAINS, MCMC_N
        W = torch.tril(self.f64(C, n, n, seed=12))
        s_ms = self.ms(lambda: sm.slice_operand_batched(W.transpose(1, 2), ns),
                       reps=20)
        s_plain = self.ms(lambda: sm.slice_operand_batched_plain(
            W.transpose(1, 2), ns), reps=3)
        sb_ms, sb_by = bound(0, C * n * n * (8 + ns), PEAK_INT8_OPS)
        sb_alone = [r["sb_kernel_ms"] for r in rows
                     if (r["n"], r["batch"]) == (n, C)]
        self.rows["Sb"] = dict(
            name="Sb slice_operand_batched (the slicing kernel, a batch on "
                 "its grid)",
            source="andvaranaut_torch/csrc/slicing.cu",
            replaces="andvaranaut_tpu/gp/precision.py:107",
            max_abs_err=0.0, ms=s_ms, plain_ms=s_plain, bound_ms=sb_ms,
            bound_by=sb_by, library_ms=None, batch=C, n=n,
            kernel_ms=sb_alone[0] if sb_alone else None)
        print(f"  Sb C={C} n={n} ms={s_ms:.4f} kernel_ms="
              f"{self.rows['Sb']['kernel_ms']} plain_ms={s_plain:.3f} "
              f"bound_ms={sb_ms:.5f} ({sb_by})", flush=True)

    def _syncs(self, fn):
        """The synchronizing CUDA operations of one call of fn (torch's
        sync debug mode warns at each), as {(file, line): count}."""
        import collections
        import os
        import warnings

        torch = self.torch
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return collections.Counter(
            (os.path.basename(w.filename), w.lineno) for w in rec
            if "synchroniz" in str(w.message))

    def _batched_vg(self):
        """The batched value+grad at n = MCMC_N, C = MCMC_CHAINS: launch
        counts, a profile and the host syncs of one call, equality with
        the per-chain serial value and gradient, both timed in turns."""
        torch, bf = self.torch, self.bigfit
        from andvaranaut_torch.inference import nuts

        X, y = make_data(MCMC_N)
        rvpack, nlp = bf.make_mixed_objective(X, y, block=MCMC_N,
                                              device=self.dev)
        rng = np.random.default_rng(3)
        Z = rvpack.z0().numpy()[None] + 0.1 + 0.05 * rng.normal(
            size=(MCMC_CHAINS, rvpack.total))
        u_and_grad, _ = nuts.potential_fns(nlp, self.dev)
        U, G = nlp.vec_value_and_grad(Z)
        serial = [u_and_grad(z) for z in Z]
        same = all(U[c] == s[0] and np.array_equal(G[c], s[1])
                   for c, s in enumerate(serial))
        check("batched value+grad vs per-chain serial (n=256, C=8)", same,
              f"bit_exact={same} values={np.array2string(U, precision=6)}")
        self.reset_counts()
        nlp.vec_value_and_grad(Z)
        c = self.counts()
        want = {"K3b": 1, "K7b": 1, "Sb": 1, "K3": 0, "K7": 0, "S": 0,
                "K3_fallback": 0}
        got = {k: c[k] for k in want}
        check("one batched value+grad launches K3b, K7b and Sb once each",
              got == want, f"launches {got} (expected {want})")
        s8 = self._syncs(lambda: nlp.vec_value_and_grad(Z))
        s1 = self._syncs(lambda: nlp.vec_value_and_grad(Z[:1]))
        ok_line = [k for k in s8 if k[0] == "precision.py"]
        check("one host sync for the ok gates of all chains",
              sum(s8[k] for k in ok_line) == 1
              and sum(s8.values()) <= sum(s1.values()) + 1,
              f"syncs by (file, line) C={MCMC_CHAINS}: {dict(s8)}; C=1: "
              f"{dict(s1)}")

        def window():
            for _ in range(20000):
                torch.cuda._sleep(1)
            nlp.vec_value_and_grad(Z)
            for _ in range(20000):
                torch.cuda._sleep(1)
        try:
            seen = self.profile(window, names=True)
        except (RuntimeError, AttributeError, ImportError) as e:
            check("profile of the batched value+grad", False,
                  f"profile unavailable: {e!r}")
            seen = {}
        if seen:
            k3, k7 = seen.get("K3", 0), seen.get("K6/K7", 0)
            sb = seen.get("Sb", 0)
            others = {k: v for k, v in seen.items()
                      if k in ("K6/K7 combine", SLICING)}
            check("profile: one K3, one Sb and one K7 launch for all chains",
                  k3 == 1 and sb == 1 and k7 == 1 and not others,
                  f"K3 launches {k3}, Sb {sb}, K6/K7 {k7} (expected 1 each, "
                  f"C={MCMC_CHAINS}); combine or two-kernel slicing "
                  f"launches {others} (expected none)")
        times = {"loop": [], "batched": []}
        for kind in ("loop", "batched", "batched", "loop"):
            if kind == "loop":
                t, _ = self.wall_ms(lambda: [u_and_grad(z) for z in Z])
            else:
                t, _ = self.wall_ms(lambda: nlp.vec_value_and_grad(Z))
            times[kind].append(t)
        self.mcmc_vg_ms = times
        print(f"  value+grad n={MCMC_N} C={MCMC_CHAINS}: batched_ms="
              f"{times['batched']} per-chain loop_ms={times['loop']}",
              flush=True)

    def _counted_evals(self):
        """Wraps bigfit._nlml_vg_batched (the batched value+grad behind
        the mixed objective's vec_value_and_grad) to count its calls and
        time them (host clock, synchronised).  Returns (stats, restore)."""
        bf, torch = self.bigfit, self.torch
        orig = bf._nlml_vg_batched
        stats = {"calls": 0, "rows": 0, "ms": 0.0}

        def counted(X, y, Z, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(X, y, Z, *a)
            torch.cuda.synchronize()
            stats["ms"] += (time.perf_counter() - t0) * 1e3
            stats["calls"] += 1
            stats["rows"] += Z.shape[0]
            return out

        bf._nlml_vg_batched = counted

        def restore():
            bf._nlml_vg_batched = orig
        return stats, restore

    def mcmc_small(self):
        """The small-n mixed MCMC objective: K3b and K7b against single
        launches and plain versions, their times, the batched value+grad
        (launches, profile, syncs, timed against the per-chain loop), and
        sample_model(mixed=True, sampler='hmc_host', chains=8) at n = 256
        with its posterior mean held against the f64 route's."""
        from andvaranaut_torch.inference import nuts

        errs = self._k3b_checks()
        self._k7b_checks()
        self._k3b_row(errs)
        self._k7b_rows()
        self._batched_vg()
        cfg = _gp_cfg(MCMC_N)
        kw = dict(draws=30, tune=30, chains=MCMC_CHAINS, random_seed=4,
                  sampler="hmc_host", max_treedepth=3, device=self.dev)
        stats, restore = self._counted_evals()
        try:
            self.reset_counts()
            t0 = time.perf_counter()
            d1 = nuts.sample_model(cfg, mixed=True, **kw)
            self.torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            self.mcmc_counts = self.counts()
        finally:
            restore()
        t0 = time.perf_counter()
        d0 = nuts.sample_model(cfg, mixed=False, **kw)
        wall0 = time.perf_counter() - t0
        m0, m1 = d0.posterior_mean(), d1.posterior_mean()
        ok = all(np.allclose(np.asarray(m1[k]), np.asarray(m0[k]),
                             rtol=POST_RTOL, atol=POST_ATOL) for k in m0)
        lp = d1.sample_stats["lp"]
        check("sample_model(mixed, hmc_host, 8 chains) n=256 vs f64 route",
              ok and np.isfinite(lp).all(),
              f"mixed {m1} f64 {m0} (rtol {POST_RTOL}, atol {POST_ATOL}); "
              f"finite lp={bool(np.isfinite(lp).all())}")
        c = self.mcmc_counts
        check("the MCMC run launched K3b, K7b and Sb once per batched call",
              c["K3b"] == stats["calls"] == c["K7b"] and c["K3"] == 0
              and c["K7"] == 0 and c["Sb"] == stats["calls"]
              and stats["calls"] > 0,
              f"batched calls {stats['calls']}, launches K3b={c['K3b']} "
              f"K7b={c['K7b']} Sb={c['Sb']} K3={c['K3']} K7={c['K7']} "
              f"fallback={c['K3_fallback']}")
        ess = min(float(np.min(v)) for v in d1.ess().values())
        ess0 = min(float(np.min(v)) for v in d0.ess().values())
        self.mcmc_small_stats = dict(
            leapfrog_ms=stats["ms"] / max(stats["calls"], 1),
            calls=stats["calls"], wall_s=wall, min_ess=ess,
            ess_per_s=ess / wall, f64_wall_s=wall0, f64_min_ess=ess0,
            accept=float(d1.sample_stats["accept"].mean()))
        print(f"  mcmc n={MCMC_N} C={MCMC_CHAINS} mixed hmc_host: "
              f"{self.mcmc_small_stats}", flush=True)

    def mcmc16k(self):
        """sample_model(mixed=True, sampler='hmc_host', chains=2) on
        make_data(16384), started at the bench hypers (start=: the
        curvature mass there), budget 8 and a few transitions: ms per
        leapfrog, accept rate, finite lp, K1-K6 launches per leapfrog."""
        from andvaranaut_torch.inference import nuts

        cfg = _gp_cfg(N)
        start = {"gv": np.array(GV), "l": np.array(L_SCALES),
                 "kv": np.array([KV])}
        stats, restore = self._counted_evals()
        try:
            self.reset_counts()
            t0 = time.perf_counter()
            data = nuts.sample_model(
                cfg, draws=MCMC16K_DRAWS, tune=MCMC16K_TUNE,
                chains=MCMC16K_CHAINS, random_seed=0, mixed=True,
                sampler="hmc_host", max_treedepth=3, start=start,
                device=self.dev)
            self.torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = self.counts()
        finally:
            restore()
        lp = data.sample_stats["lp"]
        evals, leaps = stats["rows"], max(stats["calls"], 1)
        per = {k: round(c[k] / leaps, 2) for k in ("K1", "K2", "K3", "K4",
                                                    "K5", "K6", "K7")}
        check("mcmc16k: finite lp, K1-K6 launched, K7 not",
              bool(np.isfinite(lp).all()) and evals > 0
              and all(c[k] > 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6"))
              and c["K7"] == 0,
              f"lp={lp.tolist()} leapfrogs (batched calls)={leaps} chain "
              f"value+grads={evals} launches per leapfrog {per}")
        self.mcmc16k_stats = dict(
            leapfrog_ms=stats["ms"] / max(stats["calls"], 1),
            batched_calls=stats["calls"], chain_evals=evals, wall_s=wall,
            accept=float(data.sample_stats["accept"].mean()),
            depth=float(data.sample_stats["depth"].mean()))
        print(f"  mcmc16k: {self.mcmc16k_stats}", flush=True)

    def mcmc_fit(self):
        """GPMCMC.fit(method='mcmc_mean', return_data=True) on the card at
        tests/test_nuts.py's toy (30 LHC samples), default f64 NUTS, then
        mcmc_map plus the MAP refine (predictions at the design points
        within 0.05) and one BO iteration with opt_method='mcmc_map'."""
        import tempfile

        from andvaranaut_torch import dists
        from andvaranaut_torch import transform as tf

        def toy(x):
            return np.array([x[0] ** 2 - x[0] - x[1] ** 2 * x[0] + x[1]])

        priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
        with tempfile.TemporaryDirectory() as rundir:
            g = self.gpmcmc.GPMCMC(
                nx=2, ny=1, priors=priors, target=toy,
                xconrevs=[tf.uniform(p) for p in priors], verbose=False,
                rundir=rundir)
            g.sample(30, seed=5)
            g.change_yconrevs([tf.meanstd(g.y[:, 0])])
            t0 = time.perf_counter()
            data = g.fit(method="mcmc_mean", return_data=True, draws=60,
                         tune=60, chains=2, random_seed=1)
            t_mean = time.perf_counter() - t0
            lp = np.asarray(data.sample_stats["lp"])
            fin = all(np.isfinite(np.asarray(v)).all()
                      for v in g.hypers.values())
            check("facade fit(method='mcmc_mean', return_data=True)",
                  fin and np.isfinite(lp).all() and lp.shape == (2, 60)
                  and g.device.type == "cuda",
                  f"hypers {g.hypers} lp shape {lp.shape} "
                  f"({t_mean:.1f} s)")
            g.fit(method="mcmc_map", draws=30, tune=60, chains=2,
                  random_seed=2)
            err = float(np.abs(g.predict(g.x)[:, 0] - g.y[:, 0]).max())
            check("facade fit(method='mcmc_map') predicts the design points",
                  err < 0.05, f"max |yhat - y| = {err:.3e} (limit 0.05)")
            np.random.seed(0)
            xopt, yopt = g.BO(max_iter=1, opt_method="mcmc_map", draws=30,
                              tune=30, chains=2, random_seed=0)
            check("facade BO(opt_method='mcmc_map') one iteration",
                  g.nsamp == 31 and np.isfinite(xopt).all()
                  and np.isfinite(yopt),
                  f"nsamp={g.nsamp} xopt={xopt} yopt={yopt}")


class FacadePhases:
    """The facade's forward UQ, held-out diagnostics and persistence
    (`uq`) and its inverse problem (`inverse`) at the 16k bench facade
    (`Phases._bo_facade`), on the f64 and the mixed route.  Mixed into
    Phases."""

    # -- uq ----------------------------------------------------------------
    def _uq_route(self, mixed, split, Q, rundir, can_plot):
        """One route's uq run on a fresh 16k facade: conditioning alone,
        y_dist, test_plots on the split, and a pickle round trip; returns
        its results and launch counts."""
        from andvaranaut_torch import load_object, save_object

        gpm = self.gpmcmc
        out = {}
        with self._mixed_route(mixed):
            g = self._bo_facade(rundir)
            st = gpm.GPState(g.kerns, g.ops, g.noise, JITTER, g.gp.xin,
                             g.gp.yin, g.hypers, device=self.dev)
            self.reset_counts()
            out["cond_ms"], _ = self.wall_ms(st.chol)
            out["cond_counts"] = self.counts()
            out["mixed_state"] = st.chol()[4] is not None
            del st
            np.random.seed(UQ_SEED)
            out["draw_ms"], _ = self.wall_ms(
                lambda: g._LHC__latin_sample(UQ_SAMPLES))
            np.random.seed(UQ_SEED)
            self.reset_counts()
            # y_dist, or without matplotlib and seaborn the propagation it
            # plots
            out["uq_ms"], (xs, ys) = self.wall_ms(
                lambda: g.y_dist(nsamps=UQ_SAMPLES, return_data=True)
                if can_plot else g._forward_uq(UQ_SAMPLES))
            out["uq_counts"] = self.counts()
            out["xs"], out["ys"] = xs, ys[:, 0]
            g.train, g.test = split
            out["tp_ms"], (_, yt, yp, yv) = self.wall_ms(lambda: g.test_plots(
                method="none", returndat=True, yplots=False, xplots=False))
            out["metrics"] = gpm._regression_metrics(yp, yt, np.mean(g.y))
            out["tp_finite"] = bool(np.isfinite(yp).all()
                                    and np.isfinite(yv).all())
            fname = os.path.join(rundir, "gp16k.pkl")
            out["save_ms"], _ = self.wall_ms(lambda: save_object(g, fname))
            out["load_ms"], g2 = self.wall_ms(lambda: load_object(fname))
            p1 = g.predict(Q, return_var=True)
            p2 = g2.predict(Q, return_var=True)
            out["reload_equal"] = all(np.array_equal(a, b)
                                      for a, b in zip(p1, p2))
            out["reload_device"] = str(g2.device)
            del g, g2
        self.torch.cuda.empty_cache()
        return out

    def uq(self):
        """y_dist (10000 LHC points), test_plots(method='none') on a fixed
        90/10 split and a save_object/load_object round trip of the 16k
        facade, on the f64 and the mixed route in turns; then the
        tutorial, `python -m andvaranaut_torch.tutorial`, on the card."""
        import tempfile

        can_plot = all(importlib.util.find_spec(m) is not None
                       for m in ("matplotlib", "seaborn"))
        if can_plot:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.show = lambda: plt.close("all")
        else:
            print("  matplotlib/seaborn not installed: y_dist's propagation "
                  "(GPMCMC._forward_uq) runs without its plot", flush=True)
        perm = np.random.default_rng(UQ_SPLIT_SEED).permutation(N)
        ntr = int(np.floor(N * UQ_TRAIN_FRAC))
        split = (perm[:ntr], perm[ntr:])
        Q = np.random.default_rng(4).uniform(size=(SERVE_POINTS, NX))
        name = {False: "f64", True: "mixed"}
        runs = {False: [], True: []}
        for mixed in (False, True):
            with tempfile.TemporaryDirectory() as rundir:
                r = self._uq_route(mixed, split, Q, rundir, can_plot)
            runs[mixed].append(r)
            c, u = r["cond_counts"], r["uq_counts"]
            ok = (r["mixed_state"] == mixed and r["tp_finite"]
                  and np.isfinite(r["ys"]).all()
                  and r["ys"].shape == (UQ_SAMPLES,) and r["reload_equal"]
                  and r["reload_device"].startswith("cuda"))
            if mixed:
                # one conditioning inside y_dist, and K2 in its predict
                ok = ok and (c["K1"] > 0 and c["K3"] > 0
                             and u["K1"] == c["K1"] and u["K3"] == c["K3"]
                             and u["K2"] > c["K2"])
            else:
                ok = ok and all(u[k] == 0 for k in ("K1", "K2", "K3"))
            check(f"uq on the {name[mixed]} route (y_dist, test_plots, "
                  "pickle round trip)", ok,
                  f"mixed state={r['mixed_state']}; conditioning launches "
                  f"K1={c['K1']} K2={c['K2']} K3={c['K3']}, y_dist's "
                  f"K1={u['K1']} K2={u['K2']} K3={u['K3']}; reload predict "
                  f"equal={r['reload_equal']} on {r['reload_device']}")
            us = r["uq_ms"] / UQ_SAMPLES * 1e3
            print(f"  uq route={name[mixed]} y_dist_16k_us_per_pt={us:.3f} "
                  f"(y_dist {r['uq_ms']:.2f} ms: LHC draw "
                  f"{r['draw_ms']:.2f}, conditioning {r['cond_ms']:.2f}) "
                  f"test_plots_ms={r['tp_ms']:.2f} metrics "
                  f"{ {k: float(f'{v:.6e}') for k, v in r['metrics'].items()} }"
                  f" save_ms={r['save_ms']:.2f} load_ms={r['load_ms']:.2f}",
                  flush=True)
        f64, mix = runs[False][0], runs[True][0]
        same_x = np.array_equal(f64["xs"], mix["xs"])
        nmu = float(np.abs(mix["ys"] - f64["ys"]).max()
                    / np.abs(f64["ys"]).max())
        check("y_dist: mixed route's propagation vs f64's", same_x
              and nmu <= MU_RTOL, f"same LHC draw={same_x}; normwise "
              f"{nmu:.3e} (limit {MU_RTOL:g})")
        dm = {k: abs(mix["metrics"][k] - f64["metrics"][k])
              / abs(f64["metrics"][k]) for k in f64["metrics"]}
        check("test_plots: mixed route's held-out metrics vs f64's",
              max(dm.values()) <= METRIC_RTOL,
              f"relative {({k: float(f'{v:.3e}') for k, v in dm.items()})} "
              f"(limit {METRIC_RTOL:g})")
        self._device_profile()
        self._tutorial()

    def _device_profile(self):
        """timing.device_profile around a product on the card writes a
        Chrome trace of the block; its kernel events are counted and not
        held (after the long phases the profiler keeps none or part of a
        short window's device events, PERF.md §6)."""
        import tempfile

        from andvaranaut_torch import timing

        torch = self.torch
        a = torch.ones(2048, 2048, dtype=torch.float64, device=self.dev)
        with tempfile.TemporaryDirectory() as logdir:
            with timing.device_profile(logdir):
                (a @ a).sum()
            with open(os.path.join(logdir, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        mm = [e for e in events if e.get("name") == "aten::mm"]
        check("timing.device_profile writes a trace of the block", len(mm) > 0,
              f"{len(events)} events, aten::mm {len(mm)}, kernel events "
              f"{len(kernels)}")

    def _tutorial(self):
        """The tutorial, on the card (its toy size), in a subprocess."""
        root = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        try:
            res = subprocess.run(
                [sys.executable, "-m", "andvaranaut_torch.tutorial"],
                cwd=root, capture_output=True, text=True, timeout=600)
        except subprocess.TimeoutExpired:
            check("tutorial on the card", False, "timed out after 600 s")
            return
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith(("forward UQ", "BO optimum", "inverse:",
                                   "pickle"))]
        for ln in lines:
            print(f"  tutorial: {ln}", flush=True)
        ok = res.returncode == 0 and "pickle round-trip OK" in res.stdout
        check("tutorial on the card (python -m andvaranaut_torch.tutorial)",
              ok, f"rc={res.returncode}, {time.perf_counter() - t0:.1f} s"
              + ("" if ok else f"; stderr tail: {res.stderr[-2000:]}"))

    # -- inverse -------------------------------------------------------------
    def _inv_vg(self, nlp, z):
        torch = self.torch
        zt = torch.tensor(np.asarray(z), dtype=torch.float64, device=self.dev,
                          requires_grad=True)
        u = nlp(zt)
        (gr,) = torch.autograd.grad(u, zt)
        return float(u.detach()), gr.cpu().numpy()

    def _joint_nlp(self, g, rvpack, yobs, yvar):
        """The reference's inverse objective (gpmcmc.py:1041-1060 of the
        JAX package) written out on the card: the joint (N + nobs) Gram
        over [xc ; x repeated nobs times], f64 Cholesky, autograd."""
        torch, eng = self.torch, self.engine
        from andvaranaut_torch.gp import quad

        nobs = len(yobs)
        l, kv, _, alpha = eng.hypers_to_args(g.hypers, g.noise,
                                             device=self.dev)
        xc = torch.as_tensor(g.xc, device=self.dev)
        ycon = g.yconrevs[0]
        yin = torch.as_tensor(np.r_[g.yc[:, 0], np.asarray(ycon.con(yobs))],
                              device=self.dev)
        nvar = np.zeros(g.nsamp + nobs)
        if g.noise:
            nvar[:g.nsamp] = float(np.asarray(g.hypers["gv"]))
        if yvar is not None:
            nvar[g.nsamp:] = np.asarray(quad.gh_var_inv(ycon.con, yobs, yvar))
        nv = torch.as_tensor(nvar + JITTER, device=self.dev)
        ldj = float(np.sum(np.log(np.asarray(
            ycon.der(np.r_[g.y[:, 0], yobs])))))

        def nlp(z):
            vals = rvpack.unpack(z)
            xcrow = torch.cat([g.xconrevs[k].con(vals[f"x{k}"])
                               for k in range(NX)])
            xin = torch.cat([xc, xcrow.expand(nobs, NX)])
            K = self.kernels.gram(g.kerns, g.ops, xin, None, l, kv, alpha)
            K = K + torch.diag(nv)
            return -(eng.chol_nlml(K, yin) + ldj + rvpack.log_prior(z))

        return nlp

    def _inv_band(self, g, rvpack, z, yobs, yvar):
        """The observations' term at z on the exact state: s2 = kss -
        |L^-1 k|^2, gv, kss, |du/ds2|, s_min = s2 + min nv_o and n.  The
        value moves by |du/ds2| per unit error of s2, a length-n dot
        product (rounding bound gamma_n kss, gamma_n = n eps) that the
        mixed route holds to VAR_RTOL (s2 + gv); the gradient by about
        2 |ds2| / s_min relative."""
        torch = self.torch
        from andvaranaut_torch.gp import quad

        st = g._inverse_state()
        L, v, xin_p, valid, _ = st.chol(JITTER)
        l, kv, gv, alpha = st.hyper_args()
        zt = torch.as_tensor(np.asarray(z), device=self.dev)
        X = torch.stack([g.xconrevs[k].con(rv.forward(zt[off:off + 1]))
                         for k, (rv, off) in enumerate(zip(rvpack.rvs,
                                                           rvpack.offsets))],
                        1)
        k = self.kernels.gram(st.kerns, st.ops, xin_p, X, l, kv, alpha)
        A = torch.linalg.solve_triangular(
            L, k * valid.to(torch.float64)[:, None], upper=False)
        kss = float(kv.sum())
        s2 = kss - float((A * A).sum())
        ycon = g.yconrevs[0]
        nv = (np.zeros(len(yobs)) if yvar is None
              else np.asarray(quad.gh_var_inv(ycon.con, yobs, yvar)))
        r = np.asarray(ycon.con(yobs)) - float(A[:, 0] @ v)
        Cinv = np.linalg.inv(s2 + np.diag(nv + JITTER))
        one = np.ones(len(yobs))
        du = abs(0.5 * (one @ Cinv @ one - (one @ Cinv @ r) ** 2))
        return {"s2": s2, "gv": float(gv), "kss": kss, "du": du,
                "smin": s2 + float(nv.min()) + JITTER, "n": len(st.xin)}

    def _train_band(self, g):
        """eps kss (tr K^-1 + |K^-1 y|^2): the first-order change of the
        training block's log density when K moves by one ulp of kss, from
        the exact state's factor."""
        torch = self.torch
        st = g._inverse_state()
        L, v = st.chol(JITTER)[:2]
        Linv = torch.linalg.solve_triangular(
            L, torch.eye(L.shape[0], dtype=L.dtype, device=L.device),
            upper=False)
        tr = float((Linv * Linv).sum())
        a = Linv.T @ v
        del Linv
        kss = float(np.sum(g.hypers["kv"]))
        return np.finfo(np.float64).eps * kss * (tr + float(a @ a))

    def _inv_objective(self, g, rvpack, zs, yobs, yvar, label):
        """The port's objective against the joint-Cholesky algebra on the
        f64 route, then the mixed route's against the f64 route's, with
        each one's launches and time per value+grad.  The value is held
        at INV_VALUE_RTOL or at its f64 rounding band where that is
        larger (tests/test_torch_inverse.py: the training block's
        `_train_band` plus gamma_n kss |du/ds2|)."""
        eps = np.finfo(np.float64).eps
        nlp = g._inverse_nlp(rvpack, yobs, yvar, JITTER)
        joint = self._joint_nlp(g, rvpack, yobs, yvar)
        b_train = self._train_band(g)
        obs = [self._inv_band(g, rvpack, z, yobs, yvar) for z in zs]
        ref, worst_v, eg, lines = [], 0.0, 0.0, []
        for z, o in zip(zs, obs):
            u, gr = self._inv_vg(nlp, z)
            uj, grj = self._inv_vg(joint, z)
            ref.append((u, gr))
            b_obs = o["n"] * eps * o["kss"] * o["du"]
            tol = max(INV_VALUE_RTOL * abs(uj), b_train + b_obs)
            worst_v = max(worst_v, abs(u - uj) / tol)
            eg = max(eg, float(np.abs(gr - grj).max() / np.abs(grj).max()))
            lines.append(f"u={u:.12e} joint={uj:.12e} rel "
                         f"{abs(u - uj) / abs(uj):.3e} bands train "
                         f"{b_train:.3e} obs {b_obs:.3e} (s2={o['s2']:.3e})")
        for ln in lines:
            print(f"  {ln}", flush=True)
        check(f"inverse objective ({label}) vs the joint Cholesky, f64 "
              "route", worst_v <= 1.0 and eg <= INV_GRAD_RTOL,
              f"value |d| / max({INV_VALUE_RTOL:g} |u|, rounding band) max "
              f"{worst_v:.3f} (limit 1), gradient normwise {eg:.3e} (limit "
              f"{INV_GRAD_RTOL:g}) at {len(zs)} z")
        t_port = self.ms(lambda: self._inv_vg(nlp, zs[0]), reps=10)
        t_joint = self.ms(lambda: self._inv_vg(joint, zs[0]), reps=2)
        print(f"  inverse ({label}) f64 route: ms_per_eval={t_port:.3f} "
              f"(value+grad on the conditioned state) joint_cholesky_ms="
              f"{t_joint:.2f} ({t_joint / t_port:.1f}x)", flush=True)
        del joint
        self.torch.cuda.empty_cache()
        with self._mixed_route(True):
            g.gp._cache.clear()
            self.reset_counts()
            build_ms, nlpm = self.wall_ms(
                lambda: g._inverse_nlp(rvpack, yobs, yvar, JITTER))
            built = self.counts()
            self.reset_counts()
            got = [self._inv_vg(nlpm, z) for z in zs]
            V, G = nlpm.vec_value_and_grad(zs)
            self.sync()
            evals = self.counts()
            t_mixed = self.ms(lambda: self._inv_vg(nlpm, zs[0]), reps=5)
            del nlpm
            g.gp._cache.clear()
        ok = (built["K1"] > 0 and built["K3"] > 0 and evals["K1"] == 0
              and evals["K3"] == 0 and evals["K2"] > 0)
        worst_v = worst_g = 0.0
        for (u0, g0), (u1, g1), o, vb, gb in zip(ref, got, obs, V, G):
            ds2 = VAR_RTOL * (o["s2"] + o["gv"])
            tol = NLML_RTOL * abs(u0) + ds2 * o["du"]
            gtol = max(VG_GRAD_RTOL, 2 * ds2 / o["smin"])
            worst_v = max(worst_v, abs(u1 - u0) / tol, abs(vb - u0) / tol)
            worst_g = max(worst_g, float(np.abs(g1 - g0).max()
                                         / np.abs(g0).max()) / gtol,
                          float(np.abs(gb - g0).max()
                                / np.abs(g0).max()) / gtol)
        ok = ok and worst_v <= 1.0 and worst_g <= 1.0
        check(f"inverse objective ({label}), mixed route vs f64 route", ok,
              f"value |d| / (NLML_RTOL |u| + VAR_RTOL (s2 + gv) |du/ds2|) "
              f"max {worst_v:.3f} (limit 1), gradient normwise / max("
              f"VG_GRAD_RTOL, 2 VAR_RTOL (s2 + gv) / s_min) max "
              f"{worst_g:.3f} (limit 1), serial and batched; launches "
              f"building K1={built['K1']} K3={built['K3']}, in {len(zs)} "
              f"serial + 1 batched evaluations K1={evals['K1']} "
              f"K2={evals['K2']} K3={evals['K3']}")
        print(f"  inverse ({label}) mixed route: objective built in "
              f"{build_ms:.2f} ms, ms_per_eval={t_mixed:.3f}", flush=True)

    def _inv_solve(self, g, yobs, mixed):
        """inverse_opt(method='map') on one route: wall, evaluations,
        launches; the surrogate's mean at xopt within INV_SD sd of yobs."""
        real = g._inverse_nlp
        count = [0]

        def counted(*a, **k):
            nlp = real(*a, **k)

            def f(z):
                count[0] += 1
                return nlp(z)

            f.vec_value_and_grad = nlp.vec_value_and_grad
            return f

        with self._mixed_route(mixed):
            g.gp._cache.clear()
            g._inverse_nlp = counted
            np.random.seed(11)
            self.reset_counts()
            try:
                t_ms, (data, xopt) = self.wall_ms(
                    lambda: g.inverse_opt(yobs, method="map"))
            finally:
                del g.__dict__["_inverse_nlp"]
            counts = self.counts()
            st = self.gpmcmc.GPState(g.kerns, g.ops, g.noise, JITTER,
                                     g.gp.xin, g.gp.yin, g.hypers,
                                     device=self.dev)
            self.reset_counts()
            st.chol()
            cond = self.counts()
            del st
            mu, var = g.predict(xopt[None], return_var=True)
            g.gp._cache.clear()
        sd = float(np.sqrt(var[0, 0]))
        dev = abs(float(mu[0, 0]) - float(yobs[0]))
        ok = data is None and np.isfinite(xopt).all() and dev <= INV_SD * sd
        if mixed:
            # conditioned twice: the objective's state and the final
            # predict's, as the reference's
            ok = ok and (counts["K1"] == 2 * cond["K1"] > 0
                         and counts["K3"] == 2 * cond["K3"] > 0)
        route = "mixed" if mixed else "f64"
        check(f"inverse_opt(method='map') at 16k, {route} route", ok,
              f"xopt={xopt} (x*={np.array(INV_XSTAR)}); mean at xopt "
              f"{float(mu[0, 0]):.6e} vs yobs {float(yobs[0]):.6e}: "
              f"{dev / sd:.3f} sd (limit {INV_SD:g}); launches K1="
              f"{counts['K1']} K3={counts['K3']} (one conditioning: "
              f"K1={cond['K1']} K3={cond['K3']})")
        print(f"  inverse_map_16k route={route} wall_ms={t_ms:.2f} "
              f"evaluations={count[0]} ms_per_eval_in_solve="
              f"{t_ms / max(count[0], 1):.3f}", flush=True)

    def _inv_mcmc(self, g, rvpack, yobs):
        """A short inverse_opt(method='mcmc_mean', sampler='hmc_host') on
        the f64 route: finite draws, every chain accepting, and the batched
        objective equal to the serial one at the chains' first draws."""
        torch = self.torch
        t_ms, (data, xopt) = self.wall_ms(lambda: g.inverse_opt(
            yobs, method="mcmc_mean", sampler="hmc_host", random_seed=0,
            **INV_MCMC))
        post = {k: np.asarray(v) for k, v in data.posterior.items()}
        acc = np.asarray(data.sample_stats["accept"]).mean(axis=1)
        nlp = g._inverse_nlp(rvpack, yobs, None, JITTER)
        Z = torch.stack([rvpack.pack_values({k: post[k][c, 0] for k in post})
                         for c in range(INV_MCMC["chains"])]).numpy()
        V, _ = nlp.vec_value_and_grad(Z)
        worst = 0.0
        eps = np.finfo(np.float64).eps
        for c, z in enumerate(Z):
            u = float(nlp(torch.as_tensor(z, device=self.dev)))
            o = self._inv_band(g, rvpack, z, yobs, None)
            rb = o["n"] * eps * o["kss"] * o["du"]
            worst = max(worst, abs(V[c] - u) / max(1e-12 * abs(u), rb))
        fin = all(np.isfinite(v).all() for v in post.values())
        ok = fin and (acc > 0).all() and np.isfinite(xopt).all() and worst <= 1
        check("inverse_opt(method='mcmc_mean', sampler='hmc_host') at 16k",
              ok, f"{INV_MCMC}; finite={fin}; accept per chain "
              f"{np.round(acc, 3).tolist()}; xopt={xopt}; batched vs serial "
              f"at the first draws |d| / max(1e-12 |u|, gamma_n kss |du/ds2|)"
              f" max {worst:.3f} (limit 1); {t_ms / 1e3:.1f} s")

    def inverse(self):
        """The inverse problem at the 16k bench facade: the objective on
        the conditioned state against the joint-Cholesky algebra (nobs 1;
        nobs 4 with yvarobs) and on the mixed route, the MAP solve on both
        routes, and a short hmc_host run."""
        import tempfile

        from andvaranaut_torch.inference.unconstrained import RVPack

        xstar = np.array(INV_XSTAR)
        y1 = bench_target(xstar)
        y4 = y1[0] + np.array([0.0, 0.004, -0.006, 0.002])
        zs = np.random.default_rng(INV_Z_SEED).normal(size=(INV_Z_COUNT, NX))
        with tempfile.TemporaryDirectory() as rundir:
            g = self._bo_facade(rundir)
            rvpack = RVPack(tuple(g._prior_rv(k) for k in range(NX)))
            self._inv_objective(g, rvpack, zs, y1, None, "nobs=1")
            self._inv_objective(g, rvpack, zs, y4, np.full(4, 1e-4),
                                "nobs=4, yvarobs 1e-4")
            for mixed in (False, True):
                self._inv_solve(g, y1, mixed)
            self._inv_mcmc(g, rvpack, y1)
            del g


class WarpedPhases:
    """The learnable warpings on the card (`warped`): the 16k warped
    value+grad on the mixed route, big_warped_map_fit and the facade at
    WARP_FIT_N, and the mixed warped MCMC objective.  Mixed into Phases."""

    def _warp_cfg(self, X, y, iwgp=True, cwgp=True):
        """A FitConfig of bench data with the warpers of the headline
        configuration (the wgp stages of tests/test_bigfit_warped.py)."""
        from andvaranaut_torch import dists
        from andvaranaut_torch import transform as tf
        from andvaranaut_torch.lhc import _none_conrev

        prior = dists.Uniform(0.0, 1.0)
        xc = [tf.wgp(["uniform", "kumaraswamy"], np.array([1.0, 1.0]),
                     xdist=prior) if iwgp else tf.uniform(prior),
              tf.uniform(prior)]
        yc = [tf.wgp(["meanstd", "sinharcsinh"], np.array([0.0, 1.0]),
                     y=y) if cwgp else _none_conrev()]
        return self.engine.FitConfig(
            kerns=("RBF",), ops=(), noise=True, truncate=False,
            jitter=JITTER, iwgp=iwgp, cwgp=cwgp, priors=[prior, prior],
            xconrevs=xc, yconrevs=yc, x=X, y=y[:, None])

    def _plain_calls(self):
        """`plain_calls`: calls of the kernels' plain versions."""
        return plain_calls()

    @contextlib.contextmanager
    def _warped_vgs(self):
        """Records every value+grad that bigfit.make_warped_vg builds
        while the block runs (their .calls count evaluations)."""
        bf = self.bigfit
        orig = bf.make_warped_vg
        made = []

        def recording(*a, **k):
            rvpack, vg = orig(*a, **k)
            made.append(vg)
            return rvpack, vg

        bf.make_warped_vg = recording
        try:
            yield made
        finally:
            bf.make_warped_vg = orig

    def _f64_warped(self, cfg):
        """(rvpack, fun): fun(z) -> (log posterior, gradient) of the port's
        exact f64 warped objective by autograd on the card (the
        yardstick)."""
        torch = self.torch
        rvpack, nlp = self.engine.build_objective(cfg, device=self.dev)

        def fun(z):
            zz = torch.as_tensor(z, dtype=torch.float64).to(
                self.dev).clone().requires_grad_()
            u = nlp(zz)
            (g,) = torch.autograd.grad(u, zz)
            return -float(u.detach()), -g

        return rvpack, fun

    def _warped_vg_case(self, X, y, iwgp, cwgp, label):
        """One warped value+grad at N rows, counted from zero, against
        f64 autograd; returns (counts, value+grad callable, f64 ms)."""
        torch = self.torch
        cfg = self._warp_cfg(X, y, iwgp, cwgp)
        rvpack, vg = self.bigfit.make_warped_vg(cfg, block=BLOCK,
                                                device=self.dev)
        rng = np.random.default_rng(WARP_Z_SEED)
        z = rvpack.z0() + WARP_Z_SCALE * torch.as_tensor(
            rng.standard_normal(rvpack.total))
        self.reset_counts()
        with self._plain_calls() as plain:
            first_ms, (v, g) = self.wall_ms(lambda: vg(z))
        counts = self.counts()
        zz = z.clone().requires_grad_()
        lp = rvpack.log_prior(zz)
        (gp,) = torch.autograd.grad(lp, zz)
        v = float(v) + float(lp.detach())
        g = g + gp.to(self.dev)
        _, f64 = self._f64_warped(cfg)
        f64_ms, (vx, gx) = self.wall_ms(lambda: f64(z))
        vrel = abs(v - vx) / abs(vx)
        gnorm = float((g - gx).abs().max() / gx.abs().max())
        check(f"warped {label} value+grad vs f64 autograd on the card",
              vrel <= VG_VALUE_RTOL and gnorm <= VG_GRAD_F64_RTOL
              and bool(torch.isfinite(g).all()),
              f"logpost={v:.10e} f64={vx:.10e} rel={vrel:.3e} (limit "
              f"{VG_VALUE_RTOL:g}); grad={g.cpu().numpy()} f64="
              f"{gx.cpu().numpy()} normwise rel={gnorm:.3e} (limit "
              f"{VG_GRAD_F64_RTOL:g}); first run {first_ms:.2f} ms, f64 "
              f"autograd {f64_ms:.2f} ms")
        check(f"warped {label} value+grad went through K1-K6, no plain "
              f"version", all(counts[k] > 0 for k in ("K1", "K2", "K3",
                                                       "K4"))
              and counts["K5"] == counts["K6"] == 1 and counts["K7"] == 0
              and counts["K3_fallback"] == 0 and not plain,
              f"launches {counts}; plain versions called {plain}")
        return counts, (lambda: vg(z)), f64_ms

    def _warped_vg16k(self):
        """The 16k warped value+grad with iwgp and cwgp, and with each
        alone; 3 timed evaluations of the first after its counted one."""
        X, y = make_data(N)
        counts, vg, f64_ms = self._warped_vg_case(X, y, True, True,
                                                  "16k iwgp+cwgp")
        self.warped_counts = counts
        times = [self.wall_ms(vg)[0] for _ in range(REPS)]
        self.torch.cuda.empty_cache()
        self._warped_vg_case(X, y, False, True, "16k cwgp")
        self.torch.cuda.empty_cache()
        self._warped_vg_case(X, y, True, False, "16k iwgp")
        mv, mf = getattr(self, "map_vg_16k", (None, None))
        print(f"  warped_vg_16k_ms median={statistics.median(times):.2f} "
              f"(runs {', '.join(f'{t:.2f}' for t in times)}) beside this "
              f"run's map_vg_16k_ms median={mv} and f64 autograd (unwarped "
              f"{mf}, warped {f64_ms:.2f}); all include the Gram", flush=True)
        self.try_profile(vg)

    def _warped_fit(self):
        """big_warped_map_fit (iwgp and cwgp) at WARP_FIT_N against a
        converged L-BFGS-B fit of the same priors, start and unbounded z
        on the f64 autograd objective: log posterior within FIT_LP_RTOL."""
        from scipy.optimize import minimize

        X, y = make_data(WARP_FIT_N)
        cfg = self._warp_cfg(X, y)
        with self._warped_vgs() as made:
            port_ms, (h1, lp1) = self.wall_ms(
                lambda: self.bigfit.big_warped_map_fit(
                    cfg, block=BLOCK, maxiter=WARP_FIT_MAXITER,
                    device=self.dev))
        evals = made[0].calls
        rvpack, f64 = self._f64_warped(cfg)
        nfev = [0]

        def fun(z):
            nfev[0] += 1
            v, g = f64(z)
            return -v, -g.cpu().numpy()

        ref_ms, res = self.wall_ms(lambda: minimize(
            fun, rvpack.z0().numpy(), jac=True, method="L-BFGS-B",
            options={"maxiter": 500, "ftol": 1e-12}))
        lp0 = -float(res.fun)
        h0 = {k: v.cpu().numpy().tolist() for k, v in rvpack.unpack(
            self.torch.as_tensor(res.x)).items()}
        lp_at = f64(rvpack.pack_values(h1))[0]
        rel = abs(lp1 - lp0) / abs(lp0)
        check(f"big_warped_map_fit n={WARP_FIT_N} vs f64 L-BFGS-B",
              rel <= FIT_LP_RTOL,
              f"logpost={lp1!r} f64={lp0!r} rel={rel:.3e} (limit "
              f"{FIT_LP_RTOL:g}); f64 objective at the port's optimum "
              f"{lp_at!r}; port {evals} evaluations in {port_ms:.1f} ms "
              f"({port_ms / max(evals, 1):.2f} ms each), hypers "
              f"{ {k: v.tolist() for k, v in h1.items()} }; f64 {nfev[0]} "
              f"evaluations in {ref_ms:.1f} ms, hypers {h0}")
        self.warped_fit_stats = dict(wall_ms=port_ms, evals=evals,
                                     f64_wall_ms=ref_ms, f64_evals=nfev[0])

    def _warped_facade(self):
        """fit(method='map', iwgp=True, cwgp=True) on the mixed route, then
        the default f64 route, at WARP_FIT_N rows of bench data: the
        warpers written back equal the fitted hypers (cwgp in the
        reference's interleaved order), and the predictions at the design
        points lie within the scaled reference bound of the latent
        function."""
        import tempfile

        from andvaranaut_torch import transform as tf

        X, y = make_data(WARP_FIT_N)
        cfg = self._warp_cfg(X, y)
        g0, g1 = np.meshgrid(np.linspace(0.0, 2.0, 201),
                             np.linspace(1.0, 1.5, 201))
        toy = g0 ** 2 - g0 - g1 ** 2 * g0 + g1
        b0, b1 = np.meshgrid(np.linspace(0.0, 1.0, 201),
                             np.linspace(0.0, 1.0, 201))
        latent_fn = np.sin(3 * b0) + b1 ** 2
        bound = WARP_PRED_TOY * np.ptp(latent_fn) / np.ptp(toy)
        latent = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
        with tempfile.TemporaryDirectory() as rundir:
            for precision_ in ("mixed", "f64"):
                g = self.gpmcmc.GPMCMC(
                    nx=NX, ny=1, priors=cfg.priors, target=bench_target,
                    xconrevs=cfg.xconrevs, yconrevs=cfg.yconrevs,
                    verbose=False, rundir=rundir, device=self.dev)
                g.set_data(X, y[:, None])
                ms, _ = self.wall_ms(lambda: g.fit(
                    method="map", precision=precision_, iwgp=True,
                    cwgp=True))
                h = g.hypers
                cw = np.asarray(self.engine.interleave_cwgp(
                    {k: self.torch.as_tensor(np.atleast_1d(h[k]))
                     for k in ("cwgp", "cwgp_pos")}, g.yconrevs[0].pos))
                written = (isinstance(g.yconrevs[0], tf.wgp)
                           and np.array_equal(np.asarray(
                               g.yconrevs[0].params, dtype=float), cw)
                           and np.array_equal(np.asarray(
                               g.xconrevs[0].params, dtype=float),
                               np.asarray(h["iwgp"], dtype=float)))
                pms, yhat = self.wall_ms(lambda: g.predict(X))
                err = float(np.abs(yhat[:, 0] - latent).max())
                check(f"facade warped fit ({precision_}) n={WARP_FIT_N}",
                      written and err <= bound,
                      f"fit {ms:.1f} ms, warpers written back {written} "
                      f"(cwgp in wgp order {cw.tolist()}, iwgp "
                      f"{np.asarray(h['iwgp']).tolist()}); predict "
                      f"{pms:.1f} ms, max |yhat - latent| {err:.3e} (limit "
                      f"{bound:.3e}); hypers "
                      f"{ {k: np.asarray(v).tolist() for k, v in h.items()} }")
                del g

    def _warped_mcmc(self):
        """sample_model(mixed=True, sampler='hmc_host', chains=2) on a
        cwgp configuration at WARP_MCMC_N (one block: K3 and K7, chain by
        chain): finite lp, cwgp and cwgp_pos in the posterior, launches
        per value+grad."""
        from andvaranaut_torch.inference import nuts

        X, y = make_data(WARP_MCMC_N)
        cfg = self._warp_cfg(X, y, iwgp=False, cwgp=True)
        self.reset_counts()
        with self._warped_vgs() as made, self._plain_calls() as plain:
            ms, data = self.wall_ms(lambda: nuts.sample_model(
                cfg, draws=10, tune=10, chains=2, random_seed=0,
                mixed=True, sampler="hmc_host", max_treedepth=3,
                device=self.dev))
        c = self.counts()
        calls = max(made[0].calls, 1)
        per = {k: round(v / calls, 2) for k, v in c.items() if v}
        lp = data.sample_stats["lp"]
        check("warped mixed MCMC (hmc_host, cwgp, 2 chains)",
              bool(np.isfinite(lp).all()) and "cwgp" in data.posterior
              and "cwgp_pos" in data.posterior and c["K3"] > 0
              and c["K7"] > 0 and not plain,
              f"{made[0].calls} value+grads in {ms:.1f} ms, launches per "
              f"value+grad {per}, plain versions called {plain}, lp "
              f"{lp.tolist()}")

    def warped(self):
        """The learnable warpings: `_warped_vg16k`, `_warped_fit`,
        `_warped_facade`, `_warped_mcmc`."""
        for part in (self._warped_vg16k, self._warped_fit,
                     self._warped_facade, self._warped_mcmc):
            t0 = time.perf_counter()
            part()
            self.torch.cuda.empty_cache()
            print(f"  {part.__name__}_seconds="
                  f"{time.perf_counter() - t0:.1f}", flush=True)


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _events_ms(torch, fn, reps, warm=1):
    """CUDA-event ms of one call of fn, over reps back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _k2_sharded_row(torch, label, A, B):
    """K2 at one of the sharded path's shapes, at its slice count
    (sharded.NSLICES): bit for bit with its plain version, the wrapper,
    the product kernel alone, the plain version and f64 torch.matmul
    timed, and the bound."""
    import andvaranaut_torch.gp.sharded as sharded
    import andvaranaut_torch.gp.slicemm as sm

    ns = sharded.NSLICES
    got = sm.slice_matmul(A, B, nslices=ns)
    want = sm.slice_matmul_plain(A, B, ns)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    del got, want
    torch.cuda.empty_cache()
    ms = _events_ms(torch, lambda: sm.slice_matmul(A, B, nslices=ns), reps=3)
    ops = sm._k2_operands(A, B, ns, 0)
    C = torch.empty((A.shape[0], B.shape[1]), dtype=torch.float64,
                    device=A.device)
    kernel_ms = _events_ms(torch, lambda: sm._k2_product(ops, C, ns), reps=3)
    del ops, C
    plain_ms = _events_ms(torch, lambda: sm.slice_matmul_plain(A, B, ns),
                          reps=1, warm=0)
    lib_ms = _events_ms(torch, lambda: torch.matmul(A, B), reps=3)
    m, k = A.shape
    n = B.shape[1]
    b_ms, b_by = bound(m * k * n * 2 * ns * (ns + 1) // 2,
                       (m * k + k * n + m * n) * 8, PEAK_INT8_OPS)
    torch.cuda.empty_cache()
    return dict(label=label, shape=f"({m}, {k}) @ ({k}, {n})",
                a_transposed=not A.is_contiguous(), nslices=ns,
                bit_exact=same, max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def _shard_vg_rank(n, block, reps, device, k2_checks):
    """One rank's part of the sharded 16k value+grad at map_vg's z: a
    counted first evaluation (launches per kernel, plain versions called,
    peak memory), `reps` evaluations with the collectives timed, and,
    with k2_checks on the last rank, K2 at the four sharded shapes
    (`_k2_sharded_row`) on the operands recorded in the counted run."""
    import torch

    from andvaranaut_torch import distributed
    from andvaranaut_torch.gp import sharded

    mesh = sharded.data_mesh(device=device)
    _, d, D, dev = distributed.mesh_axis(mesh)
    X, y = make_data(n)
    z = np.log([GV, *L_SCALES, KV])
    m = -(-n // D)
    calls, recorded = [], {}
    orig = sharded._mixed_ops

    def recording_ops(block_):
        mm, chol_inv = orig(block_)

        def rec(A, B):
            # the last rank's calls: its panel (first), its trailing
            # update (after the panel's refinement products), the first
            # full-width product with A as is (the L^-1 pipeline) and
            # with A a transposed view (K^-1)
            i = len(calls)
            calls.append(1)
            label = None
            if i == 0:
                label = "panel"
            elif i == 1 + 2 * sharded.PANEL_REFINE:
                label = "trailing"
            elif B.shape[1] == D * m and A.is_contiguous():
                label = "Linv"
            elif B.shape[1] == D * m and A.stride(0) == 1:
                label = "Kinv"
            if k2_checks and d == D - 1 and label and label not in recorded:
                recorded[label] = (A.clone(), B.clone())
            return mm(A, B)

        return rec, chol_inv

    sharded._mixed_ops = recording_ops
    try:
        rvpack, _, vg = sharded.make_sharded_mixed_objective(
            mesh, X, y, block=block)
    finally:
        sharded._mixed_ops = orig
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    with plain_calls() as plain:
        _sync(torch, dev)
        t0 = time.perf_counter()
        v, g = vg(z)
        _sync(torch, dev)
        first_ms = (time.perf_counter() - t0) * 1e3
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    times, coll, nbytes = [], [], 0
    distributed.STATS.timed = True
    try:
        for _ in range(reps):
            distributed.STATS.reset()
            _sync(torch, dev)
            t0 = time.perf_counter()
            vg(z)
            _sync(torch, dev)
            times.append((time.perf_counter() - t0) * 1e3)
            coll.append(distributed.STATS.seconds * 1e3)
            nbytes = distributed.STATS.bytes
    finally:
        distributed.STATS.timed = False
    shapes = {label: (tuple(A.shape), tuple(B.shape), A.stride())
              for label, (A, B) in recorded.items()}
    k2 = [_k2_sharded_row(torch, label, *recorded.pop(label))
          for label in ("panel", "trailing", "Linv", "Kinv")
          if label in recorded and dev.type == "cuda"]
    del vg, recorded
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(rank=d, ranks=D, backend=torch.distributed.get_backend(),
                value=float(v), grad=g.cpu().numpy(), counts=counts,
                plain=plain, first_ms=first_ms, times=times,
                collective_ms=coll, bytes=nbytes, peak_bytes=peak, k2=k2,
                k2_shapes=shapes)


def _shard_small_rank(n, block, points, device, rundir):
    """One rank's part of the 4096-row checks: make_sharded_predict of
    `points` points, sharded_big_map_fit, the facade's
    fit(precision='distributed', cwgp=True) and sample_model(mesh=), each
    with its wall; the single-device references run in the parent."""
    import torch

    from andvaranaut_torch import dists, distributed, gpmcmc
    from andvaranaut_torch import transform as tf
    from andvaranaut_torch.gp import engine, sharded
    from andvaranaut_torch.inference import nuts
    from andvaranaut_torch.lhc import _none_conrev

    mesh = sharded.data_mesh(device=device)
    _, d, _, dev = distributed.mesh_axis(mesh)
    X, y = make_data(n)
    Xq = np.random.default_rng(SHARD_Q_SEED).uniform(size=(points, NX))
    hypers = {"l": np.array(L_SCALES), "kv": np.array([KV]),
              "gv": np.array(GV)}
    out = {}

    def wall(fn):
        _sync(torch, dev)
        t0 = time.perf_counter()
        r = fn()
        _sync(torch, dev)
        return (time.perf_counter() - t0) * 1e3, r

    out["predict_ms"], (mu, var) = wall(lambda: sharded.make_sharded_predict(
        mesh, X, y, hypers, block=block)(Xq))
    out["mu"], out["var"] = mu, var
    made = []
    orig = sharded.make_sharded_mixed_objective

    def recording(*a, **k):
        res = orig(*a, **k)
        made.append(res[2])
        return res

    sharded.make_sharded_mixed_objective = recording
    try:
        out["fit_ms"], (h, lp) = wall(lambda: sharded.sharded_big_map_fit(
            X, y, mesh=mesh, block=block, maxiter=SHARD_FIT_MAXITER))
        out["fit_evals"] = made[-1].calls
        out["fit_hypers"], out["fit_logpost"] = h, lp
        cfg = engine.FitConfig(
            kerns=("RBF",), ops=(), noise=True, truncate=False,
            jitter=JITTER, iwgp=False, cwgp=False, priors=[None, None],
            xconrevs=[_none_conrev(), _none_conrev()],
            yconrevs=[_none_conrev()], x=X, y=y[:, None])
        out["mcmc_ms"], data = wall(lambda: nuts.sample_model(
            cfg, mesh=mesh, random_seed=0, **SHARD_MCMC))
        out["mcmc_evals"] = made[-1].calls
        out["mcmc_lp"] = np.asarray(data.sample_stats["lp"])
        out["mcmc_accept"] = np.asarray(data.sample_stats["accept"])
    finally:
        sharded.make_sharded_mixed_objective = orig
    prior = dists.Uniform(0.0, 1.0)
    g = gpmcmc.GPMCMC(
        nx=NX, ny=1, priors=[prior, prior], target=bench_target,
        xconrevs=[tf.uniform(prior), tf.uniform(prior)],
        yconrevs=[tf.wgp(["meanstd", "sinharcsinh"], np.array([0.0, 1.0]),
                         y=y)],
        verbose=False, rundir=os.path.join(rundir, f"rank{d}"), device=dev)
    g.set_data(X, y[:, None])
    out["facade_ms"], _ = wall(lambda: g.fit(
        method="map", precision="distributed", cwgp=True, block=block,
        maxiter=SHARD_FACADE_MAXITER, mesh=mesh))
    out["facade_hypers"] = {k: np.asarray(v) for k, v in g.hypers.items()}
    out["facade_yhat"] = g.predict(X)[:, 0]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


class ShardedPhases:
    """The row-sharded paths on the card (`sharded`): ranks spawned by
    `distributed.RankPool` share it over gloo (NCCL refuses two ranks of
    one communicator on one device), one rank runs on NCCL.  Mixed into
    Phases."""

    def _same_on_ranks(self, label, every, keys):
        """Each rank's replicated outputs `keys` equal rank 0's bit for
        bit."""
        bad = [(r, k) for r, res in enumerate(every) for k in keys
               if not np.array_equal(np.asarray(res[k]),
                                     np.asarray(every[0][k]))]
        check(f"{label}: replicated outputs equal on every rank", not bad,
              f"keys {keys}; differing (rank, key) {bad}")

    def _shard_vg_checks(self, label, every, vx, gx, gs):
        """map_vg's limits: value 1e-6 and gradient 5e-4 normwise vs f64
        autograd, gradient 1e-4 normwise vs the single-device value+grad;
        K1, K2, K3 and S launched on each rank, K4-K7 not, no plain
        version called, no K3 fallback."""
        r0 = every[0]
        g = np.asarray(r0["grad"])
        vrel = abs(r0["value"] - vx) / abs(vx)
        gnorm = float(np.abs(g - gx).max() / np.abs(gx).max())
        snorm = float(np.abs(g - gs).max() / np.abs(gs).max())
        check(f"{label} value+grad vs f64 autograd and the single-device "
              f"value+grad", vrel <= VG_VALUE_RTOL
              and gnorm <= VG_GRAD_F64_RTOL and snorm <= VG_GRAD_RTOL
              and bool(np.isfinite(g).all()),
              f"value={r0['value']:.10e} f64={vx:.10e} rel={vrel:.3e} "
              f"(limit {VG_VALUE_RTOL:g}); grad={g} f64={gx} normwise "
              f"{gnorm:.3e} (limit {VG_GRAD_F64_RTOL:g}); single-device "
              f"{gs} normwise {snorm:.3e} (limit {VG_GRAD_RTOL:g})")
        self._same_on_ranks(label, every, ("value", "grad"))
        per_rank = [res["counts"] for res in every]
        ok = all(c[k] > 0 for c in per_rank for k in ("K1", "K2", "K3",
                                                         "S"))
        ok = ok and all(c[k] == 0 for c in per_rank
                        for k in ("K4", "K5", "K6", "K7", "K3_fallback"))
        ok = ok and not any(res["plain"] for res in every)
        check(f"{label} launches K1, K2, K3 and S on each rank, no K4-K7, "
              f"no plain version", ok,
              f"launches per rank "
              f"{[{k: v for k, v in c.items() if v} for c in per_rank]}; "
              f"plain versions called {[res['plain'] for res in every]}")
        for res in every:
            t = res["times"]
            med = statistics.median(t)
            cmed = statistics.median(res["collective_ms"])
            print(f"  sharded_vg_16k_ms ranks={res['ranks']} "
                  f"backend={res['backend']} rank={res['rank']} "
                  f"median={med:.2f} (runs "
                  f"{', '.join(f'{x:.2f}' for x in t)}; "
                  f"first {res['first_ms']:.2f}) collective_ms median="
                  f"{cmed:.2f} compute_ms={med - cmed:.2f} collective "
                  f"share={cmed / med:.3f} bytes per eval={res['bytes']} "
                  f"peak_gib={res['peak_bytes'] / 2 ** 30:.2f}", flush=True)

    def _shard_refs(self, n, block):
        """f64 autograd of engine.chol_nlml and the single-device
        bigfit value+grad at the block, on the card, at map_vg's z."""
        torch = self.torch
        X, y = make_data(n)
        Xt = torch.as_tensor(X, device=self.dev)
        yt = torch.as_tensor(y, device=self.dev)
        z = torch.log(torch.tensor([GV, *L_SCALES, KV], dtype=torch.float64))
        vx, gx = self._exact_vg(Xt, yt, z)
        single_ms, (vs, gs) = self.wall_ms(
            lambda: self.bigfit.nlml_value_and_grad(Xt, yt, z, block=block))
        print(f"  single-device value+grad at block {block}: "
              f"{single_ms:.2f} ms (first in this phase)", flush=True)
        del Xt, yt
        torch.cuda.empty_cache()
        return vx, gx.cpu().numpy(), gs.cpu().numpy()

    def _sharded_16k(self, pool):
        vx, gx, gs = self._shard_refs(N, SHARD_BLOCK)
        _, every = pool.run(_shard_vg_rank, N, SHARD_BLOCK, REPS,
                            self.dev.type, True)
        self._shard_vg_checks(f"sharded 16k ({SHARD_RANKS} ranks, gloo)",
                              every, vx, gx, gs)
        self.shard_counts = [res["counts"] for res in every]
        rows = [row for res in every for row in res["k2"]]
        check("K2 bit for bit at the sharded path's four shapes",
              len(rows) == 4 and all(r["bit_exact"] for r in rows),
              f"{[(r['label'], r['shape'], r['nslices'], r['bit_exact'])
                  for r in rows]}"
              f"; recorded on the last rank {every[-1]['k2_shapes']}")
        for r in rows:
            print(f"  K2 sharded {r['label']} {r['shape']} at {r['nslices']} "
                  f"slices ms={r['ms']:.3f} "
                  f"kernel_ms={r['kernel_ms']:.3f} plain_ms="
                  f"{r['plain_ms']:.3f} library_ms={r['library_ms']:.3f} "
                  f"bound_ms={r['bound_ms']:.3f} ({r['bound_by']})",
                  flush=True)
        self.rows.setdefault("K2", {})["sharded_shapes"] = rows

    def _sharded_nccl(self):
        from andvaranaut_torch import distributed

        vx, gx, gs = self._shard_refs(N, SHARD_BLOCK)
        dev = self.dev.type
        _, every = distributed.launch(_shard_vg_rank, 1, dev, N,
                                      SHARD_BLOCK, REPS, dev, False)
        check("one-rank group on NCCL", every[0]["backend"] == "nccl",
              f"backend {every[0]['backend']}")
        self._shard_vg_checks("sharded 16k (1 rank, nccl)", every, vx, gx,
                              gs)

    def _sharded_small(self, pool):
        import tempfile

        torch = self.torch
        X, y = make_data(SHARD_N_SMALL)
        with tempfile.TemporaryDirectory() as rundir:
            ms, (_, every) = self.wall_ms(lambda: pool.run(
                _shard_small_rank, SHARD_N_SMALL, SHARD_BLOCK, SHARD_POINTS,
                self.dev.type, rundir))
        r0 = every[0]
        self._same_on_ranks(
            f"sharded n={SHARD_N_SMALL}", every,
            ("mu", "var", "fit_logpost", "mcmc_lp", "facade_yhat"))
        Xq = np.random.default_rng(SHARD_Q_SEED).uniform(size=(SHARD_POINTS,
                                                             NX))
        l, kv, gv, al = self.engine.hypers_to_args(
            {"l": np.array(L_SCALES), "kv": np.array([KV]),
             "gv": np.array(GV)}, True, device=self.dev)
        mu0, var0 = self.engine.predict_diag(
            ("RBF",), (), torch.as_tensor(X, device=self.dev),
            torch.as_tensor(y, device=self.dev),
            torch.as_tensor(Xq, device=self.dev), l, kv, gv, al, JITTER)
        mu0, var0 = mu0.cpu().numpy(), var0.cpu().numpy()
        mu_err = float(np.max(np.abs(r0["mu"] - mu0)
                              / (SHARD_MU_RTOL * np.abs(mu0) + ATOL)))
        var_err = float(np.max(np.abs(r0["var"] - var0)
                               / (SHARD_VAR_RTOL * np.abs(var0) + ATOL)))
        check(f"sharded predict n={SHARD_N_SMALL}, {SHARD_POINTS} points vs "
              f"exact f64", mu_err <= 1.0 and var_err <= 1.0,
              f"max |dmu| / (rtol |mu| + atol) = {mu_err:.3e}, max |dvar| / "
              f"(rtol |var| + atol) = {var_err:.3e} (limits 1; mean rtol "
              f"{SHARD_MU_RTOL:g}, var rtol {SHARD_VAR_RTOL:g}); conditioning "
              f"and predict {r0['predict_ms']:.1f} ms")
        ref_ms, (h0, lp0) = self.wall_ms(lambda: self.bigfit.big_map_fit(
            X, y, block=SHARD_BLOCK, maxiter=SHARD_FIT_MAXITER,
            device=self.dev))
        lp1, h1 = r0["fit_logpost"], r0["fit_hypers"]
        lrel = float(np.max(np.abs(h1["l"] - h0["l"]) / np.abs(h0["l"])))
        check(f"sharded_big_map_fit n={SHARD_N_SMALL} vs bigfit.big_map_fit",
              abs(lp1 - lp0) <= SHARD_FIT_LP_ATOL + SHARD_FIT_LP_RTOL
              * abs(lp0) and lrel <= SHARD_FIT_L_RTOL,
              f"logpost={lp1!r} single-device={lp0!r}; l={h1['l'].tolist()} "
              f"single-device={h0['l'].tolist()} rel={lrel:.3e}; sharded "
              f"{r0['fit_evals']} evaluations in {r0['fit_ms']:.1f} ms "
              f"({r0['fit_ms'] / max(r0['fit_evals'], 1):.1f} ms each), "
              f"single-device {ref_ms:.1f} ms")
        b0, b1 = np.meshgrid(np.linspace(0.0, 1.0, 201),
                             np.linspace(0.0, 1.0, 201))
        g0, g1 = np.meshgrid(np.linspace(0.0, 2.0, 201),
                             np.linspace(1.0, 1.5, 201))
        pred_bound = WARP_PRED_TOY * np.ptp(np.sin(3 * b0) + b1 ** 2) / np.ptp(
            g0 ** 2 - g0 - g1 ** 2 * g0 + g1)
        err = float(np.abs(r0["facade_yhat"]
                           - (np.sin(3 * X[:, 0]) + X[:, 1] ** 2)).max())
        check(f"facade fit(precision='distributed', cwgp=True) "
              f"n={SHARD_N_SMALL}", err <= pred_bound
              and {"cwgp", "cwgp_pos"} <= set(r0["facade_hypers"]),
              f"fit {r0['facade_ms']:.1f} ms (maxiter {SHARD_FACADE_MAXITER}"
              f"), max |yhat - latent| {err:.3e} (limit {pred_bound:.3e}); "
              f"hypers "
              f"{ {k: v.tolist() for k, v in r0['facade_hypers'].items()} }")
        lp = r0["mcmc_lp"]
        evals = max(r0["mcmc_evals"], 1)
        check(f"sample_model(mesh=) n={SHARD_N_SMALL}, "
              f"{SHARD_MCMC['chains']} chains, {SHARD_MCMC['tune']} + "
              f"{SHARD_MCMC['draws']}", bool(np.isfinite(lp).all()),
              f"lp {lp.tolist()}, accept {r0['mcmc_accept'].tolist()}; "
              f"{r0['mcmc_evals']} value+grads in {r0['mcmc_ms']:.1f} ms: "
              f"{r0['mcmc_ms'] / evals:.1f} ms per leapfrog")
        print(f"  sharded n={SHARD_N_SMALL} checks {ms:.1f} ms", flush=True)

    def _sharded_dryrun(self, pool):
        from andvaranaut_torch import distributed

        ms, (out, _) = self.wall_ms(lambda: pool.run(
            distributed.dryrun_multichip, SHARD_RANKS, self.dev.type))
        check(f"dryrun_multichip({SHARD_RANKS}) on the card",
              set(out) == {"nlml", "closed_form", "predict", "warped",
                           "mcmc_lp", "chains_lp"},
              f"{ms:.1f} ms; outputs {sorted(out)}; mcmc lp "
              f"{np.asarray(out['mcmc_lp']).tolist()}; chain-sharded lp "
              f"{np.asarray(out['chains_lp']).tolist()}")

    def sharded(self):
        """The row-sharded paths: `_sharded_16k` (and K2 at its shapes),
        `_sharded_small` and `_sharded_dryrun` on SHARD_RANKS ranks that
        share the card, then `_sharded_nccl` on one."""
        from andvaranaut_torch import distributed

        t0 = time.perf_counter()
        with distributed.RankPool(SHARD_RANKS, self.dev.type) as pool:
            print(f"  rank pool up in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            for part in (self._sharded_16k, self._sharded_small,
                         self._sharded_dryrun):
                t0 = time.perf_counter()
                part(pool)
                print(f"  {part.__name__}_seconds="
                      f"{time.perf_counter() - t0:.1f}", flush=True)
        t0 = time.perf_counter()
        self._sharded_nccl()
        print(f"  _sharded_nccl_seconds={time.perf_counter() - t0:.1f}",
              flush=True)


def _gp_cfg(n):
    """make_data(n) as a FitConfig (RBF, noise, no conversions)."""
    from andvaranaut_torch.gp import engine
    from andvaranaut_torch.lhc import _none_conrev

    X, y = make_data(n)
    return engine.FitConfig(
        kerns=("RBF",), ops=(), noise=True, truncate=False, jitter=JITTER,
        iwgp=False, cwgp=False, priors=[None] * NX,
        xconrevs=[_none_conrev()] * NX, yconrevs=[_none_conrev()], x=X,
        y=y[:, None])


def _shards_now():
    from andvaranaut_torch.inference import nuts

    s = nuts.SHARDS
    return dict(route=s.route, targets=list(s.targets), calls=list(s.calls),
                rows=list(s.rows), max_rows=list(s.max_rows))


def _draws(data):
    return ({k: np.asarray(v) for k, v in data.posterior.items()},
            {k: np.asarray(v) for k, v in data.sample_stats.items()})


def _chains_rank(n, chains, sampler, kw, device):
    """One rank's part of the chain-sharded run: sample_model(mixed=True)
    on make_data(n) with `chains` chains split over the group's ranks;
    launches, plain versions called, the all_gathers' count and time
    (`distributed.STATS`, timed) and the wall."""
    import torch

    from andvaranaut_torch import distributed
    from andvaranaut_torch.inference import nuts

    dev = torch.device(device)
    cfg = _gp_cfg(n)
    reset_kernel_counts()
    distributed.STATS.reset()
    distributed.STATS.timed = True
    try:
        with plain_calls() as plain:
            _sync(torch, dev)
            t0 = time.perf_counter()
            data = nuts.sample_model(cfg, mixed=True, sampler=sampler,
                                     chains=chains, device=dev, **kw)
            _sync(torch, dev)
            wall = time.perf_counter() - t0
    finally:
        distributed.STATS.timed = False
    post, stats = _draws(data)
    return dict(rank=torch.distributed.get_rank(), post=post, stats=stats,
                shards=_shards_now(), counts=kernel_counts(),
                plain=dict(plain), gathers=distributed.STATS.calls,
                gather_s=distributed.STATS.seconds, wall_s=wall)


class ChainPhases:
    """Chain sharding of the samplers on the card (`chains`): unsharded,
    in-process shards (threads, one CUDA stream each) and gloo ranks
    sharing the card; the draws equal bit for bit.  One card: this checks
    the algorithm and its overhead, not a multi-card speed.  Mixed into
    Phases."""

    def _same_draws(self, label, runs):
        """Every run's posterior and stats equal the first's bit for
        bit."""
        (l0, (p0, s0)), bad = runs[0], []
        for lab, (post, stats) in runs[1:]:
            bad += [f"{lab}:{k}" for k in p0
                    if not np.array_equal(post[k], p0[k])]
            bad += [f"{lab}:{k}" for k in s0
                    if not np.array_equal(stats[k], s0[k])]
        check(f"{label}: draws and stats bit for bit across "
              f"{[lab for lab, _ in runs]}", not bad,
              f"differing {bad}" if bad else f"{len(runs)} runs equal")

    def _local_run(self, cfg, devices, **kw):
        """sample_model(mixed=True) here: (draws, wall s, launches, plain
        calls, split)."""
        from andvaranaut_torch.inference import nuts

        self.reset_counts()
        with plain_calls() as plain:
            ms, data = self.wall_ms(lambda: nuts.sample_model(
                cfg, mixed=True, device=self.dev, devices=devices, **kw))
        return dict(draws=_draws(data), wall_s=ms / 1e3,
                    counts=self.counts(), plain=dict(plain),
                    shards=_shards_now())

    def _chains_small(self, pool, sampler):
        cfg = _gp_cfg(CHAINS_N)
        kw = dict(sampler=sampler, chains=CHAINS_C, **CHAINS_RUN)
        dev = (f"cuda:{self.torch.cuda.current_device()}"
               if self.dev.type == "cuda" else "cpu")
        ref = self._local_run(cfg, None, **kw)
        thr = self._local_run(cfg, [dev] * CHAINS_SHARDS, **kw)
        _, every = pool.run(_chains_rank, CHAINS_N, CHAINS_C, sampler,
                            CHAINS_RUN, self.dev.type)
        label = f"chains n={CHAINS_N} C={CHAINS_C} {sampler}"
        self._same_draws(label, [("unsharded", ref["draws"]),
                                 ("threads", thr["draws"])]
                         + [(f"rank{r['rank']}", (r["post"], r["stats"]))
                            for r in every])
        c, sh = thr["counts"], thr["shards"]
        half = CHAINS_C // CHAINS_SHARDS
        rounds = {"unsharded": ref["counts"]["K3b"],
                  "threads": sh["calls"][0],
                  "ranks": every[0]["shards"]["calls"][0]}
        check(f"{label}: unsharded, one K3b and K7b a round",
              ref["counts"]["K3b"] == ref["counts"]["K7b"] > 0
              and ref["shards"]["route"] is None,
              f"K3b {ref['counts']['K3b']} K7b {ref['counts']['K7b']}")
        check(f"{label}: {CHAINS_SHARDS} in-process shards, one K3b and K7b "
              f"a shard call, batches of at most {half}",
              sh["route"] == "devices" and c["K3b"] == c["K7b"]
              == sum(sh["calls"]) and min(sh["calls"]) > 0
              and max(sh["max_rows"]) <= half,
              f"shard calls {sh['calls']} rows {sh['rows']} largest "
              f"{sh['max_rows']}; K3b {c['K3b']} K7b {c['K7b']} Sb "
              f"{c['Sb']}")
        bad = [r["rank"] for r in every
               if not (r["shards"]["route"] == "ranks"
                       and r["counts"]["K3b"] == r["counts"]["K7b"]
                       == r["shards"]["calls"][r["rank"]] > 0
                       and max(r["shards"]["max_rows"]) <= half
                       and r["gathers"] == r["shards"]["calls"][0])]
        check(f"{label}: {CHAINS_SHARDS} ranks, one K3b and K7b a share, "
              f"one all_gather a round, batches of at most {half}", not bad,
              "; ".join(f"rank {r['rank']}: K3b {r['counts']['K3b']} K7b "
                        f"{r['counts']['K7b']} share calls "
                        f"{r['shards']['calls']} largest "
                        f"{r['shards']['max_rows']} all_gathers "
                        f"{r['gathers']}" for r in every))
        runs = [ref, thr] + every
        plain = [r["plain"] for r in runs if r["plain"]]
        k37 = [(r["counts"]["K3"], r["counts"]["K7"]) for r in runs]
        check(f"{label}: no plain version, no K3 or K7 on the card",
              not plain and all(k == (0, 0) for k in k37),
              f"plain calls {plain}; (K3, K7) {k37}")
        ms = {"unsharded": ref["wall_s"] * 1e3 / max(rounds["unsharded"], 1),
              "threads": thr["wall_s"] * 1e3 / max(rounds["threads"], 1),
              "ranks": max(r["wall_s"] for r in every) * 1e3
              / max(rounds["ranks"], 1)}
        share = [r["gather_s"] / r["wall_s"] for r in every]
        out = dict(rounds=rounds, ms_per_round=ms,
                   wall_s={"unsharded": ref["wall_s"],
                           "threads": thr["wall_s"],
                           "ranks": [r["wall_s"] for r in every]},
                   all_gather_share=share,
                   all_gather_ms=[r["gather_s"] * 1e3 for r in every],
                   accept=float(ref["draws"][1]["accept"].mean()),
                   k3b_per_shard=sh["calls"],
                   k3b_per_rank=[r["counts"]["K3b"] for r in every])
        print(f"  {label} ({card_line()}): {out}", flush=True)
        return out

    def _chains_big(self, pool):
        cfg = _gp_cfg(CHAINS_BIG_N)
        kw = dict(sampler="nuts", chains=2, **CHAINS_BIG_RUN)
        ref = self._local_run(cfg, None, **kw)
        _, every = pool.run(_chains_rank, CHAINS_BIG_N, 2, "nuts",
                            CHAINS_BIG_RUN, self.dev.type)
        label = f"chains n={CHAINS_BIG_N} C=2 nuts"
        self._same_draws(label, [("unsharded", ref["draws"])]
                         + [(f"rank{r['rank']}", (r["post"], r["stats"]))
                            for r in every])
        kern = ("K1", "K2", "K3", "K4", "K5", "K6", "S")
        bad = [r["rank"] for r in every
               if not (all(r["counts"][k] > 0 for k in kern)
                       and r["counts"]["K7"] == 0 and not r["plain"]
                       and r["shards"]["route"] == "ranks")]
        check(f"{label}: each rank launched K1-K6 and S, no K7, no plain "
              f"version", not bad and ref["counts"]["K7"] == 0
              and not ref["plain"],
              "; ".join(f"rank {r['rank']}: "
                        f"{ {k: r['counts'][k] for k in kern + ('K7',)} } "
                        f"plain {r['plain']}" for r in every)
              + f"; unsharded {ref['counts']}")
        rounds = every[0]["shards"]["calls"][0]
        out = dict(rounds=rounds,
                   ms_per_round={"unsharded": ref["wall_s"] * 1e3 / rounds,
                                 "ranks": max(r["wall_s"] for r in every)
                                 * 1e3 / rounds},
                   all_gather_ms=[r["gather_s"] * 1e3 for r in every],
                   launches_per_rank=[{k: r["counts"][k] for k in kern}
                                      for r in every])
        print(f"  {label} ({card_line()}): {out}", flush=True)
        return out

    def _chains_dryrun(self, pool):
        from andvaranaut_torch import distributed

        ms, (out, _) = self.wall_ms(lambda: pool.run(
            distributed.dryrun_multichip, CHAINS_SHARDS, self.dev.type))
        lp = np.asarray(out.get("chains_lp", np.zeros(0)))
        check(f"dryrun_multichip({CHAINS_SHARDS}): the chain-sharded NUTS "
              f"run", lp.shape == (CHAINS_SHARDS, 4)
              and bool(np.isfinite(lp).all()),
              f"{ms:.1f} ms; chains lp {lp.tolist()}")

    def chains(self):
        """`_chains_small` for 'nuts' and 'hmc', `_chains_big` and
        `_chains_dryrun`, on CHAINS_SHARDS ranks that share the card."""
        from andvaranaut_torch import distributed

        t0 = time.perf_counter()
        with distributed.RankPool(CHAINS_SHARDS, self.dev.type) as pool:
            print(f"  rank pool up in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            self.chains_stats = {s: self._chains_small(pool, s)
                                 for s in ("nuts", "hmc")}
            self.chains_stats["big"] = self._chains_big(pool)
            self._chains_dryrun(pool)


class Phases(McmcPhases, FacadePhases, WarpedPhases, ShardedPhases,
             ChainPhases):
    def __init__(self, torch):
        import andvaranaut_torch.gp.bigfit as bigfit
        import andvaranaut_torch.gp.cholinv as cholinv
        import andvaranaut_torch.gp.engine as engine
        import andvaranaut_torch.gp.kernels as kernels
        import andvaranaut_torch.gp.ops as ops
        import andvaranaut_torch.gp.panel as panel
        import andvaranaut_torch.gp.precision as precision
        import andvaranaut_torch.gp.slicemm as slicemm
        from andvaranaut_torch import gpmcmc

        self.torch = torch
        self.dev = torch.device("cuda")
        self.cholinv, self.engine, self.kernels = cholinv, engine, kernels
        self.precision, self.slicemm, self.gpmcmc = precision, slicemm, gpmcmc
        self.bigfit, self.panel, self.ops = bigfit, panel, ops
        self.rows = {}
        # the largest difference of the slicing kernel from its plain
        # version over every `_slicing_case` (scales and int8 planes)
        self.slicing_err = None
        self.serve_counts = {}
        self.main_counts = {}
        self.map_counts = {}
        self.map1_counts = {}
        self.bo_counts = {}
        self.off_counts = {}
        self.fused_counts = {}
        self.mcmc_counts = {}
        self.warped_counts = {}
        self.shard_counts = []
        self.chains_stats = {}

    # -- helpers ---------------------------------------------------------
    def sync(self):
        self.torch.cuda.synchronize()

    def ms(self, fn, reps, warm=1):
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def wall_ms(self, fn):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def reset_counts(self):
        reset_kernel_counts()

    def counts(self):
        return kernel_counts()

    def f64(self, *shape, seed):
        g = self.torch.Generator(device=self.dev).manual_seed(seed)
        return self.torch.randn(*shape, generator=g, device=self.dev,
                                dtype=self.torch.float64)

    # -- phase 2: kernels against their plain versions -------------------
    def k1(self):
        """K1 at the 16k factorisation's first step (16384^2 carry, panel
        16384 x 1024, rows above 1024 zero): bit for bit with the plain
        version, everything outside the live tiles bit-identical, an
        all-dead call launching nothing; the product kernel timed alone on
        operands sliced beforehand, the slicing launch alone, and a profile
        of 10 wrapper calls: the slicing kernels and the product, nothing
        else."""
        torch, sm = self.torch, self.slicemm
        m, k, rs = N, BLOCK, BLOCK
        c0 = rs // 256 * 256
        panel = self.f64(m, k, seed=1)
        panel[:rs] = 0.0
        hi0, lo0 = self.precision._pair_split(self.f64(m, m, seed=2))
        h1, l1 = hi0.clone(), lo0.clone()
        h2, l2 = hi0.clone(), lo0.clone()
        sm.syrk_sub_pair_(h1, l1, panel, row_start=rs)
        sm.syrk_sub_pair_plain_(h2, l2, panel, row_start=rs)
        torch.cuda.synchronize()
        got = h1.double() + l1.double()
        want = h2.double() + l2.double()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        del got, want
        t = torch.arange(m - c0, device=self.dev) // 256
        upper = t[:, None] < t[None, :]
        passthrough = (
            torch.equal(h1[:c0], hi0[:c0]) and torch.equal(l1[:c0], lo0[:c0])
            and torch.equal(h1[:, :c0], hi0[:, :c0])
            and torch.equal(l1[:, :c0], lo0[:, :c0])
            and torch.equal(h1[c0:, c0:][upper], hi0[c0:, c0:][upper])
            and torch.equal(l1[c0:, c0:][upper], lo0[c0:, c0:][upper]))
        del upper, t
        bitexact = torch.equal(h1, h2) and torch.equal(l1, l2)
        check("K1 vs plain (16384 carry, panel 16384x1024, row_start 1024)",
              bitexact and passthrough,
              f"max_abs_err={err:.3e} rel={rel:.3e} (limit: bit-exact) "
              f"bit_exact={bitexact} passthrough_bit_exact={passthrough}")
        n0 = sm.syrk_sub_pair_.launches
        sm.syrk_sub_pair_(h1, l1, torch.zeros_like(panel), row_start=m)
        torch.cuda.synchronize()
        check("K1 all-dead row_start=16384",
              torch.equal(h1, h2) and sm.syrk_sub_pair_.launches == n0,
              "carry unchanged, no launch")
        del h2, l2
        ms = self.ms(lambda: sm.syrk_sub_pair_(h1, l1, panel, row_start=rs),
                     reps=3)
        ops = sm._k8_operands(panel, c0)
        kernel_ms = self.ms(lambda: sm._k1_product(ops, h1, l1, c0), reps=3)
        del ops
        slicing_ms = self.ms(lambda: sm._k8_operands(panel, c0), reps=5)
        h2, l2 = hi0.clone(), lo0.clone()
        plain_ms = self.ms(
            lambda: sm.syrk_sub_pair_plain_(h2, l2, panel, row_start=rs),
            reps=2)
        del h2, l2, hi0, lo0
        P = panel[c0:]
        lib_ms = self.ms(lambda: torch.matmul(P, P.T), reps=3)
        T = (m - c0) // 256
        elems = T * (T + 1) // 2 * 256 * 256
        npairs = sm.INT_NSLICES * (sm.INT_NSLICES + 1) // 2
        b_ms, b_by = bound(elems * k * 2 * npairs,
                           (m - c0) * k * 8 + elems * 16, PEAK_INT8_OPS)
        self.rows["K1"] = dict(
            name="K1 syrk_sub_pair_", source="andvaranaut_torch/csrc/slicemm.cu",
            replaces="andvaranaut_tpu/gp/pallas_slicemm.py:476",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, kernel_ms=kernel_ms)
        print(f"  K1 ms={ms:.3f} kernel_ms={kernel_ms:.3f} slicing_ms="
              f"{slicing_ms:.3f} plain_ms={plain_ms:.3f} library_ms(f64 "
              f"matmul)={lib_ms:.3f} bound_ms={b_ms:.3f} ({b_by})",
              flush=True)
        kinds = {SLICING, "K1/K12"}
        self._wrapper_kernels(
            "K1 wrapper (first step)",
            lambda: sm.syrk_sub_pair_(h1, l1, panel, row_start=rs),
            kinds, kinds)

    def _k2_case(self, label, A, B, **kw):
        sm = self.slicemm
        got = sm.slice_matmul(A, B, **kw)
        want = sm.slice_matmul_plain(A, B, **kw)
        self.torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-300)
        same = bool(self.torch.equal(got, want))
        check(f"K2 vs plain {label}", same,
              f"max_abs_err={err:.3e} rel={rel:.3e} (limit: bit-exact) "
              f"bit_exact={same}")
        return err

    def _slicing_case(self, label, X, ns):
        """The slicing kernel against its plain version, bit for bit.
        Returns the largest difference of the scales and of the planes,
        and keeps the largest over all cases in `slicing_err`."""
        sm = self.slicemm
        rows, k = X.shape
        got = sm.slice_operand(X, ns)
        want = sm.slice_operand_plain(X, ns, -(-rows // 64) * 64,
                                      -(-k // 32) * 32)
        self.torch.cuda.synchronize()
        same = (bool(self.torch.equal(got[0], want[0]))
                and bool(self.torch.equal(got[1], want[1])))
        err = max(float((got[1] - want[1]).abs().max()),
                  float((got[0].short() - want[0].short()).abs().max()))
        self.slicing_err = max(err, self.slicing_err or 0.0)
        check(f"slicing vs plain {label}", same,
              f"{tuple(X.shape)} strides {X.stride()} ns={ns} "
              f"max_abs_err={err:.3e} bit_exact={same}")
        if "S" in self.rows:
            self.rows["S"]["max_abs_err"] = self.slicing_err
        return err

    def _slicing_alone(self, X, ns, rows_p=None, kp=None):
        """The slicing kernel alone on X: a callable that launches it on
        outputs made once, without the wrapper's checks, allocations and
        launch count."""
        sm = self.slicemm
        rows_p, kp = sm._slicing_shape(X, ns, rows_p, kp)
        out, scale = sm._slicing_buffers(X, ns, rows_p, kp)
        args = (X.data_ptr(), X.stride(0), X.stride(1), *X.shape, rows_p,
                kp, ns, *sm.slice_plan(rows_p, kp, 1, X.stride(1) != 1),
                scale.data_ptr(), out.data_ptr(),
                self.torch.cuda.current_stream().cuda_stream)
        lib = sm._slicing_lib()
        return lambda: (out, scale, lib.slice_rows(*args))

    def _pair_alone(self, Xh, Xl, ns, zero_rows=0):
        """`_slicing_alone` of the pair mode."""
        sm = self.slicemm
        rows_p, kp = sm._slicing_shape(Xh, ns, None, None)
        out, scale = sm._slicing_buffers(Xh, ns, rows_p, kp)
        args = (Xh.data_ptr(), Xl.data_ptr(), Xh.stride(0), Xh.stride(1),
                *Xh.shape, zero_rows, rows_p, kp, ns,
                *sm.slice_plan(rows_p, kp, 1, Xh.stride(1) != 1, True),
                scale.data_ptr(), out.data_ptr(),
                self.torch.cuda.current_stream().cuda_stream)
        lib = sm._slicing_lib()
        return lambda: (out, scale, lib.slice_pair_rows(*args))

    def _clamp_rows(self, X):
        """X with rows at the scale clamps (a row below 1e-30; maxima in
        [2^118, 2^119): scale 2^120; one at 2^119 after f32 rounding: the
        clamped cut) and subnormal entries."""
        X = X.clone()
        k = X.shape[1]
        X[2] *= 1e-32 / X[2].abs().max()
        X[4] *= 2.0 ** 118 / X[4].abs().max()
        X[5] *= 2.0 ** 118 / X[5].abs().max()
        X[5, k // 2] = 2.0 ** 119 * (1 - 2.0 ** -40)
        X[6, ::3] = 5e-324
        return X

    def _carry_rows(self, X):
        """X with rows whose maxima round up to the next power of two in
        f32 (every 7th row) and a zero row: the scale's corner cases."""
        X = X.clone()
        X[::7] *= 0.25 / X[::7].abs().amax(dim=1, keepdim=True)
        X[::7, 0] = 1 - 2.0 ** -30
        X[3] = 0.0
        return X

    def _wrapper_kernels(self, label, fn, allowed, expected=None):
        """Profile 10 wrapper calls: they launch only the port's own
        kernels (`allowed` profile labels), and with `expected` exactly
        that set of labels.  Fails where the profiler is unavailable or
        sees no kernel.  On an H100 the profiler kept none of a window of
        one short call, and of 10 calls only the records of the first 5
        or 7, once the long phases had run; so the window is padded at
        both ends with filler kernels (`torch.cuda._sleep`, dropped from
        the result), and the counts it prints per call may be short.  How
        many kernels a call launches is held by the launch counters (the
        card tests and the path checks)."""
        name = f"{label} launches only the port's kernels"
        reps, fillers = 10, 20000
        torch = self.torch

        def window():
            for _ in range(fillers):
                torch.cuda._sleep(1)
            for _ in range(reps):
                fn()
            for _ in range(fillers):
                torch.cuda._sleep(1)
        try:
            seen = self.profile(window, names=True)
        except (RuntimeError, AttributeError, ImportError) as e:
            check(name, False, f"profile unavailable: {e!r}")
            return
        per_call = {k: v / reps for k, v in seen.items()
                    if "spin_kernel" not in k}
        others = sorted(n for n in per_call if n not in allowed)
        check(name, bool(per_call) and not others
              and (expected is None or set(per_call) == set(expected)),
              f"kernels per call {per_call}; others {others}"
              + ("" if expected is None else f"; expected {sorted(expected)}"))

    def k2(self):
        torch, sm = self.torch, self.slicemm
        m, k, rs = N, BLOCK, BLOCK
        A = self.f64(m, k, seed=3)
        B = self.f64(k, k, seed=4)
        err = self._k2_case("panel 16384x1024 @ 1024x1024 row_start=1024",
                            A, B, row_start=rs)
        self._slicing_case("A[1024:] rows (first panel)", A[rs:], 6)
        self._slicing_case("B^T (columns of B)", B.T, 6)
        self._slicing_case("ragged rows with f32-carry maxima",
                           self._carry_rows(A[:1000, :999]), 8)
        self._slicing_case("ragged B^T-layout rows with f32-carry maxima",
                           self._carry_rows(B[:333, :777]).T.contiguous().T,
                           6)
        self._slicing_case("clamp rows (scales 2^-98, 2^120), subnormals",
                           self._clamp_rows(A[:1000, :999]), 8)
        Y = self.f64(2 * 300 + 3, 2 * 257 + 5, seed=16)
        V = Y[1:600:2, 3:517:2]
        V.copy_(self._clamp_rows(V))
        self._slicing_case(f"general strides {V.stride()}", V, 6)
        del Y, V
        # depths on both sides of the plan's switches (rows side by side,
        # W^T: 16-row strips to 544 columns a CTA and to 16 x 544, 8 rows
        # to 16 x 1120, then 4; rows along k: one CTA a 4-row strip to
        # 2272 columns, then clusters); 16384 deep (K5's and K7's depth)
        # on clusters of 16 and of 8
        D = self.f64(17921, 2112, seed=17)
        for r_, k_ in ((2112, 544), (2112, 545), (64, 8704), (64, 8705),
                       (64, 17920), (70, 17921), (1024, 16384)):
            X = D[:k_, :r_].clone().T
            X.copy_(self._clamp_rows(X))
            plan = sm.slice_plan(-(-r_ // 64) * 64, -(-k_ // 32) * 32, 1,
                                 True)
            self._slicing_case(f"W^T layout {r_}x{k_} plan {plan}", X, 8)
            del X
        for r_, k_ in ((1100, 2272), (1100, 2273), (1024, 16384)):
            X = self._clamp_rows(D[:k_, :r_].T.contiguous())
            plan = sm.slice_plan(-(-r_ // 64) * 64, -(-k_ // 32) * 32)
            self._slicing_case(f"rows along k {r_}x{k_} plan {plan}", X, 6)
            del X
        del D
        ms = self.ms(lambda: sm.slice_matmul(A, B, row_start=rs), reps=5)
        ops = sm._k2_operands(A, B, 6, rs)
        C = torch.empty((m, k), dtype=torch.float64, device=self.dev)
        kernel_ms = self.ms(lambda: sm._k2_product(ops, C, 6, row_start=rs,
                                                   r0=rs), reps=5)
        slicing_ms = self.ms(lambda: sm._k2_operands(A, B, 6, rs), reps=5)
        s_a, s_b = (self._slicing_alone(A[rs:], 6, kp=k),
                    self._slicing_alone(B.T, 6, kp=k))
        s_alone = self.ms(lambda: (s_a(), s_b()), reps=10)
        s_alone_a = self.ms(s_a, reps=10)
        s_alone_b = self.ms(s_b, reps=20)
        del ops, C, s_a, s_b
        plain_ms = self.ms(
            lambda: sm.slice_matmul_plain(A, B, row_start=rs), reps=2)
        Al = A[rs:]
        lib_ms = self.ms(lambda: torch.matmul(Al, B), reps=5)
        npairs = sm.INT_NSLICES * (sm.INT_NSLICES + 1) // 2
        n = B.shape[1]
        b_ms, b_by = bound((m - rs) * k * n * 2 * npairs,
                           (m - rs) * k * 8 + k * n * 8 + m * n * 8,
                           PEAK_INT8_OPS)
        self.rows["K2"] = dict(
            name="K2 slice_matmul", source="andvaranaut_torch/csrc/slicemm.cu",
            replaces="andvaranaut_tpu/gp/pallas_slicemm.py:1140",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, kernel_ms=kernel_ms)
        # the slicing kernel's row: both operands of the first panel
        s_ms, s_by = bound(0, ((m - rs) * k + k * n) * (8 + 6), PEAK_BYTES)
        self.rows["S"] = dict(
            name="S slice_operand (K2's first-panel operands)",
            source="andvaranaut_torch/csrc/slicing.cu",
            replaces="andvaranaut_tpu/gp/precision.py:107",
            max_abs_err=self.slicing_err, ms=slicing_ms, plain_ms=None,
            bound_ms=s_ms, bound_by=s_by, library_ms=None,
            kernel_ms=s_alone, kernel_ms_a=s_alone_a, kernel_ms_bt=s_alone_b)
        print(f"  K2 panel ms={ms:.3f} kernel_ms={kernel_ms:.3f} "
              f"slicing_ms(both operands)={slicing_ms:.4f} alone "
              f"{s_alone:.4f} (A[1024:] {s_alone_a:.4f}, B^T "
              f"{s_alone_b:.4f}; bound {s_ms:.4f}, {s_by}) "
              f"plain_ms={plain_ms:.3f} "
              f"library_ms(f64 matmul)={lib_ms:.3f} bound_ms={b_ms:.3f} "
              f"({b_by})", flush=True)
        s_plain = self.ms(lambda: (
            sm.slice_operand_plain(A[rs:], 6, m - rs, k),
            sm.slice_operand_plain(B.T, 6, k, k)), reps=2)
        self.rows["S"]["plain_ms"] = s_plain
        self._wrapper_kernels(
            "K2 wrapper (first panel)",
            lambda: sm.slice_matmul(A, B, row_start=rs),
            {SLICING, "K2"})
        del A, B, Al
        # contract flags at 2048 x 1024 @ 1024 x 2048
        A = self.f64(2048, k, seed=5)
        B = self.f64(k, 2048, seed=6)
        self._k2_case("lower_only", A, B, lower_only=True)
        self._k2_case("col_start=1024", A, B, col_start=1024)
        Bz = B.clone()
        Bz[:, 1280:] = 0.0
        self._k2_case("col_end=1280", A, Bz, col_end=1280)
        self._k2_case("row_start=700 (straddles a tile)", A, B,
                      row_start=700)
        # diagonal recursion: 512^3 at 8 slices
        A = self.f64(512, 512, seed=7) * 100.0
        B = self.f64(512, 512, seed=8)
        self._k2_case("compose 512^3 at 8 slices", A, B, nslices=8)
        c_ms = self.ms(lambda: sm.slice_matmul(A, B, nslices=8), reps=10)
        ops = sm._k2_operands(A, B, 8, 0)
        C = torch.empty((512, 512), dtype=torch.float64, device=self.dev)
        c_kernel = self.ms(lambda: sm._k2_product(ops, C, 8), reps=10)
        print(f"  K2 compose ms={c_ms:.3f} kernel_ms={c_kernel:.3f}",
              flush=True)
        # prediction solves: (15360 x 1024) and (1024 x 1024) @ (1024 x 2048)
        A = self.f64(m - k, k, seed=9)
        B = self.f64(k, SERVE_POINTS, seed=10)
        self._k2_case("predict 15360x1024 @ 1024x2048", A, B)
        self._k2_case("predict 1024x1024 @ 1024x2048", A[:k], B)
        # the blocked solves' operands as views in place
        L = self.f64(3 * k, 3 * k, seed=11)
        self._slicing_case("L[lo:hi, :lo].T (view)", L[k:2 * k, :k].T, 6)
        self._slicing_case("L[hi:, lo:hi] (view)", L[2 * k:, k:2 * k], 6)
        self._k2_case("L[lo:hi, :lo].T @ X (views)", L[k:2 * k, :k].T, B)
        self._k2_case("L[hi:, lo:hi] @ X (views)", L[2 * k:, k:2 * k], B)
        del L
        # the BO whitened solve: a 1024-row block against 10000 columns
        A = self.f64(k, k, seed=12)
        B = self.f64(k, BO_CANDIDATES, seed=13)
        self._k2_case("BO solve 1024x1024 @ 1024x10000", A, B)
        w_ms = self.ms(lambda: sm.slice_matmul(A, B), reps=5)
        ops = sm._k2_operands(A, B, 6, 0)
        C = torch.empty((k, BO_CANDIDATES), dtype=torch.float64,
                        device=self.dev)
        w_kernel = self.ms(lambda: sm._k2_product(ops, C, 6), reps=5)
        w_lib = self.ms(lambda: torch.matmul(A, B), reps=5)
        print(f"  K2 BO solve ms={w_ms:.3f} kernel_ms={w_kernel:.3f} "
              f"library_ms={w_lib:.3f}", flush=True)
        del ops, C
        # path A's first panel: 16000 x 1000 @ 1000 x 1000, off the 64 grain
        A = self.f64(N_OFF, BLOCK_OFF, seed=14)
        B = self.f64(BLOCK_OFF, BLOCK_OFF, seed=15)
        self._k2_case("path A panel 16000x1000 @ 1000x1000 row_start=1000",
                      A, B, row_start=BLOCK_OFF)
        a_ms = self.ms(lambda: sm.slice_matmul(A, B, row_start=BLOCK_OFF),
                       reps=5)
        print(f"  K2 path A panel ms={a_ms:.3f}", flush=True)

    def _k3_cases(self):
        """Diagonal blocks of bench.py's Gram as the factorisation passes
        them: views of a 1024 block (row stride 1024), with the bench's
        noise (gv 1e-4) and at the noise floor (gv 1e-6)."""
        torch = self.torch
        X, _ = make_data(N)
        Xt = torch.as_tensor(X[:2 * MAX_K3], device=self.dev)
        l = torch.tensor(L_SCALES, dtype=torch.float64, device=self.dev)
        kv = torch.tensor([KV], dtype=torch.float64, device=self.dev)
        out = {}
        for label, gv in (("bench Gram block", GV), ("noise-floor block "
                                                     "(gv 1e-6)", 1e-6)):
            G = self.kernels.gram(("RBF",), (), Xt, None, l, kv)
            G.diagonal().add_(JITTER + gv)
            out[label] = G
        return out

    def k3(self):
        """K3 at the blocks of the main path against its plain version,
        one launch of the cluster kernel on views read in place."""
        torch, ci = self.torch, self.cholinv
        for bb in (128, 256, MAX_K3):
            clusters, smem = ci.launch_info(bb, ci.cluster_size(bb, 1))
            print(f"  K3 b={bb}: a cluster of {clusters} thread blocks of 256 "
                  f"threads on as many SMs, {smem} bytes of dynamic shared "
                  f"memory per block (plan "
                  f"{ci.cluster_plan(bb, clusters)})", flush=True)
        cases = self._k3_cases()
        errs = []
        for label, G in cases.items():
            for b in (128, 256, 384, 512):
                A = G[:b, :b]
                L, Xi, ok = ci.chol_inv_block(A)
                Lp, Xp, okp = ci.chol_inv_block_plain(A)
                torch.cuda.synchronize()
                eL = float((L - Lp).abs().max())
                eX = float((Xi - Xp).abs().max())
                rL = eL / float(Lp.abs().max())
                rX = eX / float(Xp.abs().max())
                eye = torch.eye(b, dtype=torch.float64, device=self.dev)
                res = float((Xi @ L - eye).abs().max())
                zeros = (float(torch.triu(L, 1).abs().max()) == 0.0
                         and float(torch.triu(Xi, 1).abs().max()) == 0.0)
                check(f"K3 vs plain b={b} ({label})",
                      bool(ok) and bool(okp) and rL <= 1e-10 and rX <= 1e-8
                      and zeros,
                      f"L rel={rL:.3e} (limit 1e-10) X rel={rX:.3e} (limit "
                      f"1e-8) |XL-I|={res:.3e} ok={bool(ok)}/{bool(okp)} "
                      f"upper zeros={zeros}")
                errs.append(max(eL, eX))
        G = cases["bench Gram block"]
        A = G[:MAX_K3, :MAX_K3]
        eye = torch.eye(MAX_K3, dtype=torch.float64, device=self.dev)
        _, _, ok = ci.chol_inv_block(A - 2.0 * eye)
        check("K3 ok gate on a non-PD block", not bool(ok), f"ok={bool(ok)}")
        ms = self.ms(lambda: ci.chol_inv_block(A), reps=20)
        # the kernel alone: the C call on buffers allocated beforehand
        b = MAX_K3
        cl = ci.cluster_size(b, 1)
        kernel_ms = self._k3_kernel_ms(A[None], cl, reps=20)  # the view
        lat_ms, ts = self._k3_latency_est(b, 1, cl)
        plain_ms = self.ms(lambda: ci.chol_inv_block_plain(A), reps=20)
        lib_ms = self.ms(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky(A), eye, upper=False), reps=20)
        b_ms, b_by = bound(2 * b ** 3 / 3, 3 * b * b * 8, PEAK_F64_FLOPS)
        self.rows["K3"] = dict(
            name="K3 chol_inv_block", source="andvaranaut_torch/csrc/cholinv.cu",
            replaces="andvaranaut_tpu/gp/pallas_cholinv.py:362",
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, kernel_ms=kernel_ms,
            latency_est_ms=lat_ms, cluster=cl)
        print(f"  K3 b={b} cluster={cl} ms={ms:.4f} kernel_ms="
              f"{kernel_ms:.4f} plain_ms={plain_ms:.4f} library_ms(f64 "
              f"cholesky+solve_triangular)={lib_ms:.4f} bound_ms="
              f"{b_ms:.4f} ({b_by}) latency_est_ms={lat_ms:.4f} (kernel "
              f"alone at b=32 {ts[32]:.4f}, 64 {ts[64]:.4f})", flush=True)
        for bb in (128, 256, 384):
            t = self.ms(lambda: ci.chol_inv_block(G[:bb, :bb]), reps=20)
            print(f"  K3 b={bb} ms={t:.4f}", flush=True)
        self._wrapper_kernels(f"K3 wrapper (b={b})",
                              lambda: ci.chol_inv_block(A), {"K3"})

    # K4-K7: the MAP gradient's kernels
    def k4(self):
        """K4 at the middle step of the 16k identity solve, A the view
        L[:, lo:hi] as the solve passes it."""
        torch, sm = self.torch, self.slicemm
        m, k, rs = N, BLOCK, N // 2
        Lw = self.f64(m, 3 * k, seed=11)
        A = Lw[:, k:2 * k]
        A[:rs] = 0.0
        B = self.f64(k, m, seed=12)
        B[:, rs:] = 0.0
        hi0, lo0 = self.precision._pair_split(self.f64(m, m, seed=13))
        h1, l1 = hi0.clone(), lo0.clone()
        sm.mm_sub_pair_(h1, l1, A, B, row_start=rs, col_end=rs)
        h2, l2 = hi0.clone(), lo0.clone()
        sm.mm_sub_pair_plain_(h2, l2, A, B, row_start=rs, col_end=rs)
        torch.cuda.synchronize()
        got = h1[rs:, :rs].double() + l1[rs:, :rs].double()
        want = h2[rs:, :rs].double() + l2[rs:, :rs].double()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        del got, want
        passthrough = (
            torch.equal(h1[:rs], hi0[:rs]) and torch.equal(l1[:rs], lo0[:rs])
            and torch.equal(h1[rs:, rs:], hi0[rs:, rs:])
            and torch.equal(l1[rs:, rs:], lo0[rs:, rs:]))
        bitexact = torch.equal(h1, h2) and torch.equal(l1, l2)
        check("K4 vs plain (16384 carry, A = L[:, 1024:2048] view, B "
              "1024x16384, row_start = col_end = 8192)",
              bitexact and passthrough,
              f"max_abs_err={err:.3e} rel={rel:.3e} (limit: bit-exact) "
              f"bit_exact={bitexact} passthrough_bit_exact={passthrough}")
        n0 = sm.mm_sub_pair_.launches
        sm.mm_sub_pair_(h1, l1, A, B, row_start=m, col_end=rs)
        torch.cuda.synchronize()
        check("K4 all-dead row_start=16384",
              torch.equal(h1, h2) and sm.mm_sub_pair_.launches == n0,
              "carry unchanged, no launch")
        del h2, l2
        ms = self.ms(lambda: sm.mm_sub_pair_(h1, l1, A, B, row_start=rs,
                                             col_end=rs), reps=5)
        r0, nc = sm._live_rect(m, m, rs, rs)
        ops = sm._k4_operands(A, B, r0, nc)
        kernel_ms = self.ms(lambda: sm._k4_product(ops, h1, l1, r0), reps=5)
        slicing_ms = self.ms(lambda: sm._k4_operands(A, B, r0, nc), reps=5)
        del ops
        h2, l2 = hi0.clone(), lo0.clone()
        plain_ms = self.ms(lambda: sm.mm_sub_pair_plain_(
            h2, l2, A, B, row_start=rs, col_end=rs), reps=2)
        del h2, l2
        Rf = hi0[rs:, :rs].double() + lo0[rs:, :rs].double()
        Al, Bl = A[rs:], B[:, :rs]
        lib_ms = self.ms(lambda: Rf.sub_(Al @ Bl), reps=3)
        del Rf
        npairs = sm.INT_NSLICES * (sm.INT_NSLICES + 1) // 2
        live = (m - rs) * rs
        b_ms, b_by = bound(live * k * 2 * npairs,
                           (m - rs) * k * 8 + k * rs * 8 + live * 16,
                           PEAK_INT8_OPS)
        self.rows["K4"] = dict(
            name="K4 mm_sub_pair_", source="andvaranaut_torch/csrc/slicemm.cu",
            replaces="andvaranaut_tpu/gp/pallas_slicemm.py:758",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, kernel_ms=kernel_ms)
        print(f"  K4 ms={ms:.3f} kernel_ms={kernel_ms:.3f} "
              f"slicing_ms(both operands)={slicing_ms:.3f} plain_ms="
              f"{plain_ms:.3f} library_ms(f64 matmul + subtract)={lib_ms:.3f} "
              f"bound_ms={b_ms:.3f} ({b_by})", flush=True)
        self._wrapper_kernels(
            "K4 wrapper (16k middle step)",
            lambda: sm.mm_sub_pair_(h1, l1, A, B, row_start=rs, col_end=rs),
            {SLICING, "K4"})

    def _tri_pair(self, m, seed):
        """A lower-triangular f64 matrix with row-varying magnitudes (the
        shape of L^-1) as an f32 pair."""
        W = self.torch.tril(self.f64(m, m, seed=seed))
        W.mul_(self.torch.exp(self.f64(m, 1, seed=seed + 1)))
        return self.precision._pair_split(W)

    def k5(self):
        """K5 on a 16384^2 pair made from a lower-triangular matrix, at the
        gradient path's slice count: the slicing kernel's pair mode on the
        transposed view, bit for bit with its plain version, W's exact
        zeros (W^T's strictly-lower part) zero in every plane; then a
        profile of 10 wrapper calls: the pair mode's kernel only; then the
        pair mode in K5's layout at the plan's switches."""
        torch, pn, sm = self.torch, self.panel, self.slicemm
        hi, lo = self._tri_pair(N, seed=14)
        w_sl, sW = pn.pair_to_slices_cols(hi, lo)
        p_sl, psW = pn.pair_to_slices_cols_plain(hi, lo)
        torch.cuda.synchronize()
        ns = sm.TN_NSLICES
        err = max(float((w_sl[:, :, s].int() - p_sl[:, :, s].int()).abs()
                        .max()) for s in range(ns))
        same = torch.equal(w_sl, p_sl) and torch.equal(sW, psW)
        del p_sl, psW
        planes = sm.untile_layout(w_sl)
        zeros = not any(bool(torch.tril(planes[s], -1).any())
                        for s in range(ns))
        del planes
        check("K5 vs plain (16384^2 lower-triangular pair)", same and zeros,
              f"tiled slices {tuple(w_sl.shape)} and scales bit_exact={same} "
              f"max_slice_diff={err:g} upper_slices_zero={zeros} (limit: "
              f"bit-exact)")
        ms = self.ms(lambda: pn.pair_to_slices_cols(hi, lo), reps=5)
        del w_sl
        alone = self._pair_alone(hi.T, lo.T, ns)
        kernel_ms = self.ms(alone, reps=5)
        del alone
        plain_ms = self.ms(lambda: pn.pair_to_slices_cols_plain(hi, lo),
                           reps=2)
        b_ms, b_by = bound(0, N * N * (8 + ns) + N * 8, PEAK_BYTES)
        self.rows["K5"] = dict(
            name="K5 pair_to_slices_cols",
            source="andvaranaut_torch/csrc/slicing.cu",
            replaces="andvaranaut_tpu/gp/pallas_panel.py:356",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, kernel_ms=kernel_ms)
        print(f"  K5 ms={ms:.3f} kernel_ms={kernel_ms:.3f} ({b_ms / ms:.0%} "
              f"of its bound) plain_ms={plain_ms:.3f} library_ms=none "
              f"bound_ms={b_ms:.3f} ({b_by})", flush=True)
        # the pair mode in K5's layout across the plan's first cluster
        # switch and past 2^14, with zero rows and a row at the scale clamp
        for rows, k, zero in ((2112, 544, 40), (2112, 545, 40),
                              (1000, 17000, 7)):
            V = self.f64(k, rows, seed=rows + k)
            V[:, 9] *= 2.0 ** 118 / V[:, 9].abs().max()
            V[k // 3, 9] = 2.0 ** 119
            ph, pl = self.precision._pair_split(V)
            del V
            got = sm.slice_pair_operand(ph.T, pl.T, ns, zero_rows=zero)
            want = sm.slice_pair_operand_plain(
                ph.T, pl.T, ns, zero, -(-rows // 64) * 64, -(-k // 32) * 32)
            torch.cuda.synchronize()
            same = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            check(f"pair slicing vs plain (W^T layout {rows}x{k}, zero rows "
                  f"{zero}, a clamped row)", same,
                  f"plan {sm.slice_plan(-(-rows // 64) * 64, -(-k // 32) * 32, 1, True, True)}"
                  f" bit_exact={same} (limit: bit-exact)")
            del got, want, ph, pl
        self._wrapper_kernels(
            "K5 wrapper (16384^2)", lambda: pn.pair_to_slices_cols(hi, lo),
            {PAIR_SLICING}, {PAIR_SLICING})
        self._k5_planes = (hi, lo)

    @staticmethod
    def _syrk_tn_macs(m):
        """Multiply-adds that W^T W on lower 256-tiles needs for a lower-
        triangular (m, m) W: entry (i, j) contracts over k >= max(i, j).
        Row i holds the columns j < t1, t1 the end of its 256-tile
        (clipped to m): i + 1 columns j <= i of depth m - i, and the
        diagonal tile's c = t1 - 1 - i columns right of i, of depths
        m - i - 1 down to m - t1 + 1."""
        i = np.arange(m, dtype=np.int64)
        t1 = np.minimum(i // 256 * 256 + 256, m)
        c = t1 - 1 - i
        return int(((i + 1) * (m - i) + c * (2 * m - i - t1) // 2).sum())

    def k6(self):
        """K6 (the tn product on K5's tiled slices): bit for bit with its
        plain version at m=8192 (the plain version's f64 temporaries at
        16384 would need ~50 GB); timed at 16384 on the planes of the 16k
        K5 case, the wrapper and the product alone, with a profile of 10
        wrapper calls (the tn product only); at 17408, where the first 16
        tile rows contract in two k pieces, held bit for bit to the plain
        version (in row blocks) and to the same product in pieces of 2^13,
        and timed."""
        torch, sm, pn = self.torch, self.slicemm, self.panel
        m = N // 2
        hi, lo = self._tri_pair(m, seed=16)
        w_sl, sW = pn.pair_to_slices_cols(hi, lo)
        del hi, lo
        C = sm.syrk_tn_lower_presliced(w_sl, sW, w_lower=True)
        Cp = sm.syrk_tn_lower_presliced_plain(w_sl, sW)
        torch.cuda.synchronize()
        err = float((C - Cp).abs().max())
        same = torch.equal(C, Cp)
        t = torch.arange(m, device=self.dev) // 256
        upper_zero = not bool(C[t[:, None] < t[None, :]].any())
        check("K6 vs plain (m=8192, w_lower, K5 planes)", same and upper_zero,
              f"max_abs_err={err:.3e} bit_exact={same} "
              f"upper_tiles_zero={upper_zero} (limit: bit-exact)")
        del C, Cp
        plain_ms = self.ms(
            lambda: sm.syrk_tn_lower_presliced_plain(w_sl, sW), reps=1)
        del w_sl
        hi, lo = self._k5_planes
        del self._k5_planes
        w_sl, sW = pn.pair_to_slices_cols(hi, lo)
        W = hi.double() + lo.double()
        del hi, lo
        ms = self.ms(
            lambda: sm.syrk_tn_lower_presliced(w_sl, sW, w_lower=True),
            reps=3)
        C = torch.empty((N, N), dtype=torch.float64, device=self.dev)
        kernel_ms = self.ms(
            lambda: sm._k7_product(w_sl, sW, C, True,
                                   counted=sm.syrk_tn_lower_presliced),
            reps=3)
        del C
        self._wrapper_kernels(
            "K6 wrapper (m=16384)",
            lambda: sm.syrk_tn_lower_presliced(w_sl, sW, w_lower=True),
            {"K6/K7"}, {"K6/K7"})
        del w_sl
        lib_ms = self.ms(lambda: torch.matmul(W.T, W), reps=3)
        ns = sm.TN_NSLICES
        b_ms, b_by = bound(self._syrk_tn_macs(N) * 2 * ns * (ns + 1) // 2,
                           ns * N * N + N * N * 8, PEAK_INT8_OPS)
        self.rows["K6"] = dict(
            name="K6 syrk_tn_lower_presliced",
            source="andvaranaut_torch/csrc/slicemm.cu",
            replaces="andvaranaut_tpu/gp/pallas_slicemm.py:1073",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, kernel_ms=kernel_ms)
        check("K6 at m=16384 at least 2x faster than f64 W^T W",
              2 * ms <= lib_ms, f"{ms:.3f} ms against {lib_ms:.3f}")
        print(f"  K6 ms={ms:.3f} kernel_ms={kernel_ms:.3f} ({b_ms / kernel_ms:.0%}"
              f" of its bound; m=16384) plain_ms={plain_ms:.3f} (m=8192) "
              f"library_ms(f64 W^T W, m=16384)={lib_ms:.3f} "
              f"bound_ms={b_ms:.3f} ({b_by}, m=16384)", flush=True)
        del W
        # the padded size after one 16k BO step: the first tile rows
        # contract deeper than 2^14, in two k pieces
        m = MAP_N_CHUNKED
        hi, lo = self._tri_pair(m, seed=19)
        w_sl, sW = pn.pair_to_slices_cols(hi, lo)
        C = sm.syrk_tn_lower_presliced(w_sl, sW, w_lower=True)
        chunk = sm._K_CHUNK
        try:
            sm._K_CHUNK = chunk // 2
            C2 = sm.syrk_tn_lower_presliced(w_sl, sW, w_lower=True)
        finally:
            sm._K_CHUNK = chunk
        torch.cuda.synchronize()
        pieces = torch.equal(C, C2)
        del C2
        del hi, lo
        planes = sm.untile_layout(w_sl)
        same = self._tn_plain_blocked(lambda c0, c1: planes[:, c0:c1], sW, C)
        del planes
        check(f"K6 vs plain (m={m}, w_lower, k pieces, plain in row blocks; "
              f"against pieces of {chunk // 2})", same and pieces,
              f"bit_exact={same} same_as_shorter_pieces={pieces} (limit: "
              f"bit-exact)")
        ms = self.ms(
            lambda: sm.syrk_tn_lower_presliced(w_sl, sW, w_lower=True),
            reps=3)
        kernel_ms = self.ms(
            lambda: sm._k7_product(w_sl, sW, C, True,
                                   counted=sm.syrk_tn_lower_presliced),
            reps=3)
        del w_sl, C
        b_ms, b_by = bound(self._syrk_tn_macs(m) * 2 * ns * (ns + 1) // 2,
                           ns * m * m + m * m * 8, PEAK_INT8_OPS)
        self.rows["K6"].update(ms_17408=ms, kernel_ms_17408=kernel_ms,
                               bound_ms_17408=b_ms)
        print(f"  K6 ms={ms:.3f} kernel_ms={kernel_ms:.3f} (m={m}, k "
              f"pieces) bound_ms={b_ms:.3f} ({b_by})", flush=True)

    def _k7_plain_blocked(self, W, C):
        """C == syrk_tn_lower_plain(W) at a size whose plain version does
        not fit at once (`_tn_plain_blocked`)."""
        sm = self.slicemm
        sW = sm._tn_scales(W)
        return self._tn_plain_blocked(
            lambda c0, c1: sm.int_slices((W[:, c0:c1] / sW[c0:c1]).T,
                                         sm.TN_NSLICES), sW, C)

    def _tn_plain_blocked(self, sl, sW, C, rb=2048):
        """C equals the plain version of K6/K7 (W^T W from the planes of
        W^T's rows, sl(c0, c1) those of rows c0..c1, and the column scales
        sW) on (rb, rb) blocks of C (rb a multiple of 256) on and below
        the diagonal; blocks above it must be exact zeros.  Every slice
        product is exact in f64, so the blocks give the same bits."""
        torch, sm = self.torch, self.slicemm
        m = C.shape[0]
        same = True
        for r0 in range(0, m, rb):
            r1 = min(r0 + rb, m)
            a = sl(r0, r1)
            for c0 in range(0, r1, rb):
                c1 = min(c0 + rb, m)
                Cb = sm._group_combine(a, a if c0 == r0 else sl(c0, c1)) * (
                    sW[r0:r1, None] * sW[None, c0:c1])
                ti = torch.arange(r0, r1, device=self.dev)[:, None] // 256
                tj = torch.arange(c0, c1, device=self.dev)[None, :] // 256
                Cb = torch.where(ti >= tj, Cb, 0.0)
                same = same and bool(torch.equal(C[r0:r1, c0:c1], Cb))
                del Cb
            same = same and not bool(C[r0:r1, r1:].any())
            del a
        return same

    def k7(self):
        """K7 at the one-block value+grad's shape (tril of Dinv[0], n=1000)
        and at path A's N=16000 with w_lower."""
        torch, sm = self.torch, self.slicemm
        m = MAP_N1
        W = torch.tril(self.f64(m, m, seed=18))
        self._slicing_case("W^T (n=1000, lower W)", W.T, sm.TN_NSLICES)
        C = sm.syrk_tn_lower(W, w_lower=True)
        Cp = sm.syrk_tn_lower_plain(W)
        torch.cuda.synchronize()
        err = float((C - Cp).abs().max())
        same = torch.equal(C, Cp)
        check(f"K7 vs plain (m={m}, w_lower)", same,
              f"max_abs_err={err:.3e} bit_exact={same} (limit: bit-exact)")
        Cf = sm.syrk_tn_lower(W)
        torch.cuda.synchronize()
        same = torch.equal(Cf, Cp)
        check(f"K7 vs plain (m={m}, no w_lower)", same,
              f"bit_exact={same} (limit: bit-exact)")
        ms = self.ms(lambda: sm.syrk_tn_lower(W, w_lower=True), reps=10)
        w_sl, sW = sm.slice_operand(W.T, sm.TN_NSLICES)
        kernel_ms = self.ms(lambda: sm._k7_product(w_sl, sW, C, True),
                            reps=10)
        plain_ms = self.ms(lambda: sm.syrk_tn_lower_plain(W), reps=5)
        lib_ms = self.ms(lambda: torch.matmul(W.T, W), reps=10)
        ns = sm.TN_NSLICES
        b_ms, b_by = bound(self._syrk_tn_macs(m) * 2 * ns * (ns + 1) // 2,
                           m * m * 8 * 2, PEAK_INT8_OPS)
        self.rows["K7"] = dict(
            name="K7 syrk_tn_lower", source="andvaranaut_torch/csrc/slicemm.cu",
            replaces="andvaranaut_tpu/gp/pallas_slicemm.py:988",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, kernel_ms=kernel_ms)
        print(f"  K7 ms={ms:.4f} kernel_ms={kernel_ms:.4f} plain_ms="
              f"{plain_ms:.3f} library_ms(f64 W^T W)={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        self._wrapper_kernels(
            "K7 wrapper (n=1000)", lambda: sm.syrk_tn_lower(W, w_lower=True),
            {SLICING, "K6/K7", "K6/K7 combine"})
        del C, Cp, Cf, w_sl, W
        # path A's value+grad: K^-1 = L^-T L^-1 at N=16000
        m = N_OFF
        W = torch.tril(self.f64(m, m, seed=21))
        C = sm.syrk_tn_lower(W, w_lower=True)
        torch.cuda.synchronize()
        same = self._k7_plain_blocked(W, C)
        check(f"K7 vs plain (m={m}, w_lower, plain in row blocks)", same,
              f"bit_exact={same} (limit: bit-exact)")
        ms = self.ms(lambda: sm.syrk_tn_lower(W, w_lower=True), reps=3)
        w_sl, sW = sm.slice_operand(W.T, sm.TN_NSLICES)
        kernel_ms = self.ms(lambda: sm._k7_product(w_sl, sW, C, True),
                            reps=3)
        del w_sl
        lib_ms = self.ms(lambda: torch.matmul(W.T, W), reps=3)
        b_ms, b_by = bound(self._syrk_tn_macs(m) * 2 * ns * (ns + 1) // 2,
                           m * m * 8 * 2, PEAK_INT8_OPS)
        self.k7_16000 = dict(ms=ms, kernel_ms=kernel_ms, library_ms=lib_ms,
                             bound_ms=b_ms)
        print(f"  K7 m={m} w_lower ms={ms:.3f} kernel_ms={kernel_ms:.3f} "
              f"library_ms(f64 W^T W)={lib_ms:.3f} bound_ms={b_ms:.3f} "
              f"({b_by})", flush=True)
        del C, W
        self._k7_deeper_than_chunk(K7_DEEP_M)

    def _k7_deeper_than_chunk(self, m):
        """K7 with w_lower at m just above the exact int32 depth 2^14:
        only the tiles deeper than _K_CHUNK run in k pieces, so the int32
        slots that hold their sums cover the first nd tile rows and
        columns, nd counted here tile by tile; the product kernels
        allocate nothing more, and C equals the plain version bit for
        bit."""
        torch, sm = self.torch, self.slicemm
        W = torch.tril(self.f64(m, m, seed=22))
        C = sm.syrk_tn_lower(W, w_lower=True)
        torch.cuda.synchronize()
        same = self._k7_plain_blocked(W, C)
        check(f"K7 vs plain (m={m}, w_lower, k pieces, plain in row "
              f"blocks)", same, f"bit_exact={same} (limit: bit-exact)")
        w_sl, sW = sm.slice_operand(W.T, sm.TN_NSLICES)
        nt, nkc = w_sl.shape[0], w_sl.shape[1]
        dc = sm._K_CHUNK // 32
        nd = sum(nkc - min(2 * t, nkc) > dc for t in range(nt))
        slot_bytes = nd * nd * -(-nkc // dc) * sm.TN_NSLICES * 64 * 64 * 4
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sm._k7_product(w_sl, sW, C, True)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        ok = (nd > 0 and sm._deep_tiles(nt * 64, nkc * 32, True) == nd
              and extra <= slot_bytes + (4 << 20))
        check(f"K7 slots at m={m} cover only the tiles deeper than "
              f"2^14", ok,
              f"nd={nd} of {nt} tile rows, slots {slot_bytes / 2**20:.1f} "
              f"MiB, product kernels allocated {extra / 2**20:.1f} MiB "
              f"(limit slots + 4 MiB)")
        ms = self.ms(lambda: sm._k7_product(w_sl, sW, C, True), reps=2)
        print(f"  K7 m={m} w_lower kernel_ms={ms:.3f}", flush=True)

    # -- phase 3: the 16k mixed NLML --------------------------------------
    def nlml(self):
        torch = self.torch
        X, y = make_data(N)
        Xt = torch.as_tensor(X, device=self.dev)
        yt = torch.as_tensor(y, device=self.dev)
        l = torch.tensor(L_SCALES, dtype=torch.float64, device=self.dev)
        kv = torch.tensor([KV], dtype=torch.float64, device=self.dev)

        def gram():
            K = self.kernels.gram(("RBF",), (), Xt, None, l, kv)
            K.diagonal().add_(JITTER + GV)
            return K

        def mixed():
            return float(self.precision.mixed_nlml(gram(), yt, block=BLOCK))

        def exact():
            return float(self.engine.chol_nlml(gram(), yt))

        self.reset_counts()
        first_ms, val = self.wall_ms(mixed)
        self.main_counts = self.counts()
        ref_times = []
        for _ in range(REPS):
            t, ref = self.wall_ms(exact)
            ref_times.append(t)
        times = []
        for _ in range(REPS):
            t, v = self.wall_ms(mixed)
            times.append(t)
        rel = abs(val - ref) / abs(ref)
        check("16k mixed NLML vs f64 cholesky on the card", rel <= NLML_RTOL,
              f"mixed={val:.10e} f64={ref:.10e} rel={rel:.3e} "
              f"(limit {NLML_RTOL:g}); repeat drift {abs(v - val):.3e}")
        c = self.main_counts
        steps = N // BLOCK
        check("16k NLML went through K1, K2, K3",
              c["K1"] == steps - 1 and c["K2"] > 0 and c["K3"] > 0
              and c["S"] == 2 * c["K2"] + c["K1"],
              f"launches {c} (K1 limit {steps - 1}, one a step with a live "
              f"trailing matrix; slicing calls S: two a K2 call and one a "
              f"K1 call)")
        check("16k NLML K3 fallbacks", c["K3_fallback"] == 0,
              f"fallbacks={c['K3_fallback']}")
        print(f"  nlml_ms median={statistics.median(times):.2f} "
              f"(runs {', '.join(f'{t:.2f}' for t in times)}; first "
              f"{first_ms:.2f}) f64_cholesky_nlml_ms median="
              f"{statistics.median(ref_times):.2f}; both include the Gram",
              flush=True)
        self.try_profile(mixed)

    def profile(self, fn, names=False):
        """Device time by kernel over one evaluation, and the device's
        busy share of the wall time (kernels run on one stream, so their
        durations do not overlap).  Also counts every kernel launch and
        the PyTorch `trunc` launches.  Returns the busy share, or with
        names=True the {label: launches} of every kernel seen."""
        from collections import defaultdict

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = defaultdict(lambda: [0.0, 0])
        trunc = 0
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            label = ev.name
            trunc += "trunc" in label
            for tag, short in PROFILE_LABELS:
                if tag in label:
                    label = short
                    break
            by_name[label][0] += ev.time_range.elapsed_us()
            by_name[label][1] += 1
        busy = sum(v[0] for v in by_name.values())
        launches = sum(v[1] for v in by_name.values())
        print(f"  profile: wall_ms={wall_us / 1e3:.2f} device_busy_ms="
              f"{busy / 1e3:.2f} busy_share={busy / wall_us:.3f} "
              f"device_launches={launches} trunc_launches={trunc}",
              flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        for name, (us, count) in top:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {name[:90]}",
                  flush=True)
        if names:
            return {k: v[1] for k, v in by_name.items()}
        return busy / wall_us

    def try_profile(self, fn, names=False):
        """`profile(fn)`, or None where the profiler is unavailable (a
        diagnostic: its absence does not fail the run)."""
        try:
            return self.profile(fn, names)
        except (RuntimeError, AttributeError, ImportError) as e:
            print(f"  profile unavailable: {e!r}", flush=True)
            return None

    # -- phase 4: GPState serving at 16k ----------------------------------
    @contextlib.contextmanager
    def _mixed_route(self, on=True):
        """Sets gpmcmc.FORCE_MIXED (the mixed blocked factorisation,
        K1-K3, for GPState and BO conditioning; exact f64 is the default,
        as in the reference off a TPU) and restores it."""
        gpm = self.gpmcmc
        old = gpm.FORCE_MIXED
        gpm.FORCE_MIXED = on
        try:
            yield
        finally:
            gpm.FORCE_MIXED = old

    def _serve(self, X, y, reqs):
        """GPState conditioned on (X, y) once, then the requests: (state,
        conditioning ms, [request ms], [(mu, var)])."""
        hypers = {"l": np.array(L_SCALES), "kv": np.array([KV]),
                  "gv": np.array(GV)}
        st = self.gpmcmc.GPState(("RBF",), (), True, JITTER, X, y, hypers)
        cond_ms, _ = self.wall_ms(st.chol)
        outs, req_ms = [], []
        for q in reqs:
            t, out = self.wall_ms(lambda q=q: st.predict(q))
            outs.append(out)
            req_ms.append(t)
        return st, cond_ms, req_ms, outs

    def _serve_requests(self):
        rng = np.random.default_rng(1)
        return [rng.uniform(size=(SERVE_POINTS, NX))
                for _ in range(SERVE_REQUESTS)]

    def serving(self):
        """16k GPState serving on the mixed route (FORCE_MIXED): K1-K3."""
        torch, eng = self.torch, self.engine
        X, y = make_data(N)
        reqs = self._serve_requests()
        self.reset_counts()
        with self._mixed_route():
            st, cond_ms, req_ms, outs = self._serve(X, y, reqs)
            self.serve_counts = self.counts()
            check("GPState at 16k took the mixed path", st._mixed()
                  and st.chol()[4] is not None,
                  f"launches {self.serve_counts}")
        l, kv, gv, alpha = st.hyper_args()
        xin_p, yin_p, valid = eng.pad_data(X, y, 32, device=self.dev)
        L0, v0 = eng.chol_state_masked(("RBF",), (), xin_p, yin_p, valid, l,
                                       kv, gv, alpha, JITTER)
        emu = evar = 0.0
        ok = True
        for q, (mu, var) in zip(reqs, outs):
            mu0, var0 = eng.predict_from_chol_masked(
                ("RBF",), (), xin_p, valid, L0, v0,
                torch.as_tensor(q, device=self.dev), l, kv, gv, alpha)
            mu0, var0 = mu0.cpu().numpy(), var0.cpu().numpy()
            ok &= bool(np.allclose(mu, mu0, rtol=MU_RTOL, atol=ATOL))
            ok &= bool(np.allclose(var, var0, rtol=VAR_RTOL, atol=ATOL))
            emu = max(emu, float(np.max(np.abs(mu - mu0) / np.abs(mu0))))
            evar = max(evar, float(np.max(np.abs(var - var0) / np.abs(var0))))
            ok &= bool(np.isfinite(mu).all() and np.isfinite(var).all())
            ok &= mu.shape == var.shape == (SERVE_POINTS,)
        check("GPState 16k predictions vs exact f64 on the card", ok,
              f"mu max rel={emu:.3e} (rtol {MU_RTOL:g}, atol {ATOL:g}) "
              f"var max rel={evar:.3e} (rtol {VAR_RTOL:g})")
        us = sum(req_ms) / (SERVE_REQUESTS * SERVE_POINTS) * 1e3
        print(f"  conditioning_ms={cond_ms:.2f} request_ms="
              f"{', '.join(f'{t:.2f}' for t in req_ms)} predict_us_per_point="
              f"{us:.3f}", flush=True)


    # -- phase 5: the MAP fit ----------------------------------------------
    def _exact_vg(self, Xt, yt, z):
        """Value and gradient of the exact f64 NLML by autograd on the
        card (the yardstick; the port never calls it)."""
        torch = self.torch
        zz = z.to(self.dev).clone().requires_grad_()
        K = self.kernels.gram(("RBF",), (), Xt, None, torch.exp(zz[1:3]),
                              torch.exp(zz[3:4]))
        K.diagonal().add_(JITTER + torch.exp(zz[0]))
        v = self.engine.chol_nlml(K, yt)
        (g,) = torch.autograd.grad(v, zz)
        return float(v.detach()), g

    def _same_factor_grad(self, Xt, yt, z, block=BLOCK):
        """The port's closed-form gradient and the same closed form with
        K^-1 from an f64 triangular inverse of the same mixed factor."""
        torch, bf, pr = self.torch, self.bigfit, self.precision
        rvpack = bf._default_rvpack(NX, ("RBF",), True)
        zc = z.to(self.dev)
        with torch.no_grad():
            gv, l, kv, _ = self.engine.unpack_hypers(rvpack, zc, True,
                                                     False)
            K = self.kernels.gram(("RBF",), (), Xt, None, l, kv)
            K.diagonal().add_(JITTER + gv)
            L, Dinv = pr.blocked_cholesky(K, block=block, return_inv=True)
            a = pr.refined_chol_solve(L, K, yt, Dinv)
            del K
            n = Xt.shape[0]
            C = bf._kinv_lower(L, Dinv, n, bf.GRAD_INV_ITERS)
            eye = torch.eye(n, dtype=torch.float64, device=self.dev)
            Li = torch.linalg.solve_triangular(L, eye, upper=False)
            del eye, L, Dinv
            C64 = Li.T @ Li
            del Li
        args = (rvpack, ("RBF",), (), True, JITTER)
        g = bf._grad_from_kinv(Xt, a, C, zc, *args)
        del C
        g64 = bf._grad_from_kinv(Xt, a, C64, zc, *args)
        return g, g64

    def _vg_case(self, n, label, block=BLOCK):
        """Value+grad through the port at n rows, against f64 autograd and
        against the same closed form through an f64 inverse of the same
        factor; returns the launch counts of the first run, its wall time
        and the value+grad callable."""
        torch = self.torch
        X, y = make_data(n)
        Xt = torch.as_tensor(X, device=self.dev)
        yt = torch.as_tensor(y, device=self.dev)
        z = torch.log(torch.tensor([GV, *L_SCALES, KV], dtype=torch.float64))

        def vg():
            v, g = self.bigfit.nlml_value_and_grad(Xt, yt, z, block=block)
            return float(v), g

        self.reset_counts()
        first_ms, (v, g) = self.wall_ms(vg)
        counts = self.counts()
        ref_times = []
        for _ in range(REPS):
            t, (vx, gx) = self.wall_ms(lambda: self._exact_vg(Xt, yt, z))
            ref_times.append(t)
        self.ref_vg_ms = statistics.median(ref_times)

        def normwise(a, b):
            return float((a - b).abs().max() / b.abs().max())

        vrel = abs(v - vx) / abs(vx)
        grel = ((g - gx).abs() / gx.abs()).cpu().numpy()
        gnorm = normwise(g, gx)
        ok = (vrel <= VG_VALUE_RTOL and gnorm <= VG_GRAD_F64_RTOL
              and bool(torch.isfinite(g).all()) and g.shape == (4,))
        check(f"{label} value+grad vs f64 autograd on the card", ok,
              f"value={v:.10e} f64={vx:.10e} rel={vrel:.3e} (limit "
              f"{VG_VALUE_RTOL:g}); grad={g.cpu().numpy()} f64="
              f"{gx.cpu().numpy()} normwise rel={gnorm:.3e} (limit "
              f"{VG_GRAD_F64_RTOL:g}), "
              f"entrywise rel={grel}")
        gs, g64 = self._same_factor_grad(Xt, yt, z, block)
        snorm = normwise(gs, g64)
        check(f"{label} gradient vs the same factor's f64 inverse",
              snorm <= VG_GRAD_RTOL,
              f"grad={gs.cpu().numpy()} f64-inverse={g64.cpu().numpy()} "
              f"normwise rel={snorm:.3e} (limit {VG_GRAD_RTOL:g}), entrywise "
              f"rel={((gs - g64).abs() / g64.abs()).cpu().numpy()}; "
              f"f64-inverse vs f64 autograd normwise {normwise(g64, gx):.3e}")
        return counts, first_ms, vg

    def map_vg(self):
        """Value+grad at 16k (K1-K6) and at n=1000 (one block, K7)."""
        counts, first_ms, vg = self._vg_case(N, "16k")
        self.map_counts = counts
        times = [self.wall_ms(vg)[0] for _ in range(REPS)]
        check("16k value+grad went through K1-K6",
              all(counts[k] > 0 for k in ("K1", "K2", "K3", "K4"))
              and counts["K5"] == counts["K6"] == 1 and counts["K7"] == 0,
              f"launches {counts}")
        check("16k value+grad K3 fallbacks", counts["K3_fallback"] == 0,
              f"fallbacks={counts['K3_fallback']}")
        self.map_vg_16k = (f"{statistics.median(times):.2f}",
                           f"{self.ref_vg_ms:.2f}")
        print(f"  map_vg_16k_ms median={statistics.median(times):.2f} (runs "
              f"{', '.join(f'{t:.2f}' for t in times)}; first {first_ms:.2f}) "
              f"f64_autograd_vg_ms median={self.ref_vg_ms:.2f}; both include "
              f"the Gram", flush=True)
        self.try_profile(vg)
        counts, first_ms, _ = self._vg_case(MAP_N_CHUNKED,
                                            f"n={MAP_N_CHUNKED}")
        check(f"n={MAP_N_CHUNKED} value+grad went through K1-K6",
              all(counts[k] > 0 for k in ("K1", "K2", "K3", "K4"))
              and counts["K5"] == counts["K6"] == 1 and counts["K7"] == 0,
              f"launches {counts}; first run {first_ms:.2f} ms")
        counts, _, _ = self._vg_case(MAP_N1, f"n={MAP_N1}")
        self.map1_counts = counts
        check(f"n={MAP_N1} value+grad went through K7", counts["K7"] > 0,
              f"launches {counts}")

    def _neg_logpost_f64(self, Xt, yt, rvpack):
        """-(log posterior) and its gradient in z (numpy in, numpy out)
        by f64 autograd of the exact NLML on the card; counts its calls
        in .evals."""
        torch = self.torch

        def fun(z_np):
            fun.evals += 1
            zz = torch.tensor(z_np, dtype=torch.float64, device=self.dev,
                              requires_grad=True)
            K = self.kernels.gram(("RBF",), (), Xt, None, torch.exp(zz[1:3]),
                                  torch.exp(zz[3:4]))
            K.diagonal().add_(JITTER + torch.exp(zz[0]))
            lp = self.engine.chol_nlml(K, yt) + rvpack.log_prior(zz)
            (g,) = torch.autograd.grad(lp, zz)
            return -float(lp.detach()), -g.cpu().numpy()

        fun.evals = 0
        return fun

    def _neg_logpost_port(self, Xt, yt, rvpack):
        """The same through the port's value+grad (what big_map_fit
        minimises); None where the factorisation refuses the point."""
        torch, bf = self.torch, self.bigfit

        def fun(z_np):
            z = torch.as_tensor(z_np, dtype=torch.float64)
            try:
                v, g = bf.nlml_value_and_grad(Xt, yt, z, block=BLOCK,
                                              rvpack=rvpack, jitter=JITTER)
            except torch.linalg.LinAlgError:
                return None
            zz = z.clone().requires_grad_()
            lp = rvpack.log_prior(zz)
            (gp,) = torch.autograd.grad(lp, zz)
            return (-(float(v) + float(lp.detach())),
                    -(g.cpu().numpy() + gp.numpy()))

        return fun

    def fit_pair(self, n, maxiter, ref_options=None, port_options=None):
        """big_map_fit at n rows and L-BFGS-B on the f64 autograd
        value+grad with the same priors, bounds and start, and by default
        the same maxiter and ftol (big_map_fit's: 1e-7; `ref_options`
        replaces them for the f64 fit, `port_options` for big_map_fit).
        Prints evaluations and wall time of both; returns both results
        and what the comparisons need."""
        from scipy.optimize import minimize

        torch, bf = self.torch, self.bigfit
        X, y = make_data(n)
        bf._nlml_vg.calls = 0
        port_ms, (h1, lp1) = self.wall_ms(
            lambda: bf.big_map_fit(X, y, block=BLOCK, **(
                port_options or {"maxiter": maxiter})))
        port_evals = bf._nlml_vg.calls
        rvpack = bf._default_rvpack(NX, ("RBF",), True)
        Xt = torch.as_tensor(X, device=self.dev)
        yt = torch.as_tensor(y, device=self.dev)
        fun = self._neg_logpost_f64(Xt, yt, rvpack)
        bounds = bf._log_bounds(NX, ("RBF",), True)
        ref_ms, res = self.wall_ms(lambda: minimize(
            fun, rvpack.z0().numpy(), jac=True, method="L-BFGS-B",
            bounds=bounds, options=ref_options or {"maxiter": maxiter,
                                                   "ftol": 1e-7}))
        lp0 = -float(res.fun)
        h0 = {k: v.cpu().numpy() for k, v in rvpack.unpack(
            torch.as_tensor(res.x, dtype=torch.float64)).items()}
        print(f"  fit n={n}: port {port_evals} evaluations in "
              f"{port_ms:.1f} ms ({port_ms / max(port_evals, 1):.2f} ms per "
              f"evaluation), logpost {lp1!r}, hypers "
              f"{ {k: v.tolist() for k, v in h1.items()} }; f64 autograd "
              f"{fun.evals} evaluations in {ref_ms:.1f} ms, logpost {lp0!r}, "
              f"hypers { {k: v.tolist() for k, v in h0.items()} }",
              flush=True)
        return dict(h1=h1, lp1=lp1, h0=h0, lp0=lp0, z0=res.x,
                    z1=rvpack.pack_values(h1).numpy(), rvpack=rvpack,
                    X=X, y=y, Xt=Xt, yt=yt, f64=fun, bounds=bounds)

    def map_fit(self):
        """big_map_fit at FIT_N rows against the f64 MAP, held to the FIT_*
        limits.  Both fits run to convergence (ftol 1e-12, maxiter 500),
        so the check holds the port's optimum to the f64 one.  Stopped at
        big_map_fit's default ftol 1e-7, either fit ends up to ~12 % in kv
        from its optimum, along the likelihood's flat kv direction, at a
        point that rounding picks (f64 autograd 9.7 % from every start
        tried): a comparison with such a stop holds where an early stop
        lands, not the port's objective (PERF.md, Findings)."""
        converge = {"maxiter": 500, "ftol": 1e-12}
        r = self.fit_pair(FIT_N, 50, ref_options=converge,
                          port_options=converge)
        h1, h0, lp1, lp0 = r["h1"], r["h0"], r["lp1"], r["lp0"]
        lrel = float(np.max(np.abs(h1["l"] - h0["l"]) / np.abs(h0["l"])))
        kvrel = float(np.max(np.abs(h1["kv"] - h0["kv"]) / np.abs(h0["kv"])))
        lprel = abs(lp1 - lp0) / abs(lp0)
        check(f"big_map_fit n={FIT_N} vs f64 L-BFGS-B",
              lprel <= FIT_LP_RTOL and lrel <= FIT_L_RTOL
              and kvrel <= FIT_KV_RTOL,
              f"logpost={lp1:.6f} f64={lp0:.6f} rel={lprel:.3e} (limit "
              f"{FIT_LP_RTOL:g}); l={h1['l']} f64={h0['l']} rel={lrel:.3e} "
              f"(limit {FIT_L_RTOL:g}); kv={h1['kv']} f64={h0['kv']} "
              f"rel={kvrel:.3e} (limit {FIT_KV_RTOL:g}); gv={h1['gv']} "
              f"f64={h0['gv']}")
        # report only: the port's objective against f64 at the f64 MAP,
        # the grade that big_map_fit's stopping point rides on
        port = self._neg_logpost_port(r["Xt"], r["yt"], r["rvpack"])(r["z0"])
        if port is None:
            print("  at the f64 MAP: the port's factorisation refused it",
                  flush=True)
            return
        vp, gp = port
        vf, gf = r["f64"](r["z0"])
        print(f"  at the f64 MAP: port -logpost {vp!r} f64 {vf!r} (diff "
              f"{vp - vf:.4e}); gradient port {np.round(gp, 6).tolist()} "
              f"f64 {np.round(gf, 6).tolist()} (max |diff| "
              f"{np.max(np.abs(gp - gf)):.3e})", flush=True)

    def fit_cross(self, r):
        """Both objectives (logpost and the projected gradient's largest
        entry, zero at a stationary point) at five points of the segment
        from the f64 optimum (t=0) to the port's (t=1), then the f64 fit
        continued by L-BFGS-B and the port's by big_map_fit, each from
        its own optimum at ftol 1e-12, with both objectives at their
        ends."""
        from scipy.optimize import minimize

        torch, bf = self.torch, self.bigfit
        lo = np.array([b[0] for b in r["bounds"]])
        hi = np.array([b[1] for b in r["bounds"]])
        port = self._neg_logpost_port(r["Xt"], r["yt"], r["rvpack"])

        def both(label, z):
            out = []
            for fname, f in (("f64", r["f64"]), ("port", port)):
                vg = f(z)
                if vg is None:
                    out.append(f"{fname}: factorisation refused")
                    continue
                v, g = vg
                pg = g.copy()
                pg[(z <= lo + 1e-9) & (g > 0)] = 0.0
                pg[(z >= hi - 1e-9) & (g < 0)] = 0.0
                out.append(f"{fname} logpost {-v!r} projected grad max "
                           f"{float(np.abs(pg).max()):.3e}")
            hyp = {k: v.cpu().numpy().tolist() for k, v in r["rvpack"].unpack(
                torch.as_tensor(z, dtype=torch.float64)).items()}
            print(f"  {label}: {'; '.join(out)}; hypers {hyp}", flush=True)

        for t in (0.0, 0.25, 0.5, 0.75, 1.0):
            both(f"t={t}", (1 - t) * r["z0"] + t * r["z1"])
        ms, res = self.wall_ms(lambda: minimize(
            r["f64"], r["z0"], jac=True, method="L-BFGS-B",
            bounds=r["bounds"], options={"maxiter": 40, "maxfun": 60,
                                         "ftol": 1e-12}))
        print(f"  f64 fit continued: {res.nfev} evaluations, {ms:.1f} ms, "
              f"{res.message}", flush=True)
        both("f64 fit continued", res.x)
        bf._nlml_vg.calls = 0
        ms, (h, _) = self.wall_ms(lambda: bf.big_map_fit(
            r["X"], r["y"], block=BLOCK, maxiter=40, ftol=1e-12,
            start=r["h1"]))
        print(f"  port fit continued: {bf._nlml_vg.calls} evaluations, "
              f"{ms:.1f} ms", flush=True)
        both("port fit continued", r["rvpack"].pack_values(h).numpy())

    # -- phase 6: K9 against its plain version ------------------------------
    def _k9_inputs(self, n, m, d, seed):
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        ls = torch.linspace(0.4, 0.9, d, dtype=torch.float32, device=self.dev)
        Xs = torch.rand(n, d, generator=g, device=self.dev) / ls
        Ys = torch.rand(m, d, generator=g, device=self.dev) / ls
        return Xs, Ys

    def _k9_case(self, name, Xs, Ys, alpha, label):
        ops = self.ops
        got = ops.gram_tiles(name, Xs, Ys, alpha)
        want = ops.gram_tiles_plain(name, Xs, Ys, alpha)
        self.sync()
        diff = (got - want).abs()
        err = float(diff.max())
        excess = float((diff - K9_RTOL * want.abs()).max())
        rel = float((diff / want.abs().clamp(min=1e-30)).max())
        ok = (excess <= K9_ATOL and got.shape == want.shape
              and bool(self.torch.isfinite(got).all()))
        check(f"K9 {name} vs plain {label}", ok,
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} (limit |d| <= "
              f"{K9_ATOL:g} + {K9_RTOL:g}|plain|)")
        return err

    def k9(self):
        torch, ops = self.torch, self.ops
        n, m, d = N, BO_CANDIDATES, NX
        Xs, Ys = self._k9_inputs(n, m, d, seed=30)
        Xo, Yo = self._k9_inputs(n - 5, m + 3, 3, seed=31)
        alpha = 0.8
        errs = []
        for name in ops.NAMES:
            errs.append(self._k9_case(name, Xs, Ys, alpha,
                                      f"({n}, {m}, d={d})"))
            self._k9_case(name, Xo, Yo, alpha, f"({n - 5}, {m + 3}, d=3)")
        times = {name: self.ms(lambda name=name: ops.gram_tiles(
            name, Xs, Ys, alpha), reps=20) for name in ops.NAMES}
        ms = times["RBF"]
        plain_ms = self.ms(lambda: ops.gram_tiles_plain("RBF", Xs, Ys),
                           reps=5)
        lib_ms = self.ms(lambda: torch.exp(-0.5 * torch.cdist(Xs, Ys) ** 2),
                         reps=5)
        b_ms, b_by = bound(n * m * (3 * d + 2), (n * m + (n + m) * d) * 4,
                           PEAK_F32_FLOPS)
        self.rows["K9"] = dict(
            name="K9 gram_tiles", source="andvaranaut_torch/csrc/gram.cu",
            replaces="andvaranaut_tpu/gp/pallas_ops.py:72",
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms)
        print(f"  K9 RBF ({n}, {m}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"library_ms(f32 cdist + exp)={lib_ms:.3f} bound_ms={b_ms:.4f} "
              f"({b_by}); per kernel ms "
              f"{ {k: round(v, 4) for k, v in times.items()} }", flush=True)

    # -- phase 7: the GPMCMC facade and BO at 16k ---------------------------
    def _timed(self, split, key, fn):
        """fn, adding its wall seconds (the device synchronised on both
        sides) to split[key]."""

        def wrapped(*a, **k):
            self.sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.sync()
                split[key] = split.get(key, 0.0) + time.perf_counter() - t0

        return wrapped

    def _facade_predict_check(self, g, Q, label, var_on_prior=False):
        """The facade's latent prediction at Q against the exact f64 path
        on the same converted data and hypers: the mean normwise at
        MU_RTOL, the variance elementwise at VAR_RTOL or, with
        var_on_prior, on the prior variance's scale at VAR_PRIOR_RTOL;
        returns the wall ms."""
        torch, eng, gpm = self.torch, self.engine, self.gpmcmc
        t_ms, (mu, var) = self.wall_ms(
            lambda: g.predict(Q, return_var=True, revert=False))
        mu, var = mu[:, 0], var[:, 0]
        st = g.gp
        l, kv, gv, alpha = eng.hypers_to_args(g.hypers, g.noise,
                                              device=self.dev)
        xin_p, yin_p, valid = eng.pad_data(st.xin, st.yin, 32,
                                           device=self.dev)
        L0, v0 = eng.chol_state_masked(st.kerns, st.ops, xin_p, yin_p, valid,
                                       l, kv, gv, alpha, 1e-6)
        Qc = torch.as_tensor(gpm._apply_conrevs(g.xconrevs, Q, "con"),
                             device=self.dev)
        mu0, var0 = eng.predict_from_chol_masked(
            st.kerns, st.ops, xin_p, valid, L0, v0, Qc, l, kv, gv, alpha)
        del L0
        mu0, var0 = mu0.cpu().numpy(), var0.cpu().numpy()
        kss = float(kv.sum())
        emu = float(np.max(np.abs(mu - mu0) / np.abs(mu0)))
        nmu = float(np.max(np.abs(mu - mu0)) / np.max(np.abs(mu0)))
        evar = float(np.max(np.abs(var - var0) / np.abs(var0)))
        pvar = float(np.max(np.abs(var - var0))) / kss
        ok_var = (pvar <= VAR_PRIOR_RTOL if var_on_prior
                  else bool(np.allclose(var, var0, rtol=VAR_RTOL, atol=ATOL)))
        ok = (nmu <= MU_RTOL and ok_var and np.isfinite(mu).all()
              and np.isfinite(var).all() and mu.shape == (len(Q),))
        var_limit = (f"max |dvar| / kss (limit {VAR_PRIOR_RTOL:g})"
                     if var_on_prior else f"elementwise (limit {VAR_RTOL:g})")
        check(f"facade predict {label} vs exact f64 on the card", ok,
              f"mixed={st._mixed()} padded to "
              f"{eng.round_up(len(st.xin), st._bucket())} rows; mu normwise "
              f"rel={nmu:.3e} (limit {MU_RTOL:g}), elementwise {emu:.3e}; "
              f"var {var_limit}: elementwise rel={evar:.3e}, max |dvar| / "
              f"kss={pvar:.3e} (kss={kss:.4g}, min var={var0.min():.3e}); "
              f"wall_ms={t_ms:.2f}")
        return t_ms

    def _exact_latent(self, g, sargs, X, fast):
        """Latent mean and variance of the mixed state at X, through the
        exact f64 cross-Gram (fast=False: the yardstick of the K9
        acquisition, which the port never takes on the card) or K9's."""
        torch, eng = self.torch, self.engine
        xin_p, valid, L, av, Dinv, l, kv, gv, _alpha = sargs
        Xc = torch.stack([g.xconrevs[i].con(X[:, i]) for i in range(NX)],
                         dim=1)
        with torch.no_grad():
            return eng.predict_from_chol_masked_mixed(
                tuple(g.kerns), tuple(g.ops), xin_p, valid, L, av, Dinv, Xc,
                l, kv, gv, None, fast=fast)

    def bo(self):
        """The facade and one BO iteration at 16k on the card, on the
        mixed route (FORCE_MIXED: K1-K3 conditioning, K9 acquisitions)."""
        import tempfile

        rng = np.random.default_rng(2)
        Q = rng.uniform(size=(SERVE_POINTS, NX))
        with tempfile.TemporaryDirectory() as rundir, self._mixed_route():
            g = self._bo_facade(rundir)
            self._facade_predict_check(g, Q, f"at {N} rows")
            self._bo_acquisitions(g)
            self._bo_iteration(g, rng)
            del g

    def _bo_facade(self, rundir):
        """GPMCMC at 16384 rows with the bench data and hypers."""
        from andvaranaut_torch import dists
        from andvaranaut_torch import transform as tf

        X, y = make_data(N)
        priors = [dists.Uniform(0.0, 1.0) for _ in range(NX)]
        g = self.gpmcmc.GPMCMC(nx=NX, ny=1, priors=priors, target=bench_target,
                               xconrevs=[tf.uniform(p) for p in priors],
                               verbose=False, rundir=rundir, device=self.dev)
        g.set_data(X, y[:, None])
        g.change_yconrevs([tf.meanstd(g.y[:, 0])])
        g.hypers = {"l": np.array(L_SCALES), "kv": np.array([KV]),
                    "gv": np.array(GV)}
        g.fit(method="none")
        return g

    def _bo_acquisitions(self, g):
        """The batch EI over BO_CANDIDATES LHC points and the design point
        x* at argmin(y) through K9 against the exact f64 Gram on the same
        mixed state, for two yopt: the best reverted posterior mean over
        the candidates (EI of the order of the posterior sd) and min(y)
        (the BO loop's; a noise outlier of the 16k design, where EI can be
        0 at every point of the domain), raised to the exact posterior
        mean m* at x* where m* lies above it.  So at x* the exact EI is at
        least sd* sqrt(2/pi) sum_{x_i < 0} w_i |x_i| > 0 (the GH nodes
        below the mean), whatever the candidates' seed.

        Checked: K9 launched; the exact EI at K9's argmax within EI_RTOL
        max|EI| of the exact maximum; and, pointwise, |dEI| <= |dm| +
        0.8 |ds| with m, s the reverted predictive mean and sd of each
        path: GH-quadrature EI under an affine reversion (this phase's
        meanstd) is 1-Lipschitz in m and sqrt(2/pi)-Lipschitz in s, so the
        acquisition adds no error of its own to the f32 Gram's.  The
        ratio max|dEI| / max|EI| is printed beside them and not held: the
        f32 Gram's error, amplified through alpha = K^-1 y, moves the mean
        by up to a third of the posterior sd at 16k, where EI is tiny
        (PERF.md, Findings)."""
        torch, eng = self.torch, self.engine
        from andvaranaut_torch.gp import quad

        state_ms, (sargs, has_alpha, mixed) = self.wall_ms(
            lambda: g._bo_state_args(1e-6))
        check("BO state at 16k took the mixed path", mixed,
              f"mixed={mixed}, state_ms={state_ms:.2f}")
        xs = g._LHC__latin_sample(BO_CANDIDATES, seed=BO_SEED)
        i_min = int(np.argmin(g.y[:, 0]))
        xs = np.vstack([xs, g.x[i_min][None, :]])  # x*, the last candidate
        Xt = torch.as_tensor(xs, device=self.dev)
        exact_ms, (mu, var) = self.wall_ms(
            lambda: self._exact_latent(g, sargs, Xt, fast=False))
        fmu, fvar = self._exact_latent(g, sargs, Xt, fast=True)
        yrev = g.yconrevs[0].rev
        ym_x, yv_x = quad.gh_stats(yrev, mu, var)
        ym_f, yv_f = quad.gh_stats(yrev, fmu, fvar)
        dm = (ym_f - ym_x).abs()
        ds = (yv_f.sqrt() - yv_x.sqrt()).abs()
        print(f"  K9 path vs exact f64 Gram, latent mean normwise "
              f"{float((fmu - mu).abs().max() / mu.abs().max()):.3e}, "
              f"max |dmean|/sd {float((dm / yv_x.sqrt()).max()):.3e}, "
              f"latent var elementwise "
              f"{float(((fvar - var).abs() / var).max()):.3e}", flush=True)
        run = g._get_bo_program("batch", "EI", "min", True, has_alpha, mixed)
        y_min, m_star = float(np.min(g.y)), float(ym_x[-1])
        ei_lit, _ = quad.gh_stats(yrev, mu[-1:], var[-1:], EI=True,
                                  EIopt="min", yopt=y_min)
        print(f"  x* = design point at argmin(y): min(y)={y_min:.6e}, exact "
              f"mean m*={m_star:.6e} (m* - min(y) = "
              f"{(m_star - y_min) / float(yv_x[-1].sqrt()):.3f} sd*), exact "
              f"EI at x* with yopt = min(y): {float(ei_lit[0]):.3e}",
              flush=True)
        timed = []
        for yopt, label in ((float(ym_x.min()), "yopt = best mean"),
                            (max(y_min, m_star),
                             "yopt = max(min(y), m* at argmin(y))")):
            n9 = self.ops.gram_tiles.launches
            acq_ms, v_fast = self.wall_ms(lambda: run(Xt, *sargs, yopt))
            timed.append(acq_ms)
            k9_used = self.ops.gram_tiles.launches > n9
            ei_x, _ = quad.gh_stats(yrev, mu, var, EI=True, EIopt="min",
                                    yopt=yopt)
            ei_f = -v_fast
            dei = (ei_f - ei_x).abs()
            scale = float(ei_x.abs().max())
            best_x = float(ei_x.max())
            at_k9 = float(ei_x[torch.argmax(ei_f)])
            slack = float((dei - (dm + 0.8 * ds)).max())
            ok = (k9_used and scale > 0.0 and best_x - at_k9 <= EI_RTOL * scale
                  and slack <= 1e-12 * scale
                  and bool(torch.isfinite(ei_f).all()))
            check(f"batch EI over {len(xs)} candidates, K9 vs exact "
                  f"f64 Gram (mixed state, {label})", ok,
                  f"yopt={yopt:.6e}, exact EI at x* {float(ei_x[-1]):.3e}; "
                  f"exact EI at K9's argmax {at_k9:.6e} vs exact max "
                  f"{best_x:.6e} (limit {EI_RTOL:g} max|EI|); max(|dEI| - "
                  f"(|dm| + 0.8|ds|))={slack:.3e} (limit 1e-12 max|EI|); "
                  f"max|dEI|={float(dei.max()):.3e} = "
                  f"{float(dei.max()) / max(scale, 1e-300):.3e} max|EI| "
                  f"(max|EI|={scale:.3e}); K9 launched={k9_used}")
        print(f"  bo_acq_16k_us_per_pt={timed[0] / len(xs) * 1e3:.3f} "
              f"(K9, {timed[0]:.2f} ms for {len(xs)}; again "
              f"{timed[1]:.2f}; exact f64 Gram {exact_ms:.2f} ms) "
              f"state_ms={state_ms:.2f}", flush=True)
        g.yopt = float(np.min(g.y))
        de = g._get_bo_program("de", "EI", "min", True, has_alpha, mixed)
        gen = torch.Generator(device=self.dev).manual_seed(0)
        lo = torch.zeros(NX, dtype=torch.float64, device=self.dev)
        hi = torch.ones(NX, dtype=torch.float64, device=self.dev)
        de_ms, (xb, fb, ngen) = self.wall_ms(
            lambda: de(gen, lo, hi, *sargs, g.yopt))
        ok = bool(torch.isfinite(xb).all()) and bool(torch.isfinite(fb))
        check("DE program at 16k", ok,
              f"x={xb.cpu().numpy()} -EI={float(fb):.6e} generations={ngen}")
        print(f"  bo_de_16k_ms={de_ms:.2f} generations={ngen} population "
              f"{15 * NX}", flush=True)

    def _bo_step(self, g):
        """One BO iteration (predict mode, BO_CANDIDATES candidates,
        refine) with its wall time split by stage, launches counted from
        zero: (total ms, split s, xopt, yopt, plain K9 calls, rows
        before)."""
        ops = self.ops
        split = {}
        g._bo_state_args = self._timed(split, "state", g._bo_state_args)
        g._LHC__latin_sample = self._timed(split, "draw",
                                           g._LHC__latin_sample)
        g._core__vector_solver = self._timed(split, "target",
                                             g._core__vector_solver)
        g.fit = self._timed(split, "refit", g.fit)
        g.predict = self._timed(split, "predict", g.predict)
        get = g._get_bo_program

        def timed_get(kind, *a, **k):
            run = get(kind, *a, **k)
            if kind == "batch":
                return self._timed(split, "acquisition", run)
            if kind == "refine":
                return self._timed(split, "refine", run[0]), run[1]
            return run

        g._get_bo_program = timed_get
        plain_calls = [0]
        plain = ops.gram_tiles_plain

        def counting_plain(*a, **k):
            plain_calls[0] += 1
            return plain(*a, **k)

        ops.gram_tiles_plain = counting_plain
        n0 = g.nsamp
        np.random.seed(0)
        self.reset_counts()
        try:
            total_ms, (xopt, yopt) = self.wall_ms(lambda: g.BO(
                max_iter=1, opt_method="predict", method="EI",
                predict_samps=BO_CANDIDATES, refine=True))
        finally:
            ops.gram_tiles_plain = plain
            for name in ("_bo_state_args", "_LHC__latin_sample",
                         "_core__vector_solver", "fit", "predict",
                         "_get_bo_program"):
                g.__dict__.pop(name, None)
        return total_ms, split, xopt, yopt, plain_calls[0], n0

    def _bo_iteration(self, g, rng):
        """One BO iteration (`_bo_step`) with its K9 launches counted from
        zero and no plain K9 call, then a predict at its padded state."""
        total_ms, split, xopt, yopt, plain_calls, n0 = self._bo_step(g)
        self.bo_counts = self.counts()
        hyp_ok = all(np.isfinite(np.asarray(v)).all()
                     for v in g.hypers.values())
        ok = (g.nsamp == n0 + 1 and len(g.xc) == n0 + 1 and hyp_ok
              and self.bo_counts["K9"] > 0 and plain_calls == 0
              and np.isfinite(xopt).all() and np.isfinite(yopt))
        check("one BO iteration at 16k (predict, refine, exact f64 refit)",
              ok, f"n {n0} -> {g.nsamp}; refit hypers "
              f"{ {k: np.asarray(v).tolist() for k, v in g.hypers.items()} }; "
              f"K9 launches {self.bo_counts['K9']}, plain K9 calls "
              f"{plain_calls}; xopt={xopt} yopt={yopt}")
        other = total_ms / 1e3 - sum(split.values())
        print(f"  bo_iter_16k_s={total_ms / 1e3:.3f} split_s "
              f"{ {k: round(v, 3) for k, v in split.items()} } other_s="
              f"{other:.3f}; launches {self.bo_counts}", flush=True)
        Q2 = rng.uniform(size=(SERVE_POINTS, NX))
        self._facade_predict_check(g, Q2, f"after the BO step ({g.nsamp} "
                                   "rows)", var_on_prior=True)
        sargs, has_alpha, mixed = g._bo_state_args(1e-6)
        refine, rv = g._get_bo_program("refine", "EI", "min", True,
                                       has_alpha, mixed)
        z0 = rv.pack_values({f"x{k}": float(xopt[k]) for k in range(NX)})
        print("  refine from the BO step's point, profiled:", flush=True)
        self.try_profile(lambda: refine(z0, *sargs, float(g.yopt)))

    # -- phase 7b: the two routes of serving and BO conditioning -----------
    def routes(self):
        """16k GPState serving (3 x 2048 points) on both routes, exact f64
        (the default, as the reference off a TPU) and mixed (FORCE_MIXED:
        K1-K3), in turns: f64, mixed, mixed, f64; then one 16k BO
        iteration on each route (f64, mixed: ~21 s each, most of it the
        f64 refit, so not repeated).  Holds each run to the route it was
        given and that the default is f64; the times are reported."""
        import tempfile

        torch, gpm = self.torch, self.gpmcmc
        X, y = make_data(N)
        st = gpm.GPState(("RBF",), (), True, JITTER, X, y,
                         {"l": np.array(L_SCALES), "kv": np.array([KV]),
                          "gv": np.array(GV)})
        with tempfile.TemporaryDirectory() as rundir:
            g = self._bo_facade(rundir)
            check("default route at 16k on the card is exact f64",
                  not gpm.FORCE_MIXED and not st._mixed()
                  and not g._bo_mixed(),
                  f"FORCE_MIXED={gpm.FORCE_MIXED} GPState._mixed()="
                  f"{st._mixed()} GPMCMC._bo_mixed()={g._bo_mixed()}")
            del g
        del st
        reqs = self._serve_requests()
        order = (False, True, True, False)
        name = {False: "f64", True: "mixed"}
        serve = {False: [], True: []}
        for mixed in order:
            with self._mixed_route(mixed):
                st, cond_ms, req_ms, outs = self._serve(X, y, reqs)
                took = st.chol()[4] is not None
            us = sum(req_ms) / (SERVE_REQUESTS * SERVE_POINTS) * 1e3
            serve[mixed].append((cond_ms, us))
            fin = all(np.isfinite(m).all() and np.isfinite(v).all()
                      for m, v in outs)
            check(f"routes: 16k serving on the {name[mixed]} route",
                  took == mixed and fin,
                  f"mixed state={took}, finite={fin}")
            print(f"  serving route={name[mixed]} conditioning_ms="
                  f"{cond_ms:.2f} request_ms="
                  f"{', '.join(f'{t:.2f}' for t in req_ms)} "
                  f"predict_us_per_point={us:.3f}", flush=True)
            del st, outs
            torch.cuda.empty_cache()
        bo = {False: [], True: []}
        for mixed in (False, True):
            with tempfile.TemporaryDirectory() as rundir, \
                    self._mixed_route(mixed):
                g = self._bo_facade(rundir)
                took = g._bo_mixed()
                total_ms, split, xopt, yopt, _, n0 = self._bo_step(g)
                counts = self.counts()
            bo[mixed].append(total_ms / 1e3)
            ok = (took == mixed and g.nsamp == n0 + 1
                  and np.isfinite(xopt).all() and np.isfinite(yopt)
                  and (counts["K3"] > 0) == mixed and counts["K9"] > 0)
            check(f"routes: one 16k BO iteration on the {name[mixed]} route",
                  ok, f"mixed state={took}, n {n0} -> {g.nsamp}, launches "
                  f"K1={counts['K1']} K3={counts['K3']} K9={counts['K9']}")
            print(f"  bo route={name[mixed]} bo_iter_16k_s="
                  f"{total_ms / 1e3:.3f} split_s "
                  f"{ {k: round(v, 3) for k, v in split.items()} }",
                  flush=True)
            del g
            torch.cuda.empty_cache()
        for mixed in (False, True):
            c = [t[0] for t in serve[mixed]]
            u = [t[1] for t in serve[mixed]]
            print(f"  route {name[mixed]}: serving conditioning_ms "
                  f"{', '.join(f'{t:.2f}' for t in c)}, predict_us_per_point "
                  f"{', '.join(f'{t:.3f}' for t in u)}; bo_iter_16k_s "
                  f"{', '.join(f'{t:.3f}' for t in bo[mixed])}", flush=True)

    # -- phase 8: K8 and K10-K12 against their plain versions ---------------
    @staticmethod
    def _lower_live_entries(m, rs):
        """Entries (r, c), r and c >= rs, whose 256-tile row is at or below
        their 256-tile column: the lower-tile work of a syrk of rows rs.."""
        r = np.arange(rs, m, dtype=np.int64)
        return int((np.minimum(r // 256 * 256 + 256, m) - rs).sum())

    def k8(self):
        """K8 at the f64-carry factorisation's first step (P 16000 x 1000,
        rows above 1000 zero), an all-dead call and a_upper on an
        upper-triangular 4096^2 operand: bit for bit with the plain
        version (the same exact integer sums, the same f64 combine), exact
        zeros outside the live tiles.  The in-place step the factorisation
        runs (`syrk_sub_lower_`) at the same step, bit for bit with the
        two-step form (its plain version, and the kernel's C subtracted).
        Each entry's product kernel timed alone on operands sliced
        beforehand, and a profile of 10 calls of each: the slicing
        kernels and the product, nothing else (one slicing call, of two
        kernels, and one product a call, by the launch counters)."""
        torch, sm = self.torch, self.slicemm
        m, k, rs = N_OFF, BLOCK_OFF, BLOCK_OFF
        c0 = rs // 256 * 256
        A = self.f64(m, k, seed=40)
        A[:rs] = 0.0
        C = sm.syrk_lower(A, row_start=rs)
        Cp = sm.syrk_lower_plain(A, row_start=rs)
        torch.cuda.synchronize()
        err = float((C - Cp).abs().max())
        same = torch.equal(C, Cp)
        del Cp
        t = torch.arange(m, device=self.dev) // 256
        live = (t[:, None] >= t[None, :]) & (t[None, :] >= rs // 256)
        zeros = not bool(C[~live].any())
        exact = A @ A.T
        grade = float((C - exact)[live].abs().max() / exact[live].abs().max())
        del exact, live, t
        check("K8 vs plain (16000x1000, row_start 1000)", same and zeros,
              f"max_abs_err={err:.3e} bit_exact={same} (limit: bit-exact) "
              f"dead_tiles_zero={zeros}; vs f64 A A^T on live tiles "
              f"rel={grade:.3e}")
        # the in-place step, against the two-step form at the same step
        A0 = self.f64(m, m, seed=42)
        A1 = A0.clone()
        sm.syrk_sub_lower_(A1, A, rs)
        A2 = sm.syrk_sub_lower_plain_(A0.clone(), A, rs)
        A3 = A0.clone()
        A3[rs:, rs:] -= C[rs:, rs:]
        torch.cuda.synchronize()
        sub_err = float((A1 - A2).abs().max())
        same_sub = torch.equal(A1, A2) and torch.equal(A1, A3)
        del A2, C
        tt = torch.arange(rs, m, device=self.dev) // 256
        upper = tt[:, None] < tt[None, :]
        del tt
        untouched = (torch.equal(A1[:rs], A0[:rs])
                     and torch.equal(A1[:, :rs], A0[:, :rs])
                     and torch.equal(A1[rs:, rs:][upper], A0[rs:, rs:][upper]))
        del upper
        check("K8 in place vs the two-step form (16000^2 f64 carry, P "
              "16000x1000, row_start 1000)", same_sub and untouched,
              f"max_abs_err={sub_err:.3e} bit_exact={same_sub} (limit: "
              f"bit-exact; plain version and kernel C subtracted) "
              f"untouched_outside_live_tiles={untouched}")
        n0 = sm.syrk_lower.launches
        Z = torch.zeros_like(A)  # every row above row_start = m is zero
        Cd = sm.syrk_lower(Z, row_start=m)
        Ad = A0.clone()
        sm.syrk_sub_lower_(Ad, Z, m)
        torch.cuda.synchronize()
        check("K8 all-dead row_start=16000",
              sm.syrk_lower.launches == n0 and not bool(Cd.any())
              and torch.equal(Cd, sm.syrk_lower_plain(Z, row_start=m))
              and torch.equal(Ad, A0),
              "zeros as the plain version, the carry unchanged in place, "
              "no launch")
        del Cd, Z, Ad
        U = torch.triu(self.f64(K8_UPPER_M, K8_UPPER_M, seed=41))
        Cu = sm.syrk_lower(U, a_upper=True)
        Cn = sm.syrk_lower(U)
        Cup = sm.syrk_lower_plain(U, a_upper=True)
        torch.cuda.synchronize()
        same_u = torch.equal(Cu, Cup) and torch.equal(Cu, Cn)
        check(f"K8 a_upper vs plain and vs the dense kernel "
              f"({K8_UPPER_M}^2 upper-triangular)", same_u,
              f"max_abs_err={float((Cu - Cup).abs().max()):.3e} "
              f"bit_exact={same_u} (limit: bit-exact)")
        del Cu, Cn, Cup
        up_ms = self.ms(lambda: sm.syrk_lower(U, a_upper=True), reps=3)
        dense_ms = self.ms(lambda: sm.syrk_lower(U), reps=3)
        del U
        ms = self.ms(lambda: sm.syrk_lower(A, row_start=rs), reps=3)
        ops = sm._k8_operands(A, c0)
        C = torch.empty((m, m), dtype=torch.float64, device=self.dev)
        kernel_ms = self.ms(lambda: sm._k8_product(ops, C, c0), reps=3)
        del C
        slicing_ms = self.ms(lambda: sm._k8_operands(A, c0), reps=5)
        inplace_ms = self.ms(lambda: sm.syrk_sub_lower_(A1, A, rs), reps=3)
        inplace_kernel_ms = self.ms(
            lambda: sm._k8_product(ops, A1, c0, row_start=rs), reps=3)
        del ops
        two_step_ms = self.ms(lambda: A3[rs:, rs:].sub_(
            sm.syrk_lower(A, row_start=rs)[rs:, rs:]), reps=3)
        plain_ms = self.ms(lambda: sm.syrk_lower_plain(A, row_start=rs),
                           reps=1)
        P = A[rs:]
        lib_ms = self.ms(lambda: torch.matmul(P, P.T), reps=3)
        At = A3[rs:, rs:]
        inplace_lib_ms = self.ms(lambda: At.addmm_(P, P.T, alpha=-1.0),
                                 reps=3)
        del At, A3
        npairs = sm.INT_NSLICES * (sm.INT_NSLICES + 1) // 2
        entries = self._lower_live_entries(m, rs)
        b_ms, b_by = bound(entries * k * 2 * npairs,
                           (m - rs) * k * 8 + m * m * 8, PEAK_INT8_OPS)
        ib_ms, ib_by = bound(entries * k * 2 * npairs,
                             (m - rs) * k * 8 + entries * 16, PEAK_INT8_OPS)
        self.rows["K8"] = dict(
            name="K8 syrk_lower", source="andvaranaut_torch/csrc/slicemm.cu",
            replaces="andvaranaut_tpu/gp/pallas_slicemm.py:876",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, kernel_ms=kernel_ms,
            inplace_ms=inplace_ms, inplace_kernel_ms=inplace_kernel_ms,
            inplace_bound_ms=ib_ms, inplace_library_ms=inplace_lib_ms)
        print(f"  K8 ms={ms:.3f} kernel_ms={kernel_ms:.3f} slicing_ms="
              f"{slicing_ms:.3f} plain_ms={plain_ms:.3f} library_ms(f64 "
              f"P P^T, 15000 rows)={lib_ms:.3f} bound_ms={b_ms:.3f} ({b_by}); "
              f"in place ms={inplace_ms:.3f} kernel_ms={inplace_kernel_ms:.3f} "
              f"bound_ms={ib_ms:.3f} ({ib_by}) two_step_ms={two_step_ms:.3f} "
              f"library_ms(f64 addmm_)={inplace_lib_ms:.3f}; a_upper "
              f"{K8_UPPER_M}^2 ms={up_ms:.3f} vs dense {dense_ms:.3f}",
              flush=True)
        kinds = {SLICING, "K8"}
        self._wrapper_kernels("K8 wrapper (first path-A step)",
                              lambda: sm.syrk_lower(A, row_start=rs),
                              kinds, kinds)
        self._wrapper_kernels("K8 in-place step (first path-A step)",
                              lambda: sm.syrk_sub_lower_(A1, A, rs),
                              kinds, kinds)

    def _carry_case(self, seed):
        """A 16384^2 f32-pair carry with row-varying magnitudes and a
        lower-triangular Linv of unit scale (repeated in-place launches
        keep the carry's magnitude)."""
        torch = self.torch
        W = self.f64(N, N, seed=seed)
        W.mul_(torch.exp(self.f64(N, 1, seed=seed + 1)))
        hi, lo = self.precision._pair_split(W)
        del W
        Linv = torch.tril(self.f64(BLOCK, BLOCK, seed=seed + 2)) / BLOCK ** 0.5
        return hi, lo, Linv

    def _fused_steps(self):
        """(lo, row_start) of the fused stage's first and middle steps."""
        return ((0, BLOCK), (N // 2, N // 2 + BLOCK))

    def k10(self):
        """K10 against its plain version at two steps: the carry bit for
        bit (the same slices, scales and f64 combine as the plain version,
        and the same pair split), everything outside the written window
        bit-identical to the input; the slicing kernel's pair mode on the
        window bit for bit with its plain version; the product kernel timed
        alone on operands sliced beforehand, and a profile of 10 calls:
        the pair slicing, Linv's slicing and the product, nothing
        else."""
        torch, pn, sm = self.torch, self.panel, self.slicemm
        hi0, lo0, Linv = self._carry_case(50)
        errs, pair_errs = [], []
        for lo, rs in self._fused_steps():
            c0 = rs // 256 * 256
            cols = slice(lo, lo + BLOCK)
            got = sm.slice_pair_operand(hi0[c0:, cols], lo0[c0:, cols],
                                        sm.INT_NSLICES, zero_rows=rs - c0)
            want = sm.slice_pair_operand_plain(
                hi0[c0:, cols], lo0[c0:, cols], sm.INT_NSLICES, rs - c0,
                N - c0, BLOCK)
            torch.cuda.synchronize()
            pair_same = (torch.equal(got[0], want[0])
                         and torch.equal(got[1], want[1]))
            pair_errs.append(max(
                float((got[1] - want[1]).abs().max()),
                float((got[0].short() - want[0].short()).abs().max())))
            del got, want
            check(f"pair slicing vs plain (16384^2 carry, window lo {lo}, "
                  f"rows from {c0}, zero above {rs})", pair_same,
                  f"max_abs_err={pair_errs[-1]:.3e} bit_exact={pair_same} "
                  f"(limit: bit-exact)")
            h1, l1 = hi0.clone(), lo0.clone()
            pn.panel_into_carry_(h1, l1, Linv, lo, rs, BLOCK)
            h2, l2 = hi0.clone(), lo0.clone()
            pn.panel_into_carry_plain_(h2, l2, Linv, lo, rs, BLOCK)
            torch.cuda.synchronize()
            err = float((h1[rs:, cols].double() + l1[rs:, cols].double()
                         - h2[rs:, cols].double() - l2[rs:, cols].double())
                        .abs().max())
            errs.append(err)
            same = torch.equal(h1, h2) and torch.equal(l1, l2)
            del h2, l2
            outside = all(
                torch.equal(a[r], b[r]) for a, b in ((h1, hi0), (l1, lo0))
                for r in ((slice(0, rs),), (slice(rs, None), slice(0, lo)),
                          (slice(rs, None), slice(lo + BLOCK, None))))
            check(f"K10 vs plain (16384^2 carry, block {BLOCK}, lo {lo}, "
                  f"row_start {rs})", same and outside,
                  f"max_abs_err={err:.3e} bit_exact={same} (limit: "
                  f"bit-exact) outside_window_bit_identical={outside}")
            del h1, l1
        lo, rs = self._fused_steps()[0]
        c0 = rs // 256 * 256
        cols = slice(lo, lo + BLOCK)
        h1, l1 = hi0.clone(), lo0.clone()
        ms = self.ms(lambda: pn.panel_into_carry_(h1, l1, Linv, lo, rs,
                                                  BLOCK), reps=5)
        ops = pn._k10_operands(h1, l1, Linv, lo, rs, BLOCK)
        kernel_ms = self.ms(lambda: pn._k10_product(ops, h1, l1, lo, rs,
                                                    BLOCK), reps=5)
        del ops
        pair_ms = self.ms(lambda: sm.slice_pair_operand(
            h1[c0:, cols], l1[c0:, cols], sm.INT_NSLICES, zero_rows=rs - c0),
            reps=10)
        alone = self._pair_alone(h1[c0:, cols], l1[c0:, cols],
                                 sm.INT_NSLICES, rs - c0)
        pair_alone = self.ms(alone, reps=10)
        del alone
        pair_plain_ms = self.ms(lambda: sm.slice_pair_operand_plain(
            h1[c0:, cols], l1[c0:, cols], sm.INT_NSLICES, rs - c0, N - c0,
            BLOCK), reps=2)
        linv_ms = self.ms(lambda: sm.slice_operand(Linv, sm.INT_NSLICES),
                          reps=10)
        plain_ms = self.ms(lambda: pn.panel_into_carry_plain_(
            h1, l1, Linv, lo, rs, BLOCK), reps=1)
        win = hi0[rs:, cols].double() + lo0[rs:, cols].double()
        lib_ms = self.ms(lambda: torch.matmul(win, Linv.T), reps=5)
        del win, hi0, lo0
        npairs = sm.INT_NSLICES * (sm.INT_NSLICES + 1) // 2
        rows = N - rs
        b_ms, b_by = bound(rows * BLOCK * BLOCK * 2 * npairs,
                           rows * BLOCK * 16 + BLOCK * BLOCK * 8,
                           PEAK_INT8_OPS)
        self.rows["K10"] = dict(
            name="K10 panel_into_carry_", source="andvaranaut_torch/csrc/panel.cu",
            replaces="andvaranaut_tpu/gp/pallas_panel.py:198",
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, kernel_ms=kernel_ms)
        sp_ms, sp_by = bound(0, (N - c0) * BLOCK * (8 + sm.INT_NSLICES)
                             + (N - c0) * 8, PEAK_BYTES)
        self.rows["SP"] = dict(
            name="SP slice_pair_operand (K10's first window)",
            source="andvaranaut_torch/csrc/slicing.cu",
            replaces="andvaranaut_tpu/gp/pallas_panel.py:198",
            max_abs_err=max(pair_errs), ms=pair_ms, plain_ms=pair_plain_ms,
            bound_ms=sp_ms, bound_by=sp_by, library_ms=None,
            kernel_ms=pair_alone)
        print(f"  K10 ms={ms:.3f} kernel_ms={kernel_ms:.3f} pair_slicing_ms="
              f"{pair_ms:.4f} alone {pair_alone:.4f} (plain "
              f"{pair_plain_ms:.3f}, bound {sp_ms:.4f} "
              f"{sp_by}) linv_slicing_ms={linv_ms:.4f} plain_ms="
              f"{plain_ms:.3f} library_ms(f64 cols @ Linv^T)={lib_ms:.3f} "
              f"bound_ms={b_ms:.3f} ({b_by})", flush=True)
        kinds = {PAIR_SLICING, SLICING, "K10"}
        self._wrapper_kernels(
            "K10 wrapper (first fused step)",
            lambda: pn.panel_into_carry_(h1, l1, Linv, lo, rs, BLOCK),
            kinds, kinds)

    def k11(self):
        """K11 (the slicing kernel's pair mode on the finished panel)
        against its plain version at two steps: the tiled slices and the
        scales bit for bit (the same exact f64 steps)."""
        torch, pn = self.torch, self.panel
        hi0, lo0, _ = self._carry_case(51)
        errs = []
        for lo, rs in self._fused_steps():
            p_sl, sa = pn.pair_to_slices(hi0, lo0, lo, rs, BLOCK)
            q_sl, qa = pn.pair_to_slices_plain(hi0, lo0, lo, rs, BLOCK)
            torch.cuda.synchronize()
            err = float((p_sl.int() - q_sl.int()).abs().max())
            errs.append(err)
            same = torch.equal(p_sl, q_sl) and torch.equal(sa, qa)
            check(f"K11 vs plain (16384^2 carry, block {BLOCK}, lo {lo}, "
                  f"row_start {rs})", same,
                  f"slices and scales bit_exact={same} max_slice_diff="
                  f"{err:g} (limit: bit-exact)")
            del p_sl, q_sl
        lo, rs = self._fused_steps()[0]
        ms = self.ms(lambda: pn.pair_to_slices(hi0, lo0, lo, rs, BLOCK),
                     reps=10)
        c0 = rs // 256 * 256
        cols = slice(lo, lo + BLOCK)
        ns = self.slicemm.INT_NSLICES
        alone = self._pair_alone(hi0[c0:, cols], lo0[c0:, cols], ns, rs - c0)
        kernel_ms = self.ms(alone, reps=10)
        del alone
        plain_ms = self.ms(lambda: pn.pair_to_slices_plain(
            hi0, lo0, lo, rs, BLOCK), reps=2)
        del hi0, lo0
        rows = N - c0
        b_ms, b_by = bound(0, rows * BLOCK * (8 + ns) + rows * 8, PEAK_BYTES)
        self.rows["K11"] = dict(
            name="K11 pair_to_slices (the slicing kernel's pair mode)",
            source="andvaranaut_torch/csrc/slicing.cu",
            replaces="andvaranaut_tpu/gp/pallas_panel.py:299",
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, kernel_ms=kernel_ms)
        print(f"  K11 ms={ms:.4f} kernel_ms={kernel_ms:.4f} plain_ms="
              f"{plain_ms:.3f} library_ms=none bound_ms={b_ms:.4f} ({b_by})",
              flush=True)

    def k12(self):
        """K12 on K11's tiled slices against its plain version and against
        K1 on the same panel (the pair's value, zero above row_start), bit
        for bit at two steps, everything outside the live tiles
        bit-identical; its wrapper, which launches the product kernel
        alone on the slices given, timed."""
        torch, pn, sm = self.torch, self.panel, self.slicemm
        hi0, lo0, _ = self._carry_case(52)
        errs = []
        for lo, rs in self._fused_steps():
            p_sl, sa = pn.pair_to_slices(hi0, lo0, lo, rs, BLOCK)
            h1, l1 = hi0.clone(), lo0.clone()
            sm.syrk_sub_pair_presliced_(h1, l1, p_sl, sa, row_start=rs)
            h2, l2 = hi0.clone(), lo0.clone()
            sm.syrk_sub_pair_presliced_plain_(h2, l2, p_sl, sa, row_start=rs)
            torch.cuda.synchronize()
            err = float((h1.double() + l1.double() - h2.double()
                         - l2.double()).abs().max())
            errs.append(err)
            same = torch.equal(h1, h2) and torch.equal(l1, l2)
            del h2, l2
            c0 = rs // 256 * 256
            t = torch.arange(N - c0, device=self.dev) // 256
            upper = t[:, None] < t[None, :]
            same = same and all(
                torch.equal(a[:c0], b[:c0]) and torch.equal(a[:, :c0], b[:, :c0])
                and torch.equal(a[c0:, c0:][upper], b[c0:, c0:][upper])
                for a, b in ((h1, hi0), (l1, lo0)))
            del upper, t
            P = hi0[:, lo:lo + BLOCK].double() + lo0[:, lo:lo + BLOCK].double()
            P[:rs] = 0.0
            h3, l3 = hi0.clone(), lo0.clone()
            sm.syrk_sub_pair_(h3, l3, P, row_start=rs)
            torch.cuda.synchronize()
            as_k1 = torch.equal(h1, h3) and torch.equal(l1, l3)
            del h1, l1, h3, l3, P
            check(f"K12 vs plain and vs K1 on the same panel (16384^2 "
                  f"carry, block {BLOCK}, lo {lo}, row_start {rs})",
                  same and as_k1,
                  f"max_abs_err={err:.3e} bit_exact={same} (limit: "
                  f"bit-exact, outside the live tiles included) "
                  f"equal_to_K1={as_k1}")
        lo, rs = self._fused_steps()[0]
        p_sl, sa = pn.pair_to_slices(hi0, lo0, lo, rs, BLOCK)
        h1, l1 = hi0.clone(), lo0.clone()
        ms = self.ms(lambda: sm.syrk_sub_pair_presliced_(
            h1, l1, p_sl, sa, row_start=rs), reps=3)
        plain_ms = self.ms(lambda: sm.syrk_sub_pair_presliced_plain_(
            h1, l1, p_sl, sa, row_start=rs), reps=1)
        P = hi0[rs:, lo:lo + BLOCK].double() + lo0[rs:, lo:lo + BLOCK].double()
        del h1, l1, hi0, lo0
        lib_ms = self.ms(lambda: torch.matmul(P, P.T), reps=3)
        del P
        T = (N - rs) // 256
        elems = T * (T + 1) // 2 * 256 * 256
        npairs = sm.INT_NSLICES * (sm.INT_NSLICES + 1) // 2
        b_ms, b_by = bound(elems * BLOCK * 2 * npairs,
                           (N - rs) * (BLOCK * sm.INT_NSLICES + 8)
                           + elems * 16, PEAK_INT8_OPS)
        self.rows["K12"] = dict(
            name="K12 syrk_sub_pair_presliced_",
            source="andvaranaut_torch/csrc/slicemm.cu",
            replaces="andvaranaut_tpu/gp/pallas_slicemm.py:669",
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, kernel_ms=ms)
        print(f"  K12 ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms(f64 "
              f"P P^T)={lib_ms:.3f} bound_ms={b_ms:.3f} ({b_by})", flush=True)

    # -- phase 9: the f64-carry route at N=16000, block 1000 ------------------
    def offgrain(self):
        """bench.py's problem at N=16000, block 1000: the NLML against f64
        (median of REPS after the counted warm-up run) and the value+grad
        at the bench hypers, each with its launches: K8 once per step with
        a live trailing matrix, none of K1, K4-K6, K10-K12; and the
        factorisation's steps allocate no (m, m) product (K8 subtracts in
        place)."""
        torch = self.torch
        X, y = make_data(N_OFF)
        Xt = torch.as_tensor(X, device=self.dev)
        yt = torch.as_tensor(y, device=self.dev)
        l = torch.tensor(L_SCALES, dtype=torch.float64, device=self.dev)
        kv = torch.tensor([KV], dtype=torch.float64, device=self.dev)

        def gram():
            K = self.kernels.gram(("RBF",), (), Xt, None, l, kv)
            K.diagonal().add_(JITTER + GV)
            return K

        def mixed():
            return float(self.precision.mixed_nlml(gram(), yt,
                                                   block=BLOCK_OFF))

        steps = N_OFF // BLOCK_OFF
        none = ("K1", "K4", "K5", "K6", "K10", "K11", "K12")
        self.reset_counts()
        first_ms, val = self.wall_ms(mixed)
        c = self.off_counts = self.counts()
        ref_times = []
        for _ in range(REPS):
            t, ref = self.wall_ms(lambda: float(self.engine.chol_nlml(
                gram(), yt)))
            ref_times.append(t)
        times = [self.wall_ms(mixed)[0] for _ in range(REPS)]
        rel = abs(val - ref) / abs(ref)
        check(f"{N_OFF} mixed NLML at block {BLOCK_OFF} vs f64 cholesky",
              rel <= NLML_RTOL, f"mixed={val:.10e} f64={ref:.10e} "
              f"rel={rel:.3e} (limit {NLML_RTOL:g})")
        check(f"{N_OFF} NLML at block {BLOCK_OFF} went through K8, not "
              f"the pair-carry kernels",
              c["K8"] == steps - 1 and all(c[k] == 0 for k in none),
              f"launches {c} (K8 limit {steps - 1}: one per step with a "
              f"live trailing matrix)")
        print(f"  nlml_off_{N_OFF}_ms median={statistics.median(times):.2f} "
              f"(runs {', '.join(f'{t:.2f}' for t in times)}; first "
              f"{first_ms:.2f}) f64_cholesky_nlml_ms median="
              f"{statistics.median(ref_times):.2f}; both include the Gram",
              flush=True)
        self.try_profile(mixed)
        A = gram()
        self.sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.precision._chol_steps(A, steps, BLOCK_OFF)
        self.sync()
        extra = torch.cuda.max_memory_allocated() - base
        del A
        full = N_OFF * N_OFF * 8
        check(f"{N_OFF} f64-carry factorisation steps allocate no (m, m) "
              f"product", extra < full,
              f"peak beyond the carry {extra / 2**20:.1f} MiB (limit: one "
              f"(m, m) f64 C, {full / 2**20:.0f} MiB, which the two-step "
              f"form allocated each step)")
        counts, first_ms, vg = self._vg_case(N_OFF, f"{N_OFF} block "
                                             f"{BLOCK_OFF}", block=BLOCK_OFF)
        check(f"{N_OFF} value+grad at block {BLOCK_OFF} launches",
              counts["K8"] == steps - 1 and counts["K7"] == 1
              and all(counts[k] == 0 for k in none),
              f"launches {counts} (K8 limit {steps - 1}, K7 1)")
        times = [self.wall_ms(vg)[0] for _ in range(2)]
        print(f"  map_vg_off_{N_OFF}_ms runs "
              f"{', '.join(f'{t:.2f}' for t in times)} (first {first_ms:.2f}) "
              f"f64_autograd_vg_ms median={self.ref_vg_ms:.2f}", flush=True)

    # -- phase 10: the fused panel stage at 16k ------------------------------
    def fused(self):
        """The 16k NLML with ANDVARANAUT_FUSED_PANEL=1 (the variable restored
        afterwards): parity against f64, the factor against the unfused
        route's (grades of tests/test_precision.py's fused-panel test),
        launches (K10-K12 once per step with a live trailing matrix, no
        K1), then both routes timed in turns (unfused, fused, fused,
        unfused; three evaluations a turn) and profiled once each."""
        import os

        torch, pr = self.torch, self.precision
        X, y = make_data(N)
        Xt = torch.as_tensor(X, device=self.dev)
        yt = torch.as_tensor(y, device=self.dev)
        l = torch.tensor(L_SCALES, dtype=torch.float64, device=self.dev)
        kv = torch.tensor([KV], dtype=torch.float64, device=self.dev)

        def gram():
            K = self.kernels.gram(("RBF",), (), Xt, None, l, kv)
            K.diagonal().add_(JITTER + GV)
            return K

        def mixed():
            return float(pr.mixed_nlml(gram(), yt, block=BLOCK))

        key = "ANDVARANAUT_FUSED_PANEL"
        old = os.environ.get(key)

        def route(on):
            os.environ[key] = "1" if on else "0"

        try:
            route(False)
            L0, D0 = pr.blocked_cholesky(gram(), block=BLOCK, return_inv=True)
            route(True)
            self.reset_counts()
            first_ms, val = self.wall_ms(mixed)
            c = self.fused_counts = self.counts()
            ref = float(self.engine.chol_nlml(gram(), yt))
            rel = abs(val - ref) / abs(ref)
            check("16k mixed NLML, fused panel, vs f64 cholesky",
                  rel <= NLML_RTOL, f"mixed={val:.10e} f64={ref:.10e} "
                  f"rel={rel:.3e} (limit {NLML_RTOL:g})")
            steps = N // BLOCK
            check("16k fused NLML went through K10, K11, K12 and not K1",
                  all(c[k] == steps - 1 for k in ("K10", "K11", "K12"))
                  and c["K1"] == 0 and c["SP"] == 2 * (steps - 1),
                  f"launches {c} (K10-K12 limit {steps - 1} each, K1 0, "
                  f"pair slicing SP {2 * (steps - 1)}: K10's window and "
                  f"K11)")
            L, D = pr.blocked_cholesky(gram(), block=BLOCK, return_inv=True)
            dL = float((L - L0).abs().max() / L0.abs().max())
            dD = float((D - D0).abs().max() / D0.abs().max())
            del L, D, L0, D0
            check("16k fused factor vs the unfused route's", dL <= 1e-9
                  and dD <= 1e-7, f"tril(L) max diff / max|L|={dL:.3e} "
                  f"(limit 1e-9) Dinv {dD:.3e} (limit 1e-7)")
            times = {False: [], True: []}
            for on in (False, True, True, False):
                route(on)
                for _ in range(3):
                    times[on].append(self.wall_ms(mixed)[0])
            for on, name in ((False, "unfused"), (True, "fused")):
                ts = times[on]
                print(f"  nlml_16k_ms {name} median="
                      f"{statistics.median(ts):.2f} (runs "
                      f"{', '.join(f'{t:.2f}' for t in ts)})", flush=True)
            print(f"  first fused run {first_ms:.2f} ms", flush=True)
            for on, name in ((False, "unfused"), (True, "fused")):
                route(on)
                print(f"  {name} route, profiled:", flush=True)
                self.try_profile(mixed)
        finally:
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old


def bench_target(x):
    """bench.py's target without its noise: sin(3 x0) + x1^2."""
    return np.array([np.sin(3.0 * x[0]) + x[1] ** 2])


def _start():
    """torch with CUDA and the port's kernels built, or an exit code."""
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return None, 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return None, 2
    try:
        from andvaranaut_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return None, 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    try:
        _build.build_all()
    except RuntimeError as e:
        print(f"[FAIL] build: {e}", flush=True)
        return None, 1
    print(f"build_seconds={time.perf_counter() - t0:.1f}", flush=True)
    for src, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)
    return torch, 0


def fit16k():
    """The full 16k MAP fit, bench data, maxiter 200, ftol 1e-7, beside
    the f64 autograd fit, then `Phases.fit_cross`.  Reports only: it
    holds nothing to a limit."""
    torch, rc = _start()
    if torch is None:
        return rc
    ph = Phases(torch)
    t0 = time.perf_counter()
    ph.fit_cross(ph.fit_pair(N, 200))
    print(f"fit16k_seconds={time.perf_counter() - t0:.1f}", flush=True)
    return 0


def mcmc16k_long():
    """sample_model(mixed=True, sampler='hmc_host') on make_data(16384)
    from the bench hypers (the curvature mass there), 2 chains, budget 8
    (max_treedepth 3), MCMC16K_LONG transitions of warmup and draws: each
    chain's mean acceptance, the share of its draws that moved, its lp
    range, step size and leapfrogs per transition, and the wall.  Reports
    only: it holds nothing to a limit."""
    torch, rc = _start()
    if torch is None:
        return rc
    from andvaranaut_torch.inference import nuts

    cfg = _gp_cfg(N)
    start = {"gv": np.array(GV), "l": np.array(L_SCALES),
             "kv": np.array([KV])}
    t0 = time.perf_counter()
    data = nuts.sample_model(cfg, mixed=True, sampler="hmc_host", chains=2,
                             max_treedepth=3, start=start, random_seed=0,
                             device="cuda", **MCMC16K_LONG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = data.sample_stats
    z = np.concatenate([np.asarray(v).reshape(2, MCMC16K_LONG["draws"], -1)
                        for v in data.posterior.values()], axis=-1)
    for c in range(2):
        moved = float(np.mean(np.any(np.diff(z[c], axis=0) != 0, axis=1)))
        print(json.dumps({
            "chain": c, "accept_mean": float(st["accept"][c].mean()),
            "accept_min": float(st["accept"][c].min()),
            "moved_share": moved, "lp_min": float(st["lp"][c].min()),
            "lp_max": float(st["lp"][c].max()),
            "eps": float(st["eps"][c].mean()),
            "leapfrogs_mean": float(st["depth"][c].mean()),
            "diverging": int(st["diverging"][c].sum())}), flush=True)
    print(f"mcmc16k_long: {MCMC16K_LONG}, wall {wall:.1f} s, posterior "
          f"mean {data.posterior_mean()}", flush=True)
    return 0


def _collective_rates_rank(mib):
    """One rank's seconds for each collective of the distributed layer on
    `mib` MiB of f64 a rank on its device, after a warm-up call."""
    import torch

    from andvaranaut_torch import distributed as dd

    group = torch.distributed.group.WORLD
    size = torch.distributed.get_world_size()
    dev = dd.mesh_axis(dd.global_data_mesh())[3]
    x = torch.ones(mib * 2 ** 17, dtype=torch.float64, device=dev)
    calls = {"broadcast": lambda: dd.broadcast(x, 0, group),
             "all_reduce": lambda: dd.all_reduce(x, group),
             "all_gather": lambda: dd.all_gather(x, group),
             "reduce_scatter": lambda: dd.reduce_scatter(
                 x.reshape(size, -1), group)}
    out = {}
    for name, fn in calls.items():
        fn()
        _sync(torch, dev)
        t0 = time.perf_counter()
        fn()
        _sync(torch, dev)
        out[name] = time.perf_counter() - t0
    return out


def collective_rates(mib=512):
    """The collectives' seconds and GB/s of the input a rank sends, on
    SHARD_RANKS ranks that share the card over gloo and on one rank over
    NCCL, at `mib` MiB a rank (what the `sharded` phase's 16k transfers
    move at a time).  Reports only."""
    torch, rc = _start()
    if torch is None:
        return rc
    from andvaranaut_torch import distributed

    for ranks in (SHARD_RANKS, 1):
        _, every = distributed.launch(_collective_rates_rank, ranks, "cuda",
                                      mib)
        for r, res in enumerate(every):
            rates = ", ".join(
                f"{k} {v:.4f} s ({mib * 2 ** 20 / v / 1e9:.2f} GB/s)"
                for k, v in res.items())
            print(f"  collectives ranks={ranks} rank={r} {mib} MiB: "
                  f"{rates}", flush=True)
    return 0


def k7_pieces():
    """K7's product kernel alone with its k pieces forced to 256, 512 and
    2^14 deep (`slicemm._K_CHUNK` lowered, restored after), at m = 300,
    600, 1000 and 2048 with w_lower: whether cutting the deep tiles' k
    ranges balances them over the SMs.  Each result is held to the
    unsplit one bit for bit; the times are reported only."""
    torch, rc = _start()
    if torch is None:
        return rc
    ph = Phases(torch)
    sm = ph.slicemm
    chunk = sm._K_CHUNK
    for m in (300, 600, 1000, 2048):
        W = torch.tril(ph.f64(m, m, seed=m))
        w_sl, sW = sm.slice_operand(W.T, sm.TN_NSLICES)
        C0 = sm.syrk_tn_lower(W, w_lower=True)
        C = torch.empty_like(C0)
        times = {}
        try:
            for depth in (256, 512, chunk):
                sm._K_CHUNK = depth
                times[depth] = ph.ms(
                    lambda: sm._k7_product(w_sl, sW, C, True), reps=20)
                torch.cuda.synchronize()
                same = bool(torch.equal(C, C0))
                check(f"K7 m={m} in pieces of {depth} vs unsplit", same,
                      f"bit_exact={same}")
        finally:
            sm._K_CHUNK = chunk
        print(f"  K7 m={m} kernel_ms by piece depth " + " ".join(
            f"{d}:{t:.4f}" for d, t in times.items()), flush=True)
    return 1 if FAILURES else 0


def _tn_order(nt, group=None):
    """The 64-tiles of the tn product's lower 256-tiles in launch order:
    by rows (group None), or in csrc/slicemm.cu's `lower_tile` walk with
    groups of `group` tile rows."""
    if group is None:
        for rt in range(nt):
            for ct in range(nt):
                if rt // 4 >= ct // 4:
                    yield rt, ct
        return
    for r0 in range(0, nt, group):
        rows = min(group, nt - r0)
        for b in range(rows * r0):
            yield r0 + b % rows, b // rows
        for q in range(-(-rows // 4)):
            left = rows - 4 * q
            for b in range(min(4, left) * left):
                yield r0 + 4 * q + b % left, r0 + 4 * q + b // left


def _tn_wave_bytes(order, nkc, sms=132):
    """A model of the slice bytes the tn product with w_lower reads from
    device memory: consecutive waves of `sms` blocks (one a streaming
    multiprocessor) run in step, and a wave reads each row tile that its
    blocks use, as either operand, once, from the earliest first chunk
    among them (12 plane tiles of 2 KB a chunk: the two passes over 4 and
    8 planes)."""
    order = list(order)
    total = 0
    for w0 in range(0, len(order), sms):
        first = {}
        for rt, ct in order[w0:w0 + sms]:
            kcb = 2 * max(rt, ct)
            for t in (rt, ct):
                first[t] = min(first.get(t, nkc), kcb)
        total += sum(nkc - k for k in first.values()) * 12 * 2048
    return total


def _smi_during(torch, fn, seconds=3.0):
    """Medians of nvidia-smi's utilization.gpu, utilization.memory (the
    share of time device memory was read or written), clocks.sm and
    power.draw, sampled every 100 ms while fn runs again and again for
    `seconds`."""
    cmd = ["nvidia-smi", "--query-gpu=utilization.gpu,utilization.memory,"
           "clocks.sm,power.draw", "--format=csv,noheader,nounits",
           "-lms", "100"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(1.0)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    rows = [[float(v) for v in line.split(",")]
            for line in out.strip().splitlines()[12:-2]
            if line.count(",") == 3]
    if not rows:
        return "no samples"
    cols = zip(*rows)
    names = ("util_gpu_pct", "util_mem_pct", "sm_mhz", "power_w")
    return " ".join(f"{k}={statistics.median(c):g}"
                    for k, c in zip(names, cols)) + f" ({len(rows)} samples)"


def _device_ms(torch, fn, reps):
    """Device time per call of fn over `reps` calls enqueued while a
    sleep kernel holds the stream, so that the host's launch overhead
    between them does not show (CUDA events around the calls only)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _slicemm_with_group(group):
    """csrc/slicemm.cu built with hopper::GROUP = group, from a copy of
    the sources in a temporary directory, loaded with the wrappers'
    signatures (for `tn_walk`; the package itself has one GROUP)."""
    import ctypes
    import shutil
    import tempfile
    from pathlib import Path

    from andvaranaut_torch import _build
    from andvaranaut_torch.gp import slicemm

    tmp = Path(tempfile.mkdtemp())
    try:
        for src in (*_build.CSRC.glob("*.cuh"), _build.CSRC / "slicemm.cu"):
            shutil.copy(src, tmp)
        hdr = tmp / "hopper_tile.cuh"
        text = hdr.read_text()
        line = "constexpr int GROUP = 16;"
        if line not in text:
            raise RuntimeError(f"no '{line}' in hopper_tile.cuh")
        hdr.write_text(text.replace(line, f"constexpr int GROUP = {group};"))
        so = tmp / "slicemm.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(tmp / "slicemm.cu")], check=True,
                       capture_output=True, timeout=900)
        lib = ctypes.CDLL(str(so))
    finally:
        shutil.rmtree(tmp)
    for fn, argtypes in slicemm._SIGS.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def tn_walk(root=None, groups=(8, 32)):
    """The tn product (K6's and K7's kernel) alone at K6's shape, m =
    16384 with w_lower on the pair mode's slices of a lower-triangular
    pair (K5's operand): its time, a checksum of C's bits, the card's
    memory activity while it runs (`_smi_during`, where no profiler
    with a DRAM byte counter can run), and the modelled slice bytes of the
    row walk and of the grouped walk (`_tn_wave_bytes`); then, with this
    tree's package, the product built with other group heights (bit for
    bit with the default build); before all that, the product at K7's
    n=1000 (CUDA events around back-to-back calls, as `Phases.ms`, and
    device time alone, `_device_ms`); then the 16k and 17408 value+grad
    (median wall of 3 after a warm-up).  With `root`, the package is
    imported from that directory instead (an earlier tree, unpacked with
    git archive), so that two trees run in turns on one card:

        python3 -c "import chip_smoke; chip_smoke.tn_walk('<dir>')"

    Reports only."""
    if root is not None:
        sys.path.insert(0, root)
    torch, rc = _start()
    if torch is None:
        return rc
    ph = Phases(torch)
    sm = ph.slicemm
    print(f"package: {sm.__file__}", flush=True)
    W = torch.tril(ph.f64(MAP_N1, MAP_N1, seed=18))
    w1, s1 = sm.slice_operand(W.T, sm.TN_NSLICES)
    C1 = torch.empty((MAP_N1, MAP_N1), dtype=torch.float64, device=ph.dev)

    def run1():
        sm._k7_product(w1, s1, C1, True)

    print(f"  tn product m={MAP_N1} w_lower kernel_ms={ph.ms(run1, reps=50):.4f}"
          f" device_only_ms={_device_ms(torch, run1, 50):.4f}", flush=True)
    hi, lo = ph._tri_pair(N, seed=14)
    w_sl, sW = sm.slice_pair_operand(hi.T, lo.T, sm.TN_NSLICES)
    del hi, lo
    C = torch.empty((N, N), dtype=torch.float64, device=ph.dev)

    def run():
        sm._k7_product(w_sl, sW, C, True)

    ms = ph.ms(run, reps=3)
    bits = C.view(torch.int64)
    weights = torch.arange(N, device=ph.dev, dtype=torch.int64) % 65521 + 1
    checksum = (int(bits.sum()), int((bits * weights).sum()))
    print(f"  tn product m={N} w_lower kernel_ms={ms:.3f} checksum="
          f"{checksum}", flush=True)
    print(f"  during it: {_smi_during(torch, run)}", flush=True)
    nt, nkc = N // 64, N // 32
    for group in (None, 8, 16, 32):
        gb = _tn_wave_bytes(_tn_order(nt, group), nkc) / 1e9
        print(f"  modelled slice bytes, {'rows' if group is None else f'groups of {group}'}"
              f": {gb:.1f} GB ({gb / PEAK_BYTES * 1e12:.1f} ms at "
              f"{PEAK_BYTES / 1e12:g} TB/s)", flush=True)
    if root is None:
        C0 = C.clone()
        default = sm._lib
        try:
            for group in groups:
                lib = _slicemm_with_group(group)
                sm._lib = lambda: lib
                gms = ph.ms(run, reps=3)
                torch.cuda.synchronize()
                same = bool(torch.equal(C, C0))
                sm._lib = default
                dms = ph.ms(run, reps=3)
                print(f"  group {group}: kernel_ms={gms:.3f} (group 16 "
                      f"after it: {dms:.3f}) bit_exact={same}", flush=True)
        finally:
            sm._lib = default
        del C0
    del w_sl, C, bits
    torch.cuda.empty_cache()
    z = torch.log(torch.tensor([GV, *L_SCALES, KV], dtype=torch.float64))
    for n in (N, MAP_N_CHUNKED):
        X, y = make_data(n)
        Xt = torch.as_tensor(X, device=ph.dev)
        yt = torch.as_tensor(y, device=ph.dev)

        def vg():
            return ph.bigfit.nlml_value_and_grad(Xt, yt, z, block=BLOCK)

        ph.wall_ms(vg)
        times = [ph.wall_ms(vg)[0] for _ in range(REPS)]
        print(f"  value+grad n={n} median_ms={statistics.median(times):.2f} "
              f"(runs {', '.join(f'{t:.2f}' for t in times)})", flush=True)
    return 0


def main():
    torch, rc = _start()
    if torch is None:
        return rc
    ph = Phases(torch)
    for name in ("k1", "k2", "k3", "k4", "k5", "k6", "k7", "nlml",
                 "serving", "map_vg", "map_fit", "k9", "bo", "routes", "k8",
                 "k10", "k11", "k12", "offgrain", "fused", "mcmc_small",
                 "mcmc16k", "mcmc_fit", "uq", "inverse", "warped",
                 "sharded", "chains"):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            getattr(ph, name)()
        except Exception:  # a failed phase is reported, the rest still run
            traceback.print_exc(file=sys.stdout)
            FAILURES.append(name)
        torch.cuda.empty_cache()
        print(f"  phase_seconds={time.perf_counter() - t0:.1f}", flush=True)

    print(f"serving launches: {ph.serve_counts}", flush=True)
    # launches: each kernel's count over the path it serves, counted from
    # zero just before that path ran (K1-K3 and the slicing kernel S: the
    # 16k NLML; K4-K6: the 16k value+grad; K7: the one-block value+grad;
    # K8: the N=16000 NLML at block 1000; K9: one 16k BO iteration;
    # K10-K12 and the pair slicing SP: the fused 16k NLML)
    path_counts = {**{k: ph.main_counts.get(k, 0)
                      for k in ("K1", "K2", "K3", "S")},
                   **{k: ph.map_counts.get(k, 0) for k in ("K4", "K5", "K6")},
                   "K7": ph.map1_counts.get("K7", 0),
                   "K8": ph.off_counts.get("K8", 0),
                   "K9": ph.bo_counts.get("K9", 0),
                   **{k: ph.fused_counts.get(k, 0)
                      for k in ("K10", "K11", "K12", "SP")},
                   **{k: ph.mcmc_counts.get(k, 0)
                      for k in ("K3b", "K7b", "Sb")}}
    print(f"BO iteration launches: {ph.bo_counts}", flush=True)
    idle = sorted(k for k, v in path_counts.items() if v == 0)
    check("every kernel launched on its path", not idle,
          f"launches {path_counts}; none: {idle}")
    rows = []
    for key in [f"K{i}" for i in range(1, 13)] + ["S", "SP", "K3b", "K7b",
                                                  "Sb"]:
        row = dict(ph.rows.get(key, {"name": key}))
        out = {"name": row.get("name", key), "route": "cuda",
               "source": row.get("source"), "replaces": row.get("replaces"),
               "launches": path_counts[key],
               "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
               "plain_ms": row.get("plain_ms"),
               "bound_ms": row.get("bound_ms"),
               "bound_by": row.get("bound_by"),
               "library_ms": row.get("library_ms")}
        if key in ph.warped_counts:
            # launches in one 16k warped value+grad (the `warped` phase)
            out["warped_launches"] = ph.warped_counts[key]
        if key in ("K1", "K2", "K3", "S"):
            # launches per rank in one 16k value+grad over SHARD_RANKS
            # ranks (the `sharded` phase)
            out["sharded_launches"] = [c.get(key, 0)
                                       for c in ph.shard_counts]
        cs = ph.chains_stats
        if key in ("K3b", "K7b") and "nuts" in cs:
            # the n=256 'nuts' run of the `chains` phase: launches per
            # in-process shard and per rank (one K3b and K7b a share)
            out["chains_launches"] = {"threads": cs["nuts"]["k3b_per_shard"],
                                      "ranks": cs["nuts"]["k3b_per_rank"]}
        if key in ("K1", "K2", "K3", "K4", "K5", "K6", "S") and "big" in cs:
            # launches per rank of the n=2048 chain-sharded 'nuts' run
            out["chains_launches"] = [c[key] for c in
                                      cs["big"]["launches_per_rank"]]
        out.update({k: v for k, v in row.items() if k not in out})
        rows.append(out)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    if FAILURES:
        print(f"chip_smoke FAILED: {', '.join(FAILURES)}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
