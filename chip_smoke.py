#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pdwt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--only volume|families|extras|sharded|backends|batch_cell]

Run from the repository root.  It builds the CUDA kernels from
``pdwt_tpu_torch/kernels/csrc`` and drives the port's thirteen paths, each
with the launch counters set to 0 just before it and read just after:

* the DWT path: each of its four kernels against its plain PyTorch version
  at the path's shapes, then the ``Wavelets`` facade (db7, 5 levels, a
  2048x2048 float32 image), the golden coefficients and roundtrip timings;
* the TI-denoise path (``bench.py``'s second metric: db7, 3 levels, a
  1024x1024 float32 image, soft threshold at beta 10): the two stationary
  kernels against their plain versions (levels 1-3 and 6 of 1024x1024,
  every threshold, small, odd and batched shapes), then
  ``Wavelets(do_swt=True)`` through ``run_denoise`` and through
  forward/threshold/norm1/inverse, a roundtrip, the fused norm, and the
  TI step's timings; then the 2D TI step as the benchmark runs it (a 64 x
  512 x 512 stack, db7, 5 levels, soft beta 90): kernel 5's norm launches
  (levels 1-5, each mode) against the plain version's bands and a float64
  norm, the sum of their partials against a float64 sum, and
  ``denoise_step(swt=True)`` on the fused norm route against the plain
  path, timed beside the torch norm route;
* the batched 1D path (``bench_all.py``'s third configuration: sym8, 4
  levels, 1024 signals of 4096 float32 samples, soft threshold at beta
  0.1, ``norm1``, inverse): the four 1D kernels against their plain
  versions (the path's levels, then odd, short, long, many, Haar and
  odd-length cases), ``Wavelets(ndim=1)`` with ``do_swt`` off and on,
  through forward/threshold/norm1/inverse and ``run_denoise``, for the
  batch and for one signal, roundtrips, the golden 1D coefficients, and
  the denoise step's timings;
* the benchmark's batched 1D cell (``sym8_1d.batch_step``, the same step
  on 65536 signals, last of the run; ``--only batch_cell`` runs it alone):
  kernels 7 and 8 on the shapes ``dwt1d`` and ``idwt1d`` hand each level
  against their plain versions, timed into rows of their own
  (``fwd_level_1d_cell``, ``inv_level_1d_cell``), and kernel 7's norm
  launches (the details thresholded and their L1 norm summed as they are
  stored) on the same shapes, timed into ``fwd_level_1d_norm_cell`` so that
  the epilogue's cost shows beside the plain launch's, their bands against
  the plain launch's and their partials against a float64 norm; then one
  ``Wavelets(nr=65536, nc=4096, ndim=1)``'s ``run_denoise`` with its
  launches counted from zero (four norm launches of kernel 7, one sum of
  the partials, four of kernel 8), held bit for bit to the kernels with
  the torch threshold and ``norm1`` and to the plain levels, and timed
  beside the torch threshold route;
* the precision tiers (``mixed``, ``bf16-fast``, ``bf16-balanced``,
  ``bf16-accurate``) on the DWT path's image and the batched 1D path's
  signals: the four banded-product kernels against their plain versions in
  every scheme the tiers route at the paths' shapes (plus shapes off the
  route rule and ``b2d``), then ``Wavelets(precision=...)`` and
  ``dwt2d``/``idwt2d``, ``dwt1d``/``idwt1d``, ``swt1d``/``iswt1d`` with
  ``precision=``: the launch counts the route rule predicts, the dtype
  contract, the path against the same route on plain versions, the
  roundtrip error against README's tier column, and each tier's roundtrip
  timings beside the exact one's;
* the TI step under the tiers (db7, 3 levels, a 1024x1024 image, soft beta
  10; bf16 under the ``bf16-*`` tiers, float32 under ``mixed``): the two
  a-trous banded-product kernels against their plain versions in every
  scheme the tiers route (levels 1-3, every threshold, plus shapes off the
  route rule), then ``Wavelets(do_swt=True, precision=...)`` through
  ``run_denoise`` and forward/threshold/inverse and ``swt2d``/``iswt2d``/
  ``iswt2d_denoise(precision=...)``, with an odd size and db7 level 6 off
  the route: launch counts the route rule predicts (``mixed``: none of the
  banded-product kernels), the dtype contract, the path against the same
  route on plain versions, roundtrip errors against README's figure or
  the JAX package's on the CPU, and each tier's TI step timed beside the
  exact one;
* the non-separable engine: ``Wavelets(do_separable=False)`` with db7
  (isotropic quads: the separable kernels) and with custom rank-3 quads
  set through ``set_filters_forward``/``set_filters_inverse``, a 2048x2048
  DWT with 5 levels and a 1024x1024 SWT with 3 levels, under ``exact`` (no
  kernel launch, as in JAX), ``mixed`` and the bf16 tiers; the two rank-r
  kernels against their plain versions at every routed level, both
  strides; launch counts, the dtype contract, the path against the plain
  route, roundtrips, and the timings;
* the operators: the reference's operator set and the models on it at
  the paths' sizes, through the facade and the models' entry points
  (group, firm, shrink, L-infinity, BayesShrink, the L2,1 norms, the
  axpy, get/set_coeff, circshift and copy on the 2048x2048 db7 5-level
  coefficients; ``auto_denoise`` with each method on the DWT at 2048x2048
  and the SWT at 1024x1024; the group TI step; ``cycle_spin_denoise`` with
  8 spins and FISTA with 50 iterations at 1024x1024, the latter with the
  identity, a 7x7 blur and the group lasso; the operators on the batched
  1D coefficients, decimated and stationary; Haar on the card; the demo's
  scenarios 1-3 on a 2048x2048 ``.dat``): each result against the same
  computation on the plain route on the card, each call between a reset
  and a read of the launch counters (exactly the exact kernels its
  transform dispatches), each call's time and device busy time;
* the boundary modes: the padded entry points of kernels 1, 2, 7 and 8
  against their plain versions (every mode, odd sides, signals shorter
  than the filter, 2 to 20 taps, per-axis tuples mixing in periodization,
  an odd-length bank's forward; timed at the paths' shapes), then the
  2048x2048 db7 5-level symmetric roundtrip and the 1024 x 4096 sym8
  4-level one through ``dwt2d``/``idwt2d``, ``dwt1d``/``idwt1d`` and the
  facade, every level on the padded kernels (the launch counters), held to
  the same route on plain versions and to the plain extension route (JAX's
  fma formulation), timed beside it; the 2048x2048 roundtrip under each
  other mode, ``Wavelets(mode=("symmetric", "periodization"))`` and
  ``denoise_step(boundary="symmetric")`` at 1024x1024;
* the sharded transforms (``pdwt_tpu_torch.parallel``): the padded entry
  points of kernels 5, 6, 9 and 10 against their plain versions on the
  shard geometries below (timed there) and on their code paths, and those
  of kernels 11-16 likewise under each precision tier's schemes and dtypes
  (``bf16-fast``'s timed), then on their code paths in every scheme; then (a)
  one NCCL rank on a (1, 1, 1) mesh, the 2048x2048 db7 5-level roundtrip
  through ``parallel.dwt2d``/``idwt2d`` against the single-card
  transforms, timed; and (b) four gloo ranks sharing the one card, the only
  way one card sees real ring halos: the same roundtrip on a 2 x 2 mesh,
  ``sharded_denoise_step(swt=True)`` at 1024x1024 (db7, 3 levels, soft beta
  10), the 1024 x 4096 sym8 4-level 1D DWT and SWT roundtrips over 4
  column shards, and a 5-level SWT of 8 x 256 signals whose level-5 halo
  sides (112 and 128 samples) are wider than a shard (64), two hops each;
  then under each tier the same 2D roundtrip and the 1D cell's DWT and
  SWT roundtrips, and under the bf16 tiers the TI step on a bf16 image;
  each rank holds its shards to the same slice of the single-card result
  (under a tier within the tier path limits) and reads exactly the padded
  launches the route rule predicts on its shard.  The sharded volumes and
  non-separable transforms join both: (a) on a (1, 1, 1, 1) (data, dep,
  row, col) mesh the 128x512x512 db4 2-level roundtrip through
  ``parallel.dwt3d``/``idwt3d`` and ``sharded_denoise_step_3d(swt=True)`` at
  64x512x512 (soft, beta 1), against the single-card calls, with exactly
  the padded launches (1p, 2p twice a level; 5p, 6p twice) and depth
  products (four a level forward, one inverse) the route gives, each timed
  beside the single card (call, busy split, peak memory); (b) the 3D DWT
  and SWT of 16x64x64 on (dep, row) = (2, 2) and on dep = 4 (halos of
  several hops), of a 8x128x512 volume under bf16-fast and mixed (11p-14p
  where the route accepts the shard), ``sharded_denoise_step_3d``, and the
  rank-3 8x8 quads' DWT and SWT on (row, col) = (2, 2) (the conv passes
  with the ring) and, under bf16-fast, on a bf16 batch of 4 over the data
  axis alone (kernels 17 and 18 on each rank).  Four processes on one card
  that send their halos through the host measure nothing of scaling: only
  the kernels' own times are kept.
* the 3D transforms (``bench_all.py``'s two 3D configurations): kernels 1,
  2, 5, 6 and 11-14 against their plain versions at the 3D path's level
  shapes (64 and 128 planes of 512x512 and 256x256 a launch, every scheme
  the tiers route there, and a batch of 5 x 3 planes), one pass of each
  timed; the 128x512x512 db4 2-level roundtrip through ``dwt3d``/``idwt3d``
  and ``Wavelets(volume)``, held to the same composition on plain versions,
  to the conv passes (JAX's fma formulation) and to its roundtrip error,
  again under ``torch.set_float32_matmul_precision("high")`` (the depth
  product stays FP32), then under each tier (JAX's 3D bounds); the
  64x512x512 TI step (``denoise_step_3d(swt=True)``, soft, beta 1) exact and
  under each tier, held to the same route and to the unfused path on plain
  versions; ``Wavelets(volume, do_swt=True).run_denoise``, the 7-band
  ``get_coeff``/``set_coeff``, 3D cycle spinning, ``auto_denoise_3d``, a 3D
  checkpoint and the demo's ``--nd`` on the card.  Every call's launches
  are exactly the route rule's (11 once a level, 12 and 14 twice a level);
  each path prints its call time, its device busy time split between the
  2D kernels, the depth products and the rest, its idle share and its
  peak memory.  ``--only volume`` runs this phase alone (a development run;
  it prints no result).
* the packet, starlet and dual-tree families, on the existing kernels: the
  DWT cell's image (2048x2048 db7, 5 levels) as a full packet tree
  (``wp2d``/``iwp2d``, kernels 1-4), its best basis under each of the four
  costs and ``wp_reconstruct`` on that cover with and without a soft beta
  (``map_fn`` a leaf at a time beside one threshold pass a depth, equal to
  the bit), ``packet_denoise`` with the automatic beta, ``WaveletPackets``;
  the tree under ``bf16-fast`` and ``mixed`` (11, 12); 1D packets of 1024
  x 4096 sym8 to 4 levels (7, 8; 15, 16 under the tiers); 3D packets of
  64x512x512 db4 to 2 levels and ``WaveletPackets`` on the volume; the
  starlet of the image (4 scales, gen 2), ``starlet_auto_denoise`` and
  ``Starlet`` on the volume (conv passes, no kernel: held to float64 on
  the card); the dual tree of the image (4 levels) and of the signals,
  ``dtcwt_auto_denoise`` and ``DualTree``; the demo's scenarios 4-6.  One
  best-basis cover serves both routes (their float32 cost sums may split
  a near-tie otherwise); launches exactly ``wp_launches``/``dt_launches``;
  every path timed as the volume's.  ``--only families`` runs it alone.
* the last modules ("extras"): ``core.anisotropic`` (fs_dwt/fs_idwt of
  the DWT cell's image at levels (5, 5), periodization on kernels 7 and 8
  and symmetric on 7p and 8p, of the 3D cell's volume at (2, 4, 4), whose
  depth pass hands kernels 7 and 8 262144 lines, held to their plain
  versions there, and of the bf16 image under bf16-fast on 15 and 16),
  ``core.continuous`` (cwt of 64 x 4096 signals on 45 scales for each
  mother, icwt, cwt2d of a 512x512 image: cuFFT, held to numpy float64),
  ``utils.interop`` (wavedec2/waverec2 at the DWT cell, symmetric and
  periodization, wavedec/waverec at the 1D cell, wavedecn/waverecn at the
  TI volume, swt2/iswt2 at 1024x1024, each equal to the port's core call)
  and ``utils.debug`` (assert_finite and checked on a tree with one NaN);
  launches exactly ``fs_launches`` and the route's, every path timed as
  the volume's.  The sharded phase drives the sharded fs_dwt, starlet and
  packets on the gloo ranks and times the fs and packet roundtrips on the
  NCCL rank.  ``--only extras`` and ``--only sharded`` run a phase alone.
* ``backend=`` ("backends", ``--only backends``): six cells (the DWT
  roundtrip, the TI step, the batched 1D step, the exact rank-3
  non-separable DWT at 2048x2048 5 levels, the starlet at 2048x2048 4
  scales, the 3D roundtrip) under ``None``, ``"pallas"`` (bit for bit to
  ``None``, the same launches) and JAX's conv formulations "fma", "xla"
  and "gather" (no launch of the port's kernels; 1e-5 of each output's
  largest value against ``None``, and "xla" against the cell's float64
  computation), each timed; then the C++ engine (``pdwt_tpu_torch.native``)
  in float32 and float64 on the DWT cell against the port's float64
  transform on the card, ``utils.device_time`` (CUDA-graph slope, the
  replay equal to the eager call), ``utils.trace`` and the build
  directory.

The banded-product kernels redesigned for Hopper's CUDA cores (kernels 14
and 18: ``swt_inv_level_2d_mxu``, ``ns_inv_level_2d_mxu``,
``ns_swt_inv_level_2d_mxu``; then kernels 16 and 17: ``inv_level_1d_mxu``,
``swt_inv_level_1d_mxu``, ``ns_fwd_level_2d_mxu``,
``ns_swt_fwd_level_2d_mxu``; then kernels 13 and 15:
``swt_fwd_level_2d_mxu``, ``fwd_level_1d_mxu``, ``swt_fwd_level_1d_mxu``;
then kernel 12: ``inv_level_2d_mxu``, which runs kernel 2's body in the
scheme; then kernel 11: ``fwd_level_2d_mxu``, which runs kernel 13's body
at output step 2) are held bit for bit to their plain versions in the
b-schemes (``fd`` within ``tier_limit``), also on the code paths of their
launch plans (dilations 2-16 on sizes no tile divides and past the image
or signal, odd sizes, the deep levels' small tiles, 37 x 53 and 1 x 1
subbands, a batch of 3, ranks 1 and 4, 2 to 42 taps for 14 and 18, 2 to 40
for 12, 13, 15 and 17, 2 to 128 for 11 and 16, every threshold); the
exact-path kernels redesigned (kernels 2, 6, 10, 9, 8, 5, 1 and 7:
``inv_level_2d``, ``swt_inv_level_2d``, which runs kernel 14's body in
``fd`` on float32 subbands, ``swt_inv_level_1d`` and ``swt_fwd_level_1d``,
which run the a-trous bodies of kernels 16 and 15 in ``fd`` on float32
data, ``inv_level_1d``, which runs kernel 16's polyphase body,
``swt_fwd_level_2d`` and ``fwd_level_2d``, which run kernel 13's body at
steps 1 and 2, rows first, and ``fwd_level_1d``, which runs kernel 15's
decimated body, all in ``fd`` on float32 data) within ``KERNEL_RTOL`` on
theirs (every tile size, 2 to 128 taps, odd too, 8 x 8, 2 x 2 and 1 x 1
subbands or images, dilations 2-16 on sizes no tile divides and up to 4096
past the signal or image, signals of 1, 2 and 7 samples, a batch of 33 and
one past the grid's limit, every threshold); so are the tails (kernels 3
and 4: ``fwd_tail_2d`` and ``inv_tail_2d``, which run the level bodies of
kernels 1 and 2 level by level in one launch over a thread-block cluster;
1-5 levels, 2 to 128 taps, halos wider than the deepest level, batches of
3 and 70000), each also equal (``torch.equal``) to the chain of its level
kernel and, with more than one level, to its own first result over 50
repeats, with its launch plan printed.  Each
timed launch of these redesigned kernels prints its device time beside its
bound; a profiler window that dropped events is profiled again, and read
as not measured if every try drops some.

It prints one JSON line with the per-kernel results (times, launches, the
least time the card could take and a PyTorch yardstick), the card's name
and power limit before it, and, last, one JSON line with ``"ok": true``.
Any failed check exits non-zero before that line; so does a machine without
a CUDA device.  Imports no JAX.  It needs one card; the sharded phase
starts its ranks with ``torch.multiprocessing`` in spawn mode, after the
kernels are built, and any rank's failure fails the run.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from wavebench import tracing

N, WNAME, LEVELS, BETA = 2048, "db7", 5, 10.0
# the TI-denoise step (bench.py:126-145)
TI_N, TI_LEVELS, TI_BETA = 1024, 3, 10.0
# the batched 1D denoise step (bench_all.py:87-97): standard normal signals
B1_SIGNALS, B1_N, B1_WNAME, B1_LEVELS, B1_BETA = 1024, 4096, "sym8", 4, 0.1
# the same step as the benchmark's batched 1D cell runs it
# (wavebench/workloads/sym8_1d.batch_step.json): 64 of those batches a call
BC_SIGNALS = 65536
# kernel vs plain version: max|diff| <= KERNEL_RTOL * max|plain|.  nvcc
# contracts each multiply-add into one FMA, the plain version rounds twice.
KERNEL_RTOL = 1e-5
# main path vs the plain path on the card, same bound and reason
PATH_RTOL = 1e-5
# max |idwt2d(dwt2d(x)) - x| (and of iswt2d(swt2d(x))) on [0, 255] float32 data
ROUNDTRIP_ATOL = 1e-3
# thresholded_norm1(c) against norm1(soft_threshold(c)): float32 sums in
# another order
NORM_RTOL = 1e-5
# the 2D TI step of the benchmark's TI cell (wavebench/workloads/
# db7_2d.ti_step.json), where denoise_step takes the norm in kernel 5
FN_BATCH, FN_N, FN_LEVELS, FN_BETA = 64, 512, 5, 90.0
# kernel 5's norm against a float64 norm of the same bands: each thread
# sums its terms in float32, a block its threads' sums in float32, and only
# then are the partials added in float64; chains of n float32 additions
# bound the relative error by n 2^-24, 6e-6 at n = 100
FUSED_NORM_RTOL = 1e-5
# kernel 7's norm at the batch cell's 65536 signals, each level's partials
# against a float64 norm and run_denoise's against norm1: one signal left
# out of the sum moves the norm by about 1.5e-5, so the limit lies well
# under that and well above the readings (1e-8 and 8.4e-8 on an H100)
FUSED_1D_NORM_RTOL = 2e-6
# the precision tiers.  A banded-product kernel against its plain version:
# float32-stored outputs within 1e-5 (products of bf16 values are exact and
# both sum in one order, so only fd's FMAs differ), bf16-stored outputs
# within 2^-7 (a float32 sum one ulp apart can flip one bf16 rounding)
TIER_RTOL, BF16_RTOL = 1e-5, 2.0 ** -7
# a tier's path against the same route on plain versions.  The exact
# tail's FMAs move its outputs by a float32 ulp; the next levels' split of
# their data then differs by up to 2^-17 relative per pass (b3, b2d), so
# float32-stored outputs within 1e-4; and it can flip the bf16 rounding of
# a b1/b2f row-pass result inside a level, which moves an output by up to
# one bf16 ulp before its own rounding, so bf16-stored outputs within 2^-6
PATH_TIER_RTOL, PATH_BF16_RTOL = 1e-4, 2.0 ** -6
TIERS = ("mixed", "bf16-fast", "bf16-balanced", "bf16-accurate")
# level-1 (forward, inverse) scheme of each tier; deeper levels run b3
L1_SCHEMES = {"mixed": ("b3", "b3"), "bf16-fast": ("b1", "fd"),
              "bf16-balanced": ("b2f", "b2f"), "bf16-accurate": ("b3", "b3")}
# a-trous forward scheme of the bf16 tiers at level 1 (bf16 input) and
# deeper (float32 input); every a-trous inverse level runs fd
SWT_SCHEMES = {"bf16-fast": ("b1", "fd"), "bf16-balanced": ("b2f", "b2f"),
               "bf16-accurate": ("b2f", "b2f")}
TERMS = {"b1": 1, "fd": 1, "b2f": 2, "b2d": 2, "b3": 3}
# max |inverse(forward(x)) - x| on [0, 255] data, README.md's tier column
ROUNDTRIP_LIMIT = {"mixed": 2.0e-2, "bf16-fast": 4.0, "bf16-balanced": 2.0,
                   "bf16-accurate": 1.0}
# the same error of the JAX package on the CPU (Pallas interpret mode), on
# the inputs this script uses (tools/tier_roundtrip_cpu.py, whose port
# column is the same to the last bit for the bf16 tiers).  Where it is
# larger than README's figure, it is the limit: the port computes JAX's
# function, and README's figures were taken on a TPU
JAX_CPU_ROUNDTRIP = {
    "2D": {"mixed": 0.020751953125, "bf16-fast": 2.4999542236328125,
           "bf16-balanced": 2.4998626708984375, "bf16-accurate": 1.4983673095703125},
    "1D DWT": {"mixed": 0.0089874267578125, "bf16-fast": 1.4999237060546875,
               "bf16-balanced": 1.4999847412109375, "bf16-accurate": 1.496124267578125},
    "1D SWT": {"mixed": 0.0001220703125, "bf16-fast": 1.3996734619140625,
               "bf16-balanced": 1.4999847412109375, "bf16-accurate": 1.4999847412109375},
    # the TI tiers and the non-separable cells (db7 SWT of the TI image,
    # 3 levels; rank-3 quads on a 2048^2 image, 5 levels, and on the TI
    # image, 3 levels), from scripts/jax_roundtrip_figures.py (the JAX
    # package's Pallas path in interpret mode on the CPU)
    "2D SWT": {"mixed": 0.0001678466796875, "bf16-fast": 2.4991455078125,
               "bf16-balanced": 2.4705963134765625, "bf16-accurate": 2.4705963134765625},
    "NS DWT": {"mixed": 0.011749267578125, "bf16-fast": 2.4994049072265625,
               "bf16-balanced": 3.490936279296875, "bf16-accurate": 1.7311477661132812},
    "NS SWT": {"mixed": 9.1552734375e-05, "bf16-fast": 1.4998626708984375,
               "bf16-balanced": 1.4998931884765625, "bf16-accurate": 1.4998931884765625},
    # the packet trees (the DWT image, db7, 5 levels; 1024 x 4096 uniform
    # [0, 255] signals from default_rng(2), sym8, 4 levels), whose A-chain
    # JAX casts to bf16 at every depth under a bf16 tier
    "2D packets": {"mixed": 0.0248260498046875, "bf16-fast": 8.496826171875},
    "1D packets": {"mixed": 0.0090484619140625, "bf16-fast": 4.4781341552734375},
}
# README.md:239: the 2D SWT roundtrip in bf16, one pass (6.5) and b2f (2.4);
# under mixed the SWT is exact.  The non-separable cells take the 2D
# column of ROUNDTRIP_LIMIT
SWT_ROUNDTRIP_LIMIT = {"mixed": ROUNDTRIP_ATOL, "bf16-fast": 6.5, "bf16-balanced": 2.4,
                       "bf16-accurate": 2.4}
# the non-separable cells (a 2048^2 DWT with 5 levels, a 1024^2 SWT with 3)
NS_N, NS_LEVELS, NS_SWT_N, NS_SWT_LEVELS = 2048, 5, 1024, 3
# the timed calls of the bf16-fast tier (the bf16 default) fill the
# banded-product kernels' rows of the JSON line
ROW_TIER = "bf16-fast"
# NVIDIA H100 SXM data sheet: HBM bytes/s; float32 outside the tensor
# cores; bf16 on the tensor cores (dense)
HBM_BPS, FP32_PEAK, BF16_PEAK = 3.35e12, 67e12, 989e12
REPLACES = {
    "fwd_level_2d": "pdwt_tpu/kernels/separable_pallas.py:234",
    "inv_level_2d": "pdwt_tpu/kernels/separable_pallas.py:385",
    "fwd_tail_2d": "pdwt_tpu/kernels/separable_pallas.py:576",
    "inv_tail_2d": "pdwt_tpu/kernels/separable_pallas.py:648",
    "swt_fwd_level_2d": "pdwt_tpu/kernels/swt_pallas.py:95",
    "swt_inv_level_2d": "pdwt_tpu/kernels/swt_pallas.py:231",
    "fwd_level_1d": "pdwt_tpu/kernels/swt_pallas.py:395",
    "inv_level_1d": "pdwt_tpu/kernels/swt_pallas.py:455",
    "swt_fwd_level_1d": "pdwt_tpu/kernels/swt_pallas.py:528",
    "swt_inv_level_1d": "pdwt_tpu/kernels/swt_pallas.py:593",
    "fwd_level_2d_mxu": "pdwt_tpu/kernels/matmul_pallas.py:242",
    "inv_level_2d_mxu": "pdwt_tpu/kernels/matmul_pallas.py:360",
    "fwd_level_1d_mxu": "pdwt_tpu/kernels/mxu1d_pallas.py:102",
    "swt_fwd_level_1d_mxu": "pdwt_tpu/kernels/mxu1d_pallas.py:102",
    "inv_level_1d_mxu": "pdwt_tpu/kernels/mxu1d_pallas.py:153",
    "swt_inv_level_1d_mxu": "pdwt_tpu/kernels/mxu1d_pallas.py:153",
    "swt_fwd_level_2d_mxu": "pdwt_tpu/kernels/swt_matmul_pallas.py:166",
    "swt_inv_level_2d_mxu": "pdwt_tpu/kernels/swt_matmul_pallas.py:293",
    "ns_fwd_level_2d_mxu": "pdwt_tpu/kernels/ns_matmul_pallas.py:100",
    "ns_swt_fwd_level_2d_mxu": "pdwt_tpu/kernels/ns_matmul_pallas.py:100",
    "ns_inv_level_2d_mxu": "pdwt_tpu/kernels/ns_matmul_pallas.py:206",
    "ns_swt_inv_level_2d_mxu": "pdwt_tpu/kernels/ns_matmul_pallas.py:206",
    # the padded entry points of kernels 1, 2, 7 and 8 (the boundary modes)
    "fwd_level_2d_padded": "pdwt_tpu/kernels/separable_pallas.py:355",
    "inv_level_2d_padded": "pdwt_tpu/kernels/separable_pallas.py:498",
    "fwd_level_1d_padded": "pdwt_tpu/kernels/swt_pallas.py:995",
    "inv_level_1d_padded": "pdwt_tpu/kernels/swt_pallas.py:1018",
    # the padded entry points of kernels 5, 6, 9 and 10 (the sharded SWT)
    "swt_fwd_level_2d_padded": "pdwt_tpu/kernels/swt_pallas.py:935",
    "swt_inv_level_2d_padded": "pdwt_tpu/kernels/swt_pallas.py:960",
    "swt_fwd_level_1d_padded": "pdwt_tpu/kernels/swt_pallas.py:1043",
    "swt_inv_level_1d_padded": "pdwt_tpu/kernels/swt_pallas.py:1069",
    # the padded entry points of kernels 11-16 (the sharded tiers): the
    # pad_fn= of the banded-product wrappers
    "fwd_level_2d_mxu_padded": "pdwt_tpu/kernels/matmul_pallas.py:306",
    "inv_level_2d_mxu_padded": "pdwt_tpu/kernels/matmul_pallas.py:442",
    "swt_fwd_level_2d_mxu_padded": "pdwt_tpu/kernels/swt_matmul_pallas.py:252",
    "swt_inv_level_2d_mxu_padded": "pdwt_tpu/kernels/swt_matmul_pallas.py:402",
    "fwd_level_1d_mxu_padded": "pdwt_tpu/kernels/mxu1d_pallas.py:211",
    "inv_level_1d_mxu_padded": "pdwt_tpu/kernels/mxu1d_pallas.py:236",
    "swt_fwd_level_1d_mxu_padded": "pdwt_tpu/kernels/mxu1d_pallas.py:272",
    "swt_inv_level_1d_mxu_padded": "pdwt_tpu/kernels/mxu1d_pallas.py:301",
    # the 2D TI step's fused norm: kernel 5's norm launches (under the
    # launch counter of swt_fwd_level_2d, counted apart here) and the sum of
    # their partials, which take the place of the plain norm of JAX's
    # thresholded_norm1
    "swt_fwd_level_2d_norm": "pdwt_tpu/kernels/swt_pallas.py:95 + pdwt_tpu/ops/norms.py:104",
    "swt_norm_sum_2d": "pdwt_tpu/ops/norms.py:104",
    # kernels 7 and 8 at the benchmark's batched 1D cell (BC_SIGNALS
    # signals, the shapes dwt1d and idwt1d hand each level), apart from
    # their rows at the 1024-signal path
    "fwd_level_1d_cell": "pdwt_tpu/kernels/swt_pallas.py:395",
    "inv_level_1d_cell": "pdwt_tpu/kernels/swt_pallas.py:455",
    # kernel 7's norm launches at the cell, which take the place of the
    # threshold ops and norm1 of the JAX facade's batched 1D step
    "fwd_level_1d_norm_cell": ("pdwt_tpu/kernels/swt_pallas.py:395 + pdwt_tpu/ops/threshold.py"
                               " + pdwt_tpu/ops/norms.py"),
}


def _source(name: str) -> str:
    """The file that holds the kernel's body (kernel 6 runs 14's, 12 runs
    2's, 10 and 8 run 16's, 11, 5 and 1 run 13's, 9 and 7 run 15's; the
    tails 3 and 4 run 1's and 2's level by level, 3 in swt_matmul.cu; the
    padded entry points, kernels 5's and 7's norm launches and the rows of
    the 1D cell run their kernel's; the sum of the norm's partials is in
    swt.cu)."""
    if name == "swt_norm_sum_2d":
        return "swt.cu"
    name = name.removesuffix("_cell").removesuffix("_padded").removesuffix("_norm")
    if name.startswith("ns_"):
        return "ns_matmul.cu"
    if name == "inv_level_2d_mxu":
        return "separable.cu"
    if name.endswith("_2d_mxu") or name in ("fwd_level_2d", "fwd_tail_2d") or (
            name.startswith("swt_") and name.endswith("_2d")):
        return "swt_matmul.cu"
    if name.endswith("_mxu") or name.endswith("_1d"):
        return "mxu1d.cu"
    return "separable.cu"


SOURCES = {name: "pdwt_tpu_torch/kernels/csrc/" + _source(name) for name in REPLACES}


class Case(NamedTuple):
    """One kernel call held against its plain version on the same input."""
    name: str
    arg: object
    kern: Callable
    plain: Callable
    label: str
    timed: bool = False      # a call of its path: timed
    flops: float = 0.0       # the operations the call needs
    peak: float = FP32_PEAK  # the card's rate for them
    limit: Optional[Callable] = None  # output -> relative limit (default KERNEL_RTOL)
    library: Optional[Callable] = None  # arg -> () -> one PyTorch yardstick call
    in_row: bool = True      # a timed call that fills the kernel's JSON row


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of one fn() call over ``reps`` calls, by CUDA
    events: the time the card takes from the call's first launch to its
    last, idle gaps while the host prepares launches included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


@functools.lru_cache(maxsize=1)
def port_kernels() -> frozenset:
    """The names of the port's CUDA kernels, the ``__global__`` functions
    of its sources (``wavebench.tracing.port_kernels``)."""
    from pdwt_tpu_torch.kernels import _build

    return tracing.port_kernels(_build.SOURCES)


def is_port_kernel(event_name: str) -> bool:
    """Is a profiler event one of the port's kernels?
    (``wavebench.tracing.is_port_kernel``)"""
    return tracing.is_port_kernel(event_name, port_kernels())


def busy_per_call(events, reps: int, launched: int):
    """(busy ms per call, {kernel name: ms per call}) from one profiler
    window over ``reps`` calls, or None where the port's kernels fall short
    of the ``launched`` count (``wavebench.tracing.busy_per_call``)."""
    busy = tracing.busy_per_call(events, reps, launched, port_kernels())
    return None if busy is None else busy[:2]


def device_ms(fn, reps: int = 10):
    """(busy milliseconds per fn() call, {kernel name: ms per call}) from
    the device activity torch.profiler records over ``reps`` calls
    (``busy_per_call``).  A window whose counts of the port's kernels read
    low is profiled again, three windows in all; after that (None, {}),
    reported as not measured rather than as a low figure."""
    from torch.profiler import ProfilerActivity, profile

    from pdwt_tpu_torch.kernels import LAUNCHES

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        before = sum(LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launched = sum(LAUNCHES.values()) - before
        busy = busy_per_call([(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA],
                             reps, launched)
        if busy is not None:
            return busy
        print(f"  device_ms: the port's kernels' recorded launches fall short of the "
              f"counters' {launched} over {reps} calls; profiling again", flush=True)
    print("  device_ms: not measured after three windows", flush=True)
    return None, {}


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def leaves(t) -> list:
    if isinstance(t, torch.Tensor):
        return [t]
    return [x for item in t for x in leaves(item)]


def nbytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(t))


def max_err(got, want) -> tuple:
    """(max |got - want|, max |want|) over all outputs of one call: at a
    dilation as large as the image the stationary H and D are roundoff, so
    the bound is relative to the call's largest output."""
    got, want = leaves(got), leaves(want)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.float().abs().max()) for w in want)
    return err, scale


def tier_limit(outs) -> float:
    """A banded-product call's limit: 2^-7 if any output is stored bf16."""
    return BF16_RTOL if any(t.dtype == torch.bfloat16 for t in leaves(outs)) else TIER_RTOL


def scheme_limit(scheme: str) -> Callable:
    """Limit of a call of kernels 13-18: each keeps every output's
    sums in its plain version's order, so the b-schemes agree bit for bit
    (limit 0); fd's FMAs round once where the plain version rounds twice
    (tier_limit)."""
    return tier_limit if scheme == "fd" else (lambda outs: 0.0)


# the kernels redesigned for Hopper's CUDA cores (kernels 14 and 18, then 2
# and 6, then 16 and 17, then 13 and 15, then 12 and 10, then 11 and 9, then
# 8 and 5, then 1 and 7, then the tails 3 and 4): each timed launch's device
# time is printed beside its bound
REDESIGNED = ("swt_inv_level_2d_mxu", "ns_inv_level_2d_mxu", "ns_swt_inv_level_2d_mxu",
              "inv_level_2d", "swt_inv_level_2d", "inv_level_1d_mxu", "swt_inv_level_1d_mxu",
              "ns_fwd_level_2d_mxu", "ns_swt_fwd_level_2d_mxu", "swt_fwd_level_2d_mxu",
              "fwd_level_1d_mxu", "swt_fwd_level_1d_mxu", "inv_level_2d_mxu", "swt_inv_level_1d",
              "fwd_level_2d_mxu", "swt_fwd_level_1d", "inv_level_1d", "swt_fwd_level_2d",
              "fwd_level_2d", "fwd_level_1d", "fwd_tail_2d", "inv_tail_2d",
              "fwd_level_2d_padded", "inv_level_2d_padded", "fwd_level_1d_padded",
              "inv_level_1d_padded", "swt_fwd_level_2d_padded", "swt_inv_level_2d_padded",
              "swt_fwd_level_1d_padded", "swt_inv_level_1d_padded", "fwd_level_2d_mxu_padded",
              "inv_level_2d_mxu_padded", "swt_fwd_level_2d_mxu_padded",
              "swt_inv_level_2d_mxu_padded", "fwd_level_1d_mxu_padded", "inv_level_1d_mxu_padded",
              "swt_fwd_level_1d_mxu_padded", "swt_inv_level_1d_mxu_padded")


def run_cases(cases, report, card) -> None:
    """Hold each kernel call against its plain version on the same input;
    time the calls marked ``timed`` (the paths' shapes) and add those
    marked ``in_row`` to the kernel's row of ``report``: CUDA-event and
    profiler times, the bound and the PyTorch yardstick."""
    for c in cases:
        got, want = c.kern(c.arg), c.plain(c.arg)
        torch.cuda.synchronize()
        check(all(g.dtype == w.dtype and g.shape == w.shape
                  for g, w in zip(leaves(got), leaves(want))),
              f"{c.name} at {c.label}: dtypes or shapes differ from the plain version")
        err, scale = max_err(got, want)
        limit = KERNEL_RTOL if c.limit is None else c.limit(want)
        line = (f"kernel {c.name} at {c.label}: max|kernel-plain| {err:.3e} "
                f"(limit {limit * scale:.3e})")
        rep = report[c.name]
        rep["max_abs_err"] = max(rep["max_abs_err"], err)
        if c.timed:
            k_ms, p_ms = cuda_ms(lambda: c.kern(c.arg)), cuda_ms(lambda: c.plain(c.arg))
            k_dev, p_dev = device_ms(lambda: c.kern(c.arg))[0], device_ms(lambda: c.plain(c.arg))[0]
            bytes_ms, ops_ms = nbytes(c.arg) + nbytes(got), c.flops / c.peak * 1e3
            bytes_ms = bytes_ms / HBM_BPS * 1e3
            line += (f"; per call {k_ms:.4f} ms vs plain {p_ms:.4f} ms; device busy "
                     f"{fmt(k_dev)} vs plain {fmt(p_dev)}; bound {max(bytes_ms, ops_ms):.4f} ms "
                     f"(bytes {bytes_ms:.4f}, operations {ops_ms:.4f})")
            lib_ms = None
            if c.library is not None:
                lib_ms = cuda_ms(c.library(c.arg))
                line += f"; PyTorch yardstick {lib_ms:.4f} ms"
            line += f" [{card}]"
            if c.name in REDESIGNED:
                print(f"per launch: {c.name} at {c.label}: device {fmt(k_dev)} beside its bound "
                      f"{max(bytes_ms, ops_ms):.4f} ms [{card}]", flush=True)
            if c.in_row:
                rep["ms"] += k_ms
                rep["plain_ms"] += p_ms
                rep["bytes_ms"] += bytes_ms
                rep["ops_ms"] += ops_ms
                rep["bound_ms"] += max(bytes_ms, ops_ms)
                for key, val in (("device_ms", k_dev), ("plain_device_ms", p_dev),
                                 ("library_ms", lib_ms)):
                    rep[key] = None if val is None or rep[key] is None else rep[key] + val
        print(line, flush=True)
        check(err <= limit * scale, f"{c.name} at {c.label} disagrees with its plain version")


def compare_route(label, got, want, bf16_rtol=PATH_BF16_RTOL) -> None:
    """A tier's path against the same route on plain versions: every output
    of one dtype and shape, float32 ones within PATH_TIER_RTOL and bf16 ones
    within ``bf16_rtol`` of their largest plain value."""
    gl, wl = leaves(got), leaves(want)
    check(len(gl) == len(wl) and all(g.dtype == w.dtype and g.shape == w.shape
                                     for g, w in zip(gl, wl)),
          f"{label}: dtypes or shapes differ from the plain route")
    worst = 0.0
    for g, w in zip(gl, wl):
        err, scale = max_err(g, w)
        limit = bf16_rtol if w.dtype == torch.bfloat16 else PATH_TIER_RTOL
        check(err <= limit * scale, f"{label} disagrees with the plain route: {err:.3e} "
              f"> {limit * scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
    print(f"{label} vs the same route on plain versions: worst relative {worst:.3e}", flush=True)


def time_in_turns(label, kern_fn, plain_fn, card, names=("kernels", "plain")) -> None:
    """CUDA-event medians of the kernel and plain versions of one step (or
    of two other versions, ``names``), in turns (plain, kernels, kernels,
    plain), then device busy time and idle share by torch.profiler, with
    the busiest kernels."""
    kn, pn = names
    times = {pn: [], kn: []}
    for which in (pn, kn, kn, pn):
        times[which].append(cuda_ms(plain_fn if which == pn else kern_fn))
    print(f"{label}, median of 20 (CUDA events): {kn} {min(times[kn]):.4f} ms, "
          f"{pn} {min(times[pn]):.4f} ms (runs {times}) [{card}]", flush=True)
    for which, fn in ((kn, kern_fn), (pn, plain_fn)):
        busy, by_name = device_ms(fn)
        idle = "not measured" if busy is None else f"{1 - busy / min(times[which]):.3f}"
        print(f"{label} {which}: device busy {fmt(busy)} per call, idle share {idle}")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms:.4f} ms  {kname[:100]}")


# -- work counts: multiply-adds of one call, from its shapes (2 operations each)

def flops_2d(r: int, c: int, hlen: int, terms: int = 1) -> float:
    """A separable 2D level (analysis of an r x c image, or synthesis of
    one): two passes, each r*c outputs of hlen multiply-adds."""
    return 2.0 * 2 * r * c * hlen * terms


def flops_swt_2d(r: int, c: int, hlen: int) -> float:
    """A stationary 2D level, either way: 6*r*c outputs of hlen."""
    return 2.0 * 6 * r * c * hlen


def flops_1d(b: int, n: int, hlen: int, terms: int = 1, swt: bool = False) -> float:
    """A batched 1D level on b signals of n samples (the longer side):
    n outputs of hlen (decimated), 2n of hlen (a-trous)."""
    return 2.0 * b * n * hlen * terms * (2 if swt else 1)


def scheme_peak(scheme: str) -> float:
    """The products of fd are float32, the others' bf16."""
    return FP32_PEAK if scheme == "fd" else BF16_PEAK


_BANDS = {}


def band_matrix(kind: str, n: int, w, level: int, dtype, device) -> torch.Tensor:
    """The dense band matrix of one 1D level, from its plain version applied
    to the identity (row i is the response to sample i): an analysis is
    x @ M, a synthesis [lo | hi] @ M."""
    from pdwt_tpu_torch.kernels import batched1d as K1

    key = (kind, n, w.name, level, dtype, str(device))
    if key not in _BANDS:
        eye = torch.eye(n, device=device)
        z = torch.zeros_like(eye)
        if kind == "fwd":
            m = torch.cat(K1.fwd_level_1d_ref(eye, w.dec_lo, w.dec_hi), 1)
        elif kind == "swt_fwd":
            m = torch.cat(K1.swt_fwd_level_1d_ref(eye, w.dec_lo, w.dec_hi, level), 1)
        elif kind == "inv":
            m = torch.cat([K1.inv_level_1d_ref(eye, z, w.rec_lo, w.rec_hi),
                           K1.inv_level_1d_ref(z, eye, w.rec_lo, w.rec_hi)], 0)
        else:
            m = torch.cat([K1.swt_inv_level_1d_ref(eye, z, w.rec_lo, w.rec_hi, level),
                           K1.swt_inv_level_1d_ref(z, eye, w.rec_lo, w.rec_hi, level)], 0)
        _BANDS[key] = m.to(dtype).contiguous()
    return _BANDS[key]


def yardstick(kind: str, w, dtype=torch.float32, level: int = 1) -> Callable:
    """arg -> () -> the PyTorch yardstick of a kernel call: one dense-band
    matrix product (torch.matmul on cuBLAS) for a 1D level, a pair of them
    (rows, then columns) for a 2D level, in ``dtype``."""
    def make(arg):
        if kind in ("fwd2d", "swt_fwd2d"):
            one = "fwd" if kind == "fwd2d" else "swt_fwd"
            r, c = arg.shape[-2:]
            A = band_matrix(one, r, w, level, dtype, arg.device).t().contiguous()
            B, xm = band_matrix(one, c, w, level, dtype, arg.device), arg[0].to(dtype)
            return lambda: (A @ xm) @ B
        if kind in ("inv2d", "swt_inv2d"):  # [[a, v], [h, d]] by rows, then by columns
            one = "inv" if kind == "inv2d" else "swt_inv"
            a, h, v, d = (t[0].to(dtype) for t in arg)
            P = torch.cat([torch.cat([a, v], 1), torch.cat([h, d], 1)], 0)
            A = band_matrix(one, a.shape[0], w, level, dtype, a.device).t().contiguous()
            B = band_matrix(one, a.shape[1], w, level, dtype, a.device)
            return lambda: (A @ P) @ B
        if kind in ("fwd", "swt_fwd"):
            xm = arg.to(dtype)
            Mx = band_matrix(kind, xm.shape[-1], w, level, dtype, xm.device)
            return lambda: xm @ Mx
        u = torch.cat([arg[0].float(), arg[1].float()], 1).to(dtype)
        Mx = band_matrix(kind, arg[0].shape[-1], w, level, dtype, u.device)
        return lambda: u @ Mx
    return make


def tail_yardstick(w, levels: int, inverse: bool = False) -> Callable:
    """arg -> () -> the PyTorch yardstick of a tail call: ``yardstick``'s
    dense-band pair per level, level by level (the forward's next level on
    the product's top-left quarter, the approximation; the inverse's on the
    whole product)."""
    f32 = torch.float32

    def make(arg):
        if not inverse:
            r, c = arg.shape[-2:]
            mats = [(band_matrix("fwd", r >> j, w, 1, f32, arg.device).t().contiguous(),
                     band_matrix("fwd", c >> j, w, 1, f32, arg.device)) for j in range(levels)]

            def run():
                y = arg[0]
                for A, B in mats:
                    z = (A @ y) @ B
                    y = z[:A.shape[0] // 2, :B.shape[1] // 2]
                return z
            return run
        a, dets = arg
        mr, mc = a.shape[-2:]
        mats = [(band_matrix("inv", mr << j, w, 1, f32, a.device).t().contiguous(),
                 band_matrix("inv", mc << j, w, 1, f32, a.device)) for j in range(levels)]

        def run_inv():
            y = a[0]
            for (A, B), (h, v, d) in zip(mats, dets):
                y = (A @ torch.cat([torch.cat([y, v[0]], 1), torch.cat([h[0], d[0]], 1)], 0)) @ B
            return y
        return run_inv
    return make


def tail_checks(K, cases) -> None:
    """The tails against the level kernels they run, on the code-path
    cases' inputs: the forward tail equals the chain of kernel 1 and the
    inverse tail the chain of kernel 2 (torch.equal: each level sums the
    same float32 terms in the same order); a multi-level case run 50 times
    gives its first result each time (a stale read of the level before
    would show now and then).  Prints each call's plan."""
    for c in cases:
        src, w, levels = c.arg
        if c.name == "fwd_tail_2d":
            B, R, C = src.shape
            def call():
                a, dets = K.fwd_tail_2d(src, w.dec_lo, w.dec_hi, levels)
                return [u for band in dets for u in band] + [a]
            chain, a = [], src
            for _ in range(levels):
                a, *det = K.fwd_level_2d(a, w.dec_lo, w.dec_hi)
                chain.extend(det)
            chain.append(a)
        else:
            a, bands = src
            B, R, C = a.shape[0], a.shape[1] << levels, a.shape[2] << levels
            call = lambda: [K.inv_tail_2d(a, bands, w.rec_lo, w.rec_hi)]
            chain = [a]
            for band in bands:
                chain = [K.inv_level_2d(chain[0], *band, w.rec_lo, w.rec_hi)]
        first = call()
        pl = K.tail_launch_plan(B, R, C, w.hlen, levels, c.name == "inv_tail_2d")
        same = all(torch.equal(g, h) for g, h in zip(first, chain))
        print(f"{c.name} at {c.label}: plan nb {pl.nb}, cs {pl.cs}, tiles (lr, lc, nph) per "
              f"level {[(p.lr, p.lc, p.nph) for p in pl.levels]}; equals the chain of its level "
              f"kernel: {same}", flush=True)
        check(same, f"{c.name} at {c.label} differs from the chain of its level kernel")
        if levels > 1:
            for _ in range(50):
                check(all(torch.equal(g, h) for g, h in zip(call(), first)),
                      f"{c.name} at {c.label}: a repeat differs from the first result")
            print(f"{c.name} at {c.label}: 50 repeats equal the first result", flush=True)


# -- the plain route: the kernels' plain versions, level by level, on the
# card, in the order the entry points run them

def plain_dwt2d(t, w, levels):
    from pdwt_tpu_torch import Coeffs2D
    from pdwt_tpu_torch.core import conv
    from pdwt_tpu_torch.kernels import separable as K

    a, dets = t[None], []
    for _ in range(levels):
        a = conv.odd_extend(conv.odd_extend(a, -1), -2)
        a, h, v, d = K.fwd_level_2d_ref(a, w.dec_lo, w.dec_hi)
        dets.append((h[0], v[0], d[0]))
    return Coeffs2D(a[0], tuple(dets))


def plain_idwt2d(c, w, shape):
    from pdwt_tpu_torch.core.shapes import level_sizes
    from pdwt_tpu_torch.kernels import separable as K

    rows, cols = level_sizes(shape[0], c.levels), level_sizes(shape[1], c.levels)
    a = c.approx[None]
    for i in range(c.levels - 1, -1, -1):
        h, v, d = (t[None] for t in c.details[i])
        a = K.inv_level_2d_ref(a, h, v, d, w.rec_lo, w.rec_hi)[:, :rows[i], :cols[i]]
    return a[0]


def plain_swt2d(t, w, levels):
    from pdwt_tpu_torch import Coeffs2D
    from pdwt_tpu_torch.kernels import swt as S

    a, dets = t[None], []
    for level in range(1, levels + 1):
        a, h, v, d = S.swt_fwd_level_2d_ref(a, w.dec_lo, w.dec_hi, level)
        dets.append((h[0], v[0], d[0]))
    return Coeffs2D(a[0], tuple(dets))


def plain_iswt2d(c, w, threshold=None):
    from pdwt_tpu_torch.kernels import swt as S

    a = c.approx[None]
    for i in range(c.levels - 1, -1, -1):
        h, v, d = (t[None] for t in c.details[i])
        a = S.swt_inv_level_2d_ref(a, h, v, d, w.rec_lo, w.rec_hi, i + 1, threshold)
    return a[0]


def plain_dwt1d(t, w, levels):
    from pdwt_tpu_torch import Coeffs1D
    from pdwt_tpu_torch.core import conv
    from pdwt_tpu_torch.kernels import batched1d as K1

    a, dets = t, []
    for _ in range(levels):
        a, d = K1.fwd_level_1d_ref(conv.odd_extend(a, -1), w.dec_lo, w.dec_hi)
        dets.append(d)
    return Coeffs1D(a, tuple(dets))


def plain_idwt1d(c, w, n):
    from pdwt_tpu_torch.core.shapes import level_sizes
    from pdwt_tpu_torch.kernels import batched1d as K1

    sizes = level_sizes(n, c.levels)
    a = c.approx
    for i in range(c.levels - 1, -1, -1):
        a = K1.inv_level_1d_ref(a, c.details[i], w.rec_lo, w.rec_hi)[:, :sizes[i]]
    return a


def plain_swt1d(t, w, levels):
    from pdwt_tpu_torch import Coeffs1D
    from pdwt_tpu_torch.kernels import batched1d as K1

    a, dets = t, []
    for level in range(1, levels + 1):
        a, d = K1.swt_fwd_level_1d_ref(a, w.dec_lo, w.dec_hi, level)
        dets.append(d)
    return Coeffs1D(a, tuple(dets))


def plain_iswt1d(c, w):
    from pdwt_tpu_torch.kernels import batched1d as K1

    a = c.approx
    for i in range(c.levels - 1, -1, -1):
        a = K1.swt_inv_level_1d_ref(a, c.details[i], w.rec_lo, w.rec_hi, i + 1)
    return a


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a CUDA card")
    from pdwt_tpu_torch import (Coeffs1D, Coeffs2D, Wavelets, dwt1d, dwt2d, get_wavelet,
                                idwt1d, idwt2d, iswt1d, iswt2d, iswt2d_denoise, ops, swt1d,
                                swt2d)
    from pdwt_tpu_torch.core import conv
    from pdwt_tpu_torch.core.shapes import level_sizes
    from pdwt_tpu_torch.filters import make_custom_wavelet
    from pdwt_tpu_torch.kernels import _build, beta_buffer
    from pdwt_tpu_torch.kernels import batched1d as K1
    from pdwt_tpu_torch.kernels import separable as K
    from pdwt_tpu_torch.kernels import swt as S
    from pdwt_tpu_torch.models import denoise_step

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path()}", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    if sys.argv[1:]:
        # a development run of one phase alone: no result line
        only = {"volume": volume_phase, "families": families_phase, "extras": extras_phase,
                "sharded": sharded_phase, "backends": backends_phase,
                "batch_cell": batch_cell_phase}
        check(len(sys.argv) == 3 and sys.argv[1] == "--only" and sys.argv[2] in only,
              "usage: chip_smoke.py [--only volume|families|extras|sharded|backends|batch_cell]")
        report = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
                         "plain_device_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                         "bound_ms": 0.0, "library_ms": 0.0} for name in REPLACES}
        only[sys.argv[2]](dev, card, report, {name: 0 for name in REPLACES},
                          torch.Generator(device=dev).manual_seed(0))
        print(f"chip_smoke: --only {sys.argv[2]} passed; a partial run prints no result",
              flush=True)
        return

    wav = get_wavelet(WNAME)
    lo, hi, rlo, rhi = wav.dec_lo, wav.dec_hi, wav.rec_lo, wav.rec_hi
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.rand(s, device=dev, generator=gen) * 255.0

    # -- shapes the main path hands each kernel (core/separable.py dispatch)
    fwd_shapes, tail = [], None
    r = N
    for lvl in range(LEVELS):
        if K.tail_supported((r, r), wav.hlen, LEVELS - lvl):
            tail = (r, LEVELS - lvl)
            break
        fwd_shapes.append(r)
        r //= 2
    check(tail is not None and fwd_shapes, f"main path dispatch {fwd_shapes}, {tail}")
    inv_shapes = [n // 2 for n in reversed(fwd_shapes)]
    tail_r, tail_k = tail

    flat = lambda a, dets: [a, *[t for band in dets for t in band]]
    m0 = tail_r >> tail_k
    h7 = wav.hlen
    # one Case for each launch of one pass
    cases = [Case("fwd_level_2d", rand(1, n, n), lambda x: K.fwd_level_2d(x, lo, hi),
                  lambda x: K.fwd_level_2d_ref(x, lo, hi), (n, n), True, flops_2d(n, n, h7),
                  library=yardstick("fwd2d", wav)) for n in fwd_shapes]
    cases += [Case("inv_level_2d", [rand(1, m, m) for _ in range(4)],
                   lambda b: K.inv_level_2d(*b, rlo, rhi),
                   lambda b: K.inv_level_2d_ref(*b, rlo, rhi), (m, m), True,
                   flops_2d(2 * m, 2 * m, h7), library=yardstick("inv2d", wav))
              for m in inv_shapes]
    cases.append(Case("fwd_tail_2d", rand(1, tail_r, tail_r),
                      lambda x: flat(*K.fwd_tail_2d(x, lo, hi, tail_k)),
                      lambda x: flat(*K.fwd_tail_2d_ref(x, lo, hi, tail_k)), (tail_r, tail_r),
                      True, sum(flops_2d(tail_r >> j, tail_r >> j, h7) for j in range(tail_k)),
                      library=tail_yardstick(wav, tail_k)))
    tail_in = (rand(1, m0, m0), [tuple(rand(1, m0 << j, m0 << j) for _ in range(3))
                                 for j in range(tail_k)])
    cases.append(Case("inv_tail_2d", tail_in, lambda t: K.inv_tail_2d(t[0], t[1], rlo, rhi),
                      lambda t: K.inv_tail_2d_ref(t[0], t[1], rlo, rhi), (m0, m0), True,
                      sum(flops_2d(m0 << (j + 1), m0 << (j + 1), h7) for j in range(tail_k)),
                      library=tail_yardstick(wav, tail_k, inverse=True)))
    # the redesigned synthesis level's code paths: every tile size, filters of
    # 2 to 128 taps (odd too), subbands smaller than a tile, a batch of 3
    odd5 = make_custom_wavelet("odd5", *np.random.default_rng(5).standard_normal((4, 5)))
    w40, w128 = (make_custom_wavelet(f"w{n}", *np.random.default_rng(n).standard_normal((4, n)))
                 for n in (40, 128))
    for w, shape in [(get_wavelet("haar"), (1, 8, 8)), (wav, (1, 8, 8)), (w128, (3, 8, 8)),
                     (wav, (3, 37, 53)), (odd5, (2, 35, 67)), (w40, (1, 70, 38)),
                     (w128, (1, 40, 70))]:
        cases.append(Case("inv_level_2d", [rand(*shape) for _ in range(4)],
                          lambda b, w=w: K.inv_level_2d(*b, w.rec_lo, w.rec_hi),
                          lambda b, w=w: K.inv_level_2d_ref(*b, w.rec_lo, w.rec_hi),
                          f"{w.name} subbands {shape}"))
    # kernel 1 on kernel 13's body at step 2 (rows first, the plain version
    # columns first): every tile size, 2 to 128 taps (odd too), 2 x 2 images
    # and odd subband sizes, a batch of 3 and one past gridDim.z (inputs from
    # a generator of their own: the later cases' inputs stay as they were)
    g1 = torch.Generator(device=dev).manual_seed(1)
    for w, shape in [(get_wavelet("haar"), (1, 2, 2)), (wav, (1, 2, 2)), (w128, (3, 16, 16)),
                     (wav, (3, 74, 106)), (odd5, (2, 70, 134)), (w40, (1, 140, 76)),
                     (w128, (1, 80, 140)), (wav, (1, 16, 16)), (get_wavelet("db2"), (70000, 2, 2))]:
        cases.append(Case("fwd_level_2d", torch.rand(shape, device=dev, generator=g1) * 255.0,
                          lambda t, w=w: K.fwd_level_2d(t, w.dec_lo, w.dec_hi),
                          lambda t, w=w: K.fwd_level_2d_ref(t, w.dec_lo, w.dec_hi),
                          f"{w.name} image {shape}"))
    # the tails 3 and 4 on the bodies of 1 and 2, one launch over a cluster:
    # 1-5 levels, 2 to 128 taps (odd too), a halo wider than the deepest
    # level (db18 at 8 rows, 128 taps on 4 x 4), a batch of 3 and one past
    # gridDim.z, the cell's tail at 4 levels (inputs from a generator of
    # their own); then each against the chain of its level kernel and, with
    # more than one level, 50 repeats
    g3 = torch.Generator(device=dev).manual_seed(3)
    tail_cases = []
    for w, shape, k in [(wav, (1, 128, 128), 1), (wav, (3, 32, 64), 3),
                        (get_wavelet("db18"), (1, 64, 128), 3),
                        (get_wavelet("haar"), (2, 16, 16), 4), (odd5, (1, 24, 40), 3),
                        (w128, (1, 16, 16), 2),
                        (get_wavelet("db2"), (70000, 4, 4), 2), (wav, (1, 160, 160), 5),
                        (wav, (1, 128, 128), 4)]:
        B, R, C = shape
        x = torch.rand(shape, device=dev, generator=g3) * 255.0
        sub = [torch.rand((B, R >> k, C >> k), device=dev, generator=g3) * 255.0]
        sub.append([tuple(torch.rand((B, R >> j, C >> j), device=dev, generator=g3) * 255.0
                          for _ in range(3)) for j in range(k, 0, -1)])
        tail_cases.append(Case("fwd_tail_2d", (x, w, k),
                               lambda t: flat(*K.fwd_tail_2d(t[0], t[1].dec_lo, t[1].dec_hi, t[2])),
                               lambda t: flat(*K.fwd_tail_2d_ref(t[0], t[1].dec_lo, t[1].dec_hi,
                                                                 t[2])),
                               f"{w.name} image {shape}, {k} levels"))
        tail_cases.append(Case("inv_tail_2d", (sub, w, k),
                               lambda t: K.inv_tail_2d(t[0][0], t[0][1], t[1].rec_lo, t[1].rec_hi),
                               lambda t: K.inv_tail_2d_ref(t[0][0], t[0][1], t[1].rec_lo,
                                                           t[1].rec_hi),
                               f"{w.name} subbands {(B, R >> k, C >> k)}, {k} levels"))
    cases += tail_cases

    # per kernel: worst error and, over the calls of one pass of its path,
    # the summed times (ms: per call by CUDA events, host launch gaps
    # included; device_ms: busy time on the card by torch.profiler), the
    # bound (bytes each read or written once at HBM_BPS, operations at the
    # peak for their type) and the PyTorch yardstick (library_ms)
    report = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
                     "plain_device_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0} for name in REPLACES}
    run_cases(cases, report, card)
    tail_checks(K, tail_cases)

    # -- main path: the facade, as a user drives it
    img = dwt_img = np.random.default_rng(0).uniform(0, 255, (N, N)).astype(np.float32)
    x = torch.from_numpy(img).to(dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    W = Wavelets(x, wname=WNAME, levels=LEVELS, device=dev)
    W.forward()
    W.soft_threshold(BETA)
    n1 = W.norm1()
    den = W.inverse()
    W2 = Wavelets(x, wname=WNAME, levels=LEVELS, device=dev)
    W2.forward()
    rt = W2.inverse()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"main path launches: {launches}", flush=True)
    for name in ("fwd_level_2d", "inv_level_2d", "fwd_tail_2d", "inv_tail_2d"):
        check(launches[name] > 0, f"the main path never launched {name}")
    check(tuple(den.shape) == (N, N) and bool(torch.isfinite(den).all()),
          "denoised image is not finite or has the wrong shape")
    rt_err = float((rt - x).abs().max())
    print(f"roundtrip max|idwt2d(dwt2d(x)) - x| = {rt_err:.3e} (limit {ROUNDTRIP_ATOL})")
    check(rt_err <= ROUNDTRIP_ATOL, "roundtrip error")

    # the plain path on the card: the kernels' plain versions, level by level
    pc = ops.soft_threshold(plain_dwt2d(x, wav, LEVELS), BETA)
    p_n1 = float(ops.norm1(pc))
    p_den = plain_idwt2d(pc, wav, (N, N))
    err, scale = max_err(den, p_den)
    print(f"denoised vs plain path: max|diff| {err:.3e} (limit {PATH_RTOL * scale:.3e}); "
          f"norm1 {n1!r} vs plain {p_n1!r}", flush=True)
    check(err <= PATH_RTOL * scale, "denoised image disagrees with the plain path")
    check(abs(n1 - p_n1) <= PATH_RTOL * abs(p_n1), "norm1 disagrees with the plain path")

    # against the repository's golden coefficients (float64 reference data)
    gold = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "golden", "golden.npz"))
    gx = torch.tensor(gold["dwt2d/db7/x"], dtype=torch.float32, device=dev)
    gl = int(gold["dwt2d/db7/levels"])
    gc = dwt2d(gx, wav, gl)
    want = [gold["dwt2d/db7/a"]] + [gold[f"dwt2d/db7/L{i}/{b}"]
                                    for i in range(1, gl + 1) for b in "hvd"]
    got = [gc.approx] + [t for band in gc.details for t in band]
    gerr = max(float(np.abs(g.cpu().numpy() - w).max()) for g, w in zip(got, want))
    gscale = max(float(np.abs(w).max()) for w in want)
    yr = idwt2d(gc, wav, tuple(gx.shape))
    rerr = float((yr - gx).abs().max())
    print(f"golden dwt2d/db7 ({tuple(gx.shape)}, {gl} levels): max err {gerr:.3e} "
          f"(limit {KERNEL_RTOL * gscale:.3e}); roundtrip {rerr:.3e}")
    check(gerr <= KERNEL_RTOL * gscale and rerr <= KERNEL_RTOL * float(gx.abs().max()),
          "golden coefficients")

    # roundtrip times, kernels and plain path, on the same card in turns
    time_in_turns(f"roundtrip {N}x{N} {WNAME} {LEVELS} levels",
                  lambda: idwt2d(dwt2d(x, wav, LEVELS), wav, (N, N)),
                  lambda: plain_idwt2d(plain_dwt2d(x, wav, LEVELS), wav, (N, N)), card)

    # ======================= the TI-denoise path =======================
    # -- each stationary kernel against its plain version.  The inverse
    # runs on the plain forward's subbands, so the hard and garrote masks
    # see the same values in both versions.  Timed: the path's own calls
    # (1024^2, levels 1-3, forward and the soft-thresholded inverse).
    thresholds = [("soft", TI_BETA), None, ("hard", TI_BETA), ("garrote", TI_BETA)]
    ti_cases = []

    def swt_cases(w, shape, level, timed):
        xl = rand(*shape)
        fl = flops_swt_2d(shape[-2], shape[-1], w.hlen) * shape[0]
        ti_cases.append(Case("swt_fwd_level_2d", xl,
                             lambda t: S.swt_fwd_level_2d(t, w.dec_lo, w.dec_hi, level),
                             lambda t: S.swt_fwd_level_2d_ref(t, w.dec_lo, w.dec_hi, level),
                             f"{w.name} {shape} level {level}", timed, fl,
                             library=yardstick("swt_fwd2d", w, level=level)))
        bands = S.swt_fwd_level_2d_ref(xl, w.dec_lo, w.dec_hi, level)
        for thr in thresholds:
            ti_cases.append(Case(
                "swt_inv_level_2d", bands,
                lambda b, thr=thr: S.swt_inv_level_2d(*b, w.rec_lo, w.rec_hi, level, thr),
                lambda b, thr=thr: S.swt_inv_level_2d_ref(*b, w.rec_lo, w.rec_hi, level, thr),
                f"{w.name} {shape} level {level} threshold {thr and thr[0]}",
                timed and thr is not None and thr[0] == "soft", fl,
                library=yardstick("swt_inv2d", w, level=level)))

    for level in range(1, TI_LEVELS + 1):
        swt_cases(wav, (1, TI_N, TI_N), level, True)
    swt_cases(wav, (1, TI_N, TI_N), 6, False)  # the facade's deepest level at 1024^2
    for level in range(1, 5):  # db2 8x16: at level 4 the support (25) exceeds 8 rows
        swt_cases(get_wavelet("db2"), (1, 8, 16), level, False)
    for level in (1, 2):
        swt_cases(wav, (1, 37, 53), level, False)
    swt_cases(wav, (3, 256, 256), 2, False)  # batch 3
    swt_cases(odd5, (1, 23, 29), 3, False)   # an odd-length custom bank
    # the redesigned inverse's code paths (kernel 14's plans in fd on float32
    # subbands): dilations 2-16 on sizes no tile divides, 2, 40 and 128 taps
    for w, shape, level in [(wav, (1, 301, 203), 2), (wav, (1, 301, 203), 3),
                            (wav, (1, 301, 203), 4), (wav, (1, 301, 203), 5),
                            (get_wavelet("haar"), (1, 64, 96), 3), (w40, (1, 200, 150), 1),
                            (w40, (1, 200, 150), 2), (w128, (1, 64, 96), 1)]:
        bands = S.swt_fwd_level_2d_ref(rand(*shape), w.dec_lo, w.dec_hi, level)
        for thr in thresholds:
            ti_cases.append(Case(
                "swt_inv_level_2d", bands,
                lambda b, w=w, lv=level, thr=thr: S.swt_inv_level_2d(*b, w.rec_lo, w.rec_hi, lv,
                                                                     thr),
                lambda b, w=w, lv=level, thr=thr: S.swt_inv_level_2d_ref(*b, w.rec_lo, w.rec_hi,
                                                                         lv, thr),
                f"{w.name} {shape} level {level} threshold {thr and thr[0]}"))
    # kernel 5 on kernel 13's body at step 1 (rows first, the plain version
    # columns first): 1 x 1 and 8 x 8 images, odd and prime sizes, 2, 3, 5,
    # 40 and 128 taps, dilations up to 4096 past the image, a batch of 3
    # (inputs from a generator of their own: the later phases' inputs stay
    # as they were)
    odd3 = make_custom_wavelet("odd3", *np.random.default_rng(3).standard_normal((4, 3)))
    g5 = torch.Generator(device=dev).manual_seed(5)
    for w, shape, level in [(get_wavelet("haar"), (1, 1, 1), 1), (wav, (1, 8, 8), 6),
                            (w128, (3, 8, 8), 1), (w40, (1, 200, 150), 2),
                            (odd3, (1, 37, 53), 4), (odd5, (3, 31, 17), 3),
                            (wav, (1, 301, 203), 5), (w128, (1, 7, 13), 13),
                            (get_wavelet("db2"), (2, 31, 17), 12)]:
        ti_cases.append(Case("swt_fwd_level_2d",
                             torch.rand(shape, device=dev, generator=g5) * 255.0,
                             lambda t, w=w, lv=level: S.swt_fwd_level_2d(t, w.dec_lo, w.dec_hi,
                                                                         lv),
                             lambda t, w=w, lv=level: S.swt_fwd_level_2d_ref(t, w.dec_lo,
                                                                             w.dec_hi, lv),
                             f"{w.name} {shape} level {level}"))
    # kernel 5's norm launches at the benchmark's TI step: levels 1-5 of a
    # 64 x 512^2 stack, each on its level's input, each mode, beta 90 from
    # a buffer on the card (as denoise_step passes it).  The bands against
    # the plain version here; the norm after the cases.  Timed: soft
    g_norm = torch.Generator(device=dev).manual_seed(11)
    fn_beta = beta_buffer(FN_BETA, dev)
    fn_x = fn_in = torch.rand((FN_BATCH, FN_N, FN_N), device=dev, generator=g_norm) * 255.0
    norm_runs = []
    for lvl in range(1, FN_LEVELS + 1):
        for fm in ("soft", "hard", "garrote"):
            parts = torch.empty(S.swt_norm_slots(*fn_in.shape, wav.hlen, lvl), device=dev)
            norm_runs.append((fn_in, lvl, fm, parts))
            ti_cases.append(Case(
                "swt_fwd_level_2d_norm", fn_in,
                lambda t, lv=lvl, m=fm, p=parts: S.swt_fwd_level_2d(
                    t, wav.dec_lo, wav.dec_hi, lv, norm=(m, fn_beta, p, lv == FN_LEVELS)),
                lambda t, lv=lvl: S.swt_fwd_level_2d_ref(t, wav.dec_lo, wav.dec_hi, lv),
                f"{wav.name} {tuple(fn_in.shape)} level {lvl} {fm} beta {FN_BETA}",
                fm == "soft", flops_swt_2d(FN_N, FN_N, wav.hlen) * FN_BATCH))
        fn_in = S.swt_fwd_level_2d_ref(fn_in, wav.dec_lo, wav.dec_hi, lvl)[0]
    del fn_in
    run_cases(ti_cases, report, card)

    # -- the norm of each norm launch: its partials' float64 sum against
    # swt_norm_partials_ref's float64 norm of the plain launch's bands, which
    # the norm launch stores bit for bit
    for t, lvl, fm, parts in norm_runs:
        fb = S.swt_fwd_level_2d(t, wav.dec_lo, wav.dec_hi, lvl)
        again = torch.empty_like(parts)
        fg = S.swt_fwd_level_2d(t, wav.dec_lo, wav.dec_hi, lvl,
                                 norm=(fm, fn_beta, again, lvl == FN_LEVELS))
        check(all(torch.equal(g, b) for g, b in zip(fg, fb)),
              f"kernel 5's norm launch at level {lvl} {fm}: bands differ from the plain launch's")
        check(torch.equal(again, parts), f"kernel 5's norm launch at level {lvl} {fm}: "
              "partials differ from call to call")
        want = torch.zeros(1, dtype=torch.float64, device=dev)
        S.swt_norm_partials_ref([b.double() for b in fb], fm, FN_BETA, want,
                                lvl == FN_LEVELS)
        got_n, want_n = float(parts.double().sum()), float(want[0])
        rel = abs(got_n - want_n) / want_n
        print(f"kernel swt_fwd_level_2d_norm at level {lvl} {fm}: partials' sum {got_n!r} vs "
              f"float64 {want_n!r}, relative {rel:.3e} (limit {FUSED_NORM_RTOL:.0e}); "
              f"{parts.numel()} partials", flush=True)
        check(rel <= FUSED_NORM_RTOL, f"kernel 5's norm at level {lvl} {fm}")
        del fb, fg
    # -- the sum of a step's partials (soft, levels 1-5) against a float64 sum
    fn_parts = torch.cat([p for _, _, m, p in norm_runs if m == "soft"])
    del norm_runs
    run_cases([Case("swt_norm_sum_2d", fn_parts, S.swt_norm_sum_2d,
                    lambda p: p.sum(dtype=torch.float64).to(torch.float32),
                    f"{fn_parts.numel()} partials of a step", True, float(fn_parts.numel()))],
              report, card)

    # -- the TI path, as a user drives it
    ti_img = np.random.default_rng(1).uniform(0, 255, (TI_N, TI_N)).astype(np.float32)
    xt = torch.from_numpy(ti_img).to(dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    T = Wavelets(xt, wname=WNAME, levels=TI_LEVELS, do_swt=True, device=dev)
    run_out, run_n1 = T.run_denoise(TI_BETA)
    T.forward()
    T.soft_threshold(TI_BETA)
    ti_n1 = T.norm1()
    ti_den = T.inverse()
    T2 = Wavelets(xt, wname=WNAME, levels=TI_LEVELS, do_swt=True, device=dev)
    T2.forward()
    ti_rt = T2.inverse()
    torch.cuda.synchronize()
    ti_launches = dict(K.LAUNCHES)
    print(f"TI path launches: {ti_launches}", flush=True)
    for name in ("swt_fwd_level_2d", "swt_inv_level_2d"):
        check(ti_launches[name] > 0, f"the TI path never launched {name}")
        launches[name] = ti_launches[name]
    for label, img in (("run_denoise", run_out), ("inverse", ti_den)):
        check(tuple(img.shape) == (TI_N, TI_N) and bool(torch.isfinite(img).all()),
              f"TI {label} image is not finite or has the wrong shape")
    rt_err = float((ti_rt - xt).abs().max())
    print(f"roundtrip max|iswt2d(swt2d(x)) - x| = {rt_err:.3e} (limit {ROUNDTRIP_ATOL})")
    check(rt_err <= ROUNDTRIP_ATOL, "SWT roundtrip error")

    pc = ops.soft_threshold(plain_swt2d(xt, wav, TI_LEVELS), TI_BETA)
    p_n1 = float(ops.norm1(pc))
    p_den = plain_iswt2d(pc, wav)
    for label, img, n1v in (("run_denoise", run_out, float(run_n1)), ("inverse", ti_den, ti_n1)):
        err, scale = max_err(img, p_den)
        print(f"TI {label} vs plain path: max|diff| {err:.3e} (limit {PATH_RTOL * scale:.3e}); "
              f"norm1 {n1v!r} vs plain {p_n1!r}", flush=True)
        check(err <= PATH_RTOL * scale, f"TI {label} disagrees with the plain path")
        check(abs(n1v - p_n1) <= PATH_RTOL * abs(p_n1), f"TI {label} norm1 disagrees")
    kc = swt2d(xt, wav, TI_LEVELS)
    fused = float(ops.thresholded_norm1(kc, TI_BETA))
    full = float(ops.norm1(ops.soft_threshold(kc, TI_BETA)))
    print(f"thresholded_norm1 {fused!r} vs norm1(soft_threshold) {full!r} "
          f"(limit {NORM_RTOL * abs(full):.3e})")
    check(abs(fused - full) <= NORM_RTOL * abs(full), "thresholded_norm1")

    # -- the 2D TI step as the benchmark's TI cell runs it: denoise_step on
    # the fused norm route (kernel 5's norm launches, the sum of their
    # partials, kernel 6 thresholding), against the plain path: the plain
    # versions level by level and a float64 thresholded_norm1
    torch.cuda.synchronize()
    K.reset_launch_counts()
    s_out, s_n1 = denoise_step(fn_x, None, wav, FN_LEVELS, FN_BETA, swt=True)
    torch.cuda.synchronize()
    step_launches = {k: v for k, v in K.LAUNCHES.items() if v}
    print(f"TI step {tuple(fn_x.shape)} launches: {step_launches}", flush=True)
    check(step_launches == {"swt_fwd_level_2d": FN_LEVELS, "swt_norm_sum_2d": 1,
                            "swt_inv_level_2d": FN_LEVELS},
          "the TI step did not take the fused norm route")
    launches["swt_fwd_level_2d_norm"] = step_launches["swt_fwd_level_2d"]
    launches["swt_norm_sum_2d"] = step_launches["swt_norm_sum_2d"]
    fa, fdets = fn_x, []
    for lvl in range(1, FN_LEVELS + 1):
        fa, *fbands = S.swt_fwd_level_2d_ref(fa, wav.dec_lo, wav.dec_hi, lvl)
        fdets.append(tuple(fbands))
    p_n1 = float(ops.thresholded_norm1(
        Coeffs2D(fa.double(), tuple(tuple(t.double() for t in b) for b in fdets)), FN_BETA))
    for i in range(FN_LEVELS - 1, -1, -1):
        fa = S.swt_inv_level_2d_ref(fa, *fdets[i], wav.rec_lo, wav.rec_hi, i + 1,
                                   ("soft", FN_BETA))
    del fdets, fbands
    err, scale = max_err(s_out, fa)
    n_rel = abs(float(s_n1) - p_n1) / p_n1
    print(f"TI step {tuple(fn_x.shape)} vs plain path: max|diff| {err:.3e} (limit "
          f"{PATH_RTOL * scale:.3e}); norm {float(s_n1)!r} vs float64 {p_n1!r}, relative "
          f"{n_rel:.3e} (limit {FUSED_NORM_RTOL:.0e})", flush=True)
    check(err <= PATH_RTOL * scale, "the TI step disagrees with the plain path")
    check(n_rel <= FUSED_NORM_RTOL, "the TI step's norm disagrees with the plain path")
    del fa, s_out

    def torch_norm_step():
        c = swt2d(fn_x, wav, FN_LEVELS)
        return iswt2d_denoise(c, wav, FN_BETA), ops.thresholded_norm1(c, FN_BETA)

    time_in_turns(f"TI step {tuple(fn_x.shape)} {WNAME} {FN_LEVELS} levels soft beta {FN_BETA}",
                  lambda: denoise_step(fn_x, None, wav, FN_LEVELS, FN_BETA, swt=True),
                  torch_norm_step, card, names=("fused norm", "torch norm"))
    del fn_x

    # -- the TI step (bench.py's ti_swt_mpix_s), kernels and plain path, in turns
    time_in_turns(f"TI step {TI_N}x{TI_N} {WNAME} {TI_LEVELS} levels soft beta {TI_BETA}",
                  lambda: iswt2d_denoise(swt2d(xt, wav, TI_LEVELS), wav, TI_BETA),
                  lambda: plain_iswt2d(plain_swt2d(xt, wav, TI_LEVELS), wav, ("soft", TI_BETA)),
                  card)

    # ======================= the batched 1D path =======================
    # -- each 1D kernel against its plain version.  The inverses run on the
    # plain forwards' bands.  Timed: the path's own calls (1024 signals;
    # decimated levels 1-4 of 4096 samples each way, stationary levels 1-4).
    w8 = get_wavelet(B1_WNAME)
    randn = lambda *s: torch.randn(s, device=dev, generator=gen)
    b1_cases = []

    def dwt1d_cases(w, x, timed):
        xe = conv.odd_extend(x, -1)
        label = f"{w.name} {tuple(xe.shape)}"
        fl = flops_1d(xe.shape[0], xe.shape[1], w.hlen)
        b1_cases.append(Case("fwd_level_1d", xe, lambda t: K1.fwd_level_1d(t, w.dec_lo, w.dec_hi),
                             lambda t: K1.fwd_level_1d_ref(t, w.dec_lo, w.dec_hi), label, timed,
                             fl, library=yardstick("fwd", w)))
        bands = K1.fwd_level_1d_ref(xe, w.dec_lo, w.dec_hi)
        b1_cases.append(Case("inv_level_1d", bands,
                             lambda b: K1.inv_level_1d(*b, w.rec_lo, w.rec_hi),
                             lambda b: K1.inv_level_1d_ref(*b, w.rec_lo, w.rec_hi),
                             f"{w.name} bands {tuple(bands[0].shape)}", timed, fl,
                             library=yardstick("inv", w)))
        return bands[0]

    def swt1d_cases(w, x, levels, timed):
        fl = flops_1d(x.shape[0], x.shape[1], w.hlen, swt=True)
        for level in levels:
            b1_cases.append(Case("swt_fwd_level_1d", x,
                                 lambda t, lv=level: K1.swt_fwd_level_1d(t, w.dec_lo, w.dec_hi,
                                                                         lv),
                                 lambda t, lv=level: K1.swt_fwd_level_1d_ref(t, w.dec_lo,
                                                                             w.dec_hi, lv),
                                 f"{w.name} {tuple(x.shape)} level {level}", timed, fl,
                                 library=yardstick("swt_fwd", w, level=level)))
            bands = K1.swt_fwd_level_1d_ref(x, w.dec_lo, w.dec_hi, level)
            b1_cases.append(Case("swt_inv_level_1d", bands,
                                 lambda b, lv=level: K1.swt_inv_level_1d(*b, w.rec_lo, w.rec_hi,
                                                                         lv),
                                 lambda b, lv=level: K1.swt_inv_level_1d_ref(*b, w.rec_lo,
                                                                             w.rec_hi, lv),
                                 f"{w.name} {tuple(x.shape)} level {level}", timed, fl,
                                 library=yardstick("swt_inv", w, level=level)))

    xa = randn(B1_SIGNALS, B1_N)
    for _ in range(B1_LEVELS):  # the shapes dwt1d hands each level
        xa = dwt1d_cases(w8, xa, True)
    swt1d_cases(w8, randn(B1_SIGNALS, B1_N), range(1, B1_LEVELS + 1), True)
    for w, shape, levels in [(w8, (3, 1023), (1, 2)),          # odd length
                             (w8, (2, 10), (1, 3)),            # shorter than the support
                             (get_wavelet("db2"), (4, 8), (1, 2, 3, 4)),  # dilation 8 > 8 samples
                             (w8, (1, 1 << 22), (1, 4)),       # one long signal
                             (w8, (70000, 64), (1, 4)),        # more signals than gridDim.y
                             (get_wavelet("haar"), (5, 64), (1, 4)),
                             (odd5, (3, 29), (1, 3))]:         # an odd-length bank
        x1 = randn(*shape)
        dwt1d_cases(w, x1, False)
        swt1d_cases(w, x1, levels, False)
    # kernel 10 on kernel 16's a-trous body: 3 (odd), 64 and 128 taps,
    # dilations past the signal, 1 and 7 samples, a batch of 33 (inputs from
    # a generator of their own: the later phases' inputs stay as they were)
    w64 = make_custom_wavelet("w64", *np.random.default_rng(64).standard_normal((4, 64)))
    g10 = torch.Generator(device=dev).manual_seed(10)
    for w, shape, levels in [(odd3, (33, 7), (1, 4)), (w64, (2, 300), (1, 3)),
                             (w128, (3, 90), (1, 2)), (w128, (1, 7), (13,)),
                             (get_wavelet("db2"), (33, 1), (1, 3)), (w64, (33, 100), (8,))]:
        bands = [torch.randn(shape, device=dev, generator=g10) for _ in range(2)]
        for level in levels:
            b1_cases.append(Case("swt_inv_level_1d", bands,
                                 lambda b, w=w, lv=level: K1.swt_inv_level_1d(*b, w.rec_lo,
                                                                              w.rec_hi, lv),
                                 lambda b, w=w, lv=level: K1.swt_inv_level_1d_ref(*b, w.rec_lo,
                                                                                  w.rec_hi, lv),
                                 f"{w.name} bands {shape} level {level}"))
    # kernel 9 on kernel 15's a-trous body: the same taps, lengths, batches
    # and dilations (inputs from a generator of their own)
    g9 = torch.Generator(device=dev).manual_seed(9)
    for w, shape, levels in [(odd3, (33, 7), (1, 4)), (w64, (2, 300), (1, 3)),
                             (w128, (3, 90), (1, 2)), (w128, (1, 7), (13,)),
                             (get_wavelet("db2"), (33, 1), (1, 3)), (w64, (33, 100), (8,))]:
        x9 = torch.randn(shape, device=dev, generator=g9)
        for level in levels:
            b1_cases.append(Case("swt_fwd_level_1d", x9,
                                 lambda t, w=w, lv=level: K1.swt_fwd_level_1d(t, w.dec_lo,
                                                                              w.dec_hi, lv),
                                 lambda t, w=w, lv=level: K1.swt_fwd_level_1d_ref(t, w.dec_lo,
                                                                                  w.dec_hi, lv),
                                 f"{w.name} {shape} level {level}"))
    # kernel 8 on kernel 16's polyphase body: 2, 3, 5, 16, 64 and 128 taps,
    # bands of 1 and 7 samples, a batch of 33, the cell's deepest level
    g8 = torch.Generator(device=dev).manual_seed(8)
    for w, shape in [(odd3, (33, 7)), (w64, (2, 300)), (w128, (3, 90)), (w128, (1, 7)),
                     (get_wavelet("db2"), (33, 1)), (get_wavelet("haar"), (5, 1)),
                     (odd5, (3, 15)), (w8, (1024, 256))]:
        bands = [torch.randn(shape, device=dev, generator=g8) for _ in range(2)]
        b1_cases.append(Case("inv_level_1d", bands,
                             lambda b, w=w: K1.inv_level_1d(*b, w.rec_lo, w.rec_hi),
                             lambda b, w=w: K1.inv_level_1d_ref(*b, w.rec_lo, w.rec_hi),
                             f"{w.name} bands {shape}"))
    # kernel 7 on kernel 15's decimated body: 2, 3, 5, 64 and 128 taps,
    # signals of 2 and 14 samples, a batch of 33, the cell's deepest level
    g7 = torch.Generator(device=dev).manual_seed(7)
    for w, shape in [(odd3, (33, 14)), (w64, (2, 300)), (w128, (3, 90)), (w128, (1, 14)),
                     (get_wavelet("db2"), (33, 2)), (get_wavelet("haar"), (5, 2)),
                     (odd5, (3, 30)), (w8, (1024, 512))]:
        b1_cases.append(Case("fwd_level_1d", torch.randn(shape, device=dev, generator=g7),
                             lambda t, w=w: K1.fwd_level_1d(t, w.dec_lo, w.dec_hi),
                             lambda t, w=w: K1.fwd_level_1d_ref(t, w.dec_lo, w.dec_hi),
                             f"{w.name} {shape}"))
    run_cases(b1_cases, report, card)

    # -- the batched 1D path, as a user drives it: the batch and one signal,
    # decimated and stationary, step by step and through run_denoise
    sig = np.random.default_rng(2).standard_normal((B1_SIGNALS, B1_N)).astype(np.float32)
    xs = torch.from_numpy(sig).to(dev)
    rt_sig = np.random.default_rng(3).uniform(0, 255, (B1_SIGNALS, B1_N)).astype(np.float32)
    xr = torch.from_numpy(rt_sig).to(dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    b1_out = {}
    for swt in (False, True):
        for label, data in (("batch", xs), ("one signal", sig[0])):
            D = Wavelets(data, wname=B1_WNAME, levels=B1_LEVELS, ndim=1, do_swt=swt, device=dev)
            D.forward()
            D.soft_threshold(B1_BETA)
            n1 = D.norm1()
            den = D.inverse()
            run, run_n1 = Wavelets(data, wname=B1_WNAME, levels=B1_LEVELS, ndim=1,
                                   do_swt=swt, device=dev).run_denoise(B1_BETA)
            b1_out[swt, label] = (den, n1, run, float(run_n1))
        R = Wavelets(xr, wname=B1_WNAME, levels=B1_LEVELS, ndim=1, do_swt=swt, device=dev)
        R.forward()
        b1_out[swt, "roundtrip"] = R.inverse()
    torch.cuda.synchronize()
    b1_launches = dict(K.LAUNCHES)
    print(f"batched 1D path launches: {b1_launches}", flush=True)
    for name in ("fwd_level_1d", "inv_level_1d", "swt_fwd_level_1d", "swt_inv_level_1d"):
        check(b1_launches[name] > 0, f"the batched 1D path never launched {name}")
        launches[name] = b1_launches[name]

    p_fwd1 = {False: lambda t: plain_dwt1d(t, w8, B1_LEVELS),
              True: lambda t: plain_swt1d(t, w8, B1_LEVELS)}
    p_inv1 = {False: lambda c: plain_idwt1d(c, w8, B1_N), True: lambda c: plain_iswt1d(c, w8)}
    for swt in (False, True):
        kind = "SWT" if swt else "DWT"
        pc = ops.soft_threshold(p_fwd1[swt](xs), B1_BETA)
        p_n1 = float(ops.norm1(pc))
        p_den = p_inv1[swt](pc)
        for label in ("batch", "one signal"):
            den, n1, run, run_n1 = b1_out[swt, label]
            want = p_den if label == "batch" else p_den[:1]
            w_n1 = p_n1 if label == "batch" else float(ops.norm1(ops.soft_threshold(
                p_fwd1[swt](xs[:1]), B1_BETA)))
            for how, img, n1v in (("inverse", den, n1), ("run_denoise", run, run_n1)):
                check(tuple(img.shape) == tuple(want.shape) and bool(torch.isfinite(img).all()),
                      f"1D {kind} {label} {how}: not finite or the wrong shape")
                err, scale = max_err(img, want)
                print(f"1D {kind} {label} {how} vs plain path: max|diff| {err:.3e} "
                      f"(limit {PATH_RTOL * scale:.3e}); norm1 {n1v!r} vs plain {w_n1!r}",
                      flush=True)
                check(err <= PATH_RTOL * scale, f"1D {kind} {label} {how} disagrees with the "
                      "plain path")
                check(abs(n1v - w_n1) <= PATH_RTOL * abs(w_n1), f"1D {kind} {label} {how} norm1")
        rt_err = float((b1_out[swt, "roundtrip"] - xr).abs().max())
        print(f"1D {kind} roundtrip max|inverse(forward(x)) - x| = {rt_err:.3e} "
              f"(limit {ROUNDTRIP_ATOL})")
        check(rt_err <= ROUNDTRIP_ATOL, f"1D {kind} roundtrip error")

    # against the repository's golden 1D coefficients (float64 reference data)
    for key in ("dwt1d/sym4", "dwt1d/db2", "dwt1d/db5", "swt1d/db2"):
        kind, gname = key.split("/")
        gw = get_wavelet(gname)
        gx = torch.tensor(gold[f"{key}/x"], dtype=torch.float32, device=dev)
        gl = int(gold[f"{key}/levels"]) if kind == "dwt1d" else 2
        gc = (dwt1d if kind == "dwt1d" else swt1d)(gx, gw, gl)
        want = [gold[f"{key}/a"]] + [gold[f"{key}/L{i}/d"] for i in range(1, gl + 1)]
        gerr = max(float(np.abs(g.cpu().numpy() - w).max())
                   for g, w in zip([gc.approx, *gc.details], want))
        gscale = max(float(np.abs(w).max()) for w in want)
        yr = idwt1d(gc, gw, gx.shape[-1]) if kind == "dwt1d" else iswt1d(gc, gw)
        rerr = float((yr - gx).abs().max())
        print(f"golden {key} ({tuple(gx.shape)}, {gl} levels): max err {gerr:.3e} "
              f"(limit {KERNEL_RTOL * gscale:.3e}); roundtrip {rerr:.3e}")
        check(gerr <= KERNEL_RTOL * gscale and rerr <= KERNEL_RTOL * float(gx.abs().max()),
              f"golden {key}")

    # -- the batched 1D denoise step (bench_all.py:91-95), kernels and plain
    # path, in turns
    def b1_step(fwd, inv):
        c = ops.soft_threshold(fwd(xs), B1_BETA)
        ops.norm1(c)
        return inv(c)

    time_in_turns(f"batched 1D step {B1_SIGNALS}x{B1_N} {B1_WNAME} {B1_LEVELS} levels soft "
                  f"beta {B1_BETA}",
                  lambda: b1_step(lambda t: dwt1d(t, w8, B1_LEVELS),
                                  lambda c: idwt1d(c, w8, B1_N)),
                  lambda: b1_step(p_fwd1[False], p_inv1[False]), card)

    precision_phase(dev, card, report, launches, x, dwt_img, xr, rt_sig, gen)
    ti_tier_phase(dev, card, report, launches, ti_img, gen)
    ns_phase(dev, card, report, launches, dwt_img, ti_img, gen)
    operators_phase(dev, card, dwt_img, ti_img, sig)
    modes_phase(dev, card, report, launches, dwt_img, rt_sig, gen)
    sharded_phase(dev, card, report, launches, gen)
    volume_phase(dev, card, report, launches, gen)
    families_phase(dev, card, report, launches, gen)
    extras_phase(dev, card, report, launches, gen)
    backends_phase(dev, card, report, launches, gen)
    batch_cell_phase(dev, card, report, launches, gen)

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": report[name]["max_abs_err"], "ms": report[name]["ms"],
                "plain_ms": report[name]["plain_ms"], "bound_ms": report[name]["bound_ms"],
                "bound_by": ("bytes" if report[name]["bytes_ms"] >= report[name]["ops_ms"]
                             else "operations"),
                "library_ms": report[name]["library_ms"] or None,
                "device_ms": report[name]["device_ms"],
                "plain_device_ms": report[name]["plain_device_ms"]}
               for name in REPLACES]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def batch_cell_phase(dev, card, report, launches, gen) -> None:
    """The benchmark's batched 1D cell: kernels 7 and 8 on the shapes
    ``dwt1d`` and ``idwt1d`` hand each level of BC_SIGNALS x B1_N signals
    (the inverses on the plain forwards' bands) against their plain
    versions, timed into the rows ``fwd_level_1d_cell`` and
    ``inv_level_1d_cell``, and kernel 7's norm launches on the same inputs,
    timed into ``fwd_level_1d_norm_cell``: their low band bit for bit the
    plain launch's, their high band the plain launch's thresholded by the
    threshold ops, their partials' sum against a float64 norm.  Then
    ``Wavelets(ndim=1).run_denoise`` at that size as the cell calls it, its
    launches counted from zero (kernel 7's norm launches, the sum of their
    partials, kernel 8), held bit for bit to the kernels with the torch
    threshold and ``norm1`` (the norm within FUSED_1D_NORM_RTOL), to the plain
    levels, and timed beside the torch threshold route.  The three rows'
    launches are that call's: kernel 7's plain launch reads 0 there, as the
    step takes its norm launches."""
    from pdwt_tpu_torch import Wavelets, dwt1d, get_wavelet, idwt1d, ops
    from pdwt_tpu_torch.core import conv
    from pdwt_tpu_torch.kernels import batched1d as K1
    from pdwt_tpu_torch.kernels import beta_buffer
    from pdwt_tpu_torch.kernels import separable as K
    from pdwt_tpu_torch.kernels import swt as S

    w = get_wavelet(B1_WNAME)
    x = torch.randn((BC_SIGNALS, B1_N), device=dev, generator=gen)
    beta = beta_buffer(B1_BETA, dev)
    soft = ops.THR_ELEM["soft"]
    cases, norm_runs, a = [], [], x
    for lvl in range(1, B1_LEVELS + 1):
        xe = conv.odd_extend(a, -1)
        fl = flops_1d(BC_SIGNALS, xe.shape[1], w.hlen)
        cases.append(Case("fwd_level_1d_cell", xe,
                          lambda t: K1.fwd_level_1d(t, w.dec_lo, w.dec_hi),
                          lambda t: K1.fwd_level_1d_ref(t, w.dec_lo, w.dec_hi),
                          f"{w.name} {tuple(xe.shape)} level {lvl}", True, fl))
        norm_runs.append((xe, lvl))
        cases.append(Case(
            "fwd_level_1d_norm_cell", xe,
            lambda t: K1.fwd_level_1d_norm(t, w.dec_lo, w.dec_hi, norm=("soft", beta))[:2],
            lambda t: (lambda lo, hi: (lo, soft(hi, B1_BETA)))(
                *K1.fwd_level_1d_ref(t, w.dec_lo, w.dec_hi)),
            f"{w.name} {tuple(xe.shape)} level {lvl} soft beta {B1_BETA}", True, fl))
        bands = K1.fwd_level_1d_ref(xe, w.dec_lo, w.dec_hi)
        cases.append(Case("inv_level_1d_cell", bands,
                          lambda b: K1.inv_level_1d(*b, w.rec_lo, w.rec_hi),
                          lambda b: K1.inv_level_1d_ref(*b, w.rec_lo, w.rec_hi),
                          f"{w.name} bands {tuple(bands[0].shape)} level {lvl}", True, fl))
        a = bands[0]
    run_cases(cases, report, card)
    del cases, a, bands

    # -- each norm launch against the plain launch on the card: the low band
    # bit for bit, the high band thresholded by the threshold ops bit for
    # bit, the partials the same every call, their sum against float64
    for xe, lvl in norm_runs:
        plo, phi = K1.fwd_level_1d(xe, w.dec_lo, w.dec_hi)
        nlo, nhi, parts = K1.fwd_level_1d_norm(xe, w.dec_lo, w.dec_hi, norm=("soft", beta))
        again = K1.fwd_level_1d_norm(xe, w.dec_lo, w.dec_hi, norm=("soft", beta))[2]
        tag = f"kernel 7's norm launch at {tuple(xe.shape)} level {lvl}"
        check(torch.equal(nlo, plo), f"{tag}: the low band differs from the plain launch's")
        check(torch.equal(nhi, soft(phi, B1_BETA)),
              f"{tag}: the high band differs from the plain launch's, thresholded")
        check(torch.equal(again, parts), f"{tag}: partials differ from call to call")
        want_n = float(soft(phi.double(), B1_BETA).abs().sum())
        got_n = float(parts.double().sum())
        rel = abs(got_n - want_n) / want_n
        print(f"kernel fwd_level_1d_norm_cell at level {lvl}: partials' sum {got_n!r} vs "
              f"float64 {want_n!r}, relative {rel:.3e} (limit {FUSED_1D_NORM_RTOL:.0e}); "
              f"{parts.numel()} partials", flush=True)
        check(rel <= FUSED_1D_NORM_RTOL, f"{tag}: the norm")
        del plo, phi, nlo, nhi, parts, again
    del norm_runs, xe

    W = Wavelets(nr=BC_SIGNALS, nc=B1_N, wname=B1_WNAME, levels=B1_LEVELS, ndim=1, device=dev)
    W.set_image(x)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out, n1 = W.run_denoise(B1_BETA)
    torch.cuda.synchronize()
    step = {k: v for k, v in K.LAUNCHES.items() if v}
    label = f"batched 1D step {BC_SIGNALS}x{B1_N} {B1_WNAME} {B1_LEVELS} levels soft beta {B1_BETA}"
    print(f"{label} launches: {step}", flush=True)
    check(step == {"fwd_level_1d_norm": B1_LEVELS, "swt_norm_sum_2d": 1,
                   "inv_level_1d": B1_LEVELS},
          f"{label}: run_denoise did not take kernel 7's norm launches {B1_LEVELS} times, one "
          f"sum of their partials and kernel 8 {B1_LEVELS} times")
    launches["fwd_level_1d_cell"] = step.get("fwd_level_1d", 0)
    launches["fwd_level_1d_norm_cell"] = step["fwd_level_1d_norm"]
    launches["inv_level_1d_cell"] = step["inv_level_1d"]

    def torch_threshold_step():
        c = ops.soft_threshold(dwt1d(x, w, B1_LEVELS), B1_BETA)
        return idwt1d(c, w, B1_N), ops.norm1(c)

    t_out, t_n1 = torch_threshold_step()
    n_rel = abs(float(n1) - float(t_n1)) / float(t_n1)
    print(f"{label} run_denoise vs the kernels with the torch threshold: equal bits "
          f"{torch.equal(out, t_out)}; norm1 {float(n1)!r} vs {float(t_n1)!r}, relative "
          f"{n_rel:.3e} (limit {FUSED_1D_NORM_RTOL:.0e})", flush=True)
    check(torch.equal(out, t_out), f"{label}: run_denoise differs from the kernels with the "
          "torch threshold")
    check(n_rel <= FUSED_1D_NORM_RTOL, f"{label}: run_denoise norm1 disagrees with norm1")
    del t_out

    def plain_step():
        c = ops.soft_threshold(plain_dwt1d(x, w, B1_LEVELS), B1_BETA)
        return plain_idwt1d(c, w, B1_N), ops.norm1(c)

    p_out, p_n1 = plain_step()
    err, scale = max_err(out, p_out)
    print(f"{label} run_denoise vs plain path: max|diff| {err:.3e} (limit "
          f"{PATH_RTOL * scale:.3e}); norm1 {float(n1)!r} vs plain {float(p_n1)!r}", flush=True)
    check(tuple(out.shape) == (BC_SIGNALS, B1_N) and bool(torch.isfinite(out).all()),
          f"{label}: run_denoise output not finite or the wrong shape")
    check(err <= PATH_RTOL * scale, f"{label}: run_denoise disagrees with the plain path")
    check(abs(float(n1) - float(p_n1)) <= PATH_RTOL * abs(float(p_n1)),
          f"{label}: run_denoise norm1 disagrees with the plain path")
    del out, p_out
    time_in_turns(label, lambda: W.run_denoise(B1_BETA), torch_threshold_step, card,
                  names=("fused threshold", "torch threshold"))


def precision_phase(dev, card, report, launches, x, img, xr, rt_sig, gen) -> None:
    """The precision tiers on the DWT path's image and the batched 1D path's
    signals: (a) each banded-product kernel against its plain version in
    every scheme the tiers route there, and off the route rule; (b) the 2D
    and (c) the 1D transforms through the facade and the functions with
    ``precision=``; (d) each tier's roundtrip times beside the exact one's."""
    from pdwt_tpu_torch import (Wavelets, dwt1d, dwt2d, get_wavelet, idwt1d, idwt2d, iswt1d,
                                swt1d)
    from pdwt_tpu_torch.core.separable import Coeffs1D, Coeffs2D
    from pdwt_tpu_torch.core.shapes import level_sizes
    from pdwt_tpu_torch.filters import make_custom_wavelet
    from pdwt_tpu_torch.kernels import batched1d as K1
    from pdwt_tpu_torch.kernels import matmul as M
    from pdwt_tpu_torch.kernels import mxu1d as M1
    from pdwt_tpu_torch.kernels import separable as K

    f32, bf16 = torch.float32, torch.bfloat16
    wav, w8 = get_wavelet(WNAME), get_wavelet(B1_WNAME)
    lo, hi, rlo, rhi = wav.dec_lo, wav.dec_hi, wav.rec_lo, wav.rec_hi
    rand = lambda *s: torch.rand(s, device=dev, generator=gen) * 255.0
    randn = lambda *s: torch.randn(s, device=dev, generator=gen)

    def fwd_schemes(tier, levels):
        """(scheme, input dtype, detail dtype) of each forward level."""
        det = f32 if tier == "mixed" else bf16
        first = L1_SCHEMES[tier][0]
        return [(first if lvl == 0 else "b3", bf16 if lvl == 0 and det == bf16 else f32, det)
                for lvl in range(levels)]

    def inv_schemes(tier, levels):
        """(scheme, detail dtype, output dtype) of each inverse level, level 1 first."""
        det = f32 if tier == "mixed" else bf16
        return [(L1_SCHEMES[tier][1] if i == 0 else "b3", det,
                 bf16 if i == 0 and det == bf16 else f32) for i in range(levels)]

    # ---------------- (a) each kernel against its plain version ----------------
    cases, seen = [], set()

    def add(case, key):
        """Add a case once; a tier that reaches the same call again only
        makes it count for its row."""
        if key in seen:
            return
        seen.add(key)
        cases.append(case)

    h7, h8 = wav.hlen, w8.hlen
    lib_f2, lib_i2 = yardstick("fwd2d", wav, bf16), yardstick("inv2d", wav, bf16)
    for tier in TIERS:
        row = tier == ROW_TIER
        # 2D: forward levels 1-4 (level 5 runs the exact tail), inverse 4..1
        n = N
        for lvl, (sch, in_dt, det) in enumerate(fwd_schemes(tier, LEVELS - 1)):
            xin = rand(1, n, n).to(in_dt)
            add(Case("fwd_level_2d_mxu", xin,
                     lambda t, s=sch, d=det: M.fwd_level_2d_mxu(t, lo, hi, s, (f32, d)),
                     lambda t, s=sch, d=det: M.fwd_level_2d_mxu_ref(t, lo, hi, s, (f32, d)),
                     f"{tier} level {lvl + 1} {sch} {in_dt} in, {det} details, {(n, n)}", True,
                     flops_2d(n, n, h7, TERMS[sch]), scheme_peak(sch), scheme_limit(sch),
                     lib_f2 if row else None, row),
                (tier if row else "", "f", lvl, sch, in_dt, det))
            n //= 2
        for i, (sch, det, out) in enumerate(inv_schemes(tier, LEVELS - 1)):
            m = N >> (i + 1)
            bands = [rand(1, m, m)] + [(rand(1, m, m) - 127.5).to(det) for _ in range(3)]
            add(Case("inv_level_2d_mxu", bands,
                     lambda b, s=sch, o=out: M.inv_level_2d_mxu(*b, rlo, rhi, s, o),
                     lambda b, s=sch, o=out: M.inv_level_2d_mxu_ref(*b, rlo, rhi, s, o),
                     f"{tier} level {i + 1} {sch} {det} details, {out} out, subbands {(m, m)}",
                     True, flops_2d(2 * m, 2 * m, h7, TERMS[sch]), scheme_peak(sch),
                     scheme_limit(sch), lib_i2 if row else None, row),
                (tier if row else "", "i", i, sch, det, out))
        # batched 1D, decimated: levels 1-4 each way
        n = B1_N
        for lvl, (sch, in_dt, det) in enumerate(fwd_schemes(tier, B1_LEVELS)):
            add(Case("fwd_level_1d_mxu", randn(B1_SIGNALS, n).to(in_dt),
                     lambda t, s=sch, d=det: M1.fwd_level_1d_mxu(t, w8.dec_lo, w8.dec_hi, s, d),
                     lambda t, s=sch, d=det: M1.fwd_level_1d_mxu_ref(t, w8.dec_lo, w8.dec_hi, s,
                                                                      d),
                     f"{tier} level {lvl + 1} {sch} {in_dt} in, {det} hi, {(B1_SIGNALS, n)}",
                     True, flops_1d(B1_SIGNALS, n, h8, TERMS[sch]), scheme_peak(sch),
                     scheme_limit(sch), yardstick("fwd", w8, bf16) if row else None, row),
                (tier if row else "", "f1", lvl, sch, in_dt, det))
            n //= 2
        for i, (sch, det, out) in enumerate(inv_schemes(tier, B1_LEVELS)):
            m = B1_N >> (i + 1)
            add(Case("inv_level_1d_mxu", [randn(B1_SIGNALS, m), randn(B1_SIGNALS, m).to(det)],
                     lambda b, s=sch, o=out: M1.inv_level_1d_mxu(*b, w8.rec_lo, w8.rec_hi, s, o),
                     lambda b, s=sch, o=out: M1.inv_level_1d_mxu_ref(*b, w8.rec_lo, w8.rec_hi, s,
                                                                      o),
                     f"{tier} level {i + 1} {sch} {det} hi, {out} out, bands {(B1_SIGNALS, m)}",
                     True, flops_1d(B1_SIGNALS, 2 * m, h8, TERMS[sch]), scheme_peak(sch),
                     scheme_limit(sch), yardstick("inv", w8, bf16) if row else None, row),
                (tier if row else "", "i1", i, sch, det, out))
        if tier == "mixed":
            continue  # mixed runs the a-trous levels on the exact kernels
        # batched 1D, a-trous: levels 1-4 each way, full length
        for lvl in range(1, B1_LEVELS + 1):
            sch = SWT_SCHEMES[tier][0 if lvl == 1 else 1]
            in_dt = bf16 if lvl == 1 else f32
            add(Case("swt_fwd_level_1d_mxu", randn(B1_SIGNALS, B1_N).to(in_dt),
                     lambda t, s=sch, lv=lvl: M1.swt_fwd_level_1d_mxu(t, w8.dec_lo, w8.dec_hi,
                                                                       lv, s, bf16),
                     lambda t, s=sch, lv=lvl: M1.swt_fwd_level_1d_mxu_ref(t, w8.dec_lo,
                                                                           w8.dec_hi, lv, s,
                                                                           bf16),
                     f"{tier} level {lvl} {sch} {in_dt} in, bf16 hi, {(B1_SIGNALS, B1_N)}", True,
                     flops_1d(B1_SIGNALS, B1_N, h8, TERMS[sch], swt=True), scheme_peak(sch),
                     scheme_limit(sch),
                     yardstick("swt_fwd", w8, bf16, lvl) if row else None, row),
                (tier if row else "", "sf", lvl, sch, in_dt))
            out = bf16 if lvl == 1 else f32
            add(Case("swt_inv_level_1d_mxu",
                     [randn(B1_SIGNALS, B1_N), randn(B1_SIGNALS, B1_N).to(bf16)],
                     lambda b, lv=lvl, o=out: M1.swt_inv_level_1d_mxu(*b, w8.rec_lo, w8.rec_hi,
                                                                       lv, "fd", o),
                     lambda b, lv=lvl, o=out: M1.swt_inv_level_1d_mxu_ref(*b, w8.rec_lo,
                                                                           w8.rec_hi, lv, "fd",
                                                                           o),
                     f"{tier} level {lvl} fd bf16 hi, {out} out, {(B1_SIGNALS, B1_N)}", True,
                     flops_1d(B1_SIGNALS, B1_N, h8, 1, swt=True), FP32_PEAK, scheme_limit("fd"),
                     yardstick("swt_inv", w8, bf16, lvl) if row else None, row),
                (tier if row else "", "si", lvl, out))
    # off the route rule: sizes no TPU tile divides, a batch of 3, b2d, an
    # odd filter, a dilation longer than the signal
    for sch in M.SCHEMES:
        for shape, in_dt in (((3, 70, 134), bf16), ((1, 250, 198), f32)):
            xin = rand(*shape).to(in_dt)
            cases.append(Case("fwd_level_2d_mxu", xin,
                              lambda t, s=sch: M.fwd_level_2d_mxu(t, lo, hi, s, (f32, bf16)),
                              lambda t, s=sch: M.fwd_level_2d_mxu_ref(t, lo, hi, s, (f32, bf16)),
                              f"{sch} {in_dt} in, {shape}", limit=scheme_limit(sch)))
            m = (shape[1] // 2, shape[2] // 2)
            bands = [rand(shape[0], *m)] + [(rand(shape[0], *m) - 127.5).to(in_dt)
                                            for _ in range(3)]
            cases.append(Case("inv_level_2d_mxu", bands,
                              lambda b, s=sch: M.inv_level_2d_mxu(*b, rlo, rhi, s, f32),
                              lambda b, s=sch: M.inv_level_2d_mxu_ref(*b, rlo, rhi, s, f32),
                              f"{sch} {in_dt} details, subbands {(shape[0], *m)}",
                              limit=scheme_limit(sch)))
        # (2, 5000) at level 12: one residue class of a dilation of 2048
        for w, (b, n), lvl in ((w8, (3, 202), 3), (get_wavelet("db3"), (5, 1000), 2),
                               (get_wavelet("db2"), (2, 6), 4), (w8, (2, 5000), 12)):
            xin = randn(b, n).to(bf16)
            cases.append(Case("fwd_level_1d_mxu", xin,
                              lambda t, s=sch, w=w: M1.fwd_level_1d_mxu(t, w.dec_lo, w.dec_hi,
                                                                         s, bf16),
                              lambda t, s=sch, w=w: M1.fwd_level_1d_mxu_ref(t, w.dec_lo,
                                                                             w.dec_hi, s, bf16),
                              f"{w.name} {sch} {(b, n)}", limit=scheme_limit(sch)))
            cases.append(Case("swt_fwd_level_1d_mxu", xin,
                              lambda t, s=sch, w=w, lv=lvl: M1.swt_fwd_level_1d_mxu(
                                  t, w.dec_lo, w.dec_hi, lv, s, f32),
                              lambda t, s=sch, w=w, lv=lvl: M1.swt_fwd_level_1d_mxu_ref(
                                  t, w.dec_lo, w.dec_hi, lv, s, f32),
                              f"{w.name} {sch} {(b, n)} level {lvl}", limit=scheme_limit(sch)))
            bands = [randn(b, n // 2), randn(b, n // 2).to(bf16)]
            cases.append(Case("inv_level_1d_mxu", bands,
                              lambda u, s=sch, w=w: M1.inv_level_1d_mxu(*u, w.rec_lo, w.rec_hi,
                                                                         s, bf16),
                              lambda u, s=sch, w=w: M1.inv_level_1d_mxu_ref(*u, w.rec_lo,
                                                                             w.rec_hi, s, bf16),
                              f"{w.name} {sch} bands {(b, n // 2)}", limit=scheme_limit(sch)))
            sbands = [randn(b, n), randn(b, n)]
            cases.append(Case("swt_inv_level_1d_mxu", sbands,
                              lambda u, s=sch, w=w, lv=lvl: M1.swt_inv_level_1d_mxu(
                                  *u, w.rec_lo, w.rec_hi, lv, s, f32),
                              lambda u, s=sch, w=w, lv=lvl: M1.swt_inv_level_1d_mxu_ref(
                                  *u, w.rec_lo, w.rec_hi, lv, s, f32),
                              f"{w.name} {sch} {(b, n)} level {lvl}", limit=scheme_limit(sch)))
    # kernel 16's launch plans: the deep levels' short tiles, dilations 2-16
    # on lengths no tile divides, a batch of 3, 2 and 128 taps (the (2, 5000)
    # shape at level 12 above takes one residue class of a dilation past the
    # signal)
    # (inputs from a generator of their own: the later phases' inputs stay
    # as they were before these cases were added)
    w128 = make_custom_wavelet("w128", *np.random.default_rng(128).standard_normal((4, 128)))
    haar = get_wavelet("haar")
    g16 = torch.Generator(device=dev).manual_seed(16)
    for w, (b, m), lvl, sch, hdt, out in [
            (w8, (1024, 256), None, "b3", bf16, f32), (w8, (64, 128), None, "b2f", bf16, bf16),
            (w8, (3, 101), 2, "b3", bf16, f32), (w8, (3, 101), 3, "b1", f32, bf16),
            (w8, (35, 777), 4, "b2d", bf16, f32), (w8, (35, 777), 5, "fd", bf16, f32),
            (haar, (3, 77), None, "b3", f32, f32), (haar, (40, 300), 4, "b2f", bf16, f32),
            (w128, (3, 90), None, "b2f", bf16, f32), (w128, (2, 300), 2, "fd", f32, bf16)]:
        bands = [torch.randn((b, m), device=dev, generator=g16),
                 torch.randn((b, m), device=dev, generator=g16).to(hdt)]
        label = f"{w.name} {sch} {hdt} hi, {out} out, bands {(b, m)}"
        if lvl is None:
            cases.append(Case(
                "inv_level_1d_mxu", bands,
                lambda u, w=w, s=sch, o=out: M1.inv_level_1d_mxu(*u, w.rec_lo, w.rec_hi, s, o),
                lambda u, w=w, s=sch, o=out: M1.inv_level_1d_mxu_ref(*u, w.rec_lo, w.rec_hi, s,
                                                                      o),
                label, limit=scheme_limit(sch)))
        else:
            cases.append(Case(
                "swt_inv_level_1d_mxu", bands,
                lambda u, w=w, s=sch, o=out, lv=lvl: M1.swt_inv_level_1d_mxu(
                    *u, w.rec_lo, w.rec_hi, lv, s, o),
                lambda u, w=w, s=sch, o=out, lv=lvl: M1.swt_inv_level_1d_mxu_ref(
                    *u, w.rec_lo, w.rec_hi, lv, s, o),
                f"{label} level {lvl}", limit=scheme_limit(sch)))
    # kernel 15's launch plans: the deep levels' short tiles, dilations 2-16
    # on lengths no tile divides, a batch of 3, 2 and 40 taps, float32 and
    # bf16 in and high band (the (2, 5000) shape at level 12 above takes one
    # residue class of a dilation past the signal, as does (2, 6) at level 4)
    w40 = make_custom_wavelet("w40", *np.random.default_rng(40).standard_normal((4, 40)))
    g15 = torch.Generator(device=dev).manual_seed(15)
    for i, (w, (b, n), lvl, sch) in enumerate([
            (w8, (1024, 512), None, "b3"), (w8, (64, 256), None, "b2f"),
            (w8, (3, 101), 2, "b3"), (w8, (3, 101), 3, "b1"), (w8, (35, 777), 4, "b2d"),
            (w8, (35, 777), 5, "fd"), (w8, (33, 1000), 16, "b3"), (haar, (3, 78), None, "b3"),
            (haar, (40, 300), 4, "b2f"), (w40, (3, 90), None, "b2f"),
            (w40, (2, 300), 2, "fd")]):
        in_dt, hdt = (bf16, f32) if i % 2 else (f32, bf16)
        xin = torch.randn((b, n), device=dev, generator=g15).to(in_dt)
        label = f"{w.name} {sch} {in_dt} in, {hdt} hi, {(b, n)}"
        if lvl is None:
            cases.append(Case(
                "fwd_level_1d_mxu", xin,
                lambda t, w=w, s=sch, d=hdt: M1.fwd_level_1d_mxu(t, w.dec_lo, w.dec_hi, s, d),
                lambda t, w=w, s=sch, d=hdt: M1.fwd_level_1d_mxu_ref(t, w.dec_lo, w.dec_hi, s,
                                                                      d),
                label, limit=scheme_limit(sch)))
        else:
            cases.append(Case(
                "swt_fwd_level_1d_mxu", xin,
                lambda t, w=w, s=sch, d=hdt, lv=lvl: M1.swt_fwd_level_1d_mxu(
                    t, w.dec_lo, w.dec_hi, lv, s, d),
                lambda t, w=w, s=sch, d=hdt, lv=lvl: M1.swt_fwd_level_1d_mxu_ref(
                    t, w.dec_lo, w.dec_hi, lv, s, d),
                f"{label} level {lvl}", limit=scheme_limit(sch)))
    # kernel 12 on kernel 2's body: every scheme, 37 x 53 and 1 x 1 subbands,
    # a batch of 3, 2 and 40 taps, float32 and bf16 details and outputs
    haar2 = get_wavelet("haar")
    g12 = torch.Generator(device=dev).manual_seed(12)
    for sch in M.SCHEMES:
        for w, shape, det, out in [(haar2, (3, 37, 53), f32, f32), (w40, (1, 37, 53), bf16, bf16),
                                   (w40, (3, 1, 1), f32, bf16), (haar2, (1, 1, 1), bf16, f32)]:
            bands = [torch.rand(shape, device=dev, generator=g12) * 255.0]
            bands += [((torch.rand(shape, device=dev, generator=g12) - 0.5) * 255.0).to(det)
                      for _ in range(3)]
            cases.append(Case(
                "inv_level_2d_mxu", bands,
                lambda b, w=w, s=sch, o=out: M.inv_level_2d_mxu(*b, w.rec_lo, w.rec_hi, s, o),
                lambda b, w=w, s=sch, o=out: M.inv_level_2d_mxu_ref(*b, w.rec_lo, w.rec_hi, s,
                                                                     o),
                f"{w.name} {sch} {det} details, {out} out, subbands {shape}",
                limit=scheme_limit(sch)))
    # kernel 11 on kernel 13's body at output step 2: every scheme, 37 x 53
    # and 1 x 1 subbands, a batch of 3, 2, 5 (odd), 40 and 128 taps, float32
    # and bf16 input and details (inputs from a generator of their own)
    odd5 = make_custom_wavelet("odd5", *np.random.default_rng(5).standard_normal((4, 5)))
    g11 = torch.Generator(device=dev).manual_seed(11)
    for sch in M.SCHEMES:
        for w, shape, in_dt, det in [(haar2, (3, 74, 106), bf16, f32),
                                     (w40, (1, 74, 106), f32, bf16),
                                     (w128, (1, 40, 70), bf16, bf16), (odd5, (3, 2, 2), f32, f32)]:
            xin = (torch.rand(shape, device=dev, generator=g11) * 255.0).to(in_dt)
            cases.append(Case(
                "fwd_level_2d_mxu", xin,
                lambda t, w=w, s=sch, d=det: M.fwd_level_2d_mxu(t, w.dec_lo, w.dec_hi, s,
                                                                 (f32, d)),
                lambda t, w=w, s=sch, d=det: M.fwd_level_2d_mxu_ref(t, w.dec_lo, w.dec_hi, s,
                                                                     (f32, d)),
                f"{w.name} {sch} {in_dt} in, {det} details, {shape}", limit=scheme_limit(sch)))
    run_cases(cases, report, card)

    # ---------------- (b) and (c): the tiers through the entry points ----------------
    hlen = wav.hlen

    def predict_2d():
        """Launches of one dwt2d + idwt2d at N, LEVELS under an MXU mode,
        from the route rule and the tail rule, as core/separable.py picks."""
        counts = {"fwd_level_2d_mxu": 0, "inv_level_2d_mxu": 0}
        r = N
        for lvl in range(LEVELS):
            if M.mxu_route_2d(r // 2, r // 2, hlen):
                counts["fwd_level_2d_mxu"] += 1
                counts["inv_level_2d_mxu"] += 1
                r //= 2
                continue
            check(K.tail_supported((r, r), hlen, LEVELS - lvl), "the tier path's tail")
            counts["fwd_tail_2d"] = counts["inv_tail_2d"] = 1
            break
        return counts

    def plain_tier_2d(t, tier):
        """The same route on plain versions."""
        mode_det = f32 if tier == "mixed" else bf16
        a, dets = t[None], []
        for lvl, (sch, in_dt, det) in enumerate(fwd_schemes(tier, LEVELS)):
            r = a.shape[-1]
            if M.mxu_route_2d(r // 2, r // 2, hlen):
                a, h, v, d = M.fwd_level_2d_mxu_ref(a, lo, hi, sch, (f32, det))
                dets.append((h, v, d))
                continue
            a, tail = K.fwd_tail_2d_ref(a.float(), lo, hi, LEVELS - lvl)
            dets.extend(tuple(u.to(mode_det) for u in band) for band in tail)
            break
        return Coeffs2D(a[0], tuple(tuple(u[0] for u in band) for band in dets))

    def plain_tier_idwt2d(c, tier):
        rows = level_sizes(N, LEVELS)
        det_all = inv_schemes(tier, LEVELS)
        a = c.approx[None].float()
        k = 0
        while k < LEVELS and not M.mxu_route_2d(rows[LEVELS - 1 - k] // 2,
                                                rows[LEVELS - 1 - k] // 2, hlen):
            k += 1
        if k:
            dets = [tuple(u[None].float() for u in c.details[i])
                    for i in range(LEVELS - 1, LEVELS - 1 - k, -1)]
            a = K.inv_tail_2d_ref(a, dets, rlo, rhi)
        for i in range(LEVELS - 1 - k, -1, -1):
            sch, _, out = det_all[i]
            h, v, d = (u[None] for u in c.details[i])
            a = M.inv_level_2d_mxu_ref(a, h, v, d, rlo, rhi, sch, out)[:, :rows[i], :rows[i]]
        return a[0]

    from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    def roundtrip_check(label, kind, tier, err, plain_err):
        """The roundtrip error against README's figure, or JAX's on the CPU
        where that is larger (1D: README's 2D column)."""
        jax_err = JAX_CPU_ROUNDTRIP[kind][tier]
        limit = max(ROUNDTRIP_LIMIT[tier], jax_err)
        print(f"{label} roundtrip max|y - x| = {err!r} on [0, 255]; the plain route on the "
              f"card {plain_err!r}; the JAX package on the CPU {jax_err!r}; README "
              f"{ROUNDTRIP_LIMIT[tier]}; limit {limit!r}", flush=True)
        check(err <= limit, f"{label} roundtrip error")

    tier_launches = {}
    x_tier = {t: (x if t == "mixed" else x.to(bf16)) for t in TIERS}
    for tier in TIERS:
        det_dt, out_dt = (f32, f32) if tier == "mixed" else (bf16, bf16)
        torch.cuda.synchronize()
        reset_launch_counts()
        Wt = Wavelets(img, wname=WNAME, levels=LEVELS, precision=tier, device=dev)
        wc = Wt.forward()
        wy = Wt.inverse()
        fc = dwt2d(x_tier[tier], wav, LEVELS, precision=tier)
        fy = idwt2d(fc, wav, (N, N), precision=tier)
        torch.cuda.synchronize()
        got = {k: v for k, v in LAUNCHES.items() if v}
        want = {k: 2 * v for k, v in predict_2d().items()}
        print(f"tier {tier} 2D path launches: {got} (route rule predicts {want})", flush=True)
        check(got == want, f"tier {tier}: the 2D path's launches differ from the route rule's")
        for k, v in got.items():
            tier_launches[k] = tier_launches.get(k, 0) + v
        for c in (wc, fc):
            check(c.approx.dtype == f32 and all(u.dtype == det_dt for band in c.details
                                                for u in band),
                  f"tier {tier}: the coefficients break the dtype contract")
        check(wy.dtype == out_dt and fy.dtype == out_dt and tuple(fy.shape) == (N, N),
              f"tier {tier}: the image breaks the dtype contract")
        check(bool(torch.isfinite(fy.float()).all()), f"tier {tier}: the image is not finite")
        pc2 = plain_tier_2d(x_tier[tier], tier)
        compare_route(f"tier {tier} dwt2d", fc, pc2, BF16_RTOL)
        compare_route(f"tier {tier} facade forward", wc, pc2, BF16_RTOL)
        compare_route(f"tier {tier} idwt2d", fy, plain_tier_idwt2d(fc, tier), PATH_BF16_RTOL)
        perr = float((plain_tier_idwt2d(pc2, tier).float() - x).abs().max())
        for label, y in (("facade", wy), ("dwt2d/idwt2d", fy)):
            roundtrip_check(f"tier {tier} 2D {label}", "2D", tier,
                            float((y.float() - x).abs().max()), perr)

    # (c) batched 1D, decimated and a-trous
    def plain_tier_1d(t, tier, swt):
        det = f32 if tier == "mixed" else bf16
        a, dets = t, []
        for lvl in range(B1_LEVELS):
            if swt and tier == "mixed":
                a, d = K1.swt_fwd_level_1d_ref(a, w8.dec_lo, w8.dec_hi, lvl + 1)
            elif swt:
                sch = SWT_SCHEMES[tier][0 if lvl == 0 else 1]
                a, d = M1.swt_fwd_level_1d_mxu_ref(a, w8.dec_lo, w8.dec_hi, lvl + 1, sch, det)
            else:
                sch = fwd_schemes(tier, B1_LEVELS)[lvl][0]
                a, d = M1.fwd_level_1d_mxu_ref(a, w8.dec_lo, w8.dec_hi, sch, det)
            dets.append(d)
        return Coeffs1D(a, tuple(dets))

    def plain_tier_inv_1d(c, tier, swt):
        a = c.approx
        for i in range(B1_LEVELS - 1, -1, -1):
            sch, _, out = inv_schemes(tier, B1_LEVELS)[i]
            if swt and tier == "mixed":
                a = K1.swt_inv_level_1d_ref(a, c.details[i], w8.rec_lo, w8.rec_hi, i + 1)
            elif swt:
                a = M1.swt_inv_level_1d_mxu_ref(a, c.details[i], w8.rec_lo, w8.rec_hi, i + 1,
                                                "fd", out)
            else:
                a = M1.inv_level_1d_mxu_ref(a, c.details[i], w8.rec_lo, w8.rec_hi, sch, out)
        return a

    xr_tier = {t: (xr if t == "mixed" else xr.to(bf16)) for t in TIERS}
    for tier in TIERS:
        det_dt, out_dt = (f32, f32) if tier == "mixed" else (bf16, bf16)
        for swt in (False, True):
            kind = "SWT" if swt else "DWT"
            torch.cuda.synchronize()
            reset_launch_counts()
            Dt = Wavelets(rt_sig, wname=B1_WNAME, levels=B1_LEVELS, ndim=1, do_swt=swt,
                          precision=tier, device=dev)
            dc = Dt.forward()
            dy = Dt.inverse()
            fwd, inv = (swt1d, iswt1d) if swt else (dwt1d, lambda c, w, **k: idwt1d(c, w, B1_N,
                                                                                   **k))
            fc = fwd(xr_tier[tier], w8, B1_LEVELS, precision=tier)
            fy = inv(fc, w8, precision=tier)
            torch.cuda.synchronize()
            got = {k: v for k, v in LAUNCHES.items() if v}
            if swt and tier == "mixed":
                want = {"swt_fwd_level_1d": 2 * B1_LEVELS, "swt_inv_level_1d": 2 * B1_LEVELS}
            else:
                pre = "swt_" if swt else ""
                want = {}
                for lvl in range(B1_LEVELS):
                    n = B1_N if swt else B1_N >> lvl
                    ok = M1.mxu_route_1d(B1_SIGNALS, n, w8.hlen, lvl + 1 if swt else None)
                    for d in ("fwd", "inv"):
                        k = f"{pre}{d}_level_1d" + ("_mxu" if ok else "")
                        want[k] = want.get(k, 0) + 2
            print(f"tier {tier} 1D {kind} path launches: {got} (route rule predicts {want})",
                  flush=True)
            check(got == want, f"tier {tier}: the 1D {kind} path's launches differ from the "
                  "route rule's")
            for k, v in got.items():
                tier_launches[k] = tier_launches.get(k, 0) + v
            for c in (dc, fc):
                check(c.approx.dtype == f32 and all(d.dtype == det_dt for d in c.details),
                      f"tier {tier} 1D {kind}: the coefficients break the dtype contract")
            check(dy.dtype == out_dt and fy.dtype == out_dt and tuple(fy.shape) == tuple(xr.shape),
                  f"tier {tier} 1D {kind}: the signals break the dtype contract")
            pc1 = plain_tier_1d(xr_tier[tier], tier, swt)
            compare_route(f"tier {tier} 1D {kind} forward", fc, pc1, BF16_RTOL)
            compare_route(f"tier {tier} 1D {kind} facade forward", dc, pc1, BF16_RTOL)
            compare_route(f"tier {tier} 1D {kind} inverse", fy,
                          plain_tier_inv_1d(fc, tier, swt), PATH_BF16_RTOL)
            perr = float((plain_tier_inv_1d(pc1, tier, swt).float() - xr).abs().max())
            for label, y in (("facade", dy), ("functions", fy)):
                roundtrip_check(f"tier {tier} 1D {kind} {label}", f"1D {kind}", tier,
                                float((y.float() - xr).abs().max()), perr)
    for name in ("fwd_level_2d_mxu", "inv_level_2d_mxu", "fwd_level_1d_mxu", "inv_level_1d_mxu",
                 "swt_fwd_level_1d_mxu", "swt_inv_level_1d_mxu"):
        check(tier_launches.get(name, 0) > 0, f"the tier paths never launched {name}")
        launches[name] = tier_launches[name]

    # ---------------- (d) each tier's roundtrip beside the exact one ----------------
    exact = {"2D": lambda: idwt2d(dwt2d(x, wav, LEVELS), wav, (N, N)),
             "1D DWT": lambda: idwt1d(dwt1d(xr, w8, B1_LEVELS), w8, B1_N),
             "1D SWT": lambda: iswt1d(swt1d(xr, w8, B1_LEVELS), w8)}
    for tier in TIERS:
        x2, s1 = x_tier[tier], xr_tier[tier]
        tiered = {"2D": lambda: idwt2d(dwt2d(x2, wav, LEVELS, precision=tier), wav, (N, N),
                                       precision=tier),
                  "1D DWT": lambda: idwt1d(dwt1d(s1, w8, B1_LEVELS, precision=tier), w8, B1_N,
                                           precision=tier),
                  "1D SWT": lambda: iswt1d(swt1d(s1, w8, B1_LEVELS, precision=tier), w8,
                                           precision=tier)}
        for kind, shape in (("2D", f"{N}x{N} {WNAME} {LEVELS}"),
                            ("1D DWT", f"{B1_SIGNALS}x{B1_N} {B1_WNAME} {B1_LEVELS}"),
                            ("1D SWT", f"{B1_SIGNALS}x{B1_N} {B1_WNAME} {B1_LEVELS}")):
            time_in_turns(f"{kind} roundtrip {shape} levels, {tier} beside exact", tiered[kind],
                          exact[kind], card, names=(tier, "exact"))



def rank3_quads(seed: int = 7, hlen: int = 8) -> np.ndarray:
    """Rank-3 quads from a seed, as tests/test_mxu_kernels.py:301-306 makes them."""
    q = np.zeros((4, hlen, hlen))
    g = np.random.default_rng(seed)
    for _ in range(3):
        q += np.einsum("si,j->sij", g.standard_normal((4, hlen)), g.standard_normal(hlen))
    return q / np.abs(q).sum(axis=(1, 2), keepdims=True)


def pr_quads(seed: int = 3):
    """(forward, inverse) rank-3 8x8 quads that reconstruct perfectly: db2's
    quads padded to 8 taps, the HH column filter delayed by one subband
    sample, mixed by an orthogonal 4x4 matrix from a seed (as in
    tests/test_torch_nonseparable.py)."""
    from pdwt_tpu_torch import get_wavelet

    w = get_wavelet("db2")
    pad = lambda f, lo, hi: np.concatenate([np.zeros(lo), f, np.zeros(hi)])
    c = lambda f: pad(f, 2, 2)
    quads = lambda lo, hi, hh: np.stack([np.outer(c(lo), c(lo)), np.outer(c(hi), c(lo)),
                                         np.outer(c(lo), c(hi)), np.outer(c(hi), hh)])
    U = np.linalg.qr(np.random.default_rng(seed).standard_normal((4, 4)))[0]
    return (np.einsum("st,tij->sij", U, quads(w.dec_lo, w.dec_hi, pad(w.dec_hi, 0, 4))),
            np.einsum("st,tij->sij", U, quads(w.rec_lo, w.rec_hi, pad(w.rec_hi, 4, 0))))


def flops_ns(r: int, c: int, hlen: int, rank: int, swt: bool, terms: int = 1) -> float:
    """A rank-r level on an r x c image (forward input, inverse output):
    decimated 1.5 rank r c hlen multiply-adds, a-trous 5 rank r c hlen."""
    return 2.0 * (5.0 if swt else 1.5) * rank * r * c * hlen * terms


def ns_yardstick(kind: str, A, Bc, level: int = 1) -> Callable:
    """arg -> () -> the PyTorch yardstick of a rank-r kernel call in bf16:
    the r column products and the stacked row product (forward), or the r
    row products and the stacked column product (inverse), on dense band
    matrices built from the plain passes."""
    from pdwt_tpu_torch.core import conv

    f = 1 << (level - 1)
    swt = kind.startswith("swt")
    fwd = kind.endswith("fwd")
    rank = Bc.shape[0]
    bc = Bc if fwd or not swt else 0.25 * Bc

    def band(n, g, device):
        eye = torch.eye(n, device=device)[None, None]
        kw = {"dilation": f, "decimate": False} if swt else {}
        if fwd:
            m = conv.analysis_pass(eye, [g], axis=-1, **kw)
        else:
            kw = {"dilation": f, "decimated": False} if swt else {}
            m = conv.synthesis_pass(eye, [g], axis=-1, **kw)
        return m[0, 0].to(torch.bfloat16)

    def make(arg):
        if fwd:
            x = arg[0].to(torch.bfloat16)
            R, C = x.shape
            Bk = [band(C, bc[k], x.device) for k in range(rank)]
            M = torch.cat([torch.cat([band(R, A[s, k], x.device).t() for k in range(rank)], 1)
                           for s in range(4)], 0)
            return lambda: M @ torch.cat([x @ b for b in Bk], 0)
        bands = [t[0].to(torch.bfloat16) for t in arg]
        m, n = bands[0].shape
        U = torch.cat(bands, 0)
        S = [torch.cat([band(m, A[s, k], U.device).t() for s in range(4)], 1) for k in range(rank)]
        G = torch.cat([band(n, bc[k], U.device) for k in range(rank)], 0)
        return lambda: torch.cat([s @ U for s in S], 1) @ G
    return make


def ti_tier_phase(dev, card, report, launches, ti_img, gen) -> None:
    """The TI step under the tiers: (a) the a-trous banded-product kernels
    against their plain versions; (b) the facade and the functions with
    ``precision=``: launch counts, dtype contract, the plain route,
    roundtrips; (c) each tier's TI step timed beside the exact one."""
    from pdwt_tpu_torch import Wavelets, get_wavelet, iswt2d, iswt2d_denoise, ops, swt2d
    from pdwt_tpu_torch.core.separable import Coeffs2D
    from pdwt_tpu_torch.filters import make_custom_wavelet
    from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pdwt_tpu_torch.kernels import swt as S
    from pdwt_tpu_torch.kernels import swt_matmul as SM

    f32, bf16 = torch.float32, torch.bfloat16
    wav = get_wavelet(WNAME)
    lo, hi, rlo, rhi = wav.dec_lo, wav.dec_hi, wav.rec_lo, wav.rec_hi
    h7 = wav.hlen
    rand = lambda *s: torch.rand(s, device=dev, generator=gen) * 255.0
    thresholds = [("soft", TI_BETA), None, ("hard", TI_BETA), ("garrote", TI_BETA)]
    fwd_scheme = lambda tier, dt: SWT_SCHEMES[tier][0 if dt == bf16 else 1]
    inv_scheme = lambda tier: "fd" if tier == "bf16-fast" else "b2f"
    routed = lambda tier, r, c, lvl: tier != "mixed" and SM.mxu_route_swt_2d(r, c, h7, lvl)

    # ---------------- (a) kernels 13-14 against their plain versions ----------------
    cases, seen = [], set()
    fl = flops_swt_2d(TI_N, TI_N, h7)
    for tier in TIERS[1:]:  # mixed runs the a-trous levels on kernels 5-6
        row = tier == ROW_TIER
        for lvl in range(1, TI_LEVELS + 1):
            in_dt = bf16 if lvl == 1 else f32
            sch = fwd_scheme(tier, in_dt)
            if (row, "f", lvl, sch) not in seen:
                seen.add((row, "f", lvl, sch))
                cases.append(Case(
                    "swt_fwd_level_2d_mxu", rand(1, TI_N, TI_N).to(in_dt),
                    lambda t, s=sch, lv=lvl: SM.swt_fwd_level_2d_mxu(t, lo, hi, lv, s,
                                                                     (f32, bf16)),
                    lambda t, s=sch, lv=lvl: SM.swt_fwd_level_2d_mxu_ref(t, lo, hi, lv, s,
                                                                         (f32, bf16)),
                    f"{tier} level {lvl} {sch} {in_dt} in, bf16 details, {(TI_N, TI_N)}", True,
                    fl * TERMS[sch], scheme_peak(sch), scheme_limit(sch),
                    yardstick("swt_fwd2d", wav, bf16, lvl) if row else None, row))
            isch, out = inv_scheme(tier), bf16 if lvl == 1 else f32
            bands = [rand(1, TI_N, TI_N)] + [(rand(1, TI_N, TI_N) - 127.5).to(bf16)
                                             for _ in range(3)]
            for thr in thresholds if lvl == 1 else thresholds[:1]:
                if (row, "i", lvl, isch, thr) in seen:
                    continue
                seen.add((row, "i", lvl, isch, thr))
                soft = thr is not None and thr[0] == "soft"
                cases.append(Case(
                    "swt_inv_level_2d_mxu", bands,
                    lambda b, s=isch, lv=lvl, o=out, th=thr: SM.swt_inv_level_2d_mxu(
                        *b, rlo, rhi, lv, s, o, th),
                    lambda b, s=isch, lv=lvl, o=out, th=thr: SM.swt_inv_level_2d_mxu_ref(
                        *b, rlo, rhi, lv, s, o, th),
                    f"{tier} level {lvl} {isch} bf16 details, {out} out, threshold "
                    f"{thr and thr[0]}, {(TI_N, TI_N)}", soft, fl * TERMS[isch],
                    scheme_peak(isch), scheme_limit(isch),
                    yardstick("swt_inv2d", wav, bf16, lvl) if row and soft else None,
                    row and soft))
    # off the route rule (the kernels take them; the entry points run 5-6
    # there), and the two schemes no tier routes here
    for sch, shape, lvl in (("b1", (1, 37, 53), 1), ("fd", (1, TI_N, TI_N), 6),
                            ("b2d", (2, 96, 160), 2), ("b3", (1, 256, 384), 3)):
        xin, bands = rand(*shape).to(bf16), [rand(*shape)] + [rand(*shape) - 127.5
                                                               for _ in range(3)]
        cases.append(Case("swt_fwd_level_2d_mxu", xin,
                          lambda t, s=sch, lv=lvl: SM.swt_fwd_level_2d_mxu(t, lo, hi, lv, s),
                          lambda t, s=sch, lv=lvl: SM.swt_fwd_level_2d_mxu_ref(t, lo, hi, lv, s),
                          f"{sch} {shape} level {lvl}", limit=scheme_limit(sch)))
        cases.append(Case("swt_inv_level_2d_mxu", bands,
                          lambda b, s=sch, lv=lvl: SM.swt_inv_level_2d_mxu(
                              *b, rlo, rhi, lv, s, f32, ("garrote", TI_BETA)),
                          lambda b, s=sch, lv=lvl: SM.swt_inv_level_2d_mxu_ref(
                              *b, rlo, rhi, lv, s, f32, ("garrote", TI_BETA)),
                          f"{sch} {shape} level {lvl} garrote", limit=scheme_limit(sch)))
    # the redesigned inverse's code paths: dilations 2-16 on sizes no tile
    # divides, a batch of 3, 2 and 42 taps, every threshold mode
    w42 = make_custom_wavelet("w42", *np.random.default_rng(42).standard_normal((4, 42)))
    modes = [None, ("soft", TI_BETA), ("hard", TI_BETA), ("garrote", TI_BETA)]
    for i, (w, shape, lvl, sch) in enumerate([
            (wav, (1, 301, 203), 2, "b1"), (wav, (1, 301, 203), 3, "b2f"),
            (wav, (1, 301, 203), 4, "b3"), (wav, (1, 301, 203), 5, "b2d"),
            (wav, (1, 301, 203), 3, "fd"), (wav, (3, 70, 134), 2, "b2f"),
            (get_wavelet("haar"), (1, 64, 96), 3, "b1"), (w42, (1, 200, 150), 1, "b3"),
            (w42, (1, 200, 150), 2, "fd")]):
        bands = [rand(*shape)] + [(rand(*shape) - 127.5).to(bf16) for _ in range(3)]
        out = bf16 if i % 2 else f32
        for thr in modes if i == 0 else [modes[i % 4]]:
            cases.append(Case(
                "swt_inv_level_2d_mxu", bands,
                lambda b, w=w, s=sch, lv=lvl, o=out, th=thr: SM.swt_inv_level_2d_mxu(
                    *b, w.rec_lo, w.rec_hi, lv, s, o, th),
                lambda b, w=w, s=sch, lv=lvl, o=out, th=thr: SM.swt_inv_level_2d_mxu_ref(
                    *b, w.rec_lo, w.rec_hi, lv, s, o, th),
                f"{w.name} {sch} {shape} level {lvl} threshold {thr and thr[0]}, {out} out",
                limit=scheme_limit(sch)))
    # the redesigned forward's code paths: the small tiles of small images,
    # dilations 2-16 on odd sizes no tile divides and one past the image, a
    # batch of 3, 2 and 40 taps, float32 and bf16 in and details (inputs
    # from a generator of their own: the later phases' inputs stay as they
    # were before these cases were added)
    w40 = make_custom_wavelet("w40", *np.random.default_rng(40).standard_normal((4, 40)))
    g13 = torch.Generator(device=dev).manual_seed(13)
    for i, (w, shape, lvl, sch) in enumerate([
            (wav, (1, 128, 128), 1, "b3"), (wav, (1, 64, 64), 3, "b1"),
            (wav, (1, 301, 203), 2, "b1"), (wav, (1, 301, 203), 3, "b2f"),
            (wav, (1, 301, 203), 4, "b3"), (wav, (1, 301, 203), 5, "b2d"),
            (wav, (1, 301, 203), 3, "fd"), (wav, (1, 37, 53), 7, "b3"),
            (wav, (3, 70, 134), 2, "b2f"), (get_wavelet("haar"), (1, 64, 96), 3, "b1"),
            (w40, (1, 200, 150), 1, "b3"), (w40, (1, 200, 150), 2, "fd")]):
        in_dt, det = (bf16, f32) if i % 2 else (f32, bf16)
        xin = (torch.rand(shape, device=dev, generator=g13) * 255.0).to(in_dt)
        cases.append(Case(
            "swt_fwd_level_2d_mxu", xin,
            lambda t, w=w, s=sch, lv=lvl, d=det: SM.swt_fwd_level_2d_mxu(
                t, w.dec_lo, w.dec_hi, lv, s, (f32, d)),
            lambda t, w=w, s=sch, lv=lvl, d=det: SM.swt_fwd_level_2d_mxu_ref(
                t, w.dec_lo, w.dec_hi, lv, s, (f32, d)),
            f"{w.name} {sch} {in_dt} in, {det} details, {shape} level {lvl}",
            limit=scheme_limit(sch)))
    run_cases(cases, report, card)

    # ---------------- (b) the TI path under each tier ----------------
    def predict(r, c, levels, tier):
        """Launches of one swt2d and one inverse as core/separable.py routes."""
        out = {}
        for lvl in range(1, levels + 1):
            sfx = "_mxu" if routed(tier, r, c, lvl) else ""
            for d in ("fwd", "inv"):
                out[f"swt_{d}_level_2d{sfx}"] = out.get(f"swt_{d}_level_2d{sfx}", 0) + 1
        return out

    def plain_fwd(t, tier, levels):
        a, dets = t[None], []
        for lvl in range(1, levels + 1):
            if routed(tier, a.shape[-2], a.shape[-1], lvl):
                a, h, v, d = SM.swt_fwd_level_2d_mxu_ref(a, lo, hi, lvl, fwd_scheme(tier, a.dtype),
                                                         (f32, bf16))
            else:
                a, h, v, d = S.swt_fwd_level_2d_ref(a.float(), lo, hi, lvl)
                if tier != "mixed":
                    h, v, d = (u.to(bf16) for u in (h, v, d))
            dets.append((h[0], v[0], d[0]))
        return Coeffs2D(a[0], tuple(dets))

    def plain_inv(c, tier, threshold=None):
        a = c.approx[None].float()
        for i in range(c.levels - 1, -1, -1):
            h, v, d = (u[None] for u in c.details[i])
            out = bf16 if tier != "mixed" and i == 0 else f32
            if routed(tier, a.shape[-2], a.shape[-1], i + 1):
                a = SM.swt_inv_level_2d_mxu_ref(a, h, v, d, rlo, rhi, i + 1, inv_scheme(tier),
                                                out, threshold)
            else:
                a = S.swt_inv_level_2d_ref(a, h.float(), v.float(), d.float(), rlo, rhi, i + 1,
                                           threshold).to(out)
        return a[0]

    xt = torch.from_numpy(ti_img).to(dev)
    odd = rand(37, 53)
    tier_launches = {}
    for tier in TIERS:
        dt = f32 if tier == "mixed" else bf16
        x_t, odd_t = xt.to(dt), odd.to(dt)
        torch.cuda.synchronize()
        reset_launch_counts()
        T = Wavelets(x_t, wname=WNAME, levels=TI_LEVELS, do_swt=True, precision=tier, device=dev)
        run_out, run_n1 = T.run_denoise(TI_BETA)
        tc = T.forward()
        T.soft_threshold(TI_BETA)
        t_den = T.inverse()
        fc = swt2d(x_t, wav, TI_LEVELS, precision=tier)
        fden = iswt2d_denoise(fc, wav, TI_BETA, precision=tier)
        fy = iswt2d(fc, wav, precision=tier)
        oc = swt2d(odd_t, wav, 2, precision=tier)  # odd: off the route
        oy = iswt2d(oc, wav, precision=tier)
        dc = swt2d(x_t, wav, 6, precision=tier)    # level 6: span 416 > 2 * 128
        dy = iswt2d(dc, wav, precision=tier)
        torch.cuda.synchronize()
        got = {k: v for k, v in LAUNCHES.items() if v}
        want = {}
        for r, c, levels, calls in ((TI_N, TI_N, TI_LEVELS, (3, 4)), (37, 53, 2, (1, 1)),
                                    (TI_N, TI_N, 6, (1, 1))):
            for k, v in predict(r, c, levels, tier).items():
                want[k] = want.get(k, 0) + v * calls[0 if "_fwd_" in k else 1]
        print(f"tier {tier} TI path launches: {got} (route rule predicts {want})", flush=True)
        check(got == want, f"tier {tier}: the TI path's launches differ from the route rule's")
        for k, v in got.items():
            tier_launches[k] = tier_launches.get(k, 0) + v
        for c in (tc, fc, oc, dc):
            check(c.approx.dtype == f32 and all(u.dtype == dt for band in c.details
                                                for u in band),
                  f"tier {tier}: the SWT coefficients break the dtype contract")
        for y, shape in ((run_out, xt.shape), (t_den, xt.shape), (fden, xt.shape),
                         (fy, xt.shape), (oy, odd.shape), (dy, xt.shape)):
            check(y.dtype == dt and y.shape == shape and bool(torch.isfinite(y.float()).all()),
                  f"tier {tier}: a TI image breaks the dtype contract or is not finite")
        pc = plain_fwd(x_t, tier, TI_LEVELS)
        compare_route(f"tier {tier} swt2d", fc, pc)
        compare_route(f"tier {tier} facade forward", tc, pc)
        compare_route(f"tier {tier} swt2d odd", oc, plain_fwd(odd_t, tier, 2))
        compare_route(f"tier {tier} swt2d 6 levels", dc, plain_fwd(x_t, tier, 6))
        compare_route(f"tier {tier} iswt2d_denoise", fden, plain_inv(fc, tier, ("soft", TI_BETA)))
        compare_route(f"tier {tier} run_denoise", run_out, plain_inv(pc, tier, ("soft", TI_BETA)))
        compare_route(f"tier {tier} iswt2d", fy, plain_inv(fc, tier))
        compare_route(f"tier {tier} iswt2d 6 levels", dy, plain_inv(dc, tier))
        p_n1 = float(ops.thresholded_norm1(pc, TI_BETA))
        check(abs(float(run_n1) - p_n1) <= PATH_TIER_RTOL * abs(p_n1),
              f"tier {tier}: run_denoise's norm1 {float(run_n1)!r} vs plain {p_n1!r}")
        jax_err = JAX_CPU_ROUNDTRIP["2D SWT"][tier]
        limit = max(SWT_ROUNDTRIP_LIMIT[tier], jax_err)
        perr = float((plain_inv(pc, tier).float() - xt).abs().max())
        for label, y in (("swt2d/iswt2d", fy),):
            err = float((y.float() - xt).abs().max())
            print(f"tier {tier} TI {label} roundtrip max|y - x| = {err!r} on [0, 255]; the plain "
                  f"route on the card {perr!r}; the JAX package on the CPU {jax_err!r}; README "
                  f"{SWT_ROUNDTRIP_LIMIT[tier]}; limit {limit!r}", flush=True)
            check(err <= limit, f"tier {tier} TI roundtrip error")
    for name in ("swt_fwd_level_2d_mxu", "swt_inv_level_2d_mxu"):
        check(tier_launches.get(name, 0) > 0, f"the TI tier paths never launched {name}")
        launches[name] = tier_launches[name]

    # ---------------- (c) each tier's TI step beside the exact one ----------------
    for tier in TIERS:
        x_t = xt if tier == "mixed" else xt.to(bf16)
        time_in_turns(f"TI step {TI_N}x{TI_N} {WNAME} {TI_LEVELS} levels soft beta {TI_BETA}, "
                      f"{tier} beside exact",
                      lambda: iswt2d_denoise(swt2d(x_t, wav, TI_LEVELS, precision=tier), wav,
                                             TI_BETA, precision=tier),
                      lambda: iswt2d_denoise(swt2d(xt, wav, TI_LEVELS), wav, TI_BETA), card,
                      names=(tier, "exact"))


def ns_phase(dev, card, report, launches, dwt_img, ti_img, gen) -> None:
    """The non-separable engine: (a) the rank-r kernels against their plain
    versions at every routed level of the two cells, both strides; (b)
    ``Wavelets(do_separable=False)`` with db7 and with custom rank-3 quads,
    and the ``_ns`` functions, under exact, ``mixed`` and the bf16 tiers:
    launch counts, dtype contract, the plain route, roundtrips; (c) the
    cells' roundtrips timed beside the exact ones."""
    from pdwt_tpu_torch import Wavelets, get_wavelet
    from pdwt_tpu_torch.core import nonseparable as NSC
    from pdwt_tpu_torch.core.separable import Coeffs2D
    from pdwt_tpu_torch.core.shapes import level_sizes
    from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from pdwt_tpu_torch.kernels import matmul as M
    from pdwt_tpu_torch.kernels import ns_matmul as NM
    from pdwt_tpu_torch.kernels import separable as K

    f32, bf16 = torch.float32, torch.bfloat16
    qf, qi = pr_quads()
    A, Bc = NSC._rank_decomp(qf)
    Ai, Bi = NSC._rank_decomp(qi)
    rank, hq = Bc.shape
    check(rank == 3 and Ai.shape[1] == 3, f"the custom quads' ranks {rank}, {Ai.shape[1]}")
    rand = lambda *s: torch.rand(s, device=dev, generator=gen) * 255.0
    bf16_tier = lambda tier: tier.startswith("bf16-")

    def fwd_plan(tier, in_dt):
        """(scheme, detail dtype) of a decimated forward level."""
        det = bf16 if bf16_tier(tier) else f32
        return (L1_SCHEMES[tier][0] if in_dt == bf16 else "b3"), det

    def inv_plan(tier, out):
        return (L1_SCHEMES[tier][1] if out == bf16 else "b3")

    # ---------------- (a) kernels 17-18 against their plain versions ----------------
    cases, seen = [], set()

    def add(case, key):
        if key not in seen:
            seen.add(key)
            cases.append(case)

    for tier in TIERS:
        row = tier == ROW_TIER
        r = NS_N
        for lvl in range(NS_LEVELS):
            if not NM.mxu_route_ns_2d(r // 2, r // 2, hq, rank):
                break
            in_dt = bf16 if lvl == 0 and bf16_tier(tier) else f32
            sch, det = fwd_plan(tier, in_dt)
            add(Case("ns_fwd_level_2d_mxu", rand(1, r, r).to(in_dt),
                     lambda t, s=sch, d=det: NM.ns_fwd_level_2d_mxu(t, A, Bc, s, (f32, d)),
                     lambda t, s=sch, d=det: NM.ns_fwd_level_2d_mxu_ref(t, A, Bc, s, (f32, d)),
                     f"{tier} level {lvl + 1} {sch} {in_dt} in, {det} details, {(r, r)}", True,
                     flops_ns(r, r, hq, rank, False, TERMS[sch]), scheme_peak(sch),
                     scheme_limit(sch), ns_yardstick("fwd", A, Bc) if row else None, row),
                (row, "f", r, sch, in_dt, det))
            m = r // 2
            out = bf16 if lvl == 0 and bf16_tier(tier) else f32
            isch, idet = inv_plan(tier, out), (bf16 if bf16_tier(tier) else f32)
            bands = [rand(1, m, m)] + [(rand(1, m, m) - 127.5).to(idet) for _ in range(3)]
            add(Case("ns_inv_level_2d_mxu", bands,
                     lambda b, s=isch, o=out: NM.ns_inv_level_2d_mxu(*b, Ai, Bi, s, o),
                     lambda b, s=isch, o=out: NM.ns_inv_level_2d_mxu_ref(*b, Ai, Bi, s, o),
                     f"{tier} level {lvl + 1} {isch} {idet} details, {out} out, subbands "
                     f"{(m, m)}", True, flops_ns(r, r, hq, rank, False, TERMS[isch]),
                     scheme_peak(isch), scheme_limit(isch),
                     ns_yardstick("inv", Ai, Bi) if row else None, row),
                (row, "i", m, isch, idet, out))
            r //= 2
        if not bf16_tier(tier):
            continue  # mixed runs the a-trous levels exact
        for lvl in range(1, NS_SWT_LEVELS + 1):
            in_dt = bf16 if lvl == 1 else f32
            sch = SWT_SCHEMES[tier][0 if lvl == 1 else 1]
            n = NS_SWT_N
            check(NM.mxu_route_ns_swt_2d(n, n, hq, rank, lvl, sch), "the SWT cell's route")
            add(Case("ns_swt_fwd_level_2d_mxu", rand(1, n, n).to(in_dt),
                     lambda t, s=sch, lv=lvl: NM.ns_swt_fwd_level_2d_mxu(t, A, Bc, lv, s,
                                                                          (f32, bf16)),
                     lambda t, s=sch, lv=lvl: NM.ns_swt_fwd_level_2d_mxu_ref(t, A, Bc, lv, s,
                                                                              (f32, bf16)),
                     f"{tier} level {lvl} {sch} {in_dt} in, bf16 details, {(n, n)}", True,
                     flops_ns(n, n, hq, rank, True, TERMS[sch]), scheme_peak(sch),
                     scheme_limit(sch), ns_yardstick("swt_fwd", A, Bc, lvl) if row else None,
                     row),
                (row, "sf", lvl, sch, in_dt))
            out = bf16 if lvl == 1 else f32
            bands = [rand(1, n, n)] + [(rand(1, n, n) - 127.5).to(bf16) for _ in range(3)]
            add(Case("ns_swt_inv_level_2d_mxu", bands,
                     lambda b, lv=lvl, o=out: NM.ns_swt_inv_level_2d_mxu(*b, Ai, Bi, lv, "fd", o),
                     lambda b, lv=lvl, o=out: NM.ns_swt_inv_level_2d_mxu_ref(*b, Ai, Bi, lv, "fd",
                                                                              o),
                     f"{tier} level {lvl} fd bf16 details, {out} out, {(n, n)}", True,
                     flops_ns(n, n, hq, rank, True), FP32_PEAK, tier_limit,
                     ns_yardstick("swt_inv", Ai, Bi, lvl) if row else None, row),
                (row, "si", lvl, out))
    # the random rank-3 set, odd and small shapes off the route, every scheme
    Ar, Br = NSC._rank_decomp(rank3_quads())
    for sch in M.SCHEMES:
        xin = rand(2, 70, 134).to(bf16)
        bands = [rand(2, 35, 67)] + [rand(2, 35, 67) - 127.5 for _ in range(3)]
        sbands = [rand(1, 37, 53)] + [(rand(1, 37, 53) - 127.5).to(bf16) for _ in range(3)]
        cases += [
            Case("ns_fwd_level_2d_mxu", xin, lambda t, s=sch: NM.ns_fwd_level_2d_mxu(t, Ar, Br, s),
                 lambda t, s=sch: NM.ns_fwd_level_2d_mxu_ref(t, Ar, Br, s),
                 f"rank3 {sch} (2, 70, 134)", limit=scheme_limit(sch)),
            Case("ns_inv_level_2d_mxu", bands,
                 lambda b, s=sch: NM.ns_inv_level_2d_mxu(*b, Ar, Br, s, bf16),
                 lambda b, s=sch: NM.ns_inv_level_2d_mxu_ref(*b, Ar, Br, s, bf16),
                 f"rank3 {sch} subbands (2, 35, 67)", limit=scheme_limit(sch)),
            Case("ns_swt_fwd_level_2d_mxu", sbands[0],
                 lambda t, s=sch: NM.ns_swt_fwd_level_2d_mxu(t, Ar, Br, 4, s),
                 lambda t, s=sch: NM.ns_swt_fwd_level_2d_mxu_ref(t, Ar, Br, 4, s),
                 f"rank3 {sch} (1, 37, 53) level 4", limit=scheme_limit(sch)),
            Case("ns_swt_inv_level_2d_mxu", sbands,
                 lambda b, s=sch: NM.ns_swt_inv_level_2d_mxu(*b, Ar, Br, 4, s),
                 lambda b, s=sch: NM.ns_swt_inv_level_2d_mxu_ref(*b, Ar, Br, 4, s),
                 f"rank3 {sch} (1, 37, 53) level 4", limit=scheme_limit(sch))]
    # the redesigned inverse's code paths: the deep levels' small tiles (128^2
    # and 64^2 subbands), dilations 2-16 on sizes no tile divides, a batch of
    # 3, ranks 1 and 4, 2 and 40 taps
    def seeded(rank, hlen, seed):
        g = np.random.default_rng(seed)
        return g.standard_normal((4, rank, hlen)) / hlen, g.standard_normal((rank, hlen)) / hlen

    for (Aq, Bq), shape, f, sch, out in [
            ((Ai, Bi), (1, 128, 128), None, "b3", f32), ((Ai, Bi), (1, 64, 64), None, "b2f", bf16),
            ((Ai, Bi), (3, 37, 53), 2, "b3", f32), ((Ai, Bi), (1, 45, 61), 4, "b1", bf16),
            ((Ai, Bi), (1, 101, 77), 8, "b2d", f32), ((Ai, Bi), (1, 101, 77), 16, "fd", f32),
            (seeded(1, 2, 1), (1, 64, 80), None, "b3", f32),
            (seeded(4, 40, 2), (1, 100, 70), None, "b2f", bf16),
            (seeded(4, 40, 3), (2, 66, 90), 2, "fd", f32),
            (seeded(1, 2, 4), (1, 33, 47), 4, "b1", f32),
            (seeded(3, 8, 5), (3, 35, 67), None, "b2d", bf16)]:
        bands = [rand(*shape)] + [(rand(*shape) - 127.5).to(bf16) for _ in range(3)]
        label = f"rank {Bq.shape[0]}, {Bq.shape[1]} taps, {sch} {shape}"
        if f is None:
            cases.append(Case(
                "ns_inv_level_2d_mxu", bands,
                lambda b, A=Aq, B=Bq, s=sch, o=out: NM.ns_inv_level_2d_mxu(*b, A, B, s, o),
                lambda b, A=Aq, B=Bq, s=sch, o=out: NM.ns_inv_level_2d_mxu_ref(*b, A, B, s, o),
                label, limit=scheme_limit(sch)))
        else:
            lv = f.bit_length()
            cases.append(Case(
                "ns_swt_inv_level_2d_mxu", bands,
                lambda b, A=Aq, B=Bq, s=sch, o=out, lv=lv: NM.ns_swt_inv_level_2d_mxu(
                    *b, A, B, lv, s, o),
                lambda b, A=Aq, B=Bq, s=sch, o=out, lv=lv: NM.ns_swt_inv_level_2d_mxu_ref(
                    *b, A, B, lv, s, o),
                f"{label} level {lv}", limit=scheme_limit(sch)))
    # kernel 17's launch plans: the deep levels' small tiles (256^2 and 128^2
    # images), dilations 2-16 on sizes no tile divides and one past the image,
    # a batch of 3, ranks 1 and 4, 2 and 40 taps, both input dtypes (inputs
    # from a generator of their own, as kernel 16's cases)
    g17 = torch.Generator(device=dev).manual_seed(17)
    for (Aq, Bq), shape, f, sch, in_dt, det in [
            ((A, Bc), (1, 256, 256), None, "b3", f32, bf16),
            ((A, Bc), (1, 128, 128), None, "b2f", f32, f32),
            ((A, Bc), (3, 37, 53), 2, "b3", f32, bf16),
            ((A, Bc), (1, 45, 61), 4, "b1", bf16, bf16),
            ((A, Bc), (1, 101, 77), 8, "b2d", f32, f32),
            ((A, Bc), (1, 101, 77), 16, "fd", f32, bf16),
            ((A, Bc), (1, 30, 41), 64, "b3", f32, f32),
            (seeded(1, 2, 1), (1, 64, 80), None, "b3", bf16, f32),
            (seeded(4, 40, 2), (1, 100, 70), None, "b2f", f32, bf16),
            (seeded(4, 40, 3), (2, 66, 90), 2, "fd", bf16, f32),
            (seeded(1, 2, 4), (1, 33, 47), 4, "b1", f32, f32),
            (seeded(3, 8, 5), (3, 70, 134), None, "b2d", bf16, bf16)]:
        x = (torch.rand(shape, device=dev, generator=g17) * 255.0).to(in_dt)
        label = f"rank {Bq.shape[0]}, {Bq.shape[1]} taps, {sch} {in_dt} in, {det} details, {shape}"
        if f is None:
            cases.append(Case(
                "ns_fwd_level_2d_mxu", x,
                lambda t, A=Aq, B=Bq, s=sch, d=det: NM.ns_fwd_level_2d_mxu(t, A, B, s, (f32, d)),
                lambda t, A=Aq, B=Bq, s=sch, d=det: NM.ns_fwd_level_2d_mxu_ref(t, A, B, s,
                                                                                (f32, d)),
                label, limit=scheme_limit(sch)))
        else:
            lv = f.bit_length()
            cases.append(Case(
                "ns_swt_fwd_level_2d_mxu", x,
                lambda t, A=Aq, B=Bq, s=sch, d=det, lv=lv: NM.ns_swt_fwd_level_2d_mxu(
                    t, A, B, lv, s, (f32, d)),
                lambda t, A=Aq, B=Bq, s=sch, d=det, lv=lv: NM.ns_swt_fwd_level_2d_mxu_ref(
                    t, A, B, lv, s, (f32, d)),
                f"{label} level {lv}", limit=scheme_limit(sch)))
    run_cases(cases, report, card)

    # ---------------- (b) the non-separable paths ----------------
    def predict_dwt(tier):
        """Launches of one dwt2d_ns + idwt2d_ns of the DWT cell."""
        if tier == "exact":
            return {}
        out, r = {}, NS_N
        for _ in range(NS_LEVELS):
            if r % 2 == 0 and NM.mxu_route_ns_2d(r // 2, r // 2, hq, rank):
                out["ns_fwd_level_2d_mxu"] = out.get("ns_fwd_level_2d_mxu", 0) + 1
            r = -(-r // 2)
        for m in level_sizes(NS_N, NS_LEVELS)[1:] + [r]:
            if NM.mxu_route_ns_2d(m, m, hq, rank):
                out["ns_inv_level_2d_mxu"] = out.get("ns_inv_level_2d_mxu", 0) + 1
        return out

    def predict_swt(tier):
        if not bf16_tier(tier):
            return {}
        out = {}
        for lvl in range(1, NS_SWT_LEVELS + 1):
            sch = SWT_SCHEMES[tier][0 if lvl == 1 else 1]
            if NM.mxu_route_ns_swt_2d(NS_SWT_N, NS_SWT_N, hq, rank, lvl, sch):
                out["ns_swt_fwd_level_2d_mxu"] = out.get("ns_swt_fwd_level_2d_mxu", 0) + 1
            if NM.mxu_route_ns_swt_2d(NS_SWT_N, NS_SWT_N, hq, rank, lvl, "fd"):
                out["ns_swt_inv_level_2d_mxu"] = out.get("ns_swt_inv_level_2d_mxu", 0) + 1
        return out

    def predict_named(tier):
        """db7's quads run the separable DWT: as the main and tier paths."""
        out, r = {}, NS_N
        for lvl in range(NS_LEVELS):
            if tier != "exact" and M.mxu_route_2d(r // 2, r // 2, 14):
                out["fwd_level_2d_mxu"] = out.get("fwd_level_2d_mxu", 0) + 1
                out["inv_level_2d_mxu"] = out.get("inv_level_2d_mxu", 0) + 1
            elif K.tail_supported((r, r), 14, NS_LEVELS - lvl):
                out["fwd_tail_2d"] = out["inv_tail_2d"] = 1
                break
            else:
                out["fwd_level_2d"] = out.get("fwd_level_2d", 0) + 1
                out["inv_level_2d"] = out.get("inv_level_2d", 0) + 1
            r //= 2
        return out

    def plain_dwt(t, tier):
        a, dets = t[None], []
        for _ in range(NS_LEVELS):
            r, c = a.shape[-2:]
            if tier != "exact" and r % 2 == 0 and NM.mxu_route_ns_2d(r // 2, c // 2, hq, rank):
                sch, det = fwd_plan(tier, a.dtype)
                a, h, v, d = NM.ns_fwd_level_2d_mxu_ref(a, A, Bc, sch, (f32, det))
            else:
                z = NSC._rank_fwd_level(a.float()[:, None], A, Bc)
                a, h, v, d = (z[:, k] for k in range(4))
                if bf16_tier(tier):
                    h, v, d = (u.to(bf16) for u in (h, v, d))
            dets.append((h[0], v[0], d[0]))
        return Coeffs2D(a[0], tuple(dets))

    def plain_idwt(c, tier):
        rows = level_sizes(NS_N, NS_LEVELS)
        a = c.approx[None].float()
        for i in range(NS_LEVELS - 1, -1, -1):
            h, v, d = (u[None] for u in c.details[i])
            out = bf16 if bf16_tier(tier) and i == 0 else f32
            m = a.shape[-1]
            if tier != "exact" and NM.mxu_route_ns_2d(m, m, hq, rank):
                a = NM.ns_inv_level_2d_mxu_ref(a, h, v, d, Ai, Bi, inv_plan(tier, out), out)
                a = a[:, :rows[i], :rows[i]]
            else:
                z = torch.stack([a, h.float(), v.float(), d.float()], 1)
                a = NSC._rank_inv_level(z, Ai, Bi, (rows[i], rows[i]))[:, 0].to(out)
        return a[0]

    def plain_swt(t, tier):
        a, dets = t[None], []
        for lvl in range(1, NS_SWT_LEVELS + 1):
            sch = SWT_SCHEMES[tier][0 if lvl == 1 else 1] if bf16_tier(tier) else None
            if sch and NM.mxu_route_ns_swt_2d(NS_SWT_N, NS_SWT_N, hq, rank, lvl, sch):
                a, h, v, d = NM.ns_swt_fwd_level_2d_mxu_ref(a, A, Bc, lvl, sch, (f32, bf16))
            else:
                z = NSC._rank_fwd_level(a.float()[:, None], A, Bc, 1 << (lvl - 1), False)
                a, h, v, d = (z[:, k] for k in range(4))
                if bf16_tier(tier):
                    h, v, d = (u.to(bf16) for u in (h, v, d))
            dets.append((h[0], v[0], d[0]))
        return Coeffs2D(a[0], tuple(dets))

    def plain_iswt(c, tier):
        a = c.approx[None].float()
        for i in range(NS_SWT_LEVELS - 1, -1, -1):
            h, v, d = (u[None] for u in c.details[i])
            out = bf16 if bf16_tier(tier) and i == 0 else f32
            if bf16_tier(tier) and NM.mxu_route_ns_swt_2d(NS_SWT_N, NS_SWT_N, hq, rank, i + 1,
                                                          "fd"):
                a = NM.ns_swt_inv_level_2d_mxu_ref(a, h, v, d, Ai, Bi, i + 1, "fd", out)
            else:
                z = torch.stack([a, h.float(), v.float(), d.float()], 1)
                a = NSC._rank_inv_level(z, Ai, 0.25 * Bi, f=1 << i, decimated=False)[:, 0]
                a = a.to(out)
        return a[0]

    xd = torch.from_numpy(dwt_img).to(dev)
    xs = torch.from_numpy(ti_img).to(dev)
    from pdwt_tpu_torch.core.nonseparable import dwt2d_ns, idwt2d_ns, iswt2d_ns, swt2d_ns

    ns_launches = {}
    for tier in ("exact",) + TIERS:
        dt = bf16 if bf16_tier(tier) else f32
        xd_t, xs_t = xd.to(dt), xs.to(dt)
        torch.cuda.synchronize()
        reset_launch_counts()
        Wn = Wavelets(xd_t, wname=WNAME, levels=NS_LEVELS, do_separable=False, precision=tier,
                      device=dev)
        nc = Wn.forward()
        ny = Wn.inverse()
        torch.cuda.synchronize()
        got = {k: v for k, v in LAUNCHES.items() if v}
        want = predict_named(tier)
        print(f"{tier} non-separable db7 launches: {got} (the separable route predicts {want})",
              flush=True)
        check(got == want, f"{tier}: db7's quads did not take the separable kernels")
        nerr = float((ny.float() - xd).abs().max())
        check(nc.approx.dtype == f32 and ny.dtype == dt and nerr <= max(
            ROUNDTRIP_LIMIT.get(tier, ROUNDTRIP_ATOL), JAX_CPU_ROUNDTRIP["2D"].get(tier, 0.0)),
              f"{tier}: db7 non-separable roundtrip {nerr!r}")
        print(f"{tier} non-separable db7 roundtrip max|y - x| = {nerr!r}", flush=True)

        reset_launch_counts()
        Wd = Wavelets(xd_t, wname="db2", levels=NS_LEVELS, do_separable=False, precision=tier,
                      device=dev)
        Wd.set_filters_forward("rank3", *qf)
        Wd.set_filters_inverse(*qi)
        wc, wy = Wd.forward(), Wd.inverse()
        fc = dwt2d_ns(xd_t, qf, NS_LEVELS, precision=tier)
        fy = idwt2d_ns(fc, qi, (NS_N, NS_N), precision=tier)
        Ws = Wavelets(xs_t, wname="db2", levels=NS_SWT_LEVELS, do_separable=False, do_swt=True,
                      precision=tier, device=dev)
        Ws.set_filters_forward("rank3", *qf)
        Ws.set_filters_inverse(*qi)
        sc, sy = Ws.forward(), Ws.inverse()
        fsc = swt2d_ns(xs_t, qf, NS_SWT_LEVELS, precision=tier)
        fsy = iswt2d_ns(fsc, qi, precision=tier)
        torch.cuda.synchronize()
        got = {k: v for k, v in LAUNCHES.items() if v}
        want = {k: 2 * v for k, v in {**predict_dwt(tier), **predict_swt(tier)}.items()}
        print(f"{tier} non-separable rank-3 launches: {got} (route rules predict {want})",
              flush=True)
        check(got == want, f"{tier}: the non-separable path's launches differ from the rules'")
        for k, v in got.items():
            ns_launches[k] = ns_launches.get(k, 0) + v
        for c in (wc, fc, sc, fsc):
            check(c.approx.dtype == f32 and all(u.dtype == dt for band in c.details
                                                for u in band),
                  f"{tier}: the non-separable coefficients break the dtype contract")
        for y, ref in ((wy, xd), (fy, xd), (sy, xs), (fsy, xs)):
            check(y.dtype == dt and y.shape == ref.shape, f"{tier}: a non-separable image "
                  "breaks the dtype contract")
        pdc, psc = plain_dwt(xd_t, tier), plain_swt(xs_t, tier)
        compare_route(f"{tier} dwt2d_ns", fc, pdc)
        compare_route(f"{tier} facade non-separable DWT", wc, pdc)
        compare_route(f"{tier} idwt2d_ns", fy, plain_idwt(fc, tier))
        compare_route(f"{tier} swt2d_ns", fsc, psc)
        compare_route(f"{tier} facade non-separable SWT", sc, psc)
        compare_route(f"{tier} iswt2d_ns", fsy, plain_iswt(fsc, tier))
        for kind, y, ref, plain_y in (("NS DWT", fy, xd, plain_idwt(pdc, tier)),
                                      ("NS SWT", fsy, xs, plain_iswt(psc, tier))):
            err = float((y.float() - ref).abs().max())
            perr = float((plain_y.float() - ref).abs().max())
            if tier == "exact":
                jax_err, readme = None, ROUNDTRIP_ATOL
            else:
                jax_err = JAX_CPU_ROUNDTRIP[kind][tier]
                readme = (ROUNDTRIP_LIMIT if kind == "NS DWT" else SWT_ROUNDTRIP_LIMIT)[tier]
            limit = max(readme, jax_err or 0.0)
            print(f"{tier} {kind} rank-3 roundtrip max|y - x| = {err!r} on [0, 255]; the plain "
                  f"route on the card {perr!r}; the JAX package on the CPU {jax_err!r}; "
                  f"README's 2D figure {readme}; limit {limit!r}", flush=True)
            check(err <= limit, f"{tier} {kind} roundtrip error")
    for name in ("ns_fwd_level_2d_mxu", "ns_inv_level_2d_mxu", "ns_swt_fwd_level_2d_mxu",
                 "ns_swt_inv_level_2d_mxu"):
        check(ns_launches.get(name, 0) > 0, f"the non-separable paths never launched {name}")
        launches[name] = ns_launches[name]

    # ---------------- (c) the cells' roundtrips beside the exact ones ----------------
    for tier in TIERS:
        dt = bf16 if bf16_tier(tier) else f32
        xd_t, xs_t = xd.to(dt), xs.to(dt)
        time_in_turns(f"non-separable DWT roundtrip {NS_N}x{NS_N} rank 3, {NS_LEVELS} levels, "
                      f"{tier} beside exact",
                      lambda: idwt2d_ns(dwt2d_ns(xd_t, qf, NS_LEVELS, precision=tier), qi,
                                        (NS_N, NS_N), precision=tier),
                      lambda: idwt2d_ns(dwt2d_ns(xd, qf, NS_LEVELS), qi, (NS_N, NS_N)), card,
                      names=(tier, "exact"))
        time_in_turns(f"non-separable SWT roundtrip {NS_SWT_N}x{NS_SWT_N} rank 3, "
                      f"{NS_SWT_LEVELS} levels, {tier} beside exact",
                      lambda: iswt2d_ns(swt2d_ns(xs_t, qf, NS_SWT_LEVELS, precision=tier), qi,
                                        precision=tier),
                      lambda: iswt2d_ns(swt2d_ns(xs, qf, NS_SWT_LEVELS), qi), card,
                      names=(tier, "exact"))


# the operators phase (the reference's operator set and the models on it)
CS_N, CS_LEVELS, CS_SPINS, CS_BETA = 1024, 3, 8, 10.0    # cycle_spin_denoise
IS_N, IS_LEVELS, IS_ITERS, IS_LAM = 1024, 4, 50, 10.0    # ista (FISTA)
# rows 1-10 of the table: the exact kernels an operator's call may launch
EXACT_KERNELS = frozenset(("fwd_level_2d", "inv_level_2d", "fwd_tail_2d", "inv_tail_2d",
                           "swt_fwd_level_2d", "swt_inv_level_2d", "fwd_level_1d",
                           "inv_level_1d", "swt_fwd_level_1d", "swt_inv_level_1d"))


def dwt2d_kernels(n: int, hlen: int, levels: int) -> frozenset:
    """The kernels that idwt2d(dwt2d(x)) launches on an exact n x n float32
    image (core/separable.py's dispatch: level kernels, then one tail)."""
    from pdwt_tpu_torch.kernels import separable as K

    names, r = set(), n
    for lvl in range(levels):
        if K.tail_supported((r, r), hlen, levels - lvl):
            names.add("fwd_tail_2d")
            break
        names.add("fwd_level_2d")
        r //= 2
    m, k = n >> levels, 0
    while k < levels and K.tail_supported((m << (k + 1), m << (k + 1)), hlen, k + 1):
        k += 1
    names.update(["inv_tail_2d"] * bool(k) + ["inv_level_2d"] * (k < levels))
    return frozenset(names)


def counted(label, fn, required):
    """fn() between a reset and a read of the launch counters: exactly the
    kernels ``required`` (of rows 1-10) were launched."""
    from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in LAUNCHES.items() if v}
    print(f"operators: {label}: launches {got}", flush=True)
    check(set(got) == set(required) and set(got) <= EXACT_KERNELS,
          f"operators: {label} launched {sorted(got)}, expected {sorted(required)}")
    return out


def hold(label, got, want, rtol=PATH_RTOL, scale=None) -> None:
    """A result against the same computation on the plain route: one dtype
    and shape per output, within rtol of the call's largest plain value,
    or of ``scale``: an operator on coefficients moves their differences by
    at most its Lipschitz constant, so it is held to that times the
    largest coefficient the transform was held to (clipping to 40 shrinks
    the outputs, not the inputs' differences)."""
    gl, wl = leaves(got), leaves(want)
    check(len(gl) == len(wl) and all(g.dtype == w.dtype and g.shape == w.shape
                                     for g, w in zip(gl, wl)),
          f"operators: {label}: dtypes or shapes differ from the plain route")
    check(all(bool(torch.isfinite(g).all()) for g in gl), f"operators: {label}: not finite")
    err, out_scale = max_err(got, want)
    scale = out_scale if scale is None else scale
    print(f"operators: {label} vs plain route: max|diff| {err:.3e} (limit "
          f"{rtol * scale:.3e})", flush=True)
    check(err <= rtol * scale, f"operators: {label} disagrees with the plain route")


def hold_value(label, got, want, rtol=PATH_RTOL) -> None:
    got, want = float(got), float(want)
    print(f"operators: {label} {got!r} vs plain route {want!r}", flush=True)
    check(abs(got - want) <= rtol * abs(want), f"operators: {label} disagrees with the plain route")


# the card's estimators against a float64 evaluation of the same
# coefficients on the host: noise sigma and VisuShrink within EST_RTOL (a
# float32 median and product); BayesShrink within EST_RTOL times its rule's
# condition number 1 + m / (m - sigma^2) in the band's mean square m (a
# float32 sum of up to 4 M squares); SURE's threshold where its float64
# risk is within SURE_RTOL of the float64 minimum, relative to n sigma^2 +
# sum d^2 (the card's risk curve is a float32 cumulative sum)
EST_RTOL, SURE_RTOL = 1e-6, 1e-5


def hold_estimators(label, coeffs) -> None:
    """noise_sigma, universal_threshold, bayes_thresholds and
    sure_thresholds on the card (a CUDA sort, sum, cumsum and argmin)
    against the same rules in float64 on the host (numpy) on the same
    coefficients; the per-band rules at the card's sigma."""
    from pdwt_tpu_torch import ops

    det0 = coeffs.details[0]
    bands = [b for det in coeffs.details
             for b in ((det,) if isinstance(det, torch.Tensor) else det)]
    host = [b.double().cpu().numpy().ravel() for b in bands]
    finest = host[0] if isinstance(det0, torch.Tensor) else host[len(det0) - 1]
    sigma = ops.noise_sigma(coeffs)
    s64 = float(np.median(np.abs(finest))) / 0.6744897501960817
    u64 = s64 * math.sqrt(2.0 * math.log(sum(d.size for d in host)))
    for name, got, want in (("noise_sigma", sigma, s64),
                            ("universal_threshold", ops.universal_threshold(coeffs), u64)):
        rel = abs(float(got) - want) / want
        print(f"operators: {label} {name} {float(got)!r} vs float64 {want!r}: relative "
              f"{rel:.3e} (limit {EST_RTOL})", flush=True)
        check(rel <= EST_RTOL, f"operators: {label} {name} disagrees with float64")
    flat = lambda t: [v for lvl in t for v in (lvl if isinstance(lvl, tuple) else (lvl,))]
    s2 = float(sigma) ** 2
    worst_b = worst_s = 0.0
    for i, (d, tb, ts) in enumerate(zip(host, flat(ops.bayes_thresholds(coeffs)),
                                        flat(ops.sure_thresholds(coeffs)))):
        n = d.size
        m = float(np.dot(d, d)) / n
        want, cond = ((s2 / math.sqrt(m - s2), 1.0 + m / (m - s2)) if m > s2
                      else (float(np.abs(d).max()), 1.0))
        rel_b = abs(float(tb) - want) / want / cond
        a = np.sort(d * d)
        cs = np.cumsum(a)
        k = np.arange(1, n + 1)
        risk = n * s2 - 2.0 * s2 * k + cs + (n - k) * a
        t = float(ts)
        if (cs[-1] / s2 - n) / n <= n ** -0.5 * math.log(max(n, 2)) ** 1.5:
            # too sparse for SURE: the hybrid rule's universal threshold
            t_u = math.sqrt(s2 * 2.0 * math.log(max(n, 2)))
            rel_s = abs(t - t_u) / t_u * SURE_RTOL / EST_RTOL
        else:
            r_t = n * s2
            if t > 0.0:  # the candidate nearest t^2, at the end of its run of ties
                j = min(int(np.searchsorted(a, t * t)), n - 1)
                j -= bool(j and abs(a[j - 1] - t * t) < abs(a[j] - t * t))
                r_t = float(risk[int(np.searchsorted(a, a[j], side="right")) - 1])
            rel_s = (r_t - min(n * s2, float(risk.min()))) / (n * s2 + float(cs[-1]))
        check(rel_b <= EST_RTOL, f"operators: {label} bayes_thresholds band {i}: "
              f"{float(tb)!r} vs float64 {want!r} (condition {cond:.3g})")
        check(rel_s <= SURE_RTOL, f"operators: {label} sure_thresholds band {i}: {t!r}, "
              f"risk {rel_s:.3e} above the float64 minimum")
        worst_b, worst_s = max(worst_b, rel_b), max(worst_s, rel_s)
    print(f"operators: {label} bayes_thresholds vs float64: worst relative / condition "
          f"{worst_b:.3e} (limit {EST_RTOL}); sure_thresholds: worst risk excess "
          f"{worst_s:.3e} (limit {SURE_RTOL})", flush=True)


def time_call(label, fn, card, per: int = 1) -> None:
    """One call's time (CUDA events, median of 20) and device busy time
    (torch.profiler), per ``per`` (the ISTA loop per iteration)."""
    ms = cuda_ms(fn) / per
    busy = device_ms(fn)[0]
    busy = None if busy is None else busy / per
    unit = "an iteration" if per > 1 else "a call"
    print(f"operators timing: {label}: {ms:.4f} ms {unit}, device busy {fmt(busy)} [{card}]",
          flush=True)


def operators_phase(dev, card, dwt_img, ti_img, sig) -> None:
    """The reference's operator set and the models on it, at the sizes a
    PDWT user runs, through the facade and the models' entry points, each
    result held against the same computation on the plain route on the
    card and each call's kernels read from the launch counters."""
    import contextlib
    import io
    import tempfile

    from pdwt_tpu_torch import Wavelets, demo, dwt2d, get_wavelet, ops, swt2d
    from pdwt_tpu_torch.models import auto_denoise, cycle_spin_denoise, denoise_step, ista
    from pdwt_tpu_torch.models import solver
    from pdwt_tpu_torch.utils import write_dat

    print("=== operators ===", flush=True)
    wav = get_wavelet(WNAME)
    x = torch.from_numpy(dwt_img).to(dev)
    xt = torch.from_numpy(ti_img).to(dev)
    dwt_k = dwt2d_kernels(N, wav.hlen, LEVELS)
    swt_k = {"swt_fwd_level_2d", "swt_inv_level_2d"}

    # -- the 2048^2 facade: the operators on the kernels' coefficients
    # against the same operators on the plain route's
    W = Wavelets(x, wname=WNAME, levels=LEVELS, device=dev)
    counted("facade forward 2048^2", W.forward, dwt_k & {"fwd_level_2d", "fwd_tail_2d"})
    pc = plain_dwt2d(x, wav, LEVELS)
    hold("facade forward", W.coeffs, pc)
    # the operators below are at most 2-Lipschitz in each value (the group
    # threshold over four bands sqrt(4), firm's ramp 24 / 16, the axpy 1.25)
    op_scale = 2.0 * max_err(W.coeffs, pc)[1]
    check(W.info()["device"] == f"cuda:{torch.cuda.get_device_name(dev)}",
          f"operators: info() device {W.info()['device']!r}")
    G = 12.0
    facade_ops = [
        ("group_soft_threshold", lambda F: F.group_soft_threshold(G),
         lambda c: ops.group_soft_threshold(c, G)),
        ("group_soft_threshold normalize app",
         lambda F: F.group_soft_threshold(G, do_thresh_appcoeffs=True, normalize=True),
         lambda c: ops.group_soft_threshold(c, G, do_thresh_appcoeffs=True, normalize=True)),
        ("firm_threshold", lambda F: F.firm_threshold(8.0, 24.0),
         lambda c: ops.firm_threshold(c, 8.0, 24.0)),
        ("shrink", lambda F: F.shrink(0.5), lambda c: ops.shrink(c, 0.5)),
        ("proj_linf", lambda F: F.proj_linf(40.0), lambda c: ops.proj_linf(c, 40.0)),
        ("bayes_shrink", lambda F: F.bayes_shrink(),
         lambda c: ops.soft_threshold(c, ops.bayes_thresholds(c))),
    ]
    for label, op, plain in facade_ops:
        F = W.copy()
        counted(f"facade {label}", lambda: op(F), ())
        hold(f"facade {label}", F.coeffs, plain(pc), scale=op_scale)
        F = W.copy()
        time_call(f"facade {label} {N}x{N} {WNAME} {LEVELS} levels", lambda: op(F), card)
    F = W.copy()
    F.group_soft_threshold(G)
    den = counted("facade inverse after group_soft_threshold", F.inverse,
                  dwt_k & {"inv_level_2d", "inv_tail_2d"})
    hold("facade inverse after group_soft_threshold", den,
         plain_idwt2d(ops.group_soft_threshold(pc, G), wav, (N, N)))
    for label, got, want in (
            ("norm_l21", W.norm_l21(), ops.norm_l21(pc)),
            ("norm_l21 app", W.norm_l21(True), ops.norm_l21(pc, do_thresh_appcoeffs=True)),
            ("noise_sigma", W.noise_sigma(), ops.noise_sigma(pc)),
            ("universal_threshold", W.universal_threshold(), ops.universal_threshold(pc))):
        hold_value(f"facade {label}", got, want)
    fused = ops.thresholded_norm_l21(W.coeffs, G, normalize=True)
    full = ops.norm_l21(ops.group_soft_threshold(W.coeffs, G, normalize=True))
    print(f"operators: thresholded_norm_l21 {float(fused)!r} vs norm_l21(group_soft_threshold) "
          f"{float(full)!r}", flush=True)
    check(abs(float(fused) - float(full)) <= NORM_RTOL * abs(float(full)),
          "operators: thresholded_norm_l21")
    for label, fn in (("norm_l21", W.norm_l21), ("noise_sigma", W.noise_sigma),
                      ("universal_threshold", W.universal_threshold),
                      ("thresholded_norm_l21", lambda: ops.thresholded_norm_l21(W.coeffs, G))):
        time_call(f"facade {label} {N}x{N}", fn, card)
    # add_wavelet, get_coeff / set_coeff, circshift, copy
    F, H = W.copy(), W.copy()
    H.shrink(0.5)
    check(counted("facade add_wavelet", lambda: F.add_wavelet(H, -0.25), ()) == 0,
          "operators: add_wavelet did not return 0")
    hold("facade add_wavelet", F.coeffs, ops.add_coeffs(pc, ops.shrink(pc, 0.5), -0.25),
         scale=op_scale)
    time_call(f"facade add_wavelet {N}x{N}", lambda: F.add_wavelet(H, 0.0), card)
    for num in (0, 1, 3 * LEVELS):
        band = W.get_coeff(num, copy=False)
        want = pc.approx if num == 0 else pc.details[(num - 1) // 3][(num - 1) % 3]
        hold(f"facade get_coeff({num})", band, want, scale=op_scale)
        check(band.device == dev and np.array_equal(W.get_coeff(num), band.cpu().numpy()),
              f"operators: get_coeff({num}) copies")
        F.set_coeff(band * 2.0, num)
        F.set_coeff(F.get_coeff(num) * 0.5, num)
        check(torch.equal(F.get_coeff(num, copy=False), band), f"operators: set_coeff({num})")
    shifted = W.circshift(37, -101, inplace=False)
    check(torch.equal(shifted, torch.roll(x, (37, -101), (0, 1))), "operators: circshift")
    time_call(f"facade circshift {N}x{N}", lambda: W.circshift(37, -101, inplace=False), card)
    C, before = W.copy(), W.coeffs.details[0][0].clone()
    C.soft_threshold(1e9)
    check(not bool(C.coeffs.details[0][0].any()) and torch.equal(W.coeffs.details[0][0], before),
          "operators: copy is not deep")
    time_call(f"facade copy {N}x{N}", W.copy, card)

    # -- auto_denoise, each method: the DWT at 2048^2, the SWT at 1024^2.
    # The estimators on the kernels' coefficients are held to float64; the
    # plain route estimates its thresholds from its own coefficients
    for swt, img, levels, kern in ((False, x, LEVELS, dwt_k), (True, xt, TI_LEVELS, swt_k)):
        kind = f"{'SWT' if swt else 'DWT'} {img.shape[0]}^2 {levels} levels"
        kc = (swt2d if swt else dwt2d)(img, wav, levels)
        c = (plain_swt2d if swt else plain_dwt2d)(img, wav, levels)
        hold_estimators(f"estimators {kind}", kc)
        for method in ("bayes", "sure", "universal"):
            est = {"bayes": lambda t: list(ops.bayes_thresholds(t)),
                   "sure": lambda t: list(ops.sure_thresholds(t)),
                   "universal": ops.universal_threshold}[method]
            # the output moves by at most the thresholds' difference: held
            # relative to the largest threshold
            beta, own = torch.stack(leaves(est(kc))), torch.stack(leaves(est(c)))
            dev_b = float((beta - own).abs().max() / own.abs().max())
            print(f"operators: auto_denoise {method} {kind} thresholds from the kernels' and "
                  f"from the plain route's coefficients: max relative difference {dev_b:.3e} "
                  f"(limit {PATH_RTOL})", flush=True)
            check(dev_b <= PATH_RTOL, f"operators: auto_denoise {method} {kind} thresholds")
            pt = ops.soft_threshold(c, est(c))
            want = plain_iswt2d(pt, wav) if swt else plain_idwt2d(pt, wav, tuple(img.shape))
            call = lambda: auto_denoise(img, wav, levels, method=method, swt=swt)
            out = counted(f"auto_denoise {method} {kind}", call, kern)
            hold(f"auto_denoise {method} {kind}", out, want)
            time_call(f"auto_denoise {method} {kind}", call, card)

    # -- the TI step with the group threshold: not fused (threshold, norm1,
    # the synthesis kernel)
    call = lambda: denoise_step(xt, None, wav, TI_LEVELS, G, swt=True, mode="group")
    out, n1 = counted("denoise_step swt group", call, swt_k)
    pg = ops.group_soft_threshold(plain_swt2d(xt, wav, TI_LEVELS), G)
    hold("denoise_step swt group", out, plain_iswt2d(pg, wav))
    hold_value("denoise_step swt group norm1", n1, ops.norm1(pg))
    time_call(f"denoise_step swt group {TI_N}x{TI_N} {WNAME} {TI_LEVELS} levels", call, card)

    # -- cycle_spin_denoise: 8 spins of the 1024^2 DWT step, shifts from one
    # generator; the plain route takes the same shifts
    xc = xt
    cs_k = dwt2d_kernels(CS_N, wav.hlen, CS_LEVELS)
    gen = lambda: torch.Generator(device=dev).manual_seed(21)
    out = counted("cycle_spin_denoise", lambda: cycle_spin_denoise(
        xc, gen(), wav, CS_LEVELS, CS_BETA, spins=CS_SPINS), cs_k)
    g, acc = gen(), torch.zeros_like(xc)
    for _ in range(CS_SPINS):
        sr, sc = ops.random_shift(g, (CS_N, CS_N))
        c = ops.soft_threshold(plain_dwt2d(torch.roll(xc, (sr, sc), (0, 1)), wav, CS_LEVELS),
                               CS_BETA)
        acc = acc + torch.roll(plain_idwt2d(c, wav, (CS_N, CS_N)), (-sr, -sc), (0, 1))
    hold("cycle_spin_denoise", out, acc / torch.full((), CS_SPINS, device=dev))
    time_call(f"cycle_spin_denoise {CS_SPINS} spins {CS_N}x{CS_N} {WNAME} {CS_LEVELS} levels "
              f"soft beta {CS_BETA}", lambda: cycle_spin_denoise(
                  xc, gen(), wav, CS_LEVELS, CS_BETA, spins=CS_SPINS), card)

    # -- ista (FISTA), 50 iterations at 1024^2, db7, 4 levels: the identity,
    # a 7x7 blur (a conv2d: the user's operator) with its adjoint derived,
    # and the group lasso; the plain route runs the same loop on the plain
    # transforms
    k = torch.outer(*(torch.hann_window(9, periodic=False, device=dev)[1:-1],) * 2)
    k = (k / k.sum())[None, None]
    blur = lambda v: torch.nn.functional.conv2d(v[None, None], k, padding=3)[0, 0]
    noise = torch.randn(xt.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(22))
    y_blur = blur(xt) + 2.0 * noise
    is_k = dwt2d_kernels(IS_N, wav.hlen, IS_LEVELS)
    for label, y, kw in (("identity", xt, {}), ("blur, op_t derived", y_blur, {"op": blur}),
                         ("group lasso", xt, {"reg": "group"})):
        call = lambda: ista(y, wav=wav, levels=IS_LEVELS, lam=IS_LAM, iters=IS_ITERS, **kw)
        got, trace = counted(f"ista {label}", call, is_k)
        fwd, inv = solver.dwt2d, solver.idwt2d
        solver.dwt2d = lambda t, w, lv, **kw: plain_dwt2d(t, w, lv)
        solver.idwt2d = lambda c, w, shape, **kw: plain_idwt2d(c, w, shape)
        try:
            want, want_trace = ista(y, wav=wav, levels=IS_LEVELS, lam=IS_LAM,
                                    iters=IS_ITERS, **kw)
        finally:
            solver.dwt2d, solver.idwt2d = fwd, inv
        check(trace.shape == (IS_ITERS,), f"operators: ista {label}: trace {trace.shape}")
        hold(f"ista {label}", got, want)
        hold(f"ista {label} objective trace", trace, want_trace)
        time_call(f"ista {label} {IS_N}x{IS_N} {WNAME} {IS_LEVELS} levels", call, card,
                  per=IS_ITERS)

    # -- the new operators on the batched 1D path's coefficients (1024 x
    # 4096, sym8, 4 levels), decimated and stationary
    w8 = get_wavelet(B1_WNAME)
    xs = torch.from_numpy(sig).to(dev)
    for swt in (False, True):
        kind = "SWT" if swt else "DWT"
        fwd_k, inv_k = ("swt_fwd_level_1d", "swt_inv_level_1d") if swt else ("fwd_level_1d",
                                                                             "inv_level_1d")
        S = Wavelets(xs, wname=B1_WNAME, levels=B1_LEVELS, ndim=1, do_swt=swt, device=dev)
        counted(f"1D {kind} forward", S.forward, {fwd_k})
        pc1 = (plain_swt1d if swt else plain_dwt1d)(xs, w8, B1_LEVELS)
        hold(f"1D {kind} forward", S.coeffs, pc1)
        scale1 = 2.0 * max_err(S.coeffs, pc1)[1]
        hold_estimators(f"estimators 1D {kind}", S.coeffs)
        # the signals are noise: a band's mean square m exceeds sigma^2 by
        # 1e-4 to 3e-3 of itself, and BayesShrink's rule multiplies its
        # inputs' difference by 1/2 m / (m - sigma^2), up to about 4000, so
        # the plain route takes the kernels' thresholds (held to float64
        # just above)
        betas1 = ops.bayes_thresholds(S.coeffs)
        b = 0.1
        for label, op, plain in (
                ("group_soft_threshold", lambda F: F.group_soft_threshold(b, normalize=True),
                 lambda c: ops.group_soft_threshold(c, b, normalize=True)),
                ("firm_threshold", lambda F: F.firm_threshold(b, 3 * b),
                 lambda c: ops.firm_threshold(c, b, 3 * b)),
                ("shrink", lambda F: F.shrink(0.5), lambda c: ops.shrink(c, 0.5)),
                ("proj_linf", lambda F: F.proj_linf(1.0), lambda c: ops.proj_linf(c, 1.0)),
                ("bayes_shrink", lambda F: F.bayes_shrink(),
                 lambda c: ops.soft_threshold(c, betas1))):
            F = S.copy()
            counted(f"1D {kind} {label}", lambda: op(F), ())
            hold(f"1D {kind} {label}", F.coeffs, plain(pc1), scale=scale1)
            F = S.copy()
            time_call(f"1D {kind} {label} {B1_SIGNALS}x{B1_N} {B1_WNAME} {B1_LEVELS} levels",
                      lambda: op(F), card)
        for label, got, want in (("norm_l21", S.norm_l21(), ops.norm_l21(pc1)),
                                 ("noise_sigma", S.noise_sigma(), ops.noise_sigma(pc1)),
                                 ("universal_threshold", S.universal_threshold(),
                                  ops.universal_threshold(pc1))):
            hold_value(f"1D {kind} {label}", got, want)
        F, H = S.copy(), S.copy()
        check(F.add_wavelet(H, 0.5) == 0, "operators: 1D add_wavelet")
        hold(f"1D {kind} add_wavelet", F.coeffs, ops.add_coeffs(pc1, pc1, 0.5), scale=scale1)
        check(torch.equal(S.circshift(0, 77, inplace=False), torch.roll(xs, 77, -1)),
              "operators: 1D circshift")
        check(torch.equal(S.get_coeff(B1_LEVELS, copy=False), S.coeffs.details[-1]),
              "operators: 1D get_coeff")
        F = S.copy()
        F.group_soft_threshold(b)
        out = counted(f"1D {kind} inverse after group_soft_threshold", F.inverse, {inv_k})
        pt = ops.group_soft_threshold(pc1, b)
        hold(f"1D {kind} inverse after group_soft_threshold", out,
             plain_iswt1d(pt, w8) if swt else plain_idwt1d(pt, w8, B1_N))

    # -- Haar on the card: the level kernels (the butterflies are the CPU's)
    hw = get_wavelet("haar")
    Hh = Wavelets(x, wname="haar", levels=LEVELS, device=dev)
    hc = counted("Haar 2D forward on the card", Hh.forward,
                 dwt2d_kernels(N, 2, LEVELS) & {"fwd_level_2d", "fwd_tail_2d"})
    hold("Haar 2D forward", hc, plain_dwt2d(x, hw, LEVELS))
    hy = counted("Haar 2D inverse on the card", Hh.inverse,
                 dwt2d_kernels(N, 2, LEVELS) & {"inv_level_2d", "inv_tail_2d"})
    hold("Haar 2D roundtrip", hy, x, ROUNDTRIP_ATOL / 255.0)
    Hs = Wavelets(xs, wname="haar", levels=B1_LEVELS, ndim=1, device=dev)
    hc1 = counted("Haar 1D forward on the card", Hs.forward, {"fwd_level_1d"})
    hold("Haar 1D forward", hc1, plain_dwt1d(xs, hw, B1_LEVELS))
    hy1 = counted("Haar 1D inverse on the card", Hs.inverse, {"inv_level_1d"})
    hold("Haar 1D inverse", hy1, plain_idwt1d(hc1, hw, B1_N))
    time_call(f"Haar 2D roundtrip {N}x{N} {LEVELS} levels",
              lambda: (Hh.forward(), Hh.inverse()), card)

    # -- demo.main, scenarios 1-3, on the 2048^2 image as a .dat file
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "img.dat")
        write_dat(path, dwt_img)
        common = [path, "--nr", str(N), "--nc", str(N), "--wavelet", WNAME, "--levels",
                  str(LEVELS), "--beta", str(BETA)]
        fwd_only = dwt_k & {"fwd_level_2d", "fwd_tail_2d"}
        for scenario, kern in (("1", fwd_only), ("2", dwt_k), ("3", dwt_k)):
            out_path = os.path.join(tmp, f"res{scenario}.dat")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = counted(f"demo scenario {scenario}", lambda: demo.main(
                    common + ["--scenario", scenario, "--out", out_path]), kern)
            text = buf.getvalue()
            check(rc == 0 and f"Running on device : cuda:{torch.cuda.get_device_name(dev)}"
                  in text, f"operators: demo scenario {scenario}: rc {rc}, output {text!r}")
            res = torch.from_numpy(np.fromfile(out_path, np.float32)).to(dev)
            if scenario == "1":
                hold("demo scenario 1 (approximation)", res.reshape(pc.approx.shape), pc.approx)
            elif scenario == "2":
                err = float((res.reshape(N, N) - x).abs().max())
                print(f"operators: demo scenario 2 max|y - x| {err:.3e} (limit "
                      f"{ROUNDTRIP_ATOL})", flush=True)
                check(err <= ROUNDTRIP_ATOL, "operators: demo scenario 2 roundtrip")
            else:
                hold("demo scenario 3", res.reshape(N, N),
                     plain_idwt2d(ops.soft_threshold(pc, BETA), wav, (N, N)))


# -- the boundary modes (queue 1 item 10): the padded entry points of kernels
# 1, 2, 7 and 8 on the mode route of the DWT path's image and the batched 1D
# path's signals
MODES_8 = ("zero", "constant", "symmetric", "reflect", "periodic", "smooth", "antisymmetric",
           "antireflect")
MIXED_MODE = ("symmetric", "periodization")
# a mode path against the same route on the padded kernels' plain versions:
# PATH_RTOL; against the plain extension route (JAX's fma formulation):
# MODE_ROUTE_RTOL, since the card's route extends both axes before it
# filters and the plain one extends each axis after the other's filtering,
# and where the extension is arithmetic (smooth, antireflect) the two round
# differently: 1.1e-5 of the largest coefficient for smooth at the 2048^2
# db7 cell on the CPU.  An arithmetic extension is held to MODE_ROUTE_RTOL
# against the same route too: its corners extrapolate along both axes,
# values far above the outputs, which the kernel sums rows first and the
# plain version columns first, and five levels compound it (2.4e-5 of the
# largest coefficient for smooth on an H100).  The scale of a synthesis is
# the largest of its inputs and outputs: its float32 roundoff is relative
# to its largest input
MODE_ROUTE_RTOL = 1e-4
ARITHMETIC_MODES = ("smooth", "antireflect")
# the roundtrip on [0, 255] data: ROUNDTRIP_ATOL, or MODE_RT_REL of the
# largest coefficient where that is more.  Smooth extrapolates hlen - 2
# samples along the edge slope at every level, so its coefficients reach
# 8.3e8 at the 2048^2 db7 cell and its float32 roundtrip 1.0e-2 (plain
# route) and 2.4e-2 (the padded route) on the CPU, 1.2e-11 and 2.9e-11 of
# that; every other mode keeps ROUNDTRIP_ATOL
MODE_RT_REL = 1e-10


def plain_mode_dwt2d(t, w, levels, mode, padded=False):
    """The mode route by plain PyTorch on the card, level by level: the conv
    passes with mode= (JAX's fma formulation, the CPU's route), or with
    ``padded`` the card's route on the padded kernels' plain versions."""
    from pdwt_tpu_torch import Coeffs2D
    from pdwt_tpu_torch.core import conv, modes
    from pdwt_tpu_torch.core import separable as sep
    from pdwt_tpu_torch.kernels import separable as K

    mode_r, mode_c = modes.per_axis(mode, 2)
    dec, hlen = (w.dec_lo, w.dec_hi), w.hlen
    a, dets = t[None, None], []
    for _ in range(levels):
        if padded:
            xp = sep.fwd_mode_pad(sep.fwd_mode_pad(a[0], -1, hlen, mode_c), -2, hlen, mode_r)
            z = torch.stack(K.fwd_level_2d_padded_ref(xp, *dec), 1)
        else:
            z = conv.analysis_pass(a, dec, axis=-1, mode=mode_c)
            z = conv.analysis_pass(z, dec, axis=-2, mode=mode_r)
        a = z[:, :1]
        dets.append(tuple(z[0, k] for k in (1, 2, 3)))
    return Coeffs2D(a[0, 0], tuple(dets))


def plain_mode_idwt2d(c, w, shape, mode, padded=False):
    from pdwt_tpu_torch.core import conv, modes
    from pdwt_tpu_torch.core import separable as sep
    from pdwt_tpu_torch.core.shapes import level_sizes
    from pdwt_tpu_torch.kernels import separable as K

    mode_r, mode_c = modes.per_axis(mode, 2)
    rec, hlen = (w.rec_lo, w.rec_hi), w.hlen
    rows = level_sizes(shape[0], c.levels, hlen, mode_r)
    cols = level_sizes(shape[1], c.levels, hlen, mode_c)
    a = c.approx
    for i in range(c.levels - 1, -1, -1):
        if padded:
            bands, c0 = [], [0, 0]
            for t in (a, *c.details[i]):
                t, c0[0] = sep.inv_mode_pad(t[None], -2, hlen, mode_r, rows[i])
                t, c0[1] = sep.inv_mode_pad(t, -1, hlen, mode_c, cols[i])
                bands.append(t)
            a = K.inv_level_2d_padded_ref(*bands, *rec, tuple(c0), (rows[i], cols[i]))[0]
            continue
        z = torch.stack([a, *c.details[i]])[None]
        t = conv.synthesis_pass(z, rec, -2, out_len=rows[i], mode=mode_r)
        a = conv.synthesis_pass(t, rec, -1, out_len=cols[i], mode=mode_c)[0, 0]
    return a


def plain_mode_dwt1d(t, w, levels, mode, padded=False):
    from pdwt_tpu_torch import Coeffs1D
    from pdwt_tpu_torch.core import conv
    from pdwt_tpu_torch.core import separable as sep
    from pdwt_tpu_torch.kernels import batched1d as K1

    a, dets = t, []
    for _ in range(levels):
        if padded:
            a, d = K1.fwd_level_1d_padded_ref(sep.fwd_mode_pad(a, -1, w.hlen, mode), w.dec_lo,
                                              w.dec_hi)
        else:
            z = conv.analysis_pass(a[:, None, None], (w.dec_lo, w.dec_hi), axis=-1, mode=mode)
            a, d = z[:, 0, 0], z[:, 1, 0]
        dets.append(d)
    return Coeffs1D(a, tuple(dets))


def plain_mode_idwt1d(c, w, n, mode, padded=False):
    from pdwt_tpu_torch.core import conv
    from pdwt_tpu_torch.core.shapes import level_sizes
    from pdwt_tpu_torch.kernels import batched1d as K1

    sizes = level_sizes(n, c.levels, w.hlen, mode)
    a = c.approx
    for i in range(c.levels - 1, -1, -1):
        if padded:  # a pywt axis: the bands as they are, offset -1
            a = K1.inv_level_1d_padded_ref(a, c.details[i], w.rec_lo, w.rec_hi, -1, sizes[i])
            continue
        z = torch.stack([a, c.details[i]], 1)[:, :, None]
        a = conv.synthesis_pass(z, (w.rec_lo, w.rec_hi), -1, out_len=sizes[i], mode=mode)[:, 0, 0]
    return a


def padded_band(kind: str, n: int, w, device, c0: int = 0, out: int = 0) -> torch.Tensor:
    """The dense band matrix of a padded 1D pass from its plain version on
    the identity: the analysis of n extended samples, x @ M -> [lo | hi];
    the synthesis of n coefficients a band at offset c0, [lo | hi] @ M."""
    from pdwt_tpu_torch.kernels import batched1d as K1

    key = ("padded", kind, n, w.name, c0, out, str(device))
    if key not in _BANDS:
        eye = torch.eye(n, device=device)
        if kind == "fwd":
            m = torch.cat(K1.fwd_level_1d_padded_ref(eye, w.dec_lo, w.dec_hi), 1)
        else:
            z = torch.zeros_like(eye)
            m = torch.cat([K1.inv_level_1d_padded_ref(eye, z, w.rec_lo, w.rec_hi, c0, out),
                           K1.inv_level_1d_padded_ref(z, eye, w.rec_lo, w.rec_hi, c0, out)], 0)
        _BANDS[key] = m.contiguous()
    return _BANDS[key]


def padded_yardstick(kind: str, w, c0=(0, 0), out=(0, 0), dtype=torch.float32) -> Callable:
    """arg -> () -> the dense-band torch.matmul yardstick of a padded call
    (``yardstick``'s, on ``padded_band``): rows then columns in 2D; bands
    and inputs in ``dtype``."""
    def band(k, n, dev, i=0):
        return padded_band(k, n, w, dev, c0[i], out[i]).to(dtype)

    def make(arg):
        if kind == "fwd2d":
            A = band("fwd", arg.shape[-2], arg.device).t().contiguous()
            B, xm = band("fwd", arg.shape[-1], arg.device), arg[0].to(dtype)
            return lambda: (A @ xm) @ B
        if kind == "inv2d":
            a, h, v, d = (t[0].to(dtype) for t in arg)
            P = torch.cat([torch.cat([a, v], 1), torch.cat([h, d], 1)], 0)
            A = band("inv", a.shape[0], a.device, 0).t().contiguous()
            B = band("inv", a.shape[1], a.device, 1)
            return lambda: (A @ P) @ B
        if kind == "fwd":
            xm, Mx = arg.to(dtype), band("fwd", arg.shape[-1], arg.device)
            return lambda: xm @ Mx
        u = torch.cat([t.to(dtype) for t in arg], 1)
        Mx = band("inv", arg[0].shape[-1], u.device)
        return lambda: u @ Mx
    return make


def padded_cases(K, K1, sep, w, shape, mode, rand, timed=False, label=""):
    """Cases of the padded entry points on one level of the mode route:
    the forward on an image (or signals) extended as the route extends it,
    and the inverse on random subbands of the forward's sizes, padded as the
    route pads them, back to ``shape``."""
    hlen, cases = w.hlen, []
    if len(shape) == 3:
        mode_r, mode_c = (mode, mode) if isinstance(mode, str) else mode
        xp = sep.fwd_mode_pad(sep.fwd_mode_pad(rand(*shape), -1, hlen, mode_c), -2, hlen, mode_r)
        ro, co = ((n - hlen) // 2 + 1 for n in xp.shape[1:])
        cases.append(Case("fwd_level_2d_padded", xp,
                          lambda t: K.fwd_level_2d_padded(t, w.dec_lo, w.dec_hi),
                          lambda t: K.fwd_level_2d_padded_ref(t, w.dec_lo, w.dec_hi),
                          f"{label}{w.name} {mode} image {shape}", timed,
                          flops_2d(2 * ro, 2 * co, hlen), library=padded_yardstick("fwd2d", w)))
        if hlen % 2:
            return cases
        bands, c0 = [], [0, 0]
        for t in (rand(shape[0], ro, co) for _ in range(4)):
            t, c0[0] = sep.inv_mode_pad(t, -2, hlen, mode_r, shape[1])
            t, c0[1] = sep.inv_mode_pad(t, -1, hlen, mode_c, shape[2])
            bands.append(t.contiguous())
        out, c0 = tuple(shape[1:]), tuple(c0)
        cases.append(Case("inv_level_2d_padded", bands,
                          lambda b: K.inv_level_2d_padded(*b, w.rec_lo, w.rec_hi, c0, out),
                          lambda b: K.inv_level_2d_padded_ref(*b, w.rec_lo, w.rec_hi, c0, out),
                          f"{label}{w.name} {mode} subbands {(shape[0], ro, co)} -> {out}",
                          timed, flops_2d(*out, hlen),
                          library=padded_yardstick("inv2d", w, c0, out)))
        return cases
    xp = sep.fwd_mode_pad(rand(*shape), -1, hlen, mode)
    n_out = (xp.shape[1] - hlen) // 2 + 1
    cases.append(Case("fwd_level_1d_padded", xp,
                      lambda t: K1.fwd_level_1d_padded(t, w.dec_lo, w.dec_hi),
                      lambda t: K1.fwd_level_1d_padded_ref(t, w.dec_lo, w.dec_hi),
                      f"{label}{w.name} {mode} signals {shape}", timed,
                      flops_1d(shape[0], 2 * n_out, hlen), library=padded_yardstick("fwd", w)))
    if hlen % 2 == 0:
        padded = [sep.inv_mode_pad(rand(shape[0], n_out), -1, hlen, mode, shape[1])
                  for _ in range(2)]
        pair, c0 = [t.contiguous() for t, _ in padded], padded[0][1]
        cases.append(Case("inv_level_1d_padded", pair,
                          lambda b: K1.inv_level_1d_padded(*b, w.rec_lo, w.rec_hi, c0, shape[1]),
                          lambda b: K1.inv_level_1d_padded_ref(*b, w.rec_lo, w.rec_hi, c0,
                                                               shape[1]),
                          f"{label}{w.name} {mode} bands {(shape[0], n_out)} -> {shape[1]}",
                          timed, flops_1d(shape[0], shape[1], hlen),
                          library=padded_yardstick("inv", w, (c0,), (shape[1],))))
    return cases


def mode_path(label, mode, fwd, inv, plain_fwd, plain_inv, x, per_kernel) -> dict:
    """One mode transform forward then inverse between a reset and a read
    of the launch counters: exactly ``per_kernel`` launches of each padded
    kernel named there (every level on the padded kernels, nothing else);
    finite outputs, of the plain routes' shapes and dtypes; coefficients and
    reconstruction held to the same route on the padded kernels' plain
    versions (``plain_fwd(x, padded=True)``, PATH_RTOL; MODE_ROUTE_RTOL for
    an arithmetic extension) and to the plain extension route
    (MODE_ROUTE_RTOL); the roundtrip within ROUNDTRIP_ATOL or
    MODE_RT_REL of the largest coefficient.  Returns the launches."""
    from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    c = fwd(x)
    y = inv(c)
    torch.cuda.synchronize()
    got = {k: v for k, v in LAUNCHES.items() if v}
    print(f"modes: {label}: launches {got}", flush=True)
    check(got == per_kernel, f"modes: {label} launched {got}, expected {per_kernel}")
    cscale = max_err(c, c)[1]
    arithmetic = any(m in ARITHMETIC_MODES for m in ((mode,) if isinstance(mode, str) else mode))
    for route, rtol in (("padded", MODE_ROUTE_RTOL if arithmetic else PATH_RTOL),
                        ("plain", MODE_ROUTE_RTOL)):
        pc = plain_fwd(x, padded=route == "padded")
        py = plain_inv(pc, padded=route == "padded")
        check(all(g.dtype == w.dtype and g.shape == w.shape and bool(torch.isfinite(g).all())
                  for g, w in zip(leaves(c) + [y], leaves(pc) + [py])),
              f"modes: {label}: not finite, or dtypes or shapes differ from the {route} route")
        err, scale = max_err(c, pc)
        yerr, yscale = max_err(y, py)
        yscale = max(yscale, cscale)
        print(f"modes: {label}: vs the {route} route: coefficients {err:.3e} (limit "
              f"{rtol * scale:.3e}), inverse {yerr:.3e} (limit {rtol * yscale:.3e})", flush=True)
        check(err <= rtol * scale and yerr <= rtol * yscale,
              f"modes: {label} disagrees with the {route} route")
    rt, limit = float((y - x).abs().max()), max(ROUNDTRIP_ATOL, MODE_RT_REL * cscale)
    print(f"modes: {label}: roundtrip max|y - x| {rt:.3e} (limit {limit:.3e}; largest "
          f"coefficient {cscale:.4g})", flush=True)
    check(rt <= limit, f"modes: {label} roundtrip error {rt:.3e}")
    return got


def modes_phase(dev, card, report, launches, dwt_img, rt_sig, gen) -> None:
    """The boundary modes: the four padded entry points against their plain
    versions (every mode, odd sides, signals shorter than the filter, 2 to
    20 taps, the mixed periodization tuple; timed at the main paths'
    shapes), then the paths a user drives, each between a reset and a read
    of the launch counters: the 2048^2 db7 5-level symmetric roundtrip and
    the 1024 x 4096 sym8 4-level one through ``dwt2d``/``idwt2d``,
    ``dwt1d``/``idwt1d`` and the facade, timed beside the plain route; the
    2048^2 roundtrip under each other mode; ``Wavelets`` with a per-axis
    tuple mixing in periodization; ``denoise_step(boundary=)`` at 1024^2."""
    from pdwt_tpu_torch import (Wavelets, dwt1d, dwt2d, get_wavelet, idwt1d, idwt2d, ops)
    from pdwt_tpu_torch.core import separable as sep
    from pdwt_tpu_torch.core.shapes import level_sizes
    from pdwt_tpu_torch.filters import make_custom_wavelet
    from pdwt_tpu_torch.kernels import batched1d as K1
    from pdwt_tpu_torch.kernels import separable as K
    from pdwt_tpu_torch.models import denoise_step

    print("=== boundary modes ===", flush=True)
    wav, w8 = get_wavelet(WNAME), get_wavelet(B1_WNAME)
    rand = lambda *s: torch.rand(s, device=dev, generator=gen) * 255.0
    # -- the kernels at the main paths' shapes (timed), then the code paths
    cases = []
    for n in level_sizes(N, LEVELS, wav.hlen, "symmetric")[:-1]:
        cases += padded_cases(K, K1, sep, wav, (1, n, n), "symmetric", rand, True)
    for n in level_sizes(B1_N, B1_LEVELS, w8.hlen, "symmetric")[:-1]:
        cases += padded_cases(K, K1, sep, w8, (B1_SIGNALS, n), "symmetric", rand, True)
    banks = [get_wavelet(n) for n in ("haar", "db2", "db3", "sym4", "db5", "db7", "sym8",
                                      "db10")]  # 2 to 20 taps
    odd5 = make_custom_wavelet("odd5", *np.random.default_rng(5).standard_normal((4, 5)))
    shapes = [(1, 37, 53), (2, 5, 7), (3, 64, 31), (1, 2, 9), (1, 130, 18)]
    for i, mode in enumerate(MODES_8 + (MIXED_MODE, ("periodization", "zero"))):
        w = banks[i % len(banks)]
        cases += padded_cases(K, K1, sep, w, shapes[i % len(shapes)], mode, rand)
        cases += padded_cases(K, K1, sep, w, ((33, 29), (2, 3), (1, 300))[i % 3],
                              mode if isinstance(mode, str) else mode[0], rand)
    cases += padded_cases(K, K1, sep, odd5, (2, 19, 24), "smooth", rand)  # odd taps: forward
    cases += padded_cases(K, K1, sep, banks[-1], (70000, 2, 2), "reflect", rand)  # past grid z
    run_cases(cases, report, card)

    # -- the full-width 2D path, as a user drives it
    x = torch.from_numpy(dwt_img).to(dev)
    per2 = {"fwd_level_2d_padded": LEVELS, "inv_level_2d_padded": LEVELS}
    fwd2 = lambda m: (lambda t, **k: plain_mode_dwt2d(t, wav, LEVELS, m, **k))
    inv2 = lambda m: (lambda c, **k: plain_mode_idwt2d(c, wav, (N, N), m, **k))
    launches.update(mode_path(f"dwt2d/idwt2d {N}x{N} {WNAME} {LEVELS} levels symmetric",
                              "symmetric", lambda t: dwt2d(t, wav, LEVELS, mode="symmetric"),
                              lambda c: idwt2d(c, wav, (N, N), mode="symmetric"),
                              fwd2("symmetric"), inv2("symmetric"), x, per2))
    W = Wavelets(x, wname=WNAME, levels=LEVELS, mode="symmetric", device=dev)
    check(W.info()["mode"] == "symmetric", "modes: info() mode")
    mode_path("facade symmetric", "symmetric", lambda t: W.forward(), lambda c: W.inverse(),
              fwd2("symmetric"), inv2("symmetric"), x, per2)
    time_in_turns(f"mode roundtrip {N}x{N} {WNAME} {LEVELS} levels symmetric",
                  lambda: idwt2d(dwt2d(x, wav, LEVELS, mode="symmetric"), wav, (N, N),
                                 mode="symmetric"),
                  lambda: plain_mode_idwt2d(plain_mode_dwt2d(x, wav, LEVELS, "symmetric"), wav,
                                            (N, N), "symmetric"), card)

    # -- the batched 1D path
    xr = torch.from_numpy(rt_sig).to(dev)
    per1 = {"fwd_level_1d_padded": B1_LEVELS, "inv_level_1d_padded": B1_LEVELS}
    fwd1 = lambda t, **k: plain_mode_dwt1d(t, w8, B1_LEVELS, "symmetric", **k)
    inv1 = lambda c, **k: plain_mode_idwt1d(c, w8, B1_N, "symmetric", **k)
    launches.update(mode_path(f"dwt1d/idwt1d {B1_SIGNALS}x{B1_N} {B1_WNAME} {B1_LEVELS} levels "
                              "symmetric", "symmetric",
                              lambda t: dwt1d(t, w8, B1_LEVELS, mode="symmetric"),
                              lambda c: idwt1d(c, w8, B1_N, mode="symmetric"), fwd1, inv1, xr,
                              per1))
    S = Wavelets(xr, wname=B1_WNAME, levels=B1_LEVELS, ndim=1, mode="symmetric", device=dev)
    mode_path("facade 1D symmetric", "symmetric", lambda t: S.forward(), lambda c: S.inverse(),
              fwd1, inv1, xr, per1)
    time_in_turns(f"mode roundtrip {B1_SIGNALS}x{B1_N} {B1_WNAME} {B1_LEVELS} levels symmetric",
                  lambda: idwt1d(dwt1d(xr, w8, B1_LEVELS, mode="symmetric"), w8, B1_N,
                                 mode="symmetric"),
                  lambda: inv1(fwd1(xr)), card)

    # -- once each through the higher layers: the other modes, the mixed
    # tuple through the facade, the denoise step
    for mode in MODES_8:
        if mode != "symmetric":
            mode_path(f"{N}x{N} roundtrip {mode}", mode,
                      lambda t, m=mode: dwt2d(t, wav, LEVELS, mode=m),
                      lambda c, m=mode: idwt2d(c, wav, (N, N), mode=m), fwd2(mode), inv2(mode),
                      x, per2)
    T = Wavelets(x, wname=WNAME, levels=LEVELS, mode=MIXED_MODE, device=dev)
    mode_path(f"facade {MIXED_MODE}", MIXED_MODE, lambda t: T.forward(), lambda c: T.inverse(),
              fwd2(MIXED_MODE), inv2(MIXED_MODE), x, per2)
    from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    xd = x[:TI_N, :TI_N].contiguous()
    torch.cuda.synchronize()
    reset_launch_counts()
    out, n1 = denoise_step(xd, None, WNAME, TI_LEVELS, TI_BETA, boundary="symmetric")
    torch.cuda.synchronize()
    got = {k: v for k, v in LAUNCHES.items() if v}
    want = {"fwd_level_2d_padded": TI_LEVELS, "inv_level_2d_padded": TI_LEVELS}
    print(f"modes: denoise_step {TI_N}x{TI_N} boundary symmetric: launches {got}", flush=True)
    check(got == want, f"modes: denoise_step launched {got}, expected {want}")
    pc = ops.soft_threshold(plain_mode_dwt2d(xd, wav, TI_LEVELS, "symmetric"), TI_BETA)
    err, scale = max_err(out, plain_mode_idwt2d(pc, wav, (TI_N, TI_N), "symmetric"))
    p_n1 = float(ops.norm1(pc))
    print(f"modes: denoise_step vs plain route {err:.3e} (limit {PATH_RTOL * scale:.3e}); "
          f"norm1 {float(n1)!r} vs {p_n1!r}", flush=True)
    check(err <= PATH_RTOL * scale and abs(float(n1) - p_n1) <= PATH_RTOL * abs(p_n1),
          "modes: denoise_step disagrees with the plain route")
    time_call("denoise_step 1024^2 boundary symmetric",
              lambda: denoise_step(xd, None, WNAME, TI_LEVELS, TI_BETA, boundary="symmetric"),
              card)



# -- the sharded transforms

# the sharded phase's cases: the 2D DWT roundtrip (N, WNAME, LEVELS), the
# TI step at TI_N, the batched 1D cell, and halos wider than a shard: sym8
# over 4 shards of 64 samples, whose level-4 halo sides (56 and 64 samples,
# a span of 120) take one hop each and level 5's (112 and 128) two
SHARD_WIDE, SHARD_WIDE_LEVELS = (8, 256), 5
#: seconds a rank waits on another before the run fails
SHARD_TIMEOUT_S = 300
#: the ranks' device (a CPU rehearsal of the phase sets "cpu")
SHARD_DEVICE = torch.device("cuda", 0)
# the sharded volumes and non-separable transforms in (b): a volume whose
# 4-plane shards on dep = 4 take level 2's halos in several hops, one whose
# (2, 2) shards (4 x 64 x 512) put level 1 on the banded-product kernels;
# an image for the ring, a bf16 batch whose 64 x 256 images put level 1 on
# kernels 17 and 18
SH3_SMALL, SH3_TIER = (16, 64, 64), (8, 128, 512)
# the sharded 1D starlet and packets in (b): 64 signals of the 1D cell's
# length over 4 column shards
SHARD_SIG = (64, 4096)
SHNS_N, SHNS_BATCH = 64, (4, 64, 256)
AXES4 = ("data", "dep", "row", "col")


def atrous_band(kind: str, n: int, w, level: int, device) -> torch.Tensor:
    """The dense band matrix of a padded a-trous 1D pass from its plain
    version on the identity: the analysis of n samples with their halo, x @
    M -> [lo | hi]; the synthesis of two such bands, [lo | hi] @ M."""
    from pdwt_tpu_torch.kernels import batched1d as K1

    key = ("atrous", kind, n, w.name, level, str(device))
    if key not in _BANDS:
        eye = torch.eye(n, device=device)
        if kind == "fwd":
            m = torch.cat(K1.swt_fwd_level_1d_padded_ref(eye, w.dec_lo, w.dec_hi, level), 1)
        else:
            z = torch.zeros_like(eye)
            m = torch.cat([K1.swt_inv_level_1d_padded_ref(eye, z, w.rec_lo, w.rec_hi, level),
                           K1.swt_inv_level_1d_padded_ref(z, eye, w.rec_lo, w.rec_hi, level)], 0)
        _BANDS[key] = m.contiguous()
    return _BANDS[key]


def atrous_yardstick(kind: str, w, level: int, dtype=torch.float32) -> Callable:
    """arg -> () -> the dense-band torch.matmul yardstick of a padded
    a-trous call (``yardstick``'s, on ``atrous_band``): rows then columns
    in 2D; bands and inputs in ``dtype``."""
    def band(k, n, dev):
        return atrous_band(k, n, w, level, dev).to(dtype)

    def make(arg):
        if kind == "fwd2d":
            A = band("fwd", arg.shape[-2], arg.device).t().contiguous()
            B, xm = band("fwd", arg.shape[-1], arg.device), arg[0].to(dtype)
            return lambda: (A @ xm) @ B
        if kind == "inv2d":
            a, h, v, d = (t[0].to(dtype) for t in arg)
            P = torch.cat([torch.cat([a, v], 1), torch.cat([h, d], 1)], 0)
            A = band("inv", a.shape[0], a.device).t().contiguous()
            B = band("inv", a.shape[1], a.device)
            return lambda: (A @ P) @ B
        if kind == "fwd":
            xm, Mx = arg.to(dtype), band("fwd", arg.shape[-1], arg.device)
            return lambda: xm @ Mx
        u = torch.cat([t.to(dtype) for t in arg], 1)
        Mx = band("inv", arg[0].shape[-1], u.device)
        return lambda: u @ Mx
    return make


def atrous_cases(w, shape, level, rand, timed=False, label=""):
    """The padded a-trous entry points on one level of a sharded SWT: the
    forward on a shard wrapped by its halo (``kernels.swt_fwd_halo``), the
    inverse on bands wrapped by theirs; 2D for a (B, r, c) shard, 1D for a
    (B, n) one."""
    from pdwt_tpu_torch import kernels as KK
    from pdwt_tpu_torch.core import conv
    from pdwt_tpu_torch.kernels import batched1d as K1
    from pdwt_tpu_torch.kernels import swt as S

    axes = (-1, -2) if len(shape) == 3 else (-1,)

    def halo(t, lohi):
        for ax in axes:
            t = conv.wrap_pad(t, ax, *lohi)
        return t.contiguous()

    fh, ih = KK.swt_fwd_halo(w.hlen, level), KK.swt_inv_halo(w.hlen, level)
    xp, bands = halo(rand(*shape), fh), [halo(rand(*shape), ih) for _ in range(4)]
    tag = f"{label}{w.name} level {level} shard {shape}"
    if len(shape) == 3:
        return [Case("swt_fwd_level_2d_padded", xp,
                     lambda t: S.swt_fwd_level_2d_padded(t, w.dec_lo, w.dec_hi, level),
                     lambda t: S.swt_fwd_level_2d_padded_ref(t, w.dec_lo, w.dec_hi, level),
                     tag, timed, flops_swt_2d(*shape[1:], w.hlen),
                     library=atrous_yardstick("fwd2d", w, level)),
                Case("swt_inv_level_2d_padded", bands,
                     lambda b: S.swt_inv_level_2d_padded(*b, w.rec_lo, w.rec_hi, level),
                     lambda b: S.swt_inv_level_2d_padded_ref(*b, w.rec_lo, w.rec_hi, level),
                     tag, timed, flops_swt_2d(*shape[1:], w.hlen),
                     library=atrous_yardstick("inv2d", w, level))]
    return [Case("swt_fwd_level_1d_padded", xp,
                 lambda t: K1.swt_fwd_level_1d_padded(t, w.dec_lo, w.dec_hi, level),
                 lambda t: K1.swt_fwd_level_1d_padded_ref(t, w.dec_lo, w.dec_hi, level),
                 tag, timed, flops_1d(*shape, w.hlen, swt=True),
                 library=atrous_yardstick("fwd", w, level)),
            Case("swt_inv_level_1d_padded", bands[:2],
                 lambda b: K1.swt_inv_level_1d_padded(*b, w.rec_lo, w.rec_hi, level),
                 lambda b: K1.swt_inv_level_1d_padded_ref(*b, w.rec_lo, w.rec_hi, level),
                 tag, timed, flops_1d(*shape, w.hlen, swt=True),
                 library=atrous_yardstick("inv", w, level))]


def mxu_padded_cases(w, shape, rand, schemes, dts, level=0, timed=False, row=False, label=""):
    """The padded entry points of kernels 11-16 on one level of a sharded
    transform: the forward on a shard of ``shape`` ((B, r, c): 11p, or 13p
    at ``level`` > 0; (B, n): 15p) wrapped as the sharded compositions wrap
    it (the periodic wrap standing in for the ring), the inverse (12p or
    14p; 16p) on random subbands of the forward's output size wrapped as
    theirs.  ``schemes`` = (forward, inverse); ``dts`` = (the forward's
    input, its details, the inverse's details, its output) dtypes."""
    from pdwt_tpu_torch import kernels as KK
    from pdwt_tpu_torch.core import conv
    from pdwt_tpu_torch.core.separable import fwd_mode_pad, inv_mode_pad
    from pdwt_tpu_torch.kernels import matmul as M
    from pdwt_tpu_torch.kernels import mxu1d as M1
    from pdwt_tpu_torch.kernels import swt_matmul as SM

    (fs, isch), (in_dt, det, idet, out) = schemes, dts
    f32, two, hlen = torch.float32, len(shape) == 3, w.hlen
    axes = (-2, -1) if two else (-1,)
    dn = lambda t: str(t).split(".")[-1]
    tag = (f"{label}{w.name} {fs}/{isch}{f' level {level}' if level else ''} shard {shape}: "
           f"{dn(in_dt)} in, {dn(det)} details; {dn(idet)} details, {dn(out)} out")
    nb = 3 if two else 1
    bf16 = torch.bfloat16  # the tier rows' yardstick dtype
    lib = (lambda kind, **kw: None if not row else
           atrous_yardstick(kind, w, level, bf16) if level else
           padded_yardstick(kind, w, dtype=bf16, **kw))
    kinds = ("fwd2d", "inv2d") if two else ("fwd", "inv")
    if level:
        def wrap(t, lohi):
            for ax in axes:
                t = conv.wrap_pad(t, ax, *lohi)
            return t.contiguous()

        fh, ih = KK.swt_fwd_halo(hlen, level), KK.swt_inv_halo(hlen, level)
        xp = wrap(rand(*shape).to(in_dt), fh)
        bands = [wrap(rand(*shape), ih)] + [wrap((rand(*shape) - 127.5).to(idet), ih)
                                            for _ in range(nb)]
        flops = (flops_swt_2d(*shape[1:], hlen) if two
                 else flops_1d(*shape, hlen, swt=True))
        flops_f, flops_i = flops * TERMS[fs], flops * TERMS[isch]
        if two:
            fwd = ("swt_fwd_level_2d_mxu_padded",
                   lambda t: SM.swt_fwd_level_2d_mxu_padded(t, w.dec_lo, w.dec_hi, level, fs,
                                                            (f32, det)),
                   lambda t: SM.swt_fwd_level_2d_mxu_padded_ref(t, w.dec_lo, w.dec_hi, level,
                                                                fs, (f32, det)))
            inv = ("swt_inv_level_2d_mxu_padded",
                   lambda b: SM.swt_inv_level_2d_mxu_padded(*b, w.rec_lo, w.rec_hi, level, isch,
                                                            out),
                   lambda b: SM.swt_inv_level_2d_mxu_padded_ref(*b, w.rec_lo, w.rec_hi, level,
                                                                isch, out))
        else:
            fwd = ("swt_fwd_level_1d_mxu_padded",
                   lambda t: M1.swt_fwd_level_1d_mxu_padded(t, w.dec_lo, w.dec_hi, level, fs,
                                                            det),
                   lambda t: M1.swt_fwd_level_1d_mxu_padded_ref(t, w.dec_lo, w.dec_hi, level,
                                                                fs, det))
            inv = ("swt_inv_level_1d_mxu_padded",
                   lambda b: M1.swt_inv_level_1d_mxu_padded(*b, w.rec_lo, w.rec_hi, level, isch,
                                                            out),
                   lambda b: M1.swt_inv_level_1d_mxu_padded_ref(*b, w.rec_lo, w.rec_hi, level,
                                                                isch, out))
        yf, yi = lib(kinds[0]), lib(kinds[1])
    else:
        xp = rand(*shape).to(in_dt)
        for ax in axes[::-1]:
            xp = fwd_mode_pad(xp, ax, hlen, "periodization")
        xp = xp.contiguous()
        sub = shape[:1] + tuple((n + 1) // 2 for n in shape[1:])
        bands, c0 = [], ()
        for t in [rand(*sub)] + [(rand(*sub) - 127.5).to(idet) for _ in range(nb)]:
            c0 = []
            for ax, n in zip(axes, shape[1:]):
                t, c = inv_mode_pad(t, ax, hlen, "periodization", n)
                c0.append(c)
            bands.append(t.contiguous())
        c0, o = tuple(c0), tuple(shape[1:])
        if two:
            fwd = ("fwd_level_2d_mxu_padded",
                   lambda t: M.fwd_level_2d_mxu_padded(t, w.dec_lo, w.dec_hi, fs, (f32, det)),
                   lambda t: M.fwd_level_2d_mxu_padded_ref(t, w.dec_lo, w.dec_hi, fs,
                                                           (f32, det)))
            inv = ("inv_level_2d_mxu_padded",
                   lambda b: M.inv_level_2d_mxu_padded(*b, w.rec_lo, w.rec_hi, isch, c0, o, out),
                   lambda b: M.inv_level_2d_mxu_padded_ref(*b, w.rec_lo, w.rec_hi, isch, c0, o,
                                                           out))
            flops_f, flops_i = (flops_2d(*shape[1:], hlen, TERMS[fs]),
                                flops_2d(*shape[1:], hlen, TERMS[isch]))
        else:
            fwd = ("fwd_level_1d_mxu_padded",
                   lambda t: M1.fwd_level_1d_mxu_padded(t, w.dec_lo, w.dec_hi, fs, det),
                   lambda t: M1.fwd_level_1d_mxu_padded_ref(t, w.dec_lo, w.dec_hi, fs, det))
            inv = ("inv_level_1d_mxu_padded",
                   lambda b: M1.inv_level_1d_mxu_padded(*b, w.rec_lo, w.rec_hi, isch, c0[0],
                                                        o[0], out),
                   lambda b: M1.inv_level_1d_mxu_padded_ref(*b, w.rec_lo, w.rec_hi, isch,
                                                            c0[0], o[0], out))
            flops_f, flops_i = (flops_1d(*shape, hlen, TERMS[fs]),
                                flops_1d(*shape, hlen, TERMS[isch]))
        yf, yi = lib(kinds[0]), lib(kinds[1], c0=c0 + (0,) * (2 - len(c0)),
                                    out=o + (0,) * (2 - len(o)))
    return [Case(fwd[0], xp, fwd[1], fwd[2], tag, timed, flops_f, scheme_peak(fs),
                 scheme_limit(fs), yf, row),
            Case(inv[0], bands, inv[1], inv[2], tag, timed, flops_i, scheme_peak(isch),
                 scheme_limit(isch), yi, row)]


def tier_shard_cases(rand, timed_tier=ROW_TIER) -> list:
    """Every call of kernels 11-16 a rank makes in (b), under each tier, on
    its shards: the DWT cell's 1024^2 (levels 1-5), the TI step's 512^2
    (levels 1-3) and the 1D cell's 1024 x 1024 (levels 1-4), each level
    the route rule accepts on the shard, in the schemes and dtypes the
    tier's rules (kernels/matmul.py's, swt_matmul.swt2d_inv_plan,
    mxu1d._swt_inv_plan) give it; ``timed_tier``'s calls timed, in their
    kernels' rows.  A call two tiers make alike is held once."""
    from pdwt_tpu_torch import get_wavelet, precision_scope
    from pdwt_tpu_torch import kernels as KK
    from pdwt_tpu_torch.kernels import matmul as M
    from pdwt_tpu_torch.kernels import mxu1d as M1
    from pdwt_tpu_torch.kernels import swt_matmul as SM

    bf16, f32 = torch.bfloat16, torch.float32
    wav, w8 = get_wavelet(WNAME), get_wavelet(B1_WNAME)
    cases, seen = [], set()
    for tier in TIERS:
        row = tier == timed_tier
        bf, mode = tier != "mixed", ("bf16" if tier != "mixed" else "mixed")
        det = bf16 if bf else f32

        def add(w, shape, level, in_dt, out_dt, fwd_rule, inv_rule):
            fs, (isch, out) = fwd_rule(mode, in_dt), inv_rule(mode, out_dt)
            key = (tier if row else "", w.name, shape, level, fs, isch, in_dt, out)
            if key not in seen:
                seen.add(key)
                cases.extend(mxu_padded_cases(w, shape, rand, (fs, isch), (in_dt, det, det, out),
                                              level, row, row, f"{tier} "))

        with precision_scope(tier):
            for lvl in range(1, LEVELS + 1):  # the DWT cell, 2 x 2 shards
                n = (N // 2) >> (lvl - 1)
                if KK.mxu_route_2d(n // 2, n // 2, wav.hlen):
                    first = bf16 if bf and lvl == 1 else f32
                    add(wav, (1, n, n), 0, first, first, M.mode_scheme, M.inv_plan)
            for lvl in range(1, B1_LEVELS + 1):  # the 1D cell, 4 column shards
                n = (B1_N // 4) >> (lvl - 1)
                if KK.mxu_route_1d(B1_SIGNALS, n, w8.hlen):
                    first = bf16 if bf and lvl == 1 else f32
                    add(w8, (B1_SIGNALS, n), 0, first, first, M.mode_scheme, M.inv_plan)
            if not bf:
                continue  # mixed runs the stationary transforms exact
            for lvl in range(1, TI_LEVELS + 1):  # the TI step, 2 x 2 shards
                if KK.mxu_route_swt_2d(TI_N // 2, TI_N // 2, wav.hlen, lvl):
                    first = bf16 if lvl == 1 else f32
                    add(wav, (1, TI_N // 2, TI_N // 2), lvl, first, first, M.swt_scheme,
                        SM.swt2d_inv_plan)
            for lvl in range(1, B1_LEVELS + 1):
                if KK.mxu_route_1d(B1_SIGNALS, B1_N // 4, w8.hlen, level=lvl):
                    first = bf16 if lvl == 1 else f32
                    add(w8, (B1_SIGNALS, B1_N // 4), lvl, first, first, M.swt_scheme,
                        M1._swt_inv_plan)
    return cases


def sharded_call(tag: str, fn, want: dict):
    """fn() between a reset and a read of the launch counters on this
    rank: exactly the padded launches ``want``."""
    from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in LAUNCHES.items() if v}
    print(f"{tag}: launches {got}", flush=True)
    check(got == want, f"{tag} launched {got}, expected {want}")
    return out


def hold_shards(tag: str, got, want, tier: bool = False) -> None:
    """Every band's shard on this rank against the same slice of the
    single-card result: one dtype and shape, finite, within PATH_RTOL of
    the call's largest single-card value; under a tier (``tier``) each band
    within the tier path limits of its own largest value (PATH_TIER_RTOL
    float32, PATH_BF16_RTOL bf16: a level the route rule sends to the
    banded-product kernel on one card may run exact on the shard)."""
    from pdwt_tpu_torch.parallel.sharded import _local  # a full tensor's shard, no gather

    gl, wl = leaves(got), leaves(want)
    mine = [g.to_local() for g in gl]
    theirs = [_local(w, g.device_mesh, g.placements) for g, w in zip(gl, wl)]
    check(len(gl) == len(wl) and all(m.dtype == t.dtype and m.shape == t.shape
                                     and bool(torch.isfinite(m).all())
                                     for m, t in zip(mine, theirs)),
          f"{tag}: not finite, or dtypes or shapes differ from the single-card result")
    if tier:
        worst = 0.0
        for m, t, w in zip(mine, theirs, wl):
            err, scale = max_err(m, t)[0], float(w.float().abs().max())
            lim = PATH_BF16_RTOL if w.dtype == torch.bfloat16 else PATH_TIER_RTOL
            check(err <= lim * scale, f"{tag} disagrees with the single-card transform: "
                  f"{err:.3e} > {lim * scale:.3e} ({w.dtype})")
            worst = max(worst, err / max(scale, 1e-30))
        print(f"{tag} vs single card: worst relative {worst:.3e}", flush=True)
        return
    err = max(float((m - t).abs().max()) for m, t in zip(mine, theirs))
    scale = max(float(w.abs().max()) for w in wl)
    print(f"{tag} vs single card: max|diff| {err:.3e} (limit {PATH_RTOL * scale:.3e})",
          flush=True)
    check(err <= PATH_RTOL * scale, f"{tag} disagrees with the single-card transform")


def _rank_image(shape, seed: int, dev) -> torch.Tensor:
    """The same float32 input on every rank, on [0, 255)."""
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 255, shape)
                            .astype(np.float32)).to(dev)


def _sharded_nccl(rank: int, card: str) -> dict:
    """(a): one rank, NCCL, a (1, 1, 1) mesh on the card (every halo the
    local wrap): the DWT cell's roundtrip through parallel.dwt2d/idwt2d
    against the single-card transforms, then timed."""
    from pdwt_tpu_torch import dwt2d, get_wavelet, idwt2d
    from pdwt_tpu_torch import parallel as par

    dev, wav = SHARD_DEVICE, get_wavelet(WNAME)
    mesh = par.make_mesh((1, 1, 1), device_type=dev.type)
    ax = dict(data_axis=None, row_axis="row", col_axis="col")
    x = _rank_image((N, N), 0, dev)
    xs = par.shard_image(x, mesh, **ax)
    per = {"fwd_level_2d_padded": LEVELS, "inv_level_2d_padded": LEVELS}
    tag = f"sharded (a) nccl (1, 1, 1): dwt2d/idwt2d {N}x{N} {WNAME} {LEVELS} levels"
    fwd = lambda: par.dwt2d(xs, wav, LEVELS, mesh, **ax)
    inv = lambda c: par.idwt2d(c, wav, (N, N), mesh, **ax)
    c, y = sharded_call(tag, lambda: (lambda c: (c, inv(c)))(fwd()), per)
    ref = dwt2d(x, wav, LEVELS)
    hold_shards(tag, c, ref)
    hold_shards(tag + " inverse", y, idwt2d(ref, wav, (N, N)))
    rt = float((y.to_local() - x).abs().max())
    print(f"{tag}: roundtrip max|y - x| {rt:.3e} (limit {ROUNDTRIP_ATOL})", flush=True)
    check(rt <= ROUNDTRIP_ATOL, f"{tag}: roundtrip error {rt:.3e}")
    call = lambda: inv(fwd())
    single = lambda: idwt2d(dwt2d(x, wav, LEVELS), wav, (N, N))
    out = {}
    for name, fn in (("sharded", call), ("single card", single)):
        ms, busy = cuda_ms(fn), device_ms(fn)[0]
        out[name] = {"ms": ms, "busy_ms": busy}
        print(f"{tag}: {name} roundtrip {ms:.4f} ms a call (CUDA events, median of 20), device "
              f"busy {fmt(busy)} (torch.profiler) [{card}]", flush=True)
    del c, y, ref, xs, x
    torch.cuda.empty_cache()
    out.update(_sharded_nccl_volume(card))
    out.update(_sharded_nccl_families(card))
    return out


@contextlib.contextmanager
def depth_products():
    """Count the depth products (``_DepthProduct`` applications: one a
    subband forward, one a level's pair of groups inverse) while the block
    runs; yields a one-element list."""
    from pdwt_tpu_torch.core import depth_matmul as DM

    n, apply = [0], DM._DepthProduct.apply

    def counted(*args):
        n[0] += 1
        return apply(*args)

    DM._DepthProduct.apply = counted
    try:
        yield n
    finally:
        del DM._DepthProduct.apply  # the inherited classmethod again


def _sharded_nccl_volume(card: str) -> dict:
    """(a) for the volumes, on a (1, 1, 1, 1) (data, dep, row, col) mesh
    with every spatial axis named (each halo the local wrap): the volume
    cell's roundtrip through parallel.dwt3d/idwt3d and
    sharded_denoise_step_3d(swt=True) on the TI cell, each against the
    single-card call, with exactly the padded launches and depth products
    the route gives, then both timed beside the single card."""
    from pdwt_tpu_torch import dwt3d, get_wavelet, idwt3d
    from pdwt_tpu_torch import parallel as par
    from pdwt_tpu_torch.models import denoise_step_3d, sharded_denoise_step_3d

    dev, w, L = SHARD_DEVICE, get_wavelet(VOL_WNAME), VOL_LEVELS
    mesh = par.make_mesh((1, 1, 1, 1), AXES4, device_type=dev.type)
    ax = dict(dep_axis="dep", row_axis="row", col_axis="col")
    vol = _rank_image(VOL_SHAPE, 4, dev)
    xs = par.shard_image(vol, mesh, **ax)
    tag = f"sharded (a) nccl (1, 1, 1, 1): dwt3d/idwt3d {VOL_SHAPE} {VOL_WNAME} {L} levels"
    launched = {"fwd_level_2d_padded": L, "inv_level_2d_padded": 2 * L}
    with depth_products() as n:
        c = sharded_call(tag + " forward", lambda: par.dwt3d(xs, w, L, mesh, **ax),
                         {"fwd_level_2d_padded": L})
        n_fwd = n[0]
        y = sharded_call(tag + " inverse", lambda: par.idwt3d(c, w, VOL_SHAPE, mesh, **ax),
                         {"inv_level_2d_padded": 2 * L})
    print(f"{tag}: depth products {n_fwd} forward, {n[0] - n_fwd} inverse", flush=True)
    check(n_fwd == 4 * L and n[0] - n_fwd == L, f"{tag}: depth products {n_fwd} and "
          f"{n[0] - n_fwd}, the route gives {4 * L} and {L}")
    ref = dwt3d(vol, w, L)
    hold_shards(tag, c, ref)
    hold_shards(tag + " inverse", y, idwt3d(ref, w, VOL_SHAPE))
    rt = float((y.to_local() - vol).abs().max())
    print(f"{tag}: roundtrip max|y - x| {rt:.3e} (limit {ROUNDTRIP_ATOL})", flush=True)
    check(rt <= ROUNDTRIP_ATOL, f"{tag}: roundtrip error {rt:.3e}")
    del c, y, ref
    out = {"volume": {}, "volume_step": {}}
    for name, fn in (("sharded", lambda: par.idwt3d(par.dwt3d(xs, w, L, mesh, **ax), w,
                                                    VOL_SHAPE, mesh, **ax)),
                     ("single card", lambda: idwt3d(dwt3d(vol, w, L), w, VOL_SHAPE))):
        out["volume"][name] = vol_timing(f"{tag}: {name} roundtrip", fn, card)
    del xs, vol
    torch.cuda.empty_cache()
    vti = _rank_image(VTI_SHAPE, 5, dev)
    ts = par.shard_image(vti, mesh, **ax)
    tag = (f"sharded (a) nccl (1, 1, 1, 1): sharded_denoise_step_3d(swt=True) {VTI_SHAPE} "
           f"{VOL_WNAME} {L} levels soft beta {VTI_BETA}")
    per = {"swt_fwd_level_2d_padded": L, "swt_inv_level_2d_padded": 2 * L}
    step = lambda: sharded_denoise_step_3d(ts, w, L, VTI_BETA, mesh, swt=True, **ax)
    den, n1 = sharded_call(tag, step, per)
    single = lambda: denoise_step_3d(vti, None, w, L, VTI_BETA, swt=True)
    ref, ref_n1 = single()
    hold_shards(tag, den, ref)
    print(f"{tag}: norm1 {float(n1)!r} vs single card {float(ref_n1)!r}", flush=True)
    check(n1.dim() == 0 and abs(float(n1) - float(ref_n1)) <= NORM_RTOL * abs(float(ref_n1)),
          f"{tag}: norm1")
    del den, ref
    for name, fn in (("sharded", step), ("single card", single)):
        out["volume_step"][name] = vol_timing(f"{tag}: {name}", fn, card)
    for k, v in per.items():
        launched[k] = launched.get(k, 0) + v
    out["vol_launches"] = launched
    return out


def _sharded_gloo(rank: int, card: str) -> dict:
    """(b): four gloo ranks sharing the one card, real ring halos through
    the host: each case's shards against the same slice of the single-card
    result on this rank, exactly the padded launches each call predicts."""
    from pdwt_tpu_torch import (dwt1d, dwt2d, get_wavelet, idwt1d, idwt2d, iswt1d, iswt2d, ops,
                                swt1d, swt2d)
    from pdwt_tpu_torch import parallel as par
    from pdwt_tpu_torch.models import sharded_denoise_step

    dev, wav, w8 = SHARD_DEVICE, get_wavelet(WNAME), get_wavelet(B1_WNAME)
    launched = {}
    m2 = par.make_mesh((1, 2, 2), device_type=dev.type)
    ax2 = dict(data_axis=None, row_axis="row", col_axis="col")
    # the DWT cell's roundtrip on (row, col) = (2, 2)
    x = _rank_image((N, N), 0, dev)
    xs = par.shard_image(x, m2, **ax2)
    tag = f"sharded (b) rank {rank} (2, 2): dwt2d/idwt2d {N}x{N} {WNAME} {LEVELS} levels"
    c = sharded_call(tag + " forward", lambda: par.dwt2d(xs, wav, LEVELS, m2, **ax2),
                     {"fwd_level_2d_padded": LEVELS})
    y = sharded_call(tag + " inverse", lambda: par.idwt2d(c, wav, (N, N), m2, **ax2),
                     {"inv_level_2d_padded": LEVELS})
    ref = dwt2d(x, wav, LEVELS)
    hold_shards(tag, c, ref)
    hold_shards(tag + " inverse", y, idwt2d(ref, wav, (N, N)))
    # the TI step on (2, 2), against the unsharded swt2d, soft threshold,
    # norm1 and iswt2d on the card
    xt = _rank_image((TI_N, TI_N), 1, dev)
    tag = (f"sharded (b) rank {rank} (2, 2): sharded_denoise_step(swt=True) {TI_N}x{TI_N} "
           f"{WNAME} {TI_LEVELS} levels soft beta {TI_BETA}")
    per = {"swt_fwd_level_2d_padded": TI_LEVELS, "swt_inv_level_2d_padded": TI_LEVELS}
    out, n1 = sharded_call(tag, lambda: sharded_denoise_step(
        par.shard_image(xt, m2, **ax2), WNAME, TI_LEVELS, TI_BETA, m2, swt=True, **ax2), per)
    launched.update(per)
    pc = ops.soft_threshold(swt2d(xt, wav, TI_LEVELS), TI_BETA)
    p_n1 = float(ops.norm1(pc))
    hold_shards(tag, out, iswt2d(pc, wav))
    print(f"{tag}: norm1 {float(n1)!r} vs single card {p_n1!r}", flush=True)
    check(n1.dim() == 0 and abs(float(n1) - p_n1) <= NORM_RTOL * abs(p_n1), f"{tag}: norm1")
    # the batched 1D cell over (data, col) = (1, 4)
    m1 = par.make_mesh((1, 4), ("data", "col"), device_type=dev.type)
    ax1 = dict(data_axis="data", col_axis="col")
    s = _rank_image((B1_SIGNALS, B1_N), 2, dev)
    ss = par.shard_image(s, m1, **ax1)
    for swt, fwd1, inv1, names in (
            (False, dwt1d, lambda c: idwt1d(c, w8, B1_N),
             ("fwd_level_1d_padded", "inv_level_1d_padded")),
            (True, swt1d, lambda c: iswt1d(c, w8),
             ("swt_fwd_level_1d_padded", "swt_inv_level_1d_padded"))):
        tag = (f"sharded (b) rank {rank} (1, 4): {'swt1d' if swt else 'dwt1d'} roundtrip "
               f"{B1_SIGNALS}x{B1_N} {B1_WNAME} {B1_LEVELS} levels")
        c = sharded_call(tag + " forward", lambda: par.dwt1d(ss, w8, B1_LEVELS, m1, swt=swt,
                                                             **ax1), {names[0]: B1_LEVELS})
        y = sharded_call(tag + " inverse", lambda: par.idwt1d(c, w8, B1_N, m1, swt=swt, **ax1),
                         {names[1]: B1_LEVELS})
        ref = fwd1(s, w8, B1_LEVELS)
        hold_shards(tag, c, ref)
        hold_shards(tag + " inverse", y, inv1(ref))
        if swt:
            launched.update({n: B1_LEVELS for n in names})
    # halos wider than a shard: 64 samples a shard, two hops a side at level 5
    sw = _rank_image(SHARD_WIDE, 3, dev)
    tag = (f"sharded (b) rank {rank} (4): swt1d/iswt1d {SHARD_WIDE} {B1_WNAME} "
           f"{SHARD_WIDE_LEVELS} levels, a halo wider than a shard")
    axw = dict(col_axis="col")
    c = sharded_call(tag + " forward", lambda: par.swt1d(par.shard_image(sw, m1, **axw), w8,
                                                         SHARD_WIDE_LEVELS, m1, **axw),
                     {"swt_fwd_level_1d_padded": SHARD_WIDE_LEVELS})
    y = sharded_call(tag + " inverse", lambda: par.iswt1d(c, w8, SHARD_WIDE[1], m1, **axw),
                     {"swt_inv_level_1d_padded": SHARD_WIDE_LEVELS})
    ref = swt1d(sw, w8, SHARD_WIDE_LEVELS)
    hold_shards(tag, c, ref)
    hold_shards(tag + " inverse", y, iswt1d(ref, w8))
    tiers = _sharded_gloo_tiers(rank, m2, ax2, m1, ax1, x, xt, s)
    return {"launches": launched, "tier_launches": tiers,
            "vol_launches": _sharded_gloo_volumes(rank), "ns_launches": _sharded_gloo_ns(rank),
            "fam_launches": _sharded_gloo_families(rank)}


def _sharded_gloo_volumes(rank: int) -> dict:
    """(b) for the volumes: the 3D DWT and SWT roundtrips of SH3_SMALL on
    (dep, row) = (2, 2) and on dep = 4 (4-plane shards, whose level-2 halos
    take several hops: 14 planes for the SWT), exact; on (2, 2) the
    SH3_TIER volume under bf16-fast and mixed (kernels 11p-14p where the
    route rule accepts the shard); sharded_denoise_step_3d(swt=True) on
    (2, 2).  Each call holds exactly the padded launches the route gives on
    this rank's shard, each rank's shards the single-card result's slice.
    Returns this rank's launches, summed over the calls."""
    from pdwt_tpu_torch import (dwt3d, get_wavelet, idwt3d, iswt3d, ops, precision_scope,
                                swt3d)
    from pdwt_tpu_torch import kernels as KK
    from pdwt_tpu_torch import parallel as par
    from pdwt_tpu_torch.models import sharded_denoise_step_3d

    dev, w, L = SHARD_DEVICE, get_wavelet(VOL_WNAME), VOL_LEVELS
    ax = dict(dep_axis="dep", row_axis="row", col_axis="col")
    total = {}

    def call(tag, fn, want):
        for k, v in want.items():
            total[k] = total.get(k, 0) + v
        return sharded_call(tag, fn, want)

    def inverse(ref, swt, shape):
        return iswt3d(ref, w) if swt else idwt3d(ref, w, shape)

    m22 = par.make_mesh((1, 2, 2, 1), AXES4, device_type=dev.type)
    m4 = par.make_mesh((1, 4, 1, 1), AXES4, device_type=dev.type)
    x = _rank_image(SH3_SMALL, 6, dev)
    for where, mesh in (("(dep, row) = (2, 2)", m22), ("dep = 4", m4)):
        xs = par.shard_image(x, mesh, **ax)
        for swt in (False, True):
            k = "swt_" if swt else ""
            tag = (f"sharded (b) rank {rank} {where}: {'swt' if swt else 'dwt'}3d roundtrip "
                   f"{SH3_SMALL} {VOL_WNAME} {L} levels")
            c = call(tag + " forward", lambda: par.dwt3d(xs, w, L, mesh, swt=swt, **ax),
                     {f"{k}fwd_level_2d_padded": L})
            y = call(tag + " inverse", lambda: par.idwt3d(c, w, SH3_SMALL, mesh, swt=swt, **ax),
                     {f"{k}inv_level_2d_padded": 2 * L})
            ref = (swt3d if swt else dwt3d)(x, w, L)
            hold_shards(tag, c, ref)
            hold_shards(tag + " inverse", y, inverse(ref, swt, SH3_SMALL))
    xt = _rank_image(SH3_TIER, 7, dev)
    r, cc = SH3_TIER[1] // 2, SH3_TIER[2]  # a rank's rows and columns on (2, 2)
    for tier in ("bf16-fast", "mixed"):
        xx = xt if tier == "mixed" else xt.bfloat16()
        with precision_scope(tier):
            xs = par.shard_image(xx, m22, **ax)
            for swt in (False, True):
                k = "swt_" if swt else ""
                if swt:
                    flags = [tier != "mixed" and KK.mxu_route_swt_2d(r, cc, w.hlen, lvl)
                             for lvl in range(1, L + 1)]
                else:
                    flags = [KK.mxu_route_2d(r >> lvl, cc >> lvl, w.hlen)
                             for lvl in range(1, L + 1)]
                fw = _routed((f"{k}fwd_level_2d_padded", f"{k}fwd_level_2d_mxu_padded"), flags)
                iv = _routed((f"{k}inv_level_2d_padded", f"{k}inv_level_2d_mxu_padded"),
                             flags + flags)
                tag = (f"sharded (b) rank {rank} (dep, row) = (2, 2) {tier}: "
                       f"{'swt' if swt else 'dwt'}3d roundtrip {SH3_TIER} {VOL_WNAME} {L} levels")
                c = call(tag + " forward", lambda: par.dwt3d(xs, w, L, m22, swt=swt, **ax), fw)
                y = call(tag + " inverse", lambda: par.idwt3d(c, w, SH3_TIER, m22, swt=swt,
                                                              **ax), iv)
                ref = (swt3d if swt else dwt3d)(xx, w, L)
                hold_shards(tag, c, ref, tier=True)
                hold_shards(tag + " inverse", y, inverse(ref, swt, SH3_TIER), tier=True)
    tag = (f"sharded (b) rank {rank} (dep, row) = (2, 2): sharded_denoise_step_3d(swt=True) "
           f"{SH3_SMALL} {VOL_WNAME} {L} levels soft beta {VTI_BETA}")
    out, n1 = call(tag, lambda: sharded_denoise_step_3d(par.shard_image(x, m22, **ax), w, L,
                                                        VTI_BETA, m22, swt=True, **ax),
                   {"swt_fwd_level_2d_padded": L, "swt_inv_level_2d_padded": 2 * L})
    pc = ops.soft_threshold(swt3d(x, w, L), VTI_BETA)
    p_n1 = float(ops.norm1(pc))
    hold_shards(tag, out, iswt3d(pc, w))
    print(f"{tag}: norm1 {float(n1)!r} vs single card {p_n1!r}", flush=True)
    check(n1.dim() == 0 and abs(float(n1) - p_n1) <= NORM_RTOL * abs(p_n1), f"{tag}: norm1")
    return total


def _sharded_gloo_ns(rank: int) -> dict:
    """(b) for the non-separable transforms, the rank-3 8x8 quads: the DWT
    and SWT roundtrips of an SHNS_N^2 image on (row, col) = (2, 2), the conv
    passes with the ring (no launch); on the data axis alone, a bf16 batch
    of SHNS_BATCH under bf16-fast, each shard the single-card call: kernels
    17 and 18 on the levels the route rule accepts.  Each rank's shards
    against the single-card result's slice.  Returns this rank's launches."""
    from pdwt_tpu_torch import kernels as KK
    from pdwt_tpu_torch import parallel as par
    from pdwt_tpu_torch import precision_scope
    from pdwt_tpu_torch.core import nonseparable as ns

    dev, q, L = SHARD_DEVICE, rank3_quads(), 2
    rk, hl = ns._rank_decomp(q)[1].shape
    total = {}
    m2 = par.make_mesh((1, 2, 2), device_type=dev.type)
    ax2 = dict(row_axis="row", col_axis="col")
    x = _rank_image((SHNS_N, SHNS_N), 8, dev)
    xs = par.shard_image(x, m2, **ax2)
    for swt in (False, True):
        tag = (f"sharded (b) rank {rank} (row, col) = (2, 2): {'swt' if swt else 'dwt'}2d_ns "
               f"roundtrip {SHNS_N}x{SHNS_N} rank-{rk} {hl}x{hl} quads {L} levels")
        c = sharded_call(tag + " forward", lambda: par.dwt2d_ns(xs, q, L, m2, swt=swt, **ax2),
                         {})
        y = sharded_call(tag + " inverse", lambda: par.idwt2d_ns(c, q, (SHNS_N, SHNS_N), m2,
                                                                 swt=swt, **ax2), {})
        ref = (ns.swt2d_ns if swt else ns.dwt2d_ns)(x, q, L)
        hold_shards(tag, c, ref)
        hold_shards(tag + " inverse", y, ns.iswt2d_ns(ref, q) if swt
                    else ns.idwt2d_ns(ref, q, (SHNS_N, SHNS_N)))
    md = par.make_mesh((4, 1, 1), device_type=dev.type)
    xb = _rank_image(SHNS_BATCH, 9, dev).bfloat16()
    r, cc = SHNS_BATCH[1:]
    with precision_scope("bf16-fast"):
        xbs = par.shard_image(xb, md, data_axis="data")
        for swt in (False, True):
            if swt:
                fl = [KK.mxu_route_ns_swt_2d(r, cc, hl, rk, lvl, KK.swt_scheme(
                    "bf16", torch.bfloat16 if lvl == 1 else torch.float32))
                      for lvl in range(1, L + 1)]
                il = [KK.mxu_route_ns_swt_2d(r, cc, hl, rk, lvl, "fd") for lvl in range(1, L + 1)]
            else:
                fl = il = [KK.mxu_route_ns_2d(r >> lvl, cc >> lvl, hl, rk)
                           for lvl in range(1, L + 1)]
            k = "ns_swt_" if swt else "ns_"
            fw = {f"{k}fwd_level_2d_mxu": sum(fl)} if any(fl) else {}
            iv = {f"{k}inv_level_2d_mxu": sum(il)} if any(il) else {}
            for d in (fw, iv):
                for name, v in d.items():
                    total[name] = total.get(name, 0) + v
            tag = (f"sharded (b) rank {rank} data = 4 bf16-fast: {'swt' if swt else 'dwt'}2d_ns "
                   f"roundtrip bf16 {SHNS_BATCH} rank-{rk} {hl}x{hl} quads {L} levels")
            c = sharded_call(tag + " forward", lambda: par.dwt2d_ns(xbs, q, L, md, swt=swt,
                                                                    data_axis="data"), fw)
            y = sharded_call(tag + " inverse", lambda: par.idwt2d_ns(c, q, (r, cc), md, swt=swt,
                                                                     data_axis="data"), iv)
            ref = (ns.swt2d_ns if swt else ns.dwt2d_ns)(xb, q, L)
            hold_shards(tag, c, ref, tier=True)
            hold_shards(tag + " inverse", y, ns.iswt2d_ns(ref, q) if swt
                        else ns.idwt2d_ns(ref, q, (r, cc)), tier=True)
    return total


def _sharded_nccl_families(card: str) -> dict:
    """(a) for the last modules, on a (1, 1, 1) mesh (each halo the local
    wrap, each pack the local one: no collective): the DWT cell's image
    through parallel.fs_dwt/fs_idwt at levels (5, 5) and through
    parallel.packets.wp2d/iwp2d to 5 levels, each against the single-card
    call with exactly the padded launches, then timed beside it."""
    from pdwt_tpu_torch import get_wavelet
    from pdwt_tpu_torch import parallel as par
    from pdwt_tpu_torch.core import anisotropic as AN
    from pdwt_tpu_torch.core import packets as PK
    from pdwt_tpu_torch.parallel import anisotropic as PA

    dev, w, L2 = SHARD_DEVICE, get_wavelet(WNAME), FS_LEVELS_2D
    mesh = par.make_mesh((1, 1, 1), device_type=dev.type)
    ax = dict(row_axis="row", col_axis="col")
    x = _rank_image((N, N), 0, dev)
    xs = par.shard_image(x, mesh, **ax)
    out = {"fs": {}, "wp2d": {}}
    tag = f"sharded (a) nccl (1, 1, 1): fs_dwt/fs_idwt {N}x{N} {WNAME} {L2}"
    n0 = PA.COLLECTIVES["all_gather"]
    fwd = lambda: par.fs_dwt(xs, w, L2, mesh, axes=("row", "col"))
    inv = lambda y: par.fs_idwt(y, w, (N, N), L2, mesh, axes=("row", "col"))
    y = sharded_call(tag + " forward", fwd, {"fwd_level_1d_padded": sum(L2)})
    r = sharded_call(tag + " inverse", lambda: inv(y), {"inv_level_1d_padded": sum(L2)})
    gathers = PA.COLLECTIVES["all_gather"] - n0
    print(f"{tag}: {gathers} all-gathers (one-shard axes pack locally)", flush=True)
    check(gathers == 0, f"{tag}: {gathers} all-gathers on one rank")
    ref = AN.fs_dwt(x, w, L2)
    hold_shards(tag, y, ref)
    hold_shards(tag + " inverse", r, AN.fs_idwt(ref, w, (N, N), L2))
    del y, r, ref
    for name, fn in (("sharded", lambda: inv(fwd())),
                     ("single card", lambda: AN.fs_idwt(AN.fs_dwt(x, w, L2), w, (N, N), L2))):
        out["fs"][name] = vol_timing(f"{tag}: {name} roundtrip", fn, card, "sharded")
    tag = f"sharded (a) nccl (1, 1, 1): packets.wp2d/iwp2d {N}x{N} {WNAME} {LEVELS} levels"
    fwd = lambda: par.packets.wp2d(xs, w, LEVELS, mesh, **ax)
    inv = lambda p: par.packets.iwp2d(p.nodes[-1], w, (N, N), mesh, **ax)
    p = sharded_call(tag + " forward", fwd, {"fwd_level_2d_padded": LEVELS})
    r = sharded_call(tag + " inverse", lambda: inv(p), {"inv_level_2d_padded": LEVELS})
    ref = PK.wp2d(x, w, LEVELS)
    hold_shards(tag, list(p.nodes), list(ref.nodes))
    hold_shards(tag + " inverse", r, PK.iwp2d(ref.nodes[-1], w, (N, N)))
    del p, r, ref
    for name, fn in (("sharded", lambda: inv(fwd())),
                     ("single card", lambda: PK.iwp2d(PK.wp2d(x, w, LEVELS).nodes[-1], w,
                                                      (N, N)))):
        out["wp2d"][name] = vol_timing(f"{tag}: {name} roundtrip", fn, card, "sharded")
    out["fam_launches"] = {"fwd_level_1d_padded": sum(L2), "inv_level_1d_padded": sum(L2),
                           "fwd_level_2d_padded": LEVELS, "inv_level_2d_padded": LEVELS}
    return out


def _sharded_gloo_families(rank: int) -> dict:
    """(b) for the last modules, each rank's shards against the single-card
    call's slice and exactly the padded launches the route gives: fs_dwt/
    fs_idwt of the DWT cell's image on (row, col) = (2, 2) (one all-gather
    a pass each way, counted), the starlet of the TI image on (2, 2) and of
    signals over 4 column shards (conv passes, no launch), the 2D packets
    of the TI image on (2, 2) with the full inverse and a best-basis
    reconstruction (the single card's cover), 1D packets over 4 column
    shards, 3D packets on (dep, row) = (2, 2).  Returns this rank's
    launches."""
    import importlib

    from pdwt_tpu_torch import get_wavelet
    from pdwt_tpu_torch import parallel as par
    from pdwt_tpu_torch.core import anisotropic as AN
    from pdwt_tpu_torch.core import packets as PK
    from pdwt_tpu_torch.parallel import anisotropic as PA

    ST = importlib.import_module("pdwt_tpu_torch.core.starlet")
    dev, w7, w8, w4 = SHARD_DEVICE, get_wavelet(WNAME), get_wavelet(B1_WNAME), \
        get_wavelet(VOL_WNAME)
    total = {}

    def call(tag, fn, want):
        for k, v in want.items():
            total[k] = total.get(k, 0) + v
        return sharded_call(tag, fn, want)

    m2 = par.make_mesh((1, 2, 2), device_type=dev.type)
    m1 = par.make_mesh((1, 4), ("data", "col"), device_type=dev.type)
    ax2 = dict(row_axis="row", col_axis="col")
    L2, pre = FS_LEVELS_2D, f"sharded (b) rank {rank}"
    x = _rank_image((N, N), 0, dev)
    tag = f"{pre} (2, 2): fs_dwt/fs_idwt {N}x{N} {WNAME} {L2}"
    n0 = PA.COLLECTIVES["all_gather"]
    y = call(tag + " forward", lambda: par.fs_dwt(par.shard_image(x, m2, **ax2), w7, L2, m2,
                                                  axes=("row", "col")),
             {"fwd_level_1d_padded": sum(L2)})
    n1 = PA.COLLECTIVES["all_gather"]
    r = call(tag + " inverse", lambda: par.fs_idwt(y, w7, (N, N), L2, m2, axes=("row", "col")),
             {"inv_level_1d_padded": sum(L2)})
    n2 = PA.COLLECTIVES["all_gather"]
    print(f"{tag}: all-gathers {n1 - n0} forward, {n2 - n1} inverse", flush=True)
    check((n1 - n0, n2 - n1) == (2, 2), f"{tag}: the packs took {n1 - n0} and {n2 - n1} "
          "all-gathers, one a sharded pass expected")
    ref = AN.fs_dwt(x, w7, L2)
    hold_shards(tag, y, ref)
    hold_shards(tag + " inverse", r, AN.fs_idwt(ref, w7, (N, N), L2))
    del y, r, ref
    xt = _rank_image((TI_N, TI_N), 1, dev)
    tag = f"{pre} (2, 2): starlet/istarlet {TI_N}x{TI_N} {STARLET_SCALES} scales"
    c = call(tag + " forward", lambda: par.starlet(par.shard_image(xt, m2, **ax2),
                                                   STARLET_SCALES, m2,
                                                   spatial_axes=("row", "col")), {})
    r = call(tag + " inverse", lambda: par.istarlet(c, m2, spatial_axes=("row", "col")), {})
    ref = ST.starlet(xt, STARLET_SCALES)
    hold_shards(tag, list(c), list(ref))
    hold_shards(tag + " inverse", r, ST.istarlet(ref))
    s = _rank_image(SHARD_SIG, 2, dev)
    tag = f"{pre} (4): starlet/istarlet {SHARD_SIG} 3 scales, 1D"
    ax1 = dict(data_axis="data", spatial_axes=("col",))
    c = call(tag + " forward", lambda: par.starlet(par.shard_image(s, m1, data_axis="data",
                                                                   col_axis="col"), 3, m1,
                                                   **ax1), {})
    r = call(tag + " inverse", lambda: par.istarlet(c, m1, **ax1), {})
    ref = ST.starlet(s, 3, ndim=1)
    hold_shards(tag, list(c), list(ref))
    hold_shards(tag + " inverse", r, ST.istarlet(ref, ndim=1))
    L = TI_LEVELS
    tag = f"{pre} (2, 2): packets.wp2d/iwp2d {TI_N}x{TI_N} {WNAME} {L} levels"
    p = call(tag + " forward", lambda: par.packets.wp2d(par.shard_image(xt, m2, **ax2), w7, L,
                                                        m2, **ax2),
             {"fwd_level_2d_padded": L})
    r = call(tag + " inverse", lambda: par.packets.iwp2d(p.nodes[-1], w7, (TI_N, TI_N), m2,
                                                         **ax2), {"inv_level_2d_padded": L})
    ref = PK.wp2d(xt, w7, L)
    hold_shards(tag, list(p.nodes), list(ref.nodes))
    hold_shards(tag + " inverse", r, PK.iwp2d(ref.nodes[-1], w7, (TI_N, TI_N)))
    cover, _ = PK.best_basis(ref, "shannon")
    deep = max(j for j, _ in cover)
    tag = f"{pre} (2, 2): packets.wp_reconstruct ({len(cover)}-leaf shannon cover, depth {deep})"
    r = call(tag, lambda: par.packets.wp_reconstruct(p, cover, w7, m2, **ax2),
             {"inv_level_2d_padded": deep})
    hold_shards(tag, r, PK.wp_reconstruct(ref, cover, w7))
    del p, r, ref
    tag = f"{pre} (4): packets.wp1d/iwp1d {SHARD_SIG} {B1_WNAME} 3 levels"
    axp = dict(data_axis="data", col_axis="col")
    p = call(tag + " forward", lambda: par.packets.wp1d(par.shard_image(s, m1, **axp), w8, 3, m1,
                                                        **axp), {"fwd_level_1d_padded": 3})
    r = call(tag + " inverse", lambda: par.packets.iwp1d(p.nodes[-1], w8, SHARD_SIG[1], m1,
                                                         **axp), {"inv_level_1d_padded": 3})
    ref = PK.wp1d(s, w8, 3)
    hold_shards(tag, list(p.nodes), list(ref.nodes))
    hold_shards(tag + " inverse", r, PK.iwp1d(ref.nodes[-1], w8, SHARD_SIG[1]))
    m22 = par.make_mesh((1, 2, 2, 1), AXES4, device_type=dev.type)
    ax3 = dict(dep_axis="dep", row_axis="row", col_axis="col")
    v = _rank_image(SH3_SMALL, 6, dev)
    tag = f"{pre} (dep, row) = (2, 2): packets.wp3d/iwp3d {SH3_SMALL} {VOL_WNAME} 2 levels"
    p = call(tag + " forward", lambda: par.packets.wp3d(par.shard_image(v, m22, **ax3), w4, 2,
                                                        m22, **ax3), {"fwd_level_2d_padded": 2})
    r = call(tag + " inverse", lambda: par.packets.iwp3d(p.nodes[-1], w4, SH3_SMALL, m22, **ax3),
             {"inv_level_2d_padded": 4})
    ref = PK.wp3d(v, w4, 2)
    hold_shards(tag, list(p.nodes), list(ref.nodes))
    hold_shards(tag + " inverse", r, PK.iwp3d(ref.nodes[-1], w4, SH3_SMALL))
    return total


def _routed(names, flags) -> dict:
    """{kernel: launches} of levels whose route flag picks names[1] (the
    banded-product padded entry point) or names[0] (the exact one)."""
    out = {}
    for f in flags:
        out[names[bool(f)]] = out.get(names[bool(f)], 0) + 1
    return out


def _sharded_gloo_tiers(rank, m2, ax2, m1, ax1, x, xt, s) -> dict:
    """(b) under the precision tiers: on (2, 2) the DWT cell's roundtrip
    under each tier and the TI step on a bf16 image under the bf16 tiers,
    on (1, 4) the 1D cell's DWT and SWT roundtrips under each tier.  Each
    call holds exactly the launches the route rule predicts on this rank's
    shard (kernels.mxu_route_*), each rank's shards the single-card tier
    transform's slice within the tier path limits (a level can be banded on
    one card and exact on a shard), the TI norm its single-card value
    within NORM_RTOL.  Returns this rank's launches of kernels 11-16 (and of
    the exact padded ones beside them), summed over the calls."""
    from pdwt_tpu_torch import (dwt1d, dwt2d, get_wavelet, idwt1d, idwt2d, iswt1d, iswt2d, ops,
                                precision_scope, swt1d, swt2d)
    from pdwt_tpu_torch import kernels as KK
    from pdwt_tpu_torch import parallel as par
    from pdwt_tpu_torch.models import sharded_denoise_step

    wav, w8 = get_wavelet(WNAME), get_wavelet(B1_WNAME)
    total = {}

    def count(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    r, ti, n1d = N // 2, TI_N // 2, B1_N // 4  # a rank's shard sides
    for tier in TIERS:
        bf = tier != "mixed"
        cast = (lambda t: t.bfloat16()) if bf else (lambda t: t)
        with precision_scope(tier):
            tag = (f"sharded (b) rank {rank} (2, 2) {tier}: dwt2d/idwt2d {N}x{N} {WNAME} "
                   f"{LEVELS} levels")
            routes = [KK.mxu_route_2d(r >> lvl, r >> lvl, wav.hlen) for lvl in range(1, LEVELS + 1)]
            fw = _routed(("fwd_level_2d_padded", "fwd_level_2d_mxu_padded"), routes)
            iv = _routed(("inv_level_2d_padded", "inv_level_2d_mxu_padded"), routes)
            xs = par.shard_image(cast(x), m2, **ax2)
            c = sharded_call(tag + " forward", lambda: par.dwt2d(xs, wav, LEVELS, m2, **ax2), fw)
            y = sharded_call(tag + " inverse", lambda: par.idwt2d(c, wav, (N, N), m2, **ax2), iv)
            count(fw), count(iv)
            ref = dwt2d(cast(x), wav, LEVELS)
            hold_shards(tag, c, ref, tier=True)
            hold_shards(tag + " inverse", y, idwt2d(ref, wav, (N, N)), tier=True)
            ss = par.shard_image(cast(s), m1, **ax1)
            for swt in (False, True):
                tag = (f"sharded (b) rank {rank} (1, 4) {tier}: {'swt1d' if swt else 'dwt1d'} "
                       f"roundtrip {B1_SIGNALS}x{B1_N} {B1_WNAME} {B1_LEVELS} levels")
                if swt:
                    routes = [bf and KK.mxu_route_1d(B1_SIGNALS, n1d, w8.hlen, level=lvl)
                              for lvl in range(1, B1_LEVELS + 1)]
                    names = ("swt_fwd_level_1d", "swt_inv_level_1d")
                else:
                    routes = [KK.mxu_route_1d(B1_SIGNALS, n1d >> (lvl - 1), w8.hlen)
                              for lvl in range(1, B1_LEVELS + 1)]
                    names = ("fwd_level_1d", "inv_level_1d")
                fw, iv = (_routed((f"{k}_padded", f"{k}_mxu_padded"), routes) for k in names)
                c = sharded_call(tag + " forward", lambda: par.dwt1d(ss, w8, B1_LEVELS, m1,
                                                                     swt=swt, **ax1), fw)
                y = sharded_call(tag + " inverse", lambda: par.idwt1d(c, w8, B1_N, m1, swt=swt,
                                                                      **ax1), iv)
                count(fw), count(iv)
                ref = (swt1d if swt else dwt1d)(cast(s), w8, B1_LEVELS)
                hold_shards(tag, c, ref, tier=True)
                hold_shards(tag + " inverse", y,
                            iswt1d(ref, w8) if swt else idwt1d(ref, w8, B1_N), tier=True)
            if not bf:
                continue
            tag = (f"sharded (b) rank {rank} (2, 2) {tier}: sharded_denoise_step(swt=True) on a "
                   f"bf16 {TI_N}x{TI_N} image, {WNAME} {TI_LEVELS} levels soft beta {TI_BETA}")
            routes = [KK.mxu_route_swt_2d(ti, ti, wav.hlen, lvl) for lvl in range(1, TI_LEVELS + 1)]
            per = _routed(("swt_fwd_level_2d_padded", "swt_fwd_level_2d_mxu_padded"), routes)
            for k, v in _routed(("swt_inv_level_2d_padded", "swt_inv_level_2d_mxu_padded"),
                                routes).items():
                per[k] = v
            xb = cast(xt)
            out, n1 = sharded_call(tag, lambda: sharded_denoise_step(
                par.shard_image(xb, m2, **ax2), WNAME, TI_LEVELS, TI_BETA, m2, swt=True, **ax2),
                per)
            count(per)
            pc = ops.soft_threshold(swt2d(xb, wav, TI_LEVELS), TI_BETA)
            p_n1 = float(ops.norm1(pc))
            hold_shards(tag, out, iswt2d(pc, wav), tier=True)
            print(f"{tag}: norm1 {float(n1)!r} ({n1.dtype}) vs single card {p_n1!r}", flush=True)
            check(n1.dim() == 0 and n1.dtype == torch.float32
                  and abs(float(n1) - p_n1) <= NORM_RTOL * abs(p_n1), f"{tag}: norm1")
    return total


def _sharded_rank(rank: int, world: int, init_file: str, out_dir: str, card: str) -> None:
    """One rank of the sharded phase: NCCL alone (a), gloo among four on
    the one card (b); its results into out_dir/rank<k>.json."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)  # every rank on the one card, before its mesh
    backend = "nccl" if world == 1 else "gloo"
    extra = {"device_id": torch.device("cuda", 0)} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="file://" + init_file, rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S),
                            **extra)
    try:
        res = (_sharded_nccl if world == 1 else _sharded_gloo)(rank, card)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, card: str) -> list:
    """Start ``world`` ranks of ``_sharded_rank`` (spawn: forking after the
    card is initialised breaks) and return their results; any rank's
    failure fails the run (the others are ended)."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        ctx = mp.spawn(_sharded_rank, args=(world, os.path.join(d, "store"), d, card),
                       nprocs=world, join=False)
        deadline = time.monotonic() + 2 * SHARD_TIMEOUT_S
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    fail(f"sharded: {world} ranks did not finish in {2 * SHARD_TIMEOUT_S} s")
        except Exception as e:  # a rank raised or exited non-zero
            fail(f"sharded: a rank of {world} failed: {e}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        res = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.json")) as fh:
                res.append(json.load(fh))
    return res


def sharded_phase(dev, card, report, launches, gen) -> None:
    """The sharded transforms: the padded entry points of kernels 5, 6, 9
    and 10 against their plain versions on the shard geometries of (b)
    (timed: a rank's launches there, alone on the card) and on their code
    paths; then (a) one NCCL rank and (b) four gloo ranks on the one card
    (``_sharded_nccl``, ``_sharded_gloo``).  The kernels were built before
    any rank starts, so no rank runs nvcc."""
    from pdwt_tpu_torch import get_wavelet
    from pdwt_tpu_torch.filters import make_custom_wavelet
    from pdwt_tpu_torch.kernels.matmul import SCHEMES

    print("=== sharded ===", flush=True)
    wav, w8 = get_wavelet(WNAME), get_wavelet(B1_WNAME)
    rand = lambda *s: torch.rand(s, device=dev, generator=gen) * 255.0
    cases = []
    # a rank's shards in (b): the TI step's 512^2 (levels 1-3), the 1D
    # cell's 1024 x 1024 (levels 1-4), the wide halo's 8 x 64 (levels 1-5)
    for lvl in range(1, TI_LEVELS + 1):
        cases += atrous_cases(wav, (1, TI_N // 2, TI_N // 2), lvl, rand, True)
    for lvl in range(1, B1_LEVELS + 1):
        cases += atrous_cases(w8, (B1_SIGNALS, B1_N // 4), lvl, rand, True)
    for lvl in range(1, SHARD_WIDE_LEVELS + 1):
        cases += atrous_cases(w8, (SHARD_WIDE[0], SHARD_WIDE[1] // 4), lvl, rand)
    # the code paths: odd and tiny shards, dilations past the shard, 2 to
    # 40 taps and an odd bank, a batch of 3 and one past the grid's limit
    odd5 = make_custom_wavelet("odd5", *np.random.default_rng(5).standard_normal((4, 5)))
    w40 = make_custom_wavelet("w40", *np.random.default_rng(40).standard_normal((4, 40)))
    for w, shape, lvl in [(get_wavelet("haar"), (2, 5, 7), 3), (wav, (3, 37, 53), 2),
                          (w40, (1, 70, 38), 2), (odd5, (1, 16, 24), 4), (wav, (1, 8, 8), 6),
                          (get_wavelet("db2"), (70000, 2, 2), 1), (w8, (3, 301), 5),
                          (get_wavelet("haar"), (2, 1), 1), (w40, (40, 300), 3),
                          (odd5, (33, 200), 8), (wav, (70000, 8), 2)]:
        cases += atrous_cases(w, shape, lvl, rand)
    # kernels 11-16's padded entry points on a rank's shards under each tier
    # (bf16-fast's timed), then their code paths in every scheme: odd and
    # tiny shards, 2 to 40 taps, a batch past the grid's limit, dilated
    # spans past the shard; bf16 and float32 storage in turn
    cases += tier_shard_cases(rand)
    haar, db2 = get_wavelet("haar"), get_wavelet("db2")
    paths = [(haar, (1, 2, 6), 0), (wav, (3, 37, 53), 0), (w40, (1, 70, 38), 0),
             (db2, (70000, 2, 2), 0), (haar, (2, 5, 7), 4), (wav, (2, 37, 53), 3),
             (w40, (1, 24, 40), 2), (db2, (70000, 2, 2), 1), (wav, (1, 8, 8), 6),
             (haar, (3, 7), 0), (wav, (33, 201), 0), (w40, (40, 300), 0), (w8, (70000, 8), 0),
             (haar, (3, 7), 4), (wav, (33, 201), 3), (w40, (40, 300), 2), (w8, (70000, 8), 1),
             (db2, (2, 5), 5)]
    for i, sch in enumerate(SCHEMES):
        for j, (w, shape, lvl) in enumerate(paths):
            dt = torch.bfloat16 if (i + j) % 2 == 0 else torch.float32
            cases += mxu_padded_cases(w, shape, rand, (sch, sch), (dt,) * 4, lvl,
                                      label="code path ")
    run_cases(cases, report, card)

    (a,) = spawn_ranks(1, card)
    print(f"sharded (a): one NCCL rank, roundtrip {a} [{card}]", flush=True)
    ranks = spawn_ranks(4, card)
    for r, res in enumerate(ranks):
        check(res["launches"] == ranks[0]["launches"], f"sharded (b): rank {r} launched "
              f"{res['launches']}, rank 0 {ranks[0]['launches']}")
    print(f"sharded (b): each of 4 ranks launched {ranks[0]['launches']} of the new padded "
          "kernels; their call times measure nothing of scaling (four processes on one card, "
          "halos through the host) and are not kept", flush=True)
    launches.update(ranks[0]["launches"])
    for r, res in enumerate(ranks):
        check(res["tier_launches"] == ranks[0]["tier_launches"], f"sharded (b): rank {r}'s tier "
              f"launches {res['tier_launches']}, rank 0's {ranks[0]['tier_launches']}")
    tl = ranks[0]["tier_launches"]
    print(f"sharded (b) under the tiers: each of 4 ranks launched {tl}", flush=True)
    for name in REPLACES:
        if name.endswith("_mxu_padded"):
            check(tl.get(name, 0) > 0, f"sharded (b): the tiers never launched {name}")
            launches[name] = tl[name]
    # the volumes and the non-separable transforms
    for key in ("vol_launches", "ns_launches"):
        for r, res in enumerate(ranks):
            check(res[key] == ranks[0][key], f"sharded (b): rank {r}'s {key} {res[key]}, "
                  f"rank 0's {ranks[0][key]}")
    vl, nl = ranks[0]["vol_launches"], ranks[0]["ns_launches"]
    print(f"sharded volumes: (a) launched {a['vol_launches']}; (b) each of 4 ranks {vl}",
          flush=True)
    print(f"sharded non-separable (b): each of 4 ranks launched {nl}", flush=True)
    for name in ("fwd_level_2d_padded", "inv_level_2d_padded", "swt_fwd_level_2d_padded",
                 "swt_inv_level_2d_padded", "fwd_level_2d_mxu_padded", "inv_level_2d_mxu_padded",
                 "swt_fwd_level_2d_mxu_padded", "swt_inv_level_2d_mxu_padded"):
        check(vl.get(name, 0) > 0, f"sharded (b): the volumes never launched {name}")
    for name in ("ns_fwd_level_2d_mxu", "ns_inv_level_2d_mxu"):
        check(nl.get(name, 0) > 0, f"sharded (b): the non-separable shards never launched {name}")
    for d in (a["vol_launches"], vl, nl):
        for name, v in d.items():
            launches[name] = launches.get(name, 0) + v
    for key, what in (("volume", "roundtrip"), ("volume_step", "TI step")):
        sh, one = a[key]["sharded"], a[key]["single card"]
        print(f"sharded (a) volume {what}: sharded {sh} vs single card {one} [{card}]",
              flush=True)
    # the fully separable, starlet and packet transforms
    for r, res in enumerate(ranks):
        check(res["fam_launches"] == ranks[0]["fam_launches"], f"sharded (b): rank {r}'s "
              f"fam_launches {res['fam_launches']}, rank 0's {ranks[0]['fam_launches']}")
    fl = ranks[0]["fam_launches"]
    print(f"sharded families: (a) launched {a['fam_launches']}; (b) each of 4 ranks {fl}",
          flush=True)
    for name in ("fwd_level_1d_padded", "inv_level_1d_padded", "fwd_level_2d_padded",
                 "inv_level_2d_padded"):
        check(fl.get(name, 0) > 0, f"sharded (b): the families never launched {name}")
    for d in (a["fam_launches"], fl):
        for name, v in d.items():
            launches[name] = launches.get(name, 0) + v
    for key, what in (("fs", "fs_dwt + fs_idwt"), ("wp2d", "wp2d + iwp2d")):
        sh, one = a[key]["sharded"], a[key]["single card"]
        print(f"sharded (a) {what}: sharded {sh} vs single card {one} [{card}]", flush=True)

# -- the volume phase (queue 1 item 12): bench_all.py's two 3D configurations
# (bench_all.py:132-153, 254-261), the 3D transforms on the 2D level kernels
# with depth as their batch
VOL_SHAPE, VOL_WNAME, VOL_LEVELS = (128, 512, 512), "db4", 2   # the roundtrip (config 6)
VTI_SHAPE, VTI_BETA = (64, 512, 512), 1.0                      # the TI step (config 7)
# the port's kernel route against the conv passes (JAX's fma formulation):
# the depth product and the kernels' FMAs sum in another order
CONV_RTOL = 1e-5
# max |inverse(forward(x)) - x| on [0, 255] data under the tiers: the JAX
# package's own 3D bounds (tests/test_3d.py:340, 349, 357)
VOL_ROUNDTRIP_LIMIT = {"mixed": 0.05, "bf16-fast": 8.0, "bf16-balanced": 8.0,
                       "bf16-accurate": 8.0}
# the fused bf16 TI step against the unfused one: the kernels threshold the
# bf16 details in float32, the threshold op rounds them to bf16 first
# (tests/test_3d.py:392-394, on [0, 255] data)
VTI_UNFUSED_BF16_ATOL = 3.0
VOL_NAMES = ("fwd_level_2d", "inv_level_2d", "swt_fwd_level_2d", "swt_inv_level_2d",
             "fwd_level_2d_mxu", "inv_level_2d_mxu", "swt_fwd_level_2d_mxu",
             "swt_inv_level_2d_mxu")


@contextlib.contextmanager
def plain_route():
    """The kernel wrappers the 3D transforms and the families reach (1-8,
    11-16) swapped for their plain versions while the block runs: the same
    composition (routes, casts, depth products) on plain versions on the
    card; no launch counts."""
    from pdwt_tpu_torch.kernels import LAUNCHES
    from pdwt_tpu_torch.kernels import batched1d as B1
    from pdwt_tpu_torch.kernels import matmul as M
    from pdwt_tpu_torch.kernels import mxu1d as MX
    from pdwt_tpu_torch.kernels import separable as K
    from pdwt_tpu_torch.kernels import swt as S
    from pdwt_tpu_torch.kernels import swt_matmul as SM

    saved = [(m, n, getattr(m, n)) for m, names in
             ((K, ("fwd_level_2d", "inv_level_2d", "fwd_tail_2d", "inv_tail_2d")),
              (S, ("swt_fwd_level_2d", "swt_inv_level_2d")),
              (B1, ("fwd_level_1d", "inv_level_1d")),
              (M, ("fwd_level_2d_mxu", "inv_level_2d_mxu")),
              (MX, ("fwd_level_1d_mxu", "inv_level_1d_mxu")),
              (SM, ("swt_fwd_level_2d_mxu", "swt_inv_level_2d_mxu"))) for n in names]
    before = sum(LAUNCHES.values())
    try:
        for m, n, _ in saved:
            setattr(m, n, getattr(m, n + "_ref"))
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    check(sum(LAUNCHES.values()) == before, "the plain route launched a kernel")


def counted_exactly(label, fn, want: dict, into: dict, phase: str = "volume"):
    """fn() between a reset and a read of the launch counters: exactly the
    launches ``want`` (name -> count); adds them to ``into``."""
    from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in LAUNCHES.items() if v}
    print(f"{phase}: {label}: launches {got}", flush=True)
    check(got == want, f"{phase}: {label} launched {got}, the route rule gives {want}")
    for k, v in got.items():
        into[k] = into.get(k, 0) + v
    return out


def vol_timing(label, fn, card, phase: str = "volume") -> dict:
    """One call's time (CUDA events, median of 20), its device busy time
    from the launch counters (``device_ms``: busy_per_call), that busy time
    split between the port's kernels, the depth products (cuBLAS GEMMs)
    and the rest (copies, casts, thresholds, rolls, conv passes), the idle
    share, and the peak memory of one call; printed, and returned as a
    dict."""
    ms = cuda_ms(fn)
    busy, by_name = device_ms(fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    out = {"ms": ms, "busy_ms": busy, "peak_gib": peak}
    if busy is None:
        print(f"{phase} timing: {label}: {ms:.4f} ms a call, device busy not measured, peak "
              f"{peak:.3f} GiB above the inputs [{card}]", flush=True)
        return out
    gemm = lambda k: any(s in k.lower() for s in ("gemm", "xmma", "cutlass", "cublas"))
    kern = sum(v for k, v in by_name.items() if is_port_kernel(k))
    prod = sum(v for k, v in by_name.items() if not is_port_kernel(k) and gemm(k))
    print(f"{phase} timing: {label}: {ms:.4f} ms a call, device busy {busy:.4f} ms (kernels "
          f"{kern:.4f}, depth products {prod:.4f}, copies and the rest "
          f"{busy - kern - prod:.4f}), idle share {1 - busy / ms:.3f}, peak "
          f"{peak:.3f} GiB above the inputs [{card}]", flush=True)
    for kname, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {v:.4f} ms  {kname[:100]}")
    return dict(out, kernels_ms=kern, products_ms=prod)


def vhold(label, got, want, rtol=PATH_RTOL) -> None:
    """A volume result against another route's on the card: one shape per
    output, finite, within rtol of the call's largest reference value."""
    gl, wl = leaves(got), leaves(want)
    check(len(gl) == len(wl) and all(g.shape == w.shape for g, w in zip(gl, wl)),
          f"{label}: shapes differ")
    check(all(bool(torch.isfinite(g).all()) for g in gl), f"{label}: not finite")
    err, scale = max_err(got, want)
    print(f"{label}: max|diff| {err:.3e} (limit {rtol * scale:.3e})", flush=True)
    check(err <= rtol * scale, f"{label}: disagrees")


def vhold_value(label, got, want, rtol=NORM_RTOL) -> None:
    got, want = float(got), float(want)
    print(f"{label} {got!r} vs {want!r}", flush=True)
    check(abs(got - want) <= rtol * abs(want), f"{label} disagrees")


def volume_phase(dev, card, report, launches, gen) -> None:
    """The 3D transforms (``core/separable3d.py``) at bench_all.py's two 3D
    configurations: (a) kernels 1, 2, 5, 6 and 11-14 against their plain
    versions at the 3D path's level shapes (64-128 planes a launch, and a
    batch of 5 x 3 planes), one pass of each timed; (b) the 128x512x512 db4
    2-level roundtrip through dwt3d/idwt3d and the facade, against the same
    composition on plain versions, against the conv passes (JAX's fma
    formulation), its roundtrip error, again under
    set_float32_matmul_precision("high"), its launch counts; (c) the same
    roundtrip under each tier; (d) the 64x512x512 TI step
    (denoise_step_3d(swt=True), soft, beta 1) exact and under each tier,
    against the same route and the unfused path on plain versions; (e)
    Wavelets(volume, do_swt=True).run_denoise, the 7-band get/set_coeff,
    3D cycle spinning, auto_denoise_3d, a 3D checkpoint and the demo's --nd
    on the card.  Each path's launches are added to the kernels' rows."""
    import io
    import tempfile

    from pdwt_tpu_torch import Wavelets, demo, dwt3d, get_wavelet, idwt3d, iswt3d, ops, swt3d
    from pdwt_tpu_torch.core import precision as P
    from pdwt_tpu_torch.core import separable3d as S3
    from pdwt_tpu_torch.kernels import matmul as M
    from pdwt_tpu_torch.kernels import separable as K
    from pdwt_tpu_torch.kernels import swt as S
    from pdwt_tpu_torch.kernels import swt_matmul as SM
    from pdwt_tpu_torch.models import auto_denoise_3d, denoise_step_3d
    from pdwt_tpu_torch.utils import load_coeffs, save_coeffs, write_dat

    print("=== volume ===", flush=True)
    t_phase = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    w = get_wavelet(VOL_WNAME)
    lo, hi, rlo, rhi, hl = w.dec_lo, w.dec_hi, w.rec_lo, w.rec_hi, w.hlen
    L = VOL_LEVELS
    rand = lambda *s: torch.rand(s, device=dev, generator=gen) * 255.0
    thr = ("soft", VTI_BETA)
    vol_launches: dict = {}

    # ---------------- (a) the kernels at the 3D geometry ----------------
    D, R, C = VOL_SHAPE
    TD = VTI_SHAPE[0]
    cases = []
    for n, (b, r) in enumerate(((D, R), (D // 2, R // 2))):   # fwd levels 1, 2
        cases.append(Case("fwd_level_2d", rand(b, r, r),
                          lambda x: K.fwd_level_2d(x, lo, hi),
                          lambda x: K.fwd_level_2d_ref(x, lo, hi),
                          f"3D level {n + 1} {(b, r, r)}", True, b * flops_2d(r, r, hl)))
        m = r // 2   # the inverse of that level: depth-synthesized subbands
        cases.append(Case("inv_level_2d", [rand(b, m, m) for _ in range(4)],
                          lambda t: K.inv_level_2d(*t, rlo, rhi),
                          lambda t: K.inv_level_2d_ref(*t, rlo, rhi),
                          f"3D level {n + 1} subbands {(b, m, m)}", True,
                          b * flops_2d(r, r, hl)))
    for lvl in (1, 2):
        xs = rand(TD, R, R)
        fl = TD * flops_swt_2d(R, R, hl)
        cases.append(Case("swt_fwd_level_2d", xs,
                          lambda x, lv=lvl: S.swt_fwd_level_2d(x, lo, hi, lv),
                          lambda x, lv=lvl: S.swt_fwd_level_2d_ref(x, lo, hi, lv),
                          f"3D level {lvl} {(TD, R, R)}", True, fl))
        bands = S.swt_fwd_level_2d_ref(xs, lo, hi, lvl)
        for tt in (thr, None):
            cases.append(Case("swt_inv_level_2d", bands,
                              lambda t, lv=lvl, tt=tt: S.swt_inv_level_2d(*t, rlo, rhi, lv, tt),
                              lambda t, lv=lvl, tt=tt: S.swt_inv_level_2d_ref(*t, rlo, rhi, lv,
                                                                              tt),
                              f"3D level {lvl} {(TD, R, R)} threshold {tt and tt[0]}",
                              tt is not None, fl))
    # the banded-product kernels in every scheme the tiers route here: the
    # forward's level 1 on the volume's dtype, level 2 on the float32 chain;
    # the inverse levels write float32 (the depth synthesis follows), so
    # kernel 12 runs b3 and kernel 14 fd or b2f; the a-slot is float32
    fwd_l1 = {"mixed": ("b3", f32, f32), "bf16-fast": ("b1", bf16, bf16),
              "bf16-balanced": ("b2f", bf16, bf16), "bf16-accurate": ("b3", bf16, bf16)}
    seen = set()
    for tier, (s1, in_dt, det) in fwd_l1.items():
        timed = tier == ROW_TIER
        for lvl, (b, r, sch, idt) in enumerate(((D, R, s1, in_dt), (D // 2, R // 2, "b3", f32))):
            if (sch, idt, det, lvl) not in seen:
                seen.add((sch, idt, det, lvl))
                cases.append(Case("fwd_level_2d_mxu", rand(b, r, r).to(idt),
                                  lambda x, s=sch, d=det: M.fwd_level_2d_mxu(x, lo, hi, s,
                                                                             (f32, d)),
                                  lambda x, s=sch, d=det: M.fwd_level_2d_mxu_ref(x, lo, hi, s,
                                                                                 (f32, d)),
                                  f"3D {tier} level {lvl + 1} {sch} {idt} in {(b, r, r)}",
                                  timed and lvl == 0, b * flops_2d(r, r, hl, TERMS[sch]),
                                  scheme_peak(sch), scheme_limit(sch)))
            m = r // 2
            if ("i", det, lvl) not in seen:
                seen.add(("i", det, lvl))
                bands = [rand(b, m, m)] + [(rand(b, m, m) - 127.5).to(det) for _ in range(3)]
                cases.append(Case("inv_level_2d_mxu", bands,
                                  lambda t: M.inv_level_2d_mxu(*t, rlo, rhi, "b3", f32),
                                  lambda t: M.inv_level_2d_mxu_ref(*t, rlo, rhi, "b3", f32),
                                  f"3D level {lvl + 1} b3 {det} details {(b, m, m)}",
                                  timed and lvl == 0, b * flops_2d(r, r, hl, 3),
                                  scheme_peak("b3"), scheme_limit("b3")))
        if tier == "mixed":
            continue  # mixed runs the stationary transforms exact
        for lvl in (1, 2):
            idt = bf16 if lvl == 1 else f32
            sch = SWT_SCHEMES[tier][0 if lvl == 1 else 1]
            inv_sch = "fd" if tier == "bf16-fast" else "b2f"
            if ("s", sch, lvl) not in seen:
                seen.add(("s", sch, lvl))
                xs = rand(TD, R, R).to(idt)
                cases.append(Case("swt_fwd_level_2d_mxu", xs,
                                  lambda x, s=sch, lv=lvl: SM.swt_fwd_level_2d_mxu(
                                      x, lo, hi, lv, s, (f32, bf16)),
                                  lambda x, s=sch, lv=lvl: SM.swt_fwd_level_2d_mxu_ref(
                                      x, lo, hi, lv, s, (f32, bf16)),
                                  f"3D {tier} level {lvl} {sch} {idt} in {(TD, R, R)}",
                                  timed and lvl == 1, TD * flops_swt_2d(R, R, hl) * TERMS[sch],
                                  scheme_peak(sch), scheme_limit(sch)))
            if ("si", inv_sch, lvl) not in seen:
                seen.add(("si", inv_sch, lvl))
                bands = list(SM.swt_fwd_level_2d_mxu_ref(rand(TD, R, R).to(bf16), lo, hi, lvl,
                                                         "b1", (f32, bf16)))
                for tt in (thr, None):
                    cases.append(Case(
                        "swt_inv_level_2d_mxu", bands,
                        lambda t, s=inv_sch, lv=lvl, tt=tt: SM.swt_inv_level_2d_mxu(
                            *t, rlo, rhi, lv, s, f32, tt),
                        lambda t, s=inv_sch, lv=lvl, tt=tt: SM.swt_inv_level_2d_mxu_ref(
                            *t, rlo, rhi, lv, s, f32, tt),
                        f"3D {tier} level {lvl} {inv_sch} threshold {tt and tt[0]} {(TD, R, R)}",
                        timed and lvl == 1 and tt is not None,
                        TD * flops_swt_2d(R, R, hl) * TERMS[inv_sch], scheme_peak(inv_sch),
                        scheme_limit(inv_sch)))
    # a batch of 5 x 3 planes (a batch of 3 volumes of depth 5), odd subbands
    odd = (15, 37, 53)
    cases.append(Case("fwd_level_2d", rand(15, 74, 106), lambda x: K.fwd_level_2d(x, lo, hi),
                      lambda x: K.fwd_level_2d_ref(x, lo, hi), "batch 5x3 (15, 74, 106)"))
    cases.append(Case("inv_level_2d", [rand(*odd) for _ in range(4)],
                      lambda t: K.inv_level_2d(*t, rlo, rhi),
                      lambda t: K.inv_level_2d_ref(*t, rlo, rhi), f"batch 5x3 subbands {odd}"))
    ob = S.swt_fwd_level_2d_ref(rand(*odd), lo, hi, 2)
    cases.append(Case("swt_fwd_level_2d", rand(*odd), lambda x: S.swt_fwd_level_2d(x, lo, hi, 2),
                      lambda x: S.swt_fwd_level_2d_ref(x, lo, hi, 2), f"batch 5x3 {odd} level 2"))
    cases.append(Case("swt_inv_level_2d", ob,
                      lambda t: S.swt_inv_level_2d(*t, rlo, rhi, 2, ("hard", 20.0)),
                      lambda t: S.swt_inv_level_2d_ref(*t, rlo, rhi, 2, ("hard", 20.0)),
                      f"batch 5x3 {odd} level 2 threshold hard"))
    cases.append(Case("fwd_level_2d_mxu", rand(15, 64, 256).to(bf16),
                      lambda x: M.fwd_level_2d_mxu(x, lo, hi, "b1", (f32, bf16)),
                      lambda x: M.fwd_level_2d_mxu_ref(x, lo, hi, "b1", (f32, bf16)),
                      "batch 5x3 (15, 64, 256) b1", limit=scheme_limit("b1")))
    ib = [rand(15, 32, 128)] + [(rand(15, 32, 128) - 127.5).to(bf16) for _ in range(3)]
    cases.append(Case("inv_level_2d_mxu", ib, lambda t: M.inv_level_2d_mxu(*t, rlo, rhi, "b3", f32),
                      lambda t: M.inv_level_2d_mxu_ref(*t, rlo, rhi, "b3", f32),
                      "batch 5x3 subbands (15, 32, 128) b3", limit=scheme_limit("b3")))
    cases.append(Case("swt_fwd_level_2d_mxu", rand(15, 64, 256),
                      lambda x: SM.swt_fwd_level_2d_mxu(x, lo, hi, 2, "fd", (f32, bf16)),
                      lambda x: SM.swt_fwd_level_2d_mxu_ref(x, lo, hi, 2, "fd", (f32, bf16)),
                      "batch 5x3 (15, 64, 256) level 2 fd", limit=scheme_limit("fd")))
    sb = list(SM.swt_fwd_level_2d_mxu_ref(rand(15, 64, 256), lo, hi, 1, "fd", (f32, bf16)))
    cases.append(Case("swt_inv_level_2d_mxu", sb,
                      lambda t: SM.swt_inv_level_2d_mxu(*t, rlo, rhi, 1, "b2f", f32,
                                                        ("garrote", 20.0)),
                      lambda t: SM.swt_inv_level_2d_mxu_ref(*t, rlo, rhi, 1, "b2f", f32,
                                                            ("garrote", 20.0)),
                      "batch 5x3 (15, 64, 256) level 1 b2f threshold garrote",
                      limit=scheme_limit("b2f")))
    # one pass of each kernel at the 3D path's shapes, in a report of its own
    # (the JSON rows keep their 2D paths' times); worst errors go to both
    vrep = {name: dict(report[name], max_abs_err=0.0, ms=0.0, plain_ms=0.0, device_ms=0.0,
                       plain_device_ms=0.0, bytes_ms=0.0, ops_ms=0.0, bound_ms=0.0,
                       library_ms=None) for name in VOL_NAMES}
    run_cases(cases, vrep, card)
    for name in VOL_NAMES:
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], vrep[name]["max_abs_err"])
    print("volume kernels, one pass of the 3D path's timed shapes (ms; device ms by "
          f"torch.profiler) [{card}]: " + json.dumps(
              {n: {k: vrep[n][k] for k in ("ms", "plain_ms", "device_ms", "plain_device_ms",
                                           "bound_ms", "max_abs_err")} for n in VOL_NAMES}),
          flush=True)
    del cases
    torch.cuda.empty_cache()
    print(f"volume (a): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (b) the exact roundtrip ----------------
    vol = rand(*VOL_SHAPE)
    exact_rt = {"fwd_level_2d": L, "inv_level_2d": L}
    rt = lambda x: idwt3d(dwt3d(x, w, L), w, VOL_SHAPE)
    c = counted_exactly("dwt3d", lambda: dwt3d(vol, w, L), {"fwd_level_2d": L}, vol_launches)
    y = counted_exactly("idwt3d", lambda: idwt3d(c, w, VOL_SHAPE), {"inv_level_2d": L},
                        vol_launches)
    Wv = Wavelets(vol, wname=VOL_WNAME, levels=L, device=dev)
    wc = counted_exactly("Wavelets(volume).forward", Wv.forward, {"fwd_level_2d": L},
                         vol_launches)
    wy = counted_exactly("Wavelets(volume).inverse", Wv.inverse, {"inv_level_2d": L},
                         vol_launches)
    check(all(torch.equal(a, b) for a, b in zip(leaves(wc), leaves(c))) and torch.equal(wy, y),
          "volume: the facade's roundtrip differs from dwt3d/idwt3d's")
    with plain_route():
        cp = dwt3d(vol, w, L)
        yp = idwt3d(cp, w, VOL_SHAPE)
    vhold("volume roundtrip: coefficients vs the same composition on plain versions", c, cp)
    vhold("volume roundtrip: image vs the same composition on plain versions", y, yp)
    per = ("periodization",) * 3
    cc = S3._dwt3d_mode(vol, w, L, per)
    yc = S3._idwt3d_mode(cc, w, VOL_SHAPE, per)
    vhold("volume roundtrip: coefficients vs the conv passes", c, cc, CONV_RTOL)
    vhold("volume roundtrip: image vs the conv passes", y, yc, CONV_RTOL)
    err = float((y - vol).abs().max())
    print(f"volume roundtrip max|idwt3d(dwt3d(x)) - x| = {err:.3e} (limit {ROUNDTRIP_ATOL})",
          flush=True)
    check(err <= ROUNDTRIP_ATOL, "volume roundtrip error")
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        yh = counted_exactly("roundtrip under set_float32_matmul_precision('high')",
                             lambda: rt(vol), exact_rt, vol_launches)
        check(torch.get_float32_matmul_precision() == "high",
              "volume: the depth product did not restore the caller's setting")
        vhold("volume roundtrip (precision 'high') vs the plain composition", yh, yp)
        vhold("volume roundtrip (precision 'high') vs the conv passes", yh, yc, CONV_RTOL)
        errh = float((yh - vol).abs().max())
        print(f"volume roundtrip (precision 'high') max|y - x| = {errh:.3e} (limit "
              f"{ROUNDTRIP_ATOL})", flush=True)
        check(errh <= ROUNDTRIP_ATOL, "volume roundtrip error under precision 'high'")
    finally:
        torch.set_float32_matmul_precision(prev)
    del cc, yc, cp, yp, wc, wy
    label = f"volume roundtrip {VOL_SHAPE} {VOL_WNAME} {L} levels"
    time_in_turns(label, lambda: rt(vol), lambda: plain_rt(rt, vol), card)
    vol_timing(label, lambda: rt(vol), card)
    print(f"volume (b): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (c) the roundtrip under each tier ----------------
    for tier in TIERS:
        xt = vol if tier == "mixed" else vol.to(bf16)
        det = f32 if tier == "mixed" else bf16
        ct = counted_exactly(f"dwt3d {tier}", lambda: dwt3d(xt, w, L, precision=tier),
                             {"fwd_level_2d_mxu": L}, vol_launches)
        yt = counted_exactly(f"idwt3d {tier}", lambda: idwt3d(ct, w, VOL_SHAPE, precision=tier),
                             {"inv_level_2d_mxu": 2 * L}, vol_launches)
        check(ct.approx.dtype == f32 and all(b.dtype == det for d in ct.details for b in d)
              and yt.dtype == xt.dtype, f"volume {tier}: the dtype contract")
        with plain_route():
            cpt = dwt3d(xt, w, L, precision=tier)
            ypt = idwt3d(cpt, w, VOL_SHAPE, precision=tier)
        compare_route(f"volume roundtrip {tier}", (ct, yt), (cpt, ypt))
        errt = float((yt.float() - vol).abs().max())
        print(f"volume roundtrip {tier} max|y - x| = {errt!r} on [0, 255] (limit "
              f"{VOL_ROUNDTRIP_LIMIT[tier]})", flush=True)
        check(errt <= VOL_ROUNDTRIP_LIMIT[tier], f"volume roundtrip error under {tier}")
        del cpt, ypt
        vol_timing(f"{label} {tier}", lambda: idwt3d(dwt3d(xt, w, L, precision=tier), w,
                                                     VOL_SHAPE, precision=tier), card)
    Wv.forward()
    print(f"volume (c): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (d) the TI step ----------------
    vti = rand(*VTI_SHAPE)
    for tier in ("exact",) + TIERS:
        xt = vti.to(bf16) if tier.startswith("bf16") else vti
        routed = tier.startswith("bf16")
        want = ({"swt_fwd_level_2d_mxu": L, "swt_inv_level_2d_mxu": 2 * L} if routed
                else {"swt_fwd_level_2d": L, "swt_inv_level_2d": 2 * L})

        def step(x=xt, tier=tier):
            with P.precision_scope(tier):
                return denoise_step_3d(x, torch.Generator(device=dev).manual_seed(7), w, L,
                                       VTI_BETA, swt=True)

        def unfused(x=xt, tier=tier):
            g = torch.Generator(device=dev).manual_seed(7)
            sh = [int(torch.randint(0, n, (), generator=g, device=dev)) for n in VTI_SHAPE]
            with P.precision_scope(tier):
                ct = ops.soft_threshold(swt3d(ops.circshift3d(x, *sh), w, L), VTI_BETA)
                return ops.circshift3d(iswt3d(ct, w), *(-s for s in sh)), ops.norm1(ct)

        out, n1 = counted_exactly(f"TI step {tier}", step, want, vol_launches)
        check(tuple(out.shape) == VTI_SHAPE and out.dtype == xt.dtype
              and bool(torch.isfinite(out).all()), f"volume TI step {tier}: shape, dtype, finite")
        with plain_route():
            outp, n1p = step()
            outu, n1u = unfused()
        compare_route(f"volume TI step {tier}", out, outp)
        if xt.dtype == bf16:
            erru = float((out.float() - outu.float()).abs().max())
            print(f"volume TI step {tier} vs the unfused path on plain versions: max|diff| "
                  f"{erru:.3e} (limit {VTI_UNFUSED_BF16_ATOL})", flush=True)
            check(erru <= VTI_UNFUSED_BF16_ATOL, f"volume TI step {tier} vs the unfused path")
        else:
            vhold(f"volume TI step {tier} vs the unfused path on plain versions", out, outu)
        for a, b, what in ((n1, n1p, "the same route"), (n1, n1u, "norm1 of the thresholded "
                                                                  "tree (unfused)")):
            print(f"volume TI step {tier} norm {float(a)!r} vs {what} {float(b)!r}", flush=True)
            check(abs(float(a) - float(b)) <= NORM_RTOL * abs(float(b)),
                  f"volume TI step {tier}: the fused norm vs {what}")
        with P.precision_scope(tier):
            kc = swt3d(xt, w, L)
            fused = float(ops.thresholded_norm1(kc, VTI_BETA))
            full = float(ops.norm1(ops.soft_threshold(kc, VTI_BETA)))
        print(f"volume TI step {tier}: thresholded_norm1 {fused!r} vs norm1(soft_threshold) "
              f"{full!r}", flush=True)
        check(abs(fused - full) <= NORM_RTOL * abs(full), f"volume {tier} thresholded_norm1")
        del outp, outu, kc
        lab = f"volume TI step {VTI_SHAPE} {VOL_WNAME} {L} levels soft beta {VTI_BETA} {tier}"
        if tier == "exact":
            time_in_turns(lab, step, lambda: plain_rt(step), card)
        vol_timing(lab, step, card)
    print(f"volume (d): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (e) the rest of the slice on the card ----------------
    T = Wavelets(vti, wname=VOL_WNAME, levels=L, do_swt=True, device=dev)
    run_out, run_n1 = counted_exactly("Wavelets(volume, do_swt=True).run_denoise",
                                      lambda: T.run_denoise(VTI_BETA),
                                      {"swt_fwd_level_2d": L, "swt_inv_level_2d": 2 * L},
                                      vol_launches)
    ref_out, ref_n1 = denoise_step_3d(vti, None, w, L, VTI_BETA, swt=True)
    vhold("volume facade run_denoise vs denoise_step_3d", run_out, ref_out)
    vhold_value("volume facade run_denoise norm vs denoise_step_3d's", run_n1, ref_n1)
    band = Wv.get_coeff(14, copy=False)
    check(band is Wv.coeffs.details[1][6], "volume: get_coeff(14) is not level 2's ddd")
    Wv.set_coeff(torch.zeros_like(band), 14)
    check(float(Wv.coeffs.details[1][6].abs().max()) == 0.0
          and Wv.coeffs.details[1][5] is not None, "volume: set_coeff(14)")
    Wc = Wavelets(vol, wname=VOL_WNAME, levels=L, do_cycle_spinning=True, seed=5, device=dev)
    Wc.forward()
    yc = Wc.inverse()
    errc = float((yc - vol).abs().max())
    shifts = (Wc.current_shift_d, Wc.current_shift_r, Wc.current_shift_c)
    print(f"volume cycle spinning, shifts (d, r, c) {shifts}: max|y - x| {errc:.3e} (limit "
          f"{ROUNDTRIP_ATOL})", flush=True)
    check(any(shifts) and errc <= ROUNDTRIP_ATOL, "volume cycle spinning roundtrip")
    for method in ("bayes", "sure", "universal"):
        got = counted_exactly(f"auto_denoise_3d {method}",
                              lambda m=method: auto_denoise_3d(vti, w, L, method=m),
                              {"fwd_level_2d": L, "inv_level_2d": L}, vol_launches)
        with plain_route():
            want = auto_denoise_3d(vti, w, L, method=method)
        vhold(f"volume auto_denoise_3d {method} vs the plain route", got, want)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "v.npz")
        save_coeffs(path, ct)
        back = load_coeffs(path, device=dev)
        check(type(back).__name__ == "Coeffs3D" and back.approx.device.type == "cuda"
              and all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(leaves(back), leaves(ct))), "volume: 3D checkpoint")
        print("volume: a bf16 3D checkpoint saved and loaded on the card, equal", flush=True)
        small = vol[:16, :64, :64].contiguous()
        dat = os.path.join(tmp, "v.dat")
        write_dat(dat, small.cpu().numpy())
        for scenario in ("1", "2", "3"):
            out_path = os.path.join(tmp, f"r{scenario}.dat")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = demo.main([dat, "--nd", "16", "--nr", "64", "--nc", "64", "--scenario",
                                scenario, "--wavelet", VOL_WNAME, "--levels", str(L), "--out",
                                out_path])
            text = buf.getvalue()
            check(rc == 0 and "Data dimensions : (16, 64, 64)" in text
                  and f"cuda:{torch.cuda.get_device_name(dev)}" in text,
                  f"volume: demo --nd scenario {scenario}: rc {rc}, output {text!r}")
            if scenario == "2":
                res = torch.from_numpy(np.fromfile(out_path, np.float32)).to(dev)
                errd = float((res.reshape(small.shape) - small).abs().max())
                print(f"volume: demo --nd scenario 2 max|y - x| {errd:.3e}", flush=True)
                check(errd <= ROUNDTRIP_ATOL, "volume: demo --nd roundtrip")
    print(f"volume launches: {vol_launches}", flush=True)
    for name in VOL_NAMES:
        check(vol_launches.get(name, 0) > 0, f"the volume path never launched {name}")
        launches[name] += vol_launches[name]
    print(f"volume phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# the packet, starlet and dual-tree families (ROADMAP items 14a-14b)
# ---------------------------------------------------------------------------

# 2D packets at the DWT cell's image and wavelet, 1D at the 1D cell's
# signals and wavelet, 3D at the TI volume's shape with the 3D cells'
# wavelet; the soft beta of the best-basis reconstruct; the starlet's
# scales, the dual tree's levels (2048 and 4096 divide by 2^4)
FAM_LEVELS, FAM_1D_LEVELS, FAM_3D_LEVELS, FAM_BETA = 5, 4, 2, 10.0
STARLET_SCALES, DT_LEVELS = 4, 4
PACKET_TIERS = ("bf16-fast", "mixed")
# JAX's packets cast the A-chain to the details' dtype at every depth, so a
# bf16 tier rounds the deep approximations (up to 32 x 255 at depth 5) to
# bf16: the roundtrip limit is the larger of README's tier figure and the
# JAX package's error on the same input (scripts/jax_roundtrip_figures.py)
FAM_KERNELS = ("fwd_level_2d", "inv_level_2d", "fwd_tail_2d", "inv_tail_2d", "fwd_level_1d",
               "inv_level_1d", "fwd_level_2d_mxu", "inv_level_2d_mxu", "fwd_level_1d_mxu",
               "inv_level_1d_mxu")


def _bump(d: dict, name: str, k: int = 1) -> dict:
    d[name] = d.get(name, 0) + k
    return d


def level_kernel_2d(r: int, c: int, hlen: int, mxu=None, bf16: bool = False) -> str:
    """The kernel one single-level dwt2d launches on (B, r, c) nodes
    (core/separable.py: the banded product where the tier's route accepts
    the subbands, else the one-level tail where it fits, on float32 only,
    else the level kernel)."""
    from pdwt_tpu_torch import kernels as KK

    r, c = r + r % 2, c + c % 2
    if mxu and KK.mxu_route_2d(r // 2, c // 2, hlen):
        return "fwd_level_2d_mxu"
    if not bf16 and KK.tail_supported((r, c), hlen, 1):
        return "fwd_tail_2d"
    return "fwd_level_2d"


def inv_kernel_2d(out_r: int, out_c: int, hlen: int, mxu=None) -> str:
    """The kernel one single-level idwt2d launches into (out_r, out_c)."""
    from pdwt_tpu_torch import kernels as KK

    mr, mc = (out_r + 1) // 2, (out_c + 1) // 2
    banded = bool(mxu) and KK.mxu_route_2d(mr, mc, hlen)
    if (out_r, out_c) == (2 * mr, 2 * mc) and KK.tail_supported((out_r, out_c), hlen, 1) \
            and not banded:
        return "inv_tail_2d"
    return "inv_level_2d_mxu" if banded else "inv_level_2d"


def wp_launches(sd: int, shape, hlen: int, levels: int, deepest: Optional[int] = None,
                mxu=None, bf16: bool = False):
    """({kernel: launches} of wp2d / wp1d to ``levels``, of the inverse from
    depth ``deepest`` (default ``levels``) up): one single-level transform a
    depth, the node axis its batch.  ``shape``: (rows, cols) in 2D,
    (signals, length) in 1D."""
    from pdwt_tpu_torch import kernels as KK
    from pdwt_tpu_torch.core.shapes import level_sizes

    deepest = levels if deepest is None else deepest
    fwd, inv = {}, {}
    if sd == 2:
        rows, cols = (level_sizes(n, levels) for n in shape)
        for j in range(levels):
            _bump(fwd, level_kernel_2d(rows[j], cols[j], hlen, mxu, bf16))
        for j in range(deepest, 0, -1):
            _bump(inv, inv_kernel_2d(rows[j - 1], cols[j - 1], hlen, mxu))
        return fwd, inv
    sig, n = shape
    lens = level_sizes(n, levels)
    for j in range(levels):
        banded = mxu and KK.mxu_route_1d(sig << j, lens[j] + lens[j] % 2, hlen)
        _bump(fwd, "fwd_level_1d_mxu" if banded else "fwd_level_1d")
    for j in range(deepest, 0, -1):
        banded = mxu and KK.mxu_route_1d(sig << (j - 1), 2 * lens[j], hlen)
        _bump(inv, "inv_level_1d_mxu" if banded else "inv_level_1d")
    return fwd, inv


def dt_launches(shape, hlen: int, levels: int):
    """({kernel: launches} of dtcwt2d / dtcwt1d, of their inverse): level 1
    runs tree A's bank on the four (two in 1D) tree combos, deeper levels
    the uniform combos (AA, BB) on the level kernels and the mixed ones on
    the conv passes; ``shape``: (rows, cols), or (signals, length) in 1D
    (``dwt1d(x, wa, levels)`` for tree A, single levels for tree B)."""
    if len(shape) == 1:
        return ({"fwd_level_1d": 2 * levels}, {"inv_level_1d": 2 * levels})
    r, c = shape
    fwd, inv = {}, {}
    _bump(fwd, level_kernel_2d(r, c, hlen), 4)
    _bump(inv, inv_kernel_2d(r, c, hlen), 4)
    for lvl in range(1, levels):
        _bump(fwd, level_kernel_2d(r >> lvl, c >> lvl, hlen), 2)
        _bump(inv, inv_kernel_2d(r >> lvl, c >> lvl, hlen), 2)
    return fwd, inv


def _merged(*ds) -> dict:
    out = {}
    for d in ds:
        for k, v in d.items():
            _bump(out, k, v)
    return out


def real_view(t):
    """Complex bands as (..., 2) real views: their real and imaginary parts
    are held like any other output."""
    if isinstance(t, torch.Tensor):
        return torch.view_as_real(t) if t.is_complex() else t
    return [real_view(x) for x in t]


def fhold(label, got, want, rtol=PATH_RTOL) -> None:
    vhold(f"families: {label}", real_view(got), real_view(want), rtol)


def count_device_kernels(fn) -> Optional[int]:
    """The device events (kernels, copies, fills) one fn() call records in
    torch.profiler: the launches a call costs the host, the port's and
    PyTorch's together (a window that drops events reads low)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def families_phase(dev, card, report, launches, gen) -> None:
    """The packet, starlet and dual-tree families at full width on the
    existing kernels: (a) the 2048x2048 db7 5-level packet tree (wp2d,
    iwp2d, the best basis under each cost, wp_reconstruct on that cover
    with and without a soft beta, map_fn a leaf at a time beside one
    threshold pass a depth, packet_denoise with the automatic beta,
    WaveletPackets); (b) its roundtrip under bf16-fast and mixed; (c) 1D
    packets of 1024 x 4096 sym8 to 4 levels, also under bf16-fast and
    mixed; (d) 3D packets of 64 x 512 x 512 db4 to 2 levels and
    WaveletPackets(ndim=3); (e) the starlet of the image (4 scales, gen 2),
    starlet_auto_denoise and Starlet on the volume; (f) the dual tree of
    the image (4 levels) and of the signals, dtcwt_auto_denoise, DualTree;
    (g) the demo's scenarios 4-6 on the card.  Every call between a reset
    and a read of the launch counters (exactly the route's launches), held
    to the same composition on the plain route (one best-basis cover for
    both routes: their float32 cost sums may split a near-tie otherwise),
    or where no kernel runs (the starlet) to the same call in float64;
    each path timed (call, busy split, idle share, peak)."""
    import importlib
    import io
    import tempfile

    from pdwt_tpu_torch import DualTree, Starlet, WaveletPackets, demo, get_wavelet
    from pdwt_tpu_torch.core import dualtree as DT
    from pdwt_tpu_torch.core import packets as PK
    from pdwt_tpu_torch.core.precision import precision_scope
    from pdwt_tpu_torch.models import packet_denoise, starlet_auto_denoise
    from pdwt_tpu_torch.ops.estimate import _MAD_TO_SIGMA, median
    from pdwt_tpu_torch.ops.threshold import THR_ELEM, _const
    from pdwt_tpu_torch.utils import write_dat

    ST = importlib.import_module("pdwt_tpu_torch.core.starlet")
    print("=== families ===", flush=True)
    t_phase = time.perf_counter()
    fam: dict = {}
    f32, bf16 = torch.float32, torch.bfloat16
    counted = lambda label, fn, want: counted_exactly(label, fn, want, fam, "families")
    timing = lambda label, fn: vol_timing(label, fn, card, "families")
    soft = THR_ELEM["soft"]
    w = get_wavelet(WNAME)
    hl, L, shape = w.hlen, FAM_LEVELS, (N, N)
    img_np = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    img = torch.from_numpy(img_np).to(dev)

    # ---------------- (a) 2D packets, exact ----------------
    pf, pi = wp_launches(2, shape, hl, L)
    p = counted("wp2d", lambda: PK.wp2d(img, w, L), pf)
    y = counted("iwp2d", lambda: PK.iwp2d(p.nodes[-1], w, shape), pi)
    with plain_route():
        pp = PK.wp2d(img, w, L)
        yp = PK.iwp2d(pp.nodes[-1], w, shape)
    fhold("wp2d nodes vs the plain route", list(p.nodes), list(pp.nodes))
    fhold("iwp2d vs the plain route", y, yp)
    err = float((y - img).abs().max())
    print(f"families: 2D packet roundtrip {shape} {WNAME} {L} levels max|y - x| {err!r} "
          f"(limit {ROUNDTRIP_ATOL})", flush=True)
    check(err <= ROUNDTRIP_ATOL, "families: the 2D packet roundtrip error")
    del yp
    timing(f"2D packets wp2d + iwp2d {shape} {WNAME} {L} levels",
           lambda: PK.iwp2d(PK.wp2d(img, w, L).nodes[-1], w, shape))
    covers = {}
    for cost in PK.COSTS:
        cov, total = counted(f"best_basis {cost}", lambda c=cost: PK.best_basis(p, c, FAM_BETA),
                             {})
        covers[cost] = cov
        same = PK.best_basis(pp, cost, FAM_BETA)[0] == cov
        deep = max(j for j, _ in cov)
        print(f"families: best_basis {cost}: {len(cov)} leaves, depths "
              f"{sorted({j for j, _ in cov})}, cost {total!r}; the plain route's nodes give "
              f"{'the same cover' if same else 'another cover (a near-tie)'}", flush=True)
        _, inv = wp_launches(2, shape, hl, L, deep)
        r0 = counted(f"wp_reconstruct ({cost} cover)",
                     lambda lv=cov: PK.wp_reconstruct(p, lv, w), inv)
        r1 = counted(f"wp_reconstruct ({cost} cover, soft beta {FAM_BETA})",
                     lambda lv=cov: PK.wp_reconstruct(
                         PK.threshold_details(p, lv, soft, FAM_BETA), lv, w), inv)
        with plain_route():
            r0p = PK.wp_reconstruct(pp, cov, w)
            r1p = PK.wp_reconstruct(PK.threshold_details(pp, cov, soft, FAM_BETA), cov, w)
        fhold(f"wp_reconstruct ({cost} cover) vs the plain route", r0, r0p)
        fhold(f"wp_reconstruct ({cost} cover, soft) vs the plain route", r1, r1p)
        err = float((r0 - img).abs().max())
        check(err <= ROUNDTRIP_ATOL, f"families: wp_reconstruct ({cost} cover) max|y - x| {err}")
        check(bool(torch.isfinite(r1).all()) and float((r1 - img).abs().max()) > 0,
              f"families: the soft reconstruct ({cost} cover) thresholded nothing")
    cover = covers["shannon"]
    _, inv = wp_launches(2, shape, hl, L, max(j for j, _ in cover))
    per_leaf = lambda: PK.wp_reconstruct(p, cover, w, map_fn=lambda v, j, i: v if i == 0
                                         else soft(v, FAM_BETA))
    stacked = lambda: PK.wp_reconstruct(PK.threshold_details(p, cover, soft, FAM_BETA), cover, w)
    a = counted("wp_reconstruct, map_fn a leaf at a time", per_leaf, inv)
    check(torch.equal(a, stacked()), "families: map_fn a leaf at a time differs from one "
          "threshold pass a depth")
    for how, fn in (("map_fn a leaf at a time", per_leaf), ("one threshold pass a depth", stacked)):
        print(f"families: wp_reconstruct (shannon cover, {len(cover)} leaves, soft) {how}: "
              f"{count_device_kernels(fn)} device launches a call", flush=True)
        timing(f"wp_reconstruct shannon cover soft beta {FAM_BETA}, {how}", fn)
    # packet_denoise: its own basis is the shannon cover of these nodes (the
    # same code on the same card); the plain route gets that cover and beta
    d1 = p.nodes[1][..., 3, :, :].float()
    beta = median(d1.abs()) * _const(_MAD_TO_SIGMA, d1) * _const(
        math.sqrt(2.0 * math.log(N * N)), d1)
    out = counted("packet_denoise (automatic beta)", lambda: packet_denoise(img, WNAME, L),
                  _merged(pf, inv))
    with plain_route():
        want = PK.wp_reconstruct(PK.threshold_details(pp, cover, soft, beta), cover, w)
    print(f"families: packet_denoise beta {float(beta)!r}", flush=True)
    fhold("packet_denoise vs the plain route (one cover, one beta)", out, want)
    timing(f"packet_denoise {shape} {WNAME} {L} levels", lambda: packet_denoise(img, WNAME, L))
    WP = WaveletPackets(img, wname=WNAME, levels=L, device=dev)
    wp = counted("WaveletPackets.forward", WP.forward, pf)
    check(all(torch.equal(u, v) for u, v in zip(wp.nodes, p.nodes)),
          "families: WaveletPackets.forward differs from wp2d")
    check(counted("WaveletPackets.best_basis", WP.best_basis, {})[0] == cover,
          "families: WaveletPackets.best_basis differs from best_basis")
    check(torch.equal(counted("WaveletPackets.reconstruct(beta)",
                              lambda: WP.reconstruct(beta=FAM_BETA), inv), a),
          "families: WaveletPackets.reconstruct differs from wp_reconstruct")
    del pp, WP, wp, want
    torch.cuda.empty_cache()
    print(f"families (a): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (b) 2D packets under the tiers ----------------
    for tier in PACKET_TIERS:
        is_bf = tier.startswith("bf16")
        xt = img.to(bf16) if is_bf else img
        mxu = "bf16" if is_bf else "mixed"
        tf, ti = wp_launches(2, shape, hl, L, mxu=mxu, bf16=is_bf)
        with precision_scope(tier):
            pt = counted(f"wp2d {tier}", lambda: PK.wp2d(xt, w, L), tf)
            yt = counted(f"iwp2d {tier}", lambda: PK.iwp2d(pt.nodes[-1], w, shape), ti)
        with plain_route(), precision_scope(tier):
            ptp = PK.wp2d(xt, w, L)
            ytp = PK.iwp2d(ptp.nodes[-1], w, shape)
        check(all(t.dtype == xt.dtype for t in pt.nodes) and yt.dtype == xt.dtype,
              f"families: 2D packets {tier}: the dtype contract (every node in the input's)")
        compare_route(f"families: 2D packets {tier}", (list(pt.nodes), yt),
                      (list(ptp.nodes), ytp))
        limit = max(ROUNDTRIP_LIMIT[tier], JAX_CPU_ROUNDTRIP["2D packets"][tier])
        err = float((yt.float() - img).abs().max())
        print(f"families: 2D packet roundtrip {tier} max|y - x| {err!r} on [0, 255] (limit "
              f"{limit})", flush=True)
        check(err <= limit, f"families: the 2D packet roundtrip error under {tier}")
        del pt, yt, ptp, ytp

        def rt(x=xt, tier=tier):
            with precision_scope(tier):
                return PK.iwp2d(PK.wp2d(x, w, L).nodes[-1], w, shape)

        timing(f"2D packets wp2d + iwp2d {shape} {WNAME} {L} levels {tier}", rt)
    del p
    torch.cuda.empty_cache()
    print(f"families (b): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (c) 1D packets ----------------
    w8 = get_wavelet(B1_WNAME)
    L1, sshape = FAM_1D_LEVELS, (B1_SIGNALS, B1_N)
    sig = torch.randn(sshape, device=dev, generator=gen)
    qf, qi = wp_launches(1, sshape, w8.hlen, L1)
    q = counted("wp1d", lambda: PK.wp1d(sig, w8, L1), qf)
    ys = counted("iwp1d", lambda: PK.iwp1d(q.nodes[-1], w8, B1_N), qi)
    with plain_route():
        qp = PK.wp1d(sig, w8, L1)
        ysp = PK.iwp1d(qp.nodes[-1], w8, B1_N)
    fhold("wp1d nodes vs the plain route", list(q.nodes), list(qp.nodes))
    fhold("iwp1d vs the plain route", ys, ysp)
    err = float((ys - sig).abs().max())
    print(f"families: 1D packet roundtrip {sshape} {B1_WNAME} {L1} levels max|y - x| {err!r} "
          f"(limit {ROUNDTRIP_ATOL})", flush=True)
    check(err <= ROUNDTRIP_ATOL, "families: the 1D packet roundtrip error")
    leaves1, _ = PK.best_basis(q, "shannon")
    _, qinv = wp_launches(1, sshape, w8.hlen, L1, max(j for j, _ in leaves1))
    rec1 = lambda: PK.wp_reconstruct(PK.threshold_details(q, leaves1, soft, B1_BETA), leaves1, w8)
    r1 = counted(f"wp_reconstruct 1D (shannon cover, {len(leaves1)} leaves, soft beta "
                 f"{B1_BETA})", rec1, qinv)
    with plain_route():
        r1p = PK.wp_reconstruct(PK.threshold_details(qp, leaves1, soft, B1_BETA), leaves1, w8)
    fhold("wp_reconstruct 1D (shannon cover, soft) vs the plain route", r1, r1p)
    del qp, ysp, r1p
    timing(f"1D packets wp1d + iwp1d {sshape} {B1_WNAME} {L1} levels",
           lambda: PK.iwp1d(PK.wp1d(sig, w8, L1).nodes[-1], w8, B1_N))
    timing(f"1D packets best-basis reconstruct, soft beta {B1_BETA}", rec1)
    usig = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, sshape).astype(
        np.float32)).to(dev)
    for tier in PACKET_TIERS:
        is_bf = tier.startswith("bf16")
        xt = usig.to(bf16) if is_bf else usig
        tf, ti = wp_launches(1, sshape, w8.hlen, L1, mxu="bf16" if is_bf else "mixed",
                             bf16=is_bf)
        with precision_scope(tier):
            qt = counted(f"wp1d {tier}", lambda: PK.wp1d(xt, w8, L1), tf)
            yt = counted(f"iwp1d {tier}", lambda: PK.iwp1d(qt.nodes[-1], w8, B1_N), ti)
        with plain_route(), precision_scope(tier):
            qtp = PK.wp1d(xt, w8, L1)
            ytp = PK.iwp1d(qtp.nodes[-1], w8, B1_N)
        compare_route(f"families: 1D packets {tier}", (list(qt.nodes), yt),
                      (list(qtp.nodes), ytp))
        limit = max(ROUNDTRIP_LIMIT[tier], JAX_CPU_ROUNDTRIP["1D packets"][tier])
        err = float((yt.float() - usig).abs().max())
        print(f"families: 1D packet roundtrip {tier} max|y - x| {err!r} on [0, 255] (limit "
              f"{limit})", flush=True)
        check(err <= limit, f"families: the 1D packet roundtrip error under {tier}")
        del qt, yt, qtp, ytp

        def rt1(x=xt, tier=tier):
            with precision_scope(tier):
                return PK.iwp1d(PK.wp1d(x, w8, L1).nodes[-1], w8, B1_N)

        timing(f"1D packets wp1d + iwp1d {sshape} {B1_WNAME} {L1} levels {tier}", rt1)
    del q, usig
    torch.cuda.empty_cache()
    print(f"families (c): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (d) 3D packets ----------------
    w4, L3 = get_wavelet(VOL_WNAME), FAM_3D_LEVELS
    vol = torch.rand(VTI_SHAPE, device=dev, generator=gen) * 255.0
    # dwt3d / idwt3d to one level, exact: one 2D level kernel (depth the
    # batch) and the depth products a depth
    v = counted("wp3d", lambda: PK.wp3d(vol, w4, L3), {"fwd_level_2d": L3})
    yv = counted("iwp3d", lambda: PK.iwp3d(v.nodes[-1], w4, VTI_SHAPE), {"inv_level_2d": L3})
    with plain_route():
        vp = PK.wp3d(vol, w4, L3)
        yvp = PK.iwp3d(vp.nodes[-1], w4, VTI_SHAPE)
    fhold("wp3d nodes vs the plain route", list(v.nodes), list(vp.nodes))
    fhold("iwp3d vs the plain route", yv, yvp)
    err = float((yv - vol).abs().max())
    print(f"families: 3D packet roundtrip {VTI_SHAPE} {VOL_WNAME} {L3} levels max|y - x| "
          f"{err!r} (limit {ROUNDTRIP_ATOL})", flush=True)
    check(err <= ROUNDTRIP_ATOL, "families: the 3D packet roundtrip error")
    del vp, yvp
    WV = WaveletPackets(vol, wname=VOL_WNAME, levels=L3, device=dev)
    check(WV.ndim == 3, "families: WaveletPackets on a volume is not 3D")
    wv = counted("WaveletPackets(ndim=3).forward", WV.forward, {"fwd_level_2d": L3})
    check(all(torch.equal(u, t) for u, t in zip(wv.nodes, v.nodes)),
          "families: WaveletPackets(ndim=3).forward differs from wp3d")
    yw = counted("WaveletPackets(ndim=3).reconstruct", WV.reconstruct, {"inv_level_2d": L3})
    check(torch.equal(yw, yv), "families: WaveletPackets(ndim=3).reconstruct differs from iwp3d")
    timing(f"3D packets wp3d + iwp3d {VTI_SHAPE} {VOL_WNAME} {L3} levels",
           lambda: PK.iwp3d(PK.wp3d(vol, w4, L3).nodes[-1], w4, VTI_SHAPE))
    del v, yv, WV, wv, yw
    torch.cuda.empty_cache()
    print(f"families (d): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (e) starlet: the conv passes, no kernel ----------------
    S = STARLET_SCALES
    c = counted("starlet", lambda: ST.starlet(img, S), {})
    ys = counted("istarlet", lambda: ST.istarlet(c), {})
    c64 = ST.starlet(img.double(), S)
    fhold("starlet vs float64 on the card", leaves(c), [t.float() for t in leaves(c64)])
    err = float((ys - img).abs().max())
    print(f"families: starlet roundtrip {shape} {S} scales max|y - x| {err!r} (limit "
          f"{ROUNDTRIP_ATOL})", flush=True)
    check(err <= ROUNDTRIP_ATOL, "families: the starlet roundtrip error")
    sd = counted("starlet_auto_denoise", lambda: starlet_auto_denoise(img, S), {})
    fhold("starlet_auto_denoise vs float64 on the card", sd,
          starlet_auto_denoise(img.double(), S).float())
    del c, c64, ys
    timing(f"starlet + istarlet {shape} {S} scales gen 2",
           lambda: ST.istarlet(ST.starlet(img, S)))
    timing(f"starlet_auto_denoise {shape} {S} scales", lambda: starlet_auto_denoise(img, S))
    SV = Starlet(vol, levels=S, device=dev)
    check(SV.ndim == 3, "families: Starlet on a volume is not 3D")
    cv = counted("Starlet(volume).forward", SV.forward, {})
    yv = counted("Starlet(volume).inverse", SV.inverse, {})
    err = float((yv - vol).abs().max())
    print(f"families: Starlet roundtrip {VTI_SHAPE} {S} scales max|y - x| {err!r} (limit "
          f"{ROUNDTRIP_ATOL})", flush=True)
    check(err <= ROUNDTRIP_ATOL, "families: the 3D starlet roundtrip error")
    cv64 = ST.starlet(vol.double(), S, ndim=3)
    fhold("Starlet(volume) vs float64 on the card", leaves(cv),
          [t.float() for t in leaves(cv64)])
    del cv, cv64, yv
    dv = counted("Starlet(volume).denoise", SV.denoise, {})
    fhold("Starlet(volume).denoise vs float64 on the card", dv,
          starlet_auto_denoise(vol.double(), S, ndim=3).float())
    del dv
    timing(f"Starlet(volume) forward + inverse {VTI_SHAPE} {S} scales",
           lambda: (SV.forward(), SV.inverse())[1])
    del SV, vol
    torch.cuda.empty_cache()
    print(f"families (e): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (f) the dual tree ----------------
    hd = DT.dtcwt_wavelets()[0].hlen
    df, di = dt_launches(shape, hd, DT_LEVELS)
    z = counted("dtcwt2d", lambda: DT.dtcwt2d(img, DT_LEVELS), df)
    yz = counted("idtcwt2d", lambda: DT.idtcwt2d(z, shape), di)
    check(all(t.dtype == torch.complex64 for t in z.details) and z.approx.dtype == f32,
          "families: dtcwt2d's dtypes")
    with plain_route():
        zp = DT.dtcwt2d(img, DT_LEVELS)
        yzp = DT.idtcwt2d(zp, shape)
        dnp = DT.dtcwt_auto_denoise(img, DT_LEVELS)
    fhold("dtcwt2d (real and imaginary parts) vs the plain route", list(z), list(zp))
    fhold("idtcwt2d vs the plain route", yz, yzp)
    err = float((yz - img).abs().max())
    print(f"families: dual-tree roundtrip {shape} {DT_LEVELS} levels max|y - x| {err!r} (limit "
          f"{ROUNDTRIP_ATOL})", flush=True)
    check(err <= ROUNDTRIP_ATOL, "families: the dual-tree roundtrip error")
    dn = counted("dtcwt_auto_denoise", lambda: DT.dtcwt_auto_denoise(img, DT_LEVELS),
                 _merged(df, di))
    fhold("dtcwt_auto_denoise vs the plain route", dn, dnp)
    D = DualTree(img, levels=DT_LEVELS, device=dev)
    check(torch.equal(counted("DualTree.denoise", D.denoise, _merged(df, di)), dn),
          "families: DualTree.denoise differs from dtcwt_auto_denoise")
    del z, zp, yz, yzp, dnp, D
    timing(f"dtcwt2d + idtcwt2d {shape} {DT_LEVELS} levels",
           lambda: DT.idtcwt2d(DT.dtcwt2d(img, DT_LEVELS), shape))
    timing(f"dtcwt_auto_denoise {shape} {DT_LEVELS} levels",
           lambda: DT.dtcwt_auto_denoise(img, DT_LEVELS))
    ef, ei = dt_launches((B1_N,), hd, DT_LEVELS)
    z1 = counted("dtcwt1d", lambda: DT.dtcwt1d(sig, DT_LEVELS), ef)
    y1 = counted("idtcwt1d", lambda: DT.idtcwt1d(z1, B1_N), ei)
    with plain_route():
        z1p = DT.dtcwt1d(sig, DT_LEVELS)
        y1p = DT.idtcwt1d(z1p, B1_N)
    fhold("dtcwt1d (real and imaginary parts) vs the plain route", list(z1), list(z1p))
    fhold("idtcwt1d vs the plain route", y1, y1p)
    err = float((y1 - sig).abs().max())
    print(f"families: 1D dual-tree roundtrip {sshape} {DT_LEVELS} levels max|y - x| {err!r} "
          f"(limit {ROUNDTRIP_ATOL})", flush=True)
    check(err <= ROUNDTRIP_ATOL, "families: the 1D dual-tree roundtrip error")
    del z1, y1, z1p, y1p
    timing(f"dtcwt1d + idtcwt1d {sshape} {DT_LEVELS} levels",
           lambda: DT.idtcwt1d(DT.dtcwt1d(sig, DT_LEVELS), B1_N))
    print(f"families (f): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (g) the demo's scenarios 4-6 on the card ----------------
    with tempfile.TemporaryDirectory() as tmp:
        small = img_np[:256, :256]
        dat = os.path.join(tmp, "i.dat")
        write_dat(dat, small)
        for scenario, first in (("4", "best-basis packet denoise applied (beta = universal"),
                                ("5", "starlet k-sigma auto denoise applied"),
                                ("6", "dual-tree complex magnitude denoise applied")):
            out_path = os.path.join(tmp, f"r{scenario}.dat")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = demo.main([dat, "--nr", "256", "--nc", "256", "--scenario", scenario,
                                "--wavelet", WNAME, "--levels", "4", "--auto-beta",
                                "universal", "--out", out_path])
            text = buf.getvalue()
            res = np.fromfile(out_path, np.float32)
            check(rc == 0 and text.startswith(first) and res.size == small.size
                  and bool(np.isfinite(res).all()),
                  f"families: demo scenario {scenario}: rc {rc}, output {text!r}")
            print(f"families: demo scenario {scenario} on the card: {text.splitlines()[0]}",
                  flush=True)

    print(f"families launches: {fam}", flush=True)
    for name in FAM_KERNELS:
        check(fam.get(name, 0) > 0, f"the families path never launched {name}")
    for name, k in fam.items():
        launches[name] += k
    print(f"families phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# -- the extras phase (ROADMAP items 14c, 15): the fully separable transform,
# the CWT, the pywt drop-ins and the sanitizers at the repo's own sizes
FS_LEVELS_2D, FS_LEVELS_3D = (5, 5), (2, 4, 4)
# bench_all.py:181-211: 64 x 4096 signals on log_scales(4096, dj=0.25) (45
# scales); a 512^2 image at scales (2, 4, 8, 16), 4 angles
CWT_SIGNALS, CWT_N, CWT_DJ, CWT2D_N, CWT2D_SCALES = 64, 4096, 0.25, 512, (2.0, 4.0, 8.0, 16.0)
# the interop cells: 1024^2 db7 SWT to 3 levels, the 3D cell's db4 at 64 planes
IO_SWT_N, IO_SWT_LEVELS = 1024, 3
# the CWT against numpy float64 on the same float32 bank: max|port - numpy|
# <= CWT_RTOL * max|W| (float32 FFTs, cuFFT's sums in another order)
CWT_RTOL = 1e-5
EXTRA_KERNELS = ("fwd_level_1d", "inv_level_1d", "fwd_level_1d_padded", "inv_level_1d_padded",
                 "fwd_level_1d_mxu", "inv_level_1d_mxu", "fwd_level_2d", "fwd_tail_2d",
                 "inv_tail_2d", "fwd_level_2d_padded", "inv_level_2d_padded",
                 "swt_fwd_level_2d", "swt_inv_level_2d")


def fs_launches(shape, hlen: int, levels, mode: str = "periodization", bf16: bool = False,
                inverse: bool = False) -> dict:
    """{kernel: launches} of fs_dwt (fs_idwt with ``inverse``) of a tensor
    of even ``shape``: one dwt1d a transformed axis, its lines the batch;
    each level on kernel 7 or 8 (7p, 8p under ``mode``), or 15 or 16 where
    a bf16 level's route rule accepts it.  Forward, only the first pass
    reads bf16 (the pack promotes to float32); an inverse of a bf16 array
    reads bf16 in every pass (each pass writes bf16)."""
    from pdwt_tpu_torch import kernels as KK
    from pdwt_tpu_torch.core.shapes import level_sizes

    out, total = {}, math.prod(shape)
    suffix = "" if mode == "periodization" else "_padded"
    order = range(len(shape) - 1, -1, -1) if inverse else range(len(shape))
    first = True
    for k in order:
        lv = levels[k]
        if lv == 0:
            continue
        B, sizes = total // shape[k], level_sizes(shape[k], lv)
        for j in range(lv):
            if inverse:
                banded = bf16 and KK.mxu_route_1d(B, 2 * sizes[j + 1], hlen)
                name = "inv_level_1d_mxu" if banded else "inv_level_1d" + suffix
            else:
                n = sizes[j] + sizes[j] % 2
                banded = bf16 and first and KK.mxu_route_1d(B, n, hlen)
                name = "fwd_level_1d_mxu" if banded else "fwd_level_1d" + suffix
            _bump(out, name)
        first = False
    return out


@contextlib.contextmanager
def plain_padded_1d():
    """The padded 1D wrappers (7p, 8p) swapped for their plain versions
    while the block runs (``plain_route`` swaps the others)."""
    from pdwt_tpu_torch.kernels import batched1d as B1

    saved = [(n, getattr(B1, n)) for n in ("fwd_level_1d_padded", "inv_level_1d_padded")]
    try:
        for n, _ in saved:
            setattr(B1, n, getattr(B1, n + "_ref"))
        yield
    finally:
        for n, f in saved:
            setattr(B1, n, f)


def _np_cwt(x: np.ndarray, bank: np.ndarray, real: bool) -> np.ndarray:
    """T&C eq. 4 in numpy float64: ifft(fft(x) * bank) over the last axis."""
    W = np.fft.ifft(np.fft.fft(x.astype(np.float64), axis=-1)[..., None, :] * bank, axis=-1)
    return W.real if real else W


def extras_phase(dev, card, report, launches, gen) -> None:
    """The last modules of the port on the card at the repo's sizes, every
    call between a reset and a read of the launch counters (exactly the
    route's launches) and timed (call, busy split, idle share, peak):
    (a) ``core.anisotropic``: fs_dwt/fs_idwt of the DWT cell's 2048^2 db7
    image at levels (5, 5), periodization and symmetric, of the 3D cell's
    128x512x512 db4 volume at levels (2, 4, 4) (its depth pass hands kernel
    7 262144 lines, held to the plain version), and of the bf16 image under
    bf16-fast; each against the same composition on plain versions, the
    exact ones to their roundtrip; (b) ``core.continuous``: cwt of 64 x 4096
    signals on 45 log scales for each mother, icwt, cwt2d of a 512^2 image
    (4 scales, 4 angles), against the same formula in numpy float64 (no
    port kernel: cuFFT); (c) ``utils.interop``: wavedec2/waverec2 at 2048^2
    db7 level 5 (symmetric, periodization), wavedec/waverec on 1024 x 4096
    sym8 level 4, wavedecn/waverecn on 64x512x512 db4 level 2 (symmetric:
    the conv passes; periodization), swt2/iswt2 on 1024^2 db7 level 3, each
    against the port's own core call on the same route and its roundtrip;
    (d) ``utils.debug``: assert_finite and checked on a coefficient tree
    with one NaN raise, on a clean one pass, and the one host sync timed."""
    from pdwt_tpu_torch import (dwt1d, dwt2d, dwt3d, get_wavelet, idwt1d, idwt2d, idwt3d,
                                iswt2d, swt2d)
    from pdwt_tpu_torch.core import anisotropic as AN
    from pdwt_tpu_torch.core import continuous as CW
    from pdwt_tpu_torch.core.precision import precision_scope
    from pdwt_tpu_torch.kernels import batched1d as B1
    from pdwt_tpu_torch.kernels import separable as KS
    from pdwt_tpu_torch.utils import debug as DBG
    from pdwt_tpu_torch.utils import interop as IO

    print("=== extras ===", flush=True)
    t_phase = time.perf_counter()
    ext: dict = {}
    counted = lambda label, fn, want: counted_exactly(label, fn, want, ext, "extras")
    timing = lambda label, fn: vol_timing(label, fn, card, "extras")
    xhold = lambda label, got, want: vhold(f"extras: {label}", real_view(got), real_view(want))
    w7, w4, w8 = get_wavelet(WNAME), get_wavelet(VOL_WNAME), get_wavelet(B1_WNAME)
    shape = (N, N)
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, shape)
                           .astype(np.float32)).to(dev)

    # ---------------- (a) the fully separable transform ----------------
    L2 = FS_LEVELS_2D
    for mode in ("periodization", "symmetric"):
        fwd = lambda m=mode: AN.fs_dwt(img, w7, L2, mode=m)
        inv = lambda y, m=mode: AN.fs_idwt(y, w7, shape, L2, mode=m)
        y = counted(f"fs_dwt {shape} {WNAME} {L2} {mode}", fwd,
                    fs_launches(shape, w7.hlen, L2, mode))
        r = counted(f"fs_idwt {shape} {WNAME} {L2} {mode}", lambda: inv(y),
                    fs_launches(shape, w7.hlen, L2, mode, inverse=True))
        with plain_route(), plain_padded_1d():
            yp = fwd()
            rp = inv(yp)
        xhold(f"fs_dwt {mode} vs the plain route", y, yp)
        xhold(f"fs_idwt {mode} vs the plain route", r, rp)
        err = float((r - img).abs().max())
        print(f"extras: fs roundtrip {shape} {WNAME} {L2} {mode} max|y - x| {err!r} (limit "
              f"{ROUNDTRIP_ATOL})", flush=True)
        check(err <= ROUNDTRIP_ATOL, f"extras: the fs roundtrip error ({mode})")
        del y, r, yp, rp
        timing(f"fs_dwt + fs_idwt {shape} {WNAME} {L2} {mode}", lambda: inv(fwd()))
    # the volume: the depth pass hands kernel 7 512 * 512 lines of 128
    L3 = FS_LEVELS_3D
    vol = torch.rand(VOL_SHAPE, device=dev, generator=gen) * 255.0
    lines = vol.movedim(0, -1).reshape(-1, VOL_SHAPE[0]).contiguous()
    for x in (lines, lines[:, ::2].contiguous()):
        got, want = B1.fwd_level_1d(x, w4.dec_lo, w4.dec_hi), B1.fwd_level_1d_ref(
            x, w4.dec_lo, w4.dec_hi)
        err, scale = max_err(list(got), list(want))
        print(f"extras: kernel 7 on {tuple(x.shape)} (past gridDim.y, grid-stride) vs its plain "
              f"version: max|diff| {err:.3e} (limit {KERNEL_RTOL * scale:.3e})", flush=True)
        check(err <= KERNEL_RTOL * scale, "extras: kernel 7 on the depth pass's lines")
        a, d = want
        got = B1.inv_level_1d(a, d, w4.rec_lo, w4.rec_hi)
        err, scale = max_err(got, B1.inv_level_1d_ref(a, d, w4.rec_lo, w4.rec_hi))
        print(f"extras: kernel 8 into {tuple(x.shape)} vs its plain version: max|diff| "
              f"{err:.3e} (limit {KERNEL_RTOL * scale:.3e})", flush=True)
        check(err <= KERNEL_RTOL * scale, "extras: kernel 8 on the depth pass's lines")
    del lines, got, want, a, d
    y = counted(f"fs_dwt {VOL_SHAPE} {VOL_WNAME} {L3}", lambda: AN.fs_dwt(vol, w4, L3),
                fs_launches(VOL_SHAPE, w4.hlen, L3))
    r = counted(f"fs_idwt {VOL_SHAPE} {VOL_WNAME} {L3}",
                lambda: AN.fs_idwt(y, w4, VOL_SHAPE, L3),
                fs_launches(VOL_SHAPE, w4.hlen, L3, inverse=True))
    with plain_route():
        yp = AN.fs_dwt(vol, w4, L3)
        rp = AN.fs_idwt(yp, w4, VOL_SHAPE, L3)
    xhold("fs_dwt volume vs the plain route", y, yp)
    xhold("fs_idwt volume vs the plain route", r, rp)
    err = float((r - vol).abs().max())
    print(f"extras: fs roundtrip {VOL_SHAPE} {VOL_WNAME} {L3} max|y - x| {err!r} (limit "
          f"{ROUNDTRIP_ATOL})", flush=True)
    check(err <= ROUNDTRIP_ATOL, "extras: the volume's fs roundtrip error")
    del y, r, yp, rp
    timing(f"fs_dwt + fs_idwt {VOL_SHAPE} {VOL_WNAME} {L3}",
           lambda: AN.fs_idwt(AN.fs_dwt(vol, w4, L3), w4, VOL_SHAPE, L3))
    del vol
    torch.cuda.empty_cache()
    # the bf16 image under bf16-fast: kernel 15 on the first pass's levels
    # the route accepts; the packed result is float32, so the inverse reads
    # its bf16 cast (kernel 16 where the route accepts)
    xb = img.to(torch.bfloat16)

    def bf_rt():
        with precision_scope("bf16-fast"):
            y = AN.fs_dwt(xb, w7, L2)
            return y, AN.fs_idwt(y.to(torch.bfloat16), w7, shape, L2)

    with precision_scope("bf16-fast"):
        y = counted(f"fs_dwt bf16 {shape} {WNAME} {L2} bf16-fast",
                    lambda: AN.fs_dwt(xb, w7, L2), fs_launches(shape, w7.hlen, L2, bf16=True))
        r = counted(f"fs_idwt bf16 {shape} {WNAME} {L2} bf16-fast",
                    lambda: AN.fs_idwt(y.to(torch.bfloat16), w7, shape, L2),
                    fs_launches(shape, w7.hlen, L2, bf16=True, inverse=True))
    check(y.dtype == torch.float32 and r.dtype == torch.bfloat16,
          f"extras: fs bf16 dtypes {y.dtype}, {r.dtype} (float32 packed, bf16 inverse)")
    with plain_route():
        yp, rp = bf_rt()
    compare_route("extras: fs bf16-fast", (y, r), (yp, rp))
    err = float((r.float() - img).abs().max())
    print(f"extras: fs roundtrip bf16-fast max|y - x| {err!r} on [0, 255] (recorded)", flush=True)
    del y, r, yp, rp
    timing(f"fs_dwt + fs_idwt bf16 {shape} {WNAME} {L2} bf16-fast",
           lambda: bf_rt()[1])
    print(f"extras (a): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (b) the CWT: cuFFT, no port kernel ----------------
    sig_np = np.random.default_rng(3).standard_normal((CWT_SIGNALS, CWT_N)).astype(np.float32)
    sig = torch.from_numpy(sig_np).to(dev)
    scales = CW.log_scales(CWT_N, dj=CWT_DJ)  # 45 scales at 4096 samples
    for mother in ("morlet", "ricker", "paul"):
        W = counted(f"cwt {mother} {tuple(sig.shape)} {len(scales)} scales",
                    lambda m=mother: CW.cwt(sig, scales, m), {})
        bank = CW._psi_hat(mother, np.asarray(scales), CW._ang_freq(CWT_N, 1.0), 1.0)
        Wn = _np_cwt(sig_np, bank.astype(np.float64), mother == "ricker")
        want_dt = torch.float32 if mother == "ricker" else torch.complex64
        check(W.dtype == want_dt and tuple(W.shape) == Wn.shape,
              f"extras: cwt {mother}: {W.dtype} {tuple(W.shape)}")
        err = float(np.abs(W.cpu().numpy() - Wn).max())
        scale = float(np.abs(Wn).max())
        print(f"extras: cwt {mother} vs numpy float64: max|diff| {err:.3e} (limit "
              f"{CWT_RTOL * scale:.3e})", flush=True)
        check(err <= CWT_RTOL * scale, f"extras: cwt {mother} disagrees with numpy")
        x_rec = counted(f"icwt {mother}", lambda m=mother, W=W: CW.icwt(W, scales, m, dj=CWT_DJ),
                        {})
        s = np.asarray(scales)[:, None]
        fac = CWT_DJ / (CW._CDELTA[mother] * CW._PSI00[mother])
        xn = fac * np.sum(np.real(Wn) / np.sqrt(s), axis=-2)
        err, scale = float(np.abs(x_rec.cpu().numpy() - xn).max()), float(np.abs(xn).max())
        print(f"extras: icwt {mother} vs numpy float64: max|diff| {err:.3e} (limit "
              f"{CWT_RTOL * scale:.3e}); its T&C reconstruction error max|x' - x| "
              f"{float(np.abs(xn - sig_np).max())!r} (recorded)", flush=True)
        check(x_rec.dtype == torch.float32 and err <= CWT_RTOL * scale,
              f"extras: icwt {mother} disagrees with numpy")
        del W, Wn, x_rec
        timing(f"cwt {mother} {tuple(sig.shape)} {len(scales)} scales",
               lambda m=mother: CW.cwt(sig, scales, m))
    timing(f"cwt + icwt morlet {tuple(sig.shape)}",
           lambda: CW.icwt(CW.cwt(sig, scales), scales, dj=CWT_DJ))
    im_np = np.random.default_rng(4).uniform(0, 255, (CWT2D_N, CWT2D_N)).astype(np.float32)
    im = torch.from_numpy(im_np).to(dev)
    W2 = counted(f"cwt2d {tuple(im.shape)} scales {CWT2D_SCALES}",
                 lambda: CW.cwt2d(im, CWT2D_SCALES), {})
    th = np.linspace(0.0, math.pi, 4, endpoint=False)
    bank2 = CW._psi_hat_2d(np.asarray(CWT2D_SCALES), th, CWT2D_N, CWT2D_N, 1.0, 1.0)
    Wn2 = np.fft.ifft2(np.fft.fft2(im_np.astype(np.float64))[None, None] * bank2)
    check(W2.dtype == torch.complex64 and tuple(W2.shape) == Wn2.shape, "extras: cwt2d shape")
    err, scale = float(np.abs(W2.cpu().numpy() - Wn2).max()), float(np.abs(Wn2).max())
    print(f"extras: cwt2d vs numpy float64: max|diff| {err:.3e} (limit {CWT_RTOL * scale:.3e})",
          flush=True)
    check(err <= CWT_RTOL * scale, "extras: cwt2d disagrees with numpy")
    del W2, Wn2
    timing(f"cwt2d {tuple(im.shape)} 4 scales 4 angles", lambda: CW.cwt2d(im, CWT2D_SCALES))
    print(f"extras (b): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (c) the pywt drop-ins ----------------
    def same_bits(label, got, want):
        gl, wl = leaves(got), leaves(want)
        check(len(gl) == len(wl) and all(torch.equal(g, w) for g, w in zip(gl, wl)),
              f"extras: {label} differs from the core call")
        print(f"extras: {label}: the core call's bits", flush=True)

    flat = lambda cl: [t for item in cl for t in (
        item.values() if isinstance(item, dict) else item if isinstance(item, tuple) else [item])]
    for mode in ("symmetric", "periodization"):
        L = LEVELS
        if mode == "symmetric":
            fwd = {"fwd_level_2d_padded": L}
            inv = {"inv_level_2d_padded": L}
        else:
            fwd, r = {}, N
            for lvl in range(L):
                if KS.tail_supported((r, r), w7.hlen, L - lvl):
                    _bump(fwd, "fwd_tail_2d")
                    break
                _bump(fwd, "fwd_level_2d")
                r //= 2
            inv = {}
            for j in range(L, 0, -1):
                _bump(inv, inv_kernel_2d(N >> (j - 1), N >> (j - 1), w7.hlen))
        cl = counted(f"wavedec2 {shape} {WNAME} level {L} {mode}",
                     lambda m=mode: IO.wavedec2(img, WNAME, m, L), fwd)
        same_bits(f"wavedec2 {mode}", flat(cl),
                  flat(IO.to_pywt(dwt2d(img, w7, L, mode=mode))))
        y = counted(f"waverec2 {mode}", lambda m=mode: IO.waverec2(cl, WNAME, m), inv)
        yc = idwt2d(IO.from_pywt(cl), w7, shape, mode=mode)
        xhold(f"waverec2 {mode} vs the core idwt2d", y[..., :N, :N], yc)
        err = float((y[..., :N, :N] - img).abs().max())
        print(f"extras: wavedec2/waverec2 {mode} roundtrip max|y - x| {err!r} (limit "
              f"{ROUNDTRIP_ATOL}); bits equal to the core inverse: "
              f"{torch.equal(y[..., :N, :N], yc)}", flush=True)
        check(err <= ROUNDTRIP_ATOL, f"extras: the wavedec2 roundtrip error ({mode})")
        del cl, y, yc
        timing(f"wavedec2 + waverec2 {shape} {WNAME} level {L} {mode}",
               lambda m=mode: IO.waverec2(IO.wavedec2(img, WNAME, m, L), WNAME, m))
    s1 = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (B1_SIGNALS, B1_N))
                          .astype(np.float32)).to(dev)
    cl = counted(f"wavedec {tuple(s1.shape)} {B1_WNAME} level {B1_LEVELS}",
                 lambda: IO.wavedec(s1, B1_WNAME, level=B1_LEVELS),
                 {"fwd_level_1d_padded": B1_LEVELS})
    same_bits("wavedec symmetric", cl, IO.to_pywt(dwt1d(s1, w8, B1_LEVELS, mode="symmetric")))
    y = counted("waverec", lambda: IO.waverec(cl, B1_WNAME), {"inv_level_1d_padded": B1_LEVELS})
    xhold("waverec vs the core idwt1d", y[..., :B1_N],
          idwt1d(IO.from_pywt(cl), w8, B1_N, mode="symmetric"))
    err = float((y[..., :B1_N] - s1).abs().max())
    print(f"extras: wavedec/waverec roundtrip max|y - x| {err!r} (limit {ROUNDTRIP_ATOL})",
          flush=True)
    check(err <= ROUNDTRIP_ATOL, "extras: the wavedec roundtrip error")
    del cl, y
    timing(f"wavedec + waverec {tuple(s1.shape)} {B1_WNAME} level {B1_LEVELS} symmetric",
           lambda: IO.waverec(IO.wavedec(s1, B1_WNAME, level=B1_LEVELS), B1_WNAME))
    del s1
    vol = torch.rand(VTI_SHAPE, device=dev, generator=gen) * 255.0
    for mode, fwd, inv in (("symmetric", {}, {}),
                           ("periodization", {"fwd_level_2d": VOL_LEVELS},
                            {"inv_level_2d": VOL_LEVELS})):
        cl = counted(f"wavedecn {VTI_SHAPE} {VOL_WNAME} level {VOL_LEVELS} {mode}",
                     lambda m=mode: IO.wavedecn(vol, VOL_WNAME, m, VOL_LEVELS), fwd)
        same_bits(f"wavedecn {mode}", flat(cl),
                  flat(IO.to_pywt(dwt3d(vol, w4, VOL_LEVELS, mode=mode))))
        y = counted(f"waverecn {mode}", lambda m=mode: IO.waverecn(cl, VOL_WNAME, m), inv)
        sl = (Ellipsis,) + tuple(slice(0, n) for n in VTI_SHAPE)
        xhold(f"waverecn {mode} vs the core idwt3d", y[sl],
              idwt3d(IO.from_pywt(cl), w4, VTI_SHAPE, mode=mode))
        err = float((y[sl] - vol).abs().max())
        print(f"extras: wavedecn/waverecn {mode} roundtrip max|y - x| {err!r} (limit "
              f"{ROUNDTRIP_ATOL})", flush=True)
        check(err <= ROUNDTRIP_ATOL, f"extras: the wavedecn roundtrip error ({mode})")
        del cl, y
        timing(f"wavedecn + waverecn {VTI_SHAPE} {VOL_WNAME} level {VOL_LEVELS} {mode}",
               lambda m=mode: IO.waverecn(IO.wavedecn(vol, VOL_WNAME, m, VOL_LEVELS),
                                          VOL_WNAME, m))
    del vol
    torch.cuda.empty_cache()
    ti = img[:IO_SWT_N, :IO_SWT_N].contiguous()
    cl = counted(f"swt2 {tuple(ti.shape)} {WNAME} level {IO_SWT_LEVELS}",
                 lambda: IO.swt2(ti, WNAME, IO_SWT_LEVELS), {"swt_fwd_level_2d": IO_SWT_LEVELS})
    c_core, approxs = swt2d(ti, w7, IO_SWT_LEVELS, keep_approx=True)
    same_bits("swt2", [t for a, hvd in cl for t in (a, *hvd)],
              [t for i in range(IO_SWT_LEVELS - 1, -1, -1)
               for t in (approxs[i], *c_core.details[i])])
    y = counted("iswt2", lambda: IO.iswt2(cl, WNAME), {"swt_inv_level_2d": IO_SWT_LEVELS})
    same_bits("iswt2", y, iswt2d(c_core, w7))
    err = float((y - ti).abs().max())
    print(f"extras: swt2/iswt2 roundtrip max|y - x| {err!r} (limit {ROUNDTRIP_ATOL})",
          flush=True)
    check(err <= ROUNDTRIP_ATOL, "extras: the swt2 roundtrip error")
    del cl, y, c_core, approxs
    timing(f"swt2 + iswt2 {tuple(ti.shape)} {WNAME} level {IO_SWT_LEVELS}",
           lambda: IO.iswt2(IO.swt2(ti, WNAME, IO_SWT_LEVELS), WNAME))
    print(f"extras (c): {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------------- (d) the sanitizers ----------------
    tree = dwt2d(img, w7, LEVELS)
    n_leaves = len(leaves(tree))
    counted("assert_finite on a clean tree", lambda: DBG.assert_finite(tree, "c"), {})
    run = DBG.checked(lambda c: (DBG.assert_finite(c, "c"), c.approx * 2)[1])
    check(torch.equal(run(tree), tree.approx * 2), "extras: checked changed the result")
    dets = [list(t) for t in tree.details]
    dets[2][0] = dets[2][0].clone()  # leaf 7: the approximation, H, V, D a level
    dets[2][0][3, 5] = float("nan")
    poisoned = type(tree)(tree.approx, tuple(tuple(t) for t in dets))
    for how, fn in (("assert_finite", lambda: DBG.assert_finite(poisoned, "c")),
                    ("checked", lambda: run(poisoned))):
        try:
            fn()
            fail(f"extras: {how} on a tree with one NaN raised nothing")
        except DBG.CheckError as e:
            check(isinstance(e, ValueError) and str(e) ==
                  "c: leaf 7 contains NaN/Inf (`check` failed)", f"extras: {how} said {e}")
            print(f"extras: {how} on one NaN raised {type(e).__name__}: {e}", flush=True)
    host = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        DBG.assert_finite(tree, "c")
        host.append((time.perf_counter() - t0) * 1e3)
    print(f"extras: assert_finite on the {n_leaves}-leaf {N}^2 tree: "
          f"{float(np.median(host)):.4f} ms a call by the host clock (median of 21, one "
          f"host sync); {count_device_kernels(lambda: DBG.assert_finite(tree, 'c'))} device "
          f"launches a call [{card}]", flush=True)
    timing(f"assert_finite {n_leaves}-leaf tree", lambda: DBG.assert_finite(tree, "c"))

    print(f"extras launches: {ext}", flush=True)
    for name in EXTRA_KERNELS:
        check(ext.get(name, 0) > 0, f"the extras path never launched {name}")
    for name, k in ext.items():
        launches[name] += k
    print(f"extras phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


BACKENDS = (None, "pallas", "fma", "xla", "gather")
#: starlet cell: 2048^2, 4 scales (the families phase's starlet size)
ST_LEVELS = 4


def bhold(label, got, want, rtol=PATH_RTOL) -> None:
    """A call's outputs within rtol of the largest value among its tensor
    outputs (``max_err``'s scale), a scalar output (the TI step's norm)
    within rtol of itself; finite and of the reference's shapes."""
    gl, wl = leaves(got), leaves(want)
    check(len(gl) == len(wl) and all(g.shape == w.shape for g, w in zip(gl, wl)),
          f"{label}: shapes differ")
    check(all(bool(torch.isfinite(g).all()) for g in gl), f"{label}: not finite")
    scale = max(float(w.double().abs().max()) for w in wl if w.dim())
    worst = 0.0
    for g, w in zip(gl, wl):
        err = float((g.double() - w.double()).abs().max())
        ref = scale if w.dim() else abs(float(w))
        check(err <= rtol * ref, f"{label}: max|diff| {err:.3e} over {rtol * ref:.3e}")
        worst = max(worst, err / ref)
    print(f"{label}: worst max|diff| / max|ref| {worst:.3e} (limit {rtol})", flush=True)


def backends_phase(dev, card, report, launches, gen) -> None:
    """``backend=`` on the card: six cells under ``None``, ``"pallas"`` and
    JAX's three conv formulations (the DWT roundtrip 2048^2 db7 5 levels,
    the TI step 1024^2 db7 3 levels soft beta 10, the batched 1D step
    1024 x 4096 sym8 4 levels, the exact rank-3 non-separable DWT 2048^2 5
    levels, the starlet 2048^2 4 scales forward and inverse, the 3D
    roundtrip 128 x 512^2 db4 2 levels).  ``"pallas"`` equals ``None`` bit
    for bit with the same launches; "fma", "xla" and "gather" launch none
    of the port's kernels and hold 1e-5 of each output's largest value
    against ``None``; "xla" holds the same against the float64 computation
    of the cell ("fma" in float64 on the card), which TF32 would miss.
    Each call is timed (call, busy, idle share, peak).  Then the C++ engine
    in float32 and float64 on the DWT cell against the port's float64
    transform, ``utils.device_time`` on the DWT roundtrip (its CUDA-graph
    replay equal to the eager call bit for bit) beside the busy and call
    times, ``utils.trace`` naming the port's kernels, and the build
    directory of ``enable_compile_cache``."""
    from pdwt_tpu_torch import (dwt1d, dwt2d, dwt2d_ns, dwt3d, get_wavelet, idwt1d, idwt2d,
                                idwt3d, native, ops)
    from pdwt_tpu_torch.core import istarlet, starlet
    from pdwt_tpu_torch.models import denoise_step
    from pdwt_tpu_torch.utils import device_time, enable_compile_cache, profiling, trace

    print("=== backends ===", flush=True)
    t_phase = time.perf_counter()
    seen: dict = {}
    w7, w8, w4 = get_wavelet(WNAME), get_wavelet(B1_WNAME), get_wavelet(VOL_WNAME)
    q = rank3_quads()
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (N, N)).astype(np.float32)).to(dev)
    ti = torch.from_numpy(rng.uniform(0, 255, (TI_N, TI_N)).astype(np.float32)).to(dev)
    sig = torch.from_numpy(rng.standard_normal((B1_SIGNALS, B1_N)).astype(np.float32)).to(dev)
    vol = torch.rand(VOL_SHAPE, device=dev, generator=gen) * 255.0

    def b1(x, be):
        c = ops.soft_threshold(dwt1d(x, w8, B1_LEVELS, backend=be), B1_BETA)
        return c, ops.norm1(c), idwt1d(c, w8, B1_N, backend=be)

    def st(x, be):
        c = starlet(x, ST_LEVELS, backend=be)
        return c, istarlet(c, backend=be)

    def dwt_rt(x, be):
        c = dwt2d(x, w7, LEVELS, backend=be)
        return c, idwt2d(c, w7, (N, N), backend=be)

    def vol_rt(x, be):
        c = dwt3d(x, w4, VOL_LEVELS, backend=be)
        return c, idwt3d(c, w4, VOL_SHAPE, backend=be)

    cells = [
        (f"DWT roundtrip {N}^2 {WNAME} {LEVELS} levels", img, dwt_rt),
        (f"TI step {TI_N}^2 {WNAME} {TI_LEVELS} levels soft beta {TI_BETA}", ti,
         lambda x, be: denoise_step(x, None, w7, TI_LEVELS, TI_BETA, swt=True, backend=be)),
        (f"batched 1D step {B1_SIGNALS}x{B1_N} {B1_WNAME} {B1_LEVELS} levels", sig, b1),
        (f"exact rank-3 NS DWT {NS_N}^2 {NS_LEVELS} levels", img,
         lambda x, be: dwt2d_ns(x, q, NS_LEVELS, backend=be)),
        (f"starlet {N}^2 {ST_LEVELS} scales forward + inverse", img, st),
        (f"3D roundtrip {'x'.join(map(str, VOL_SHAPE))} {VOL_WNAME} {VOL_LEVELS} levels", vol,
         vol_rt),
    ]
    table = []
    for label, x, fn in cells:
        outs = {}
        for be in BACKENDS:
            want = None if be in (None, "pallas") else {}
            if be == "pallas":
                want = outs["counts", None]
            from pdwt_tpu_torch.kernels import LAUNCHES, reset_launch_counts

            torch.cuda.synchronize()
            reset_launch_counts()
            out = fn(x, be)
            torch.cuda.synchronize()
            got = {k: v for k, v in LAUNCHES.items() if v}
            print(f"backends: {label} backend={be}: launches {got}", flush=True)
            if want is not None:
                check(got == want, f"backends: {label} backend={be} launched {got}, want {want}")
            for k, v in got.items():
                seen[k] = seen.get(k, 0) + v
            outs["counts", be], outs[be] = got, out
        base = outs[None]
        pg, pb = leaves(outs["pallas"]), leaves(base)
        check(len(pg) == len(pb) and all(torch.equal(g, b) for g, b in zip(pg, pb)),
              f"backends: {label}: backend='pallas' differs from backend=None")
        print(f"backends: {label}: 'pallas' equals None bit for bit", flush=True)
        for be in ("fma", "xla", "gather"):
            bhold(f"backends: {label}: {be} vs None", outs[be], base)
        ref64 = fn(x.double(), "fma")
        bhold(f"backends: {label}: xla vs float64", outs["xla"], ref64)
        del ref64, outs
        for be in BACKENDS:
            t = vol_timing(f"{label} backend={be}", lambda: fn(x, be), card, "backends")
            table.append((label, be, t))
    print("backends table (call ms, busy ms, idle share, peak GiB) "
          f"[{card}]:", flush=True)
    for label, be, t in table:
        busy = t["busy_ms"]
        idle = "not measured" if busy is None else f"{1 - busy / t['ms']:.3f}"
        print(f"  {label} | {be} | {t['ms']:.4f} | {fmt(busy)} | {idle} | "
              f"{t['peak_gib']:.3f}", flush=True)

    # ---------------- the C++ engine on the DWT cell ----------------
    check(native.is_available(), "backends: no C++ compiler for the native engine")
    x64 = img.double()
    c64 = dwt2d(x64, w7, LEVELS, backend="fma")
    y64 = idwt2d(c64, w7, (N, N), backend="fma")
    host = img.cpu()
    for dt, rtol in ((np.float32, PATH_RTOL), (np.float64, 1e-10)):
        native.lib.set_dtype(dt)
        try:
            native.dwt2d(host[:64, :64], w7, 2)  # build and load
            t0 = time.perf_counter()
            cn = native.dwt2d(host, w7, LEVELS)
            t1 = time.perf_counter()
            yn = native.idwt2d(cn, w7, (N, N))
            t2 = time.perf_counter()
        finally:
            native.lib.set_dtype(np.float32)
        print(f"backends: native {np.dtype(dt).name} DWT {N}^2 {WNAME} {LEVELS} levels: "
              f"forward {(t1 - t0) * 1e3:.1f} ms, inverse {(t2 - t1) * 1e3:.1f} ms by the host "
              f"clock (one call, {os.cpu_count()} cores)", flush=True)
        bhold(f"backends: native {np.dtype(dt).name} vs the port's float64 on the card",
              [cn, yn], [leaves(c64)[i].cpu() for i in range(len(leaves(c64)))] + [y64.cpu()],
              rtol)

    # ---------------- the slope timing, the graph, the trace ----------------
    rt = lambda t: idwt2d(dwt2d(t, w7, LEVELS), w7, (N, N))
    slope = device_time(rt, img)
    call = cuda_ms(lambda: rt(img))
    busy, _ = device_ms(lambda: rt(img))
    print(f"backends: device_time of the DWT roundtrip {slope * 1e3:.4f} ms (CUDA-graph slope) "
          f"vs busy {fmt(busy)}, eager call {call:.4f} ms [{card}]", flush=True)
    check(slope > 0, "backends: device_time gave no positive slope")
    run = profiling._graph_runner(lambda: rt(img), 1)
    run()
    torch.cuda.synchronize()
    check(torch.equal(run.out, rt(img)), "backends: the graph replay differs from the eager call")
    print("backends: the CUDA-graph replay equals the eager call bit for bit", flush=True)
    # Kineto now and then records no device event in a window late in a
    # long run (device_ms's note): three windows of three calls, as there
    for attempt in range(3):
        with tempfile.TemporaryDirectory() as out_dir:
            with trace(out_dir):
                for _ in range(3):
                    rt(img)
            with open(os.path.join(out_dir, "trace.json")) as fh:
                events = json.load(fh)["traceEvents"]
        names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        ours = sorted(n for n in names if is_port_kernel(n))
        print(f"backends: trace window {attempt + 1} wrote {len(events)} events, "
              f"{len(names)} kernel names, the port's: {[n[:60] for n in ours]}", flush=True)
        if ours:
            break
    check(bool(ours), "backends: the trace names none of the port's kernels in three windows")
    print(f"backends: enable_compile_cache() -> {enable_compile_cache()}", flush=True)

    print(f"backends launches: {seen}", flush=True)
    for name, k in seen.items():
        launches[name] += k
    print(f"backends phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def plain_rt(fn, *args):
    """fn(*args) on the plain route (``plain_route``)."""
    with plain_route():
        return fn(*args)


if __name__ == "__main__":
    main()
    sys.stdout.flush()
