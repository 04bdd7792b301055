#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fourier_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds kernels B1-B5 (complex64, the stage bodies), the clustered-block
bodies of B1, B2, B3, B4a, B4b, B5a and B5b, B6-B8 (complex128 in native
f64; B6 also on its clustered-block bodies) and B9a/B9b (the dense DFT
products of MxuFftPlan(impl="pallas"), on the tensor cores in 3xTF32, and
on the CUDA cores for comparison) from fourier_tpu_torch/csrc with nvcc,
twelve libraries built at once (each build's time printed), checks that
the clustered-block bodies of B1, B2, B3, B4a, B4b, B5a, B5b, B6 and B7 and
the tensor-core bodies of B9a and B9b spill nothing (and prints B1's and
B6's registers beside those they had before fft_pair took an I/O policy),
and holds each kernel against its plain PyTorch version and against np.fft,
at the listed sizes and at every shape the routes below give it (B1, B2,
B4a, B4b, B5a, B5b, B6 and B7 also at a walk of several tiles a cluster
ending on a partial group, and on both bodies at the sizes where they meet;
B3, B9a and B9b on both bodies, B9a and B9b also with a NaN row and an
infinite one; B1, B2, B4b, B5a and B5b at the routes' shapes in phase 4g,
from the calls phases 4-4d made, B6 in phase 4h, from those of phase 4e).
Then it drives the main path (the default complex64 1-D transform through
create_fft_f32 on device="cuda") and the routes of the other sizes the JAX
package plans differently (fused Bluestein B2, four-step with B3 rows, DFT
products), then the real transforms through RfftPlan and the module
functions (B4 for even n, B5 for odd n, the c2c kernels inside the unfused
routes) and their gradients, then the complex128 route (create_fft_f64 with
no device argument: B6, B7, B8 over B6, and the composed plans over them,
and c128 RfftPlans), then the user-built paths of B9a/B9b (pallas and
xla_packed MxuFftPlans alone, under a BluesteinPlan and a
FourStepLocalPlan, and their gradients, B9b on the body its wrapper
picks), then the numpy-compatible surface at full width (phase 4i: fft2,
ifft2, fftn, ifftn in complex64 and complex128, rfft2, irfft2, rfftn,
irfftn, hfft2, ihfft2, dctn, idctn, dstn, dct/idct/dst/idst of types 1-4
at every norm, fht, ifht, fftshift, transform_planar and an NdFftPlan moved
to the CPU and back, each against np.fft / scipy.fft in f64 on the whole
array, and the kernels at every shape it gave them against their plain
versions),
checking each plan tree against the JAX package's and that each path
launched the kernels its plan holds. Last it times the kernels against
their plain versions and torch.fft, the rfft round trips of the suite's
rows fused, unfused and through torch.fft, the suite's c128 rows (and B6 at
4096x16384) and B9a/B9b at three shapes, each beside the least time the
card could take for its bytes or operations; B1 at 4096x16384 and
1024x65536, B2 at 1013x65536, B4a and B4b at 4096x16384, B5a and B5b at
1013x65536, B6 at 1024x65536 and 4096x16384, B7 at 1013x65536 and B3 at
65536x1024 also on their stage bodies in the same run (and the rfft round
trips with B4b and B5b on their stage bodies, the parent's path, and the
four-step plans of 65536 and 262144 with B3 on its stage body), B9a's and
B9b's tensor-core bodies against their CUDA-core ones (their bound restated
for 3xTF32 on the tensor cores), and B1, B2, B3, B4b, B5a, B5b and B6 on
both bodies at every size with a clustered one and B9b's two bodies at
the splits of _b9b_sweep_sizes() (phase 5g, the A/B behind the wrappers'
choice of body); last the surface's entry points (phase 5h), each beside
torch.fft's call (a DCT/DST or the FHT beside the real FFTs it runs) and
its byte bound, and fft2 and rfft2 also on the literal port's layout.
Phase 4k holds the plan tooling on the card: save_plan/load_plan round
trips (a file and bytes) of a tree at each route, buffers and outputs
bitwise equal and the same kernels launched; measure_fft at five sizes,
backend="measure" planning from the wisdom with the timer poisoned, the
wisdom's export/import; export_compiled/load_compiled with static and
symbolic batches, the graphs' fourier_tpu_torch::* operators printed, the
loaded artifacts launching the kernels with outputs bitwise the plans'.
Phase 5j runs the comparative suite (fourier_tpu_torch/tools/bench_suite.py)
at one size a family, the large and rfft rows among them, each row's port,
torch.fft and host times beside the card's name and power limit and its
rel-L2 within the gate. Phase 4l drives the sharded plans
(fourier_tpu_torch.parallel) at full width on a one-rank NCCL mesh:
Fft2dPlan 8 x 4096^2 (forward, inverse, pipeline_chunks bitwise) and
4096 x 1013, c128 4096^2 and 2187 x 1013, FourStepPlan of 2^24 points in
digit and natural order (4096 x 4096 and 256 x 65536), Rfft2dPlan 4096^2 and
4096 x 1013, Fft3dPlan and Rfft3dPlan at 256^3 on 1x1 pencils and slabs with
the spectral round trips, and the batch-sharded calls at 4096 x 16384, each
against torch.fft and the port's single-device call with B1-B8 launched
under them, then those kernels at every (n, B) the legs gave them against
their plain versions; phase 4m spawns four gloo ranks on the one card (a
mesh of 4 and a 2x2 one), each rank's block held against the block of the
single-device result; phase 5k times the sharded calls beside the
single-device ones and torch.fft, with one call's device time by kernel.
Phase 4n runs the native FFI (fourier_tpu_torch/ffi, the host C++ core, no
kernel): it builds the core's library and dump_plan with the host C++
compiler (no CMake), holds the core against np.fft in f64 and against the
port's create_fft_f32/create_fft_f64 plans on the card on the same data at
FFI_SIZES x 5 modes (gates 1e-6 and 1e-12), runs native_fft under
torch.compile(fullgraph=True) on CPU tensors, fails unless a CUDA tensor is
refused, runs the plan-parity gate, and times one call at FFI_TIME on the
host beside the port's call on the card.
Every phase prints its lines;
any failed check raises, so the exit code is non-zero. The next-to-last
line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.

It needs a CUDA device and the repository beside it; it imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np

SIZES = (64, 96, 128, 243, 320, 512, 576, 625, 729, 1000, 1024, 1728, 2187,
         3125, 4096, 6144, 6561, 8192, 14400, 16384)
BATCHES = (1, 7, 1000)
REL_L2_GATE = 1e-6  # two f32 results, each within ~3e-7 of exact
HOST_COLUMNS = 3  # columns per case checked against np.fft in f64
MAIN_N, MAIN_B = 4096, 16384
PRIME = 4099  # composed Bluestein over a B1 inner of 16384 (the vpu route)
CHAIN = 128
REPS = 3
SEED = 20261016
B2_SIZES = (73, 769, 1013, 1418, 4093)  # inner 160, 1600, 2048, 2880, 8192
B3_SIZES = (32768, 65536, 262144)  # FourStepLocalPlan (128,256) .. (512,512)
# B3 on four-block clusters: n = 4096 * 4096, (p, q) = (4096, 4096), B = 1.
B3_QUAD = ((4096 * 4096, 1),)
B3_PLANS = ((65536, 1024), (262144, 256))  # the plans phase 5c times
B3_AB_Q = 256  # the q of phase 5g's B3 sweep
# The registers of B1's and B6's clustered bodies (fft_pair.cu, fft_pair_dd.cu)
# before fft_pair took an I/O policy, by blocks a cluster and height (ptxas
# -v for sm_90a, with the toolkit of the H100's machine); phase 2 prints
# this build's beside them.
PARENT_B1_REGS = {(c, h): r for c, rows in {
    2: {32: 128, 36: 80, 40: 102, 48: 104, 60: 128, 64: 128, 72: 94, 80: 102,
        96: 127, 100: 115, 108: 105, 120: 128, 128: 128, 144: 96, 160: 122,
        180: 122, 192: 96, 200: 115, 216: 105, 240: 128, 256: 127, 288: 123,
        300: 80, 320: 72, 324: 70, 360: 93, 384: 128, 400: 126, 432: 122, 480:
        128, 500: 88, 512: 128, 540: 106, 576: 96, 600: 122, 640: 128, 648:
        106, 720: 128, 768: 122, 800: 128, 864: 128, 900: 128, 960: 128, 972:
        114, 1000: 124, 1024: 128},
    4: {540: 128, 576: 109, 600: 128, 640: 128, 648: 126, 720: 128, 768: 121,
        800: 128, 864: 128, 900: 128, 960: 128, 972: 128, 1000: 128, 1024:
        128},
}.items() for h, r in rows.items()}
PARENT_B6_REGS = {(c, h): r for c, rows in {
    2: {32: 255, 36: 124, 40: 164, 48: 200, 60: 240, 64: 254, 72: 150, 80: 192,
        96: 240, 100: 190, 108: 164, 120: 238, 128: 254, 144: 186, 160: 228,
        180: 212, 192: 162, 200: 190, 216: 174, 240: 254, 256: 208, 288: 234,
        300: 120, 320: 112, 324: 96, 360: 159, 384: 232, 400: 225, 432: 221,
        480: 254, 500: 130, 512: 254, 540: 187, 576: 159, 600: 218, 640: 254,
        648: 178, 720: 255, 768: 222, 800: 255, 864: 255, 900: 230, 960: 241,
        972: 186, 1000: 209, 1024: 254},
    4: {540: 204, 576: 179, 600: 234, 640: 255, 648: 192, 720: 255, 768: 222,
        800: 255, 864: 255, 900: 254, 960: 254, 972: 222, 1000: 250, 1024:
        254},
}.items() for h, r in rows.items()}
# The vpu route of the JAX package (fourier_tpu.create_fft(n, backend="vpu")),
# as fourier_tpu_torch.plan.plan_tree gives it: (class, size, split or inner,
# sub-plans).
ROUTE_TREES = {
    1: ("MxuFftPlan", 1, (1, 1)),
    7: ("MxuFftPlan", 7, (1, 7)),
    32: ("MxuFftPlan", 32, (1, 32)),
    48: ("MxuFftPlan", 48, (1, 48)),
    64: ("VpuFftPlan", 64),
    100: ("MxuFftPlan", 100, (1, 100)),
    125: ("MxuFftPlan", 125, (1, 125)),
    200: ("VpuFftPlan", 200),
    222: ("MxuFftPlan", 222, (1, 222)),
    439: ("MxuFftPlan", 439, (1, 439)),
    722: ("MxuFftPlan", 722, (1, 722)),
    769: ("VpuBluesteinPlan", 769, 1600),
    818: ("VpuBluesteinPlan", 818, 1728),
    1013: ("VpuBluesteinPlan", 1013, 2048),
    1418: ("VpuBluesteinPlan", 1418, 2880),
    4093: ("VpuBluesteinPlan", 4093, 8192),
    4099: ("BluesteinPlan", 4099, ("VpuFftPlan", 16384)),
    10007: ("BluesteinPlan", 10007, ("FourStepLocalPlan", 32768, (128, 256),
                                     ("VpuFftPlan", 256), ("VpuFftPlan", 128))),
    20000: ("FourStepLocalPlan", 20000, (125, 160), ("VpuFftPlan", 160),
            ("MxuFftPlan", 125, (1, 125))),
    32768: ("FourStepLocalPlan", 32768, (128, 256), ("VpuFftPlan", 256),
            ("VpuFftPlan", 128)),
    65536: ("FourStepLocalPlan", 65536, (256, 256), ("VpuFftPlan", 256),
            ("VpuFftPlan", 256)),
    262144: ("FourStepLocalPlan", 262144, (512, 512), ("VpuFftPlan", 512),
             ("VpuFftPlan", 512)),
    458752: ("FourStepLocalPlan", 458752, (512, 896), ("MxuFftPlan", 896, (28, 32)),
             ("VpuFftPlan", 512)),
}
# Routes driven through the entry points: (n, B) at the suite's batches.
ROUTE_RUNS = ((1013, 65536), (1418, 32768), (65536, 1024), (262144, 256),
              (10007, 64), (20000, 64), (458752, 16), (125, 1000), (439, 1000))
MXU_TF32 = (125, 439)  # run with TF32 switched on by the caller
B2_TIME = (1013, 65536)
B3_TIME = (65536, 1024)
CHAIN_NEW = 32  # chain of the B2/B3 timings
PLAIN_CHAIN = 4  # shorter chain of the plain versions there
RF_EVEN = (128, 192, 486, 1024, 2000, 4096, 32768)  # B4 at m = n/2
# B4a's and B4b's bodies meet at m = 2048 (the largest paired-block m) and
# 2160 (the smallest even m the stage body keeps): both are checked there.
B4A_BOUNDARY = (2048, 2160)
# (n, B) whose clusters each walk several tiles of B4a's and B7's paired
# bodies (8 and 4 columns a tile, 66 clusters on an H100) and end on a
# partial group: B a multiple of the 16-byte chunk (16-byte copies) or not.
B4A_WALK = ((4096, 1588), (4096, 1589))
B7_WALK = ((1013, 794), (1013, 795))
# B1's bodies meet at 2048 (two-block clusters), 2160 and 4096 (four-block),
# 3000 and 4320 (the stage body); B2's at M = 2048 (n = 1013, paired) and
# 2160 (n = 1031) and 1024 (n = 509), the stage body. Both bodies are
# checked wherever a clustered one exists, at B_BOUNDARY columns.
B1_BOUNDARY = (2048, 2160, 4096, 3000, 4320)
B2_BOUNDARY = (1013, 1031, 509)
B_BOUNDARY = 1000
B1_WALK = ((4096, 1588), (4096, 1589))  # 199 tiles of 8, 30 clusters of 4
B2_WALK = B7_WALK
# B4b's also meet at m = 1728, which keeps the stage body between paired
# sizes, and m = 512 is its one body that loads w[p + m/2].
B4B_BOUNDARY = B4A_BOUNDARY + (1728, 512)
# B5a's and B5b's bodies meet at M = 2048 (n = 1013, paired) and 2160 (n =
# 1031), 1024 (n = 509) and 8192 (n = 4093, the largest M), the stage body;
# at M = 1728 (n = 863) and 160 (n = 73) B5a's paired body stores in two
# steps (a mixed-radix height), and B5b's stores four columns a thread at
# 1728 and one at 160. Their walk: 795 and 796 column pairs in tiles of 8
# (66 clusters), odd B (element copies, an unpaired last column) and B a
# multiple of 8 (16-byte copies). B4b's walk is B4A_WALK.
B5A_BOUNDARY = (1013, 1031, 509, 4093, 863, 73)
B5A_WALK = ((1013, 1589), (1013, 1592))
# More batches of B4b and B5b on both bodies: B = 1 (B5b: no pair) and odd B.
B45B_BATCHES = (1, 7)
ONE_MODE = ("B4b", "B5a", "B5b")  # the kernels checked in one mode, their own
# B6's bodies meet at 2048 (two-block clusters), 2160 and 4096 (four-block)
# and 3000 (the stage body); its walk: 397 tiles of 4 f64 columns on 30
# clusters of four, B even (16-byte copies) or odd.
B6_BOUNDARY = (2048, 2160, 4096, 3000)
B6_WALK = ((4096, 1588), (4096, 1589))
AB_POINTS = 1 << 26  # points a call in phase 5g's sweep (B = AB_POINTS // n)
AB_CHAIN = 8
RF_ODD = (769, 1013, 4093)  # B5 at inner 1600, 2048, 8192
RF_BATCHES = (1, 2, 7, 1000)  # B5's pairing: none, one pair, odd, even
# The route of the JAX package's RfftPlan(n, np.complex64, backend="vpu"),
# as fourier_tpu_torch.plan.plan_tree gives it: even n plan n/2, odd n plan n.
RFFT_TREES = {
    16: ("MxuFftPlan", 8, (1, 8)),
    64: ("MxuFftPlan", 32, (1, 32)),
    128: ("VpuFftPlan", 64),
    1024: ("VpuFftPlan", 512),
    4096: ("VpuFftPlan", 2048),
    8192: ("VpuFftPlan", 4096),
    32768: ("VpuFftPlan", 16384),
    192: ("VpuFftPlan", 96),
    486: ("VpuFftPlan", 243),
    250: ("MxuFftPlan", 125, (1, 125)),
    2026: ("VpuBluesteinPlan", 1013, 2048),
    40000: ("FourStepLocalPlan", 20000, (125, 160), ("VpuFftPlan", 160),
            ("MxuFftPlan", 125, (1, 125))),
    65536: ("FourStepLocalPlan", 32768, (128, 256), ("VpuFftPlan", 256),
            ("VpuFftPlan", 128)),
    37: ("MxuFftPlan", 37, (1, 37)),
    101: ("MxuFftPlan", 101, (1, 101)),
    243: ("VpuFftPlan", 243),
    769: ("VpuBluesteinPlan", 769, 1600),
    1013: ("VpuBluesteinPlan", 1013, 2048),
    4093: ("VpuBluesteinPlan", 4093, 8192),
    4097: ("BluesteinPlan", 4097, ("VpuFftPlan", 16384)),
    10007: ("BluesteinPlan", 10007, ("FourStepLocalPlan", 32768, (128, 256),
                                     ("VpuFftPlan", 256), ("VpuFftPlan", 128))),
}
RF_ROUTE_B = 129  # odd: the unfused odd path's single-column fallback runs
RF_ROUTE_B_LARGE = 16  # n >= 32768
GRAD_SIZES = (1024, 1013)  # B4, B5
GRAD_TOL = 2e-3  # tests/test_autodiff.py's gate for the fused-pack VJP
RF_TIME = ((1024, 65536), (4096, 16384), (1013, 65536))  # the suite's rows
RF_CHAIN = 16  # round trips per timing; the plain versions run RF_PLAIN_CHAIN
RF_PLAIN_CHAIN = 2
# The card's peaks for the bounds (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes per second, flops per second outside the tensor cores, and dense
# TF32 flops per second on them (B9a's 3xTF32 body: three TF32 products an
# f32 one).
HBM_RATE = 3.35e12
F32_RATE = 67e12
F64_RATE = 34e12
TF32_RATE = 495e12
# complex128: the reference's c128 gate (two f64 results, each near exact).
DD_GATE = 1e-12
DD_B6_SIZES = (64, 243, 625, 729, 1000, 1024, 3000, 4096)
DD_B7_SIZES = (17, 33, 125, 191, 439, 1013)  # inner 64, 128, ..., 2048
B7_INNER = (64, 128, 256, 512, 1024, 2048)  # B7's paired-block bodies
DD_B8_SIZES = (8192, 2187, 3125)  # r = 2, 3, 5
# The complex128 route of the JAX package on a TPU (its planner's _create_dd
# with the TPU branch taken), as fourier_tpu_torch.plan.plan_tree gives it; a
# JAX DdFftPlan reads as ("AutosortPlan", n) or ("BluesteinPlan", n, inner).
DD_TREES = {
    12: ("AutosortPlan", 12),
    6561: ("AutosortPlan", 6561),
    65536: ("AutosortPlan", 65536),
    17: ("VpuDdBluesteinPlan", 17, 64),
    32: ("VpuDdBluesteinPlan", 32, 64),
    100: ("VpuDdBluesteinPlan", 100, 256),
    125: ("VpuDdBluesteinPlan", 125, 256),
    191: ("VpuDdBluesteinPlan", 191, 512),
    222: ("VpuDdBluesteinPlan", 222, 512),
    439: ("VpuDdBluesteinPlan", 439, 1024),
    722: ("VpuDdBluesteinPlan", 722, 2048),
    1013: ("VpuDdBluesteinPlan", 1013, 2048),
    **{n: ("VpuDdFftPlan", n) for n in (64, 243, 256, 512, 625, 729, 1000, 1024,
                                         3000, 4096)},
    1418: ("BluesteinPlan", 1418, ("VpuDdFftPlan", 4096)),
    4099: ("BluesteinPlan", 4099, ("DdSplitPow2Plan", 16384, (
        "DdSplitPow2Plan", 8192, ("VpuDdFftPlan", 4096)))),
    20000: ("BluesteinPlan", 20000, ("AutosortPlan", 65536)),
    2187: ("DdSplitRadixPlan", 2187, 3, ("VpuDdFftPlan", 729)),
    3125: ("DdSplitRadixPlan", 3125, 5, ("VpuDdFftPlan", 625)),
    10000: ("DdSplitRadixPlan", 10000, 5, ("VpuDdFftPlan", 2000)),
    6144: ("DdSplitPow2Plan", 6144, ("VpuDdFftPlan", 3072)),
    8192: ("DdSplitPow2Plan", 8192, ("VpuDdFftPlan", 4096)),
    12288: ("DdSplitPow2Plan", 12288, ("DdSplitPow2Plan", 6144,
                                       ("VpuDdFftPlan", 3072))),
    16384: ("DdSplitPow2Plan", 16384, ("DdSplitPow2Plan", 8192,
                                       ("VpuDdFftPlan", 4096))),
}
DD_ROUTE_B = 64  # the batch phase 4e drives each c128 plan at
# The c128 RfftPlan's inner on a TPU (RfftPlan(n, np.complex128,
# backend="dd") of the JAX package): even n plan n/2, odd n plan n.
DD_RFFT_TREES = {2048: ("VpuDdFftPlan", 1024),
                 16384: ("DdSplitPow2Plan", 8192, ("VpuDdFftPlan", 4096)),
                 1013: ("VpuDdBluesteinPlan", 1013, 2048)}
DD_RFFT_B = 65  # odd: the unfused odd path's single-column fallback runs
# The suite's c128 rows (BENCH_SUITE_r5.json) timed in phase 5e, and the c64
# headline's shape 4096x16384 at c128 (B6 on four-block clusters).
DD_TIME = ((1024, 65536), (1013, 65536), (2187, 16384), (3125, 16384),
           (1418, 32768), (4096, 16384))
DD_CHAIN = 16
# Kernels B9a/B9b, reached through user-built MxuFftPlans (impl="pallas", and
# impl="xla_packed" for n <= 128); no planner route runs them.
B9A_SIZES = (1, 2, 7, 16, 64, 100, 125, 127, 128)
B9A_POISON = (7, 125)  # n not a multiple of 8: a NaN row must stay in its row
B9B_SIZES = (129, 243, 250, 384, 1000, 2048, 4096, 16129, 16384)
B9B_POISON = (129, 250)  # splits (3, 43) and (10, 25): padded in both phases
# Phase 5g's sweep of B9b's bodies, about AB_POINTS_B9B points a call:
# B9B_SIZES, every n in (128, 640] with a split (n1, n2) and every 16th
# such n above: all of the splits where two_phase_body picks the CUDA-core
# body (n * (n1 + n2) < B9B_FMA_WORK holds only below n = 480), and a
# spread of the others.
AB_POINTS_B9B = 1 << 24
B9B_WIDE_N = 250  # (10, 25): also the CUDA-core body's 1024-bound instantiation
B9_TB = 4  # the TPU tile cap the odd batches are checked with as well
B9_ROUTE_B = 257  # phase 4f's batch
# Phases 4i and 5h: the numpy-compatible surface (ndim.py, the N-D real
# family of rfft.py, dctdst.py, fftlog.py, utils/helpers.py) at the shapes of
# a spectral solver or an image pipeline, 128-256 MiB a complex array.
SURF_2D = (4096, 4096)  # fft2/ifft2, rfft2/irfft2, hfft2/ihfft2, fftshift, ...
SURF_3D = (256, 256, 256)  # fftn/ifftn, complex64 and complex128
SURF_ODD = (4096, 1013)  # rfftn/irfftn: B5 on the last axis
SURF_DCTN = (2048, 2048)  # dctn/idctn/dstn type 2
SURF_DCT = (1024, 4096)  # dct/dst/idct/idst types 1-4, every norm
SURF_FHT = (1024, 4096)  # fht/ifht, float64
SURF_FHT_ARGS = (0.01, 0.5, 0.0, 0.0)  # dln, mu, offset, bias
SURF_CHAIN = 4  # calls per timing
# Phases 4j and 5i: signal.py, spectral.py and the scipy.fft backend at the
# shapes of an image or audio pipeline, each held against scipy in f64.
SIG_IMAGE, SIG_PSF = (3968, 3968), (129, 129)  # mode "same": 4096^2 padded
SIG_AUDIO, SIG_FIR = (64, 1 << 20), 1023  # 64 channels; overlap-add blocks of 11664
SIG_ROWS = (16384, 4096)  # hilbert, czt, zoom_fft
SIG_RESAMPLE = ((1024, 48000), 44100)  # 48 kHz audio to 44.1 kHz
SIG_BAND = (1024, 0.1, 0.35)  # czt/zoom_fft: points and band [f1, f2) at fs 1
SIG_STFT = (1024, 256)  # nperseg, hop (Hann)
SIG_WELCH = 4096  # nperseg of welch, csd, coherence, spectrogram; periodogram's records
SIG_GATE, SIG_PSD_GATE = 1e-5, 1e-4  # rel-L2 of complex64 results, of PSD estimates
B9_ROUTE_B_LARGE = 16  # its batch for the four-step of 65536
B9_GRAD = (1000, 64)  # (n, B) of phase 4f's gradient
# Phase 4k: the plan tooling. Plan files of the card's trees at each route
# (B1 4096, B2 1013, B1 + B3 65536, DFT products 125 and 722, composed
# Bluestein 4099, B9b 384, B6 1024, B8 2187, B7 1013, composed c128 1418,
# B4 4096 and B5 1013), each run at TOOL_B columns; measured planning; the
# exported programs (n, dtype, batch_shape, batches run).
TOOL_B = 64
TOOL_TRIPS = (("c64", 4096), ("c64", 1013), ("c64", 65536), ("c64", 125), ("c64", 722),
              ("c64", 4099), ("mxu", 384), ("c128", 1024), ("c128", 2187), ("c128", 1013),
              ("c128", 1418), ("rfft", 4096), ("rfft", 1013))
TOOL_MEASURE = ((4096, "complex64"), (1013, "complex64"), (125, "complex64"),
                (1024, "complex128"), (1013, "complex128"))
TOOL_EXPORT = ((4096, "complex64", (16384,), (16384,)),
               (4096, "complex64", ("b",), (16, 16384)),
               (1013, "complex64", (64,), (64,)), (1024, "complex128", (64,), (64,)))
# Phase 5j: the suite at one size a family (5 families x 2 dtypes x 2
# directions), the large family's first size (2 directions) and the 3 rfft
# rows; the gate of its c64 and rfft rows, the JAX suite's.
SUITE_ROWS = 25
SUITE_GATE = 1e-5
SUITE_HOST_ROWS = 256  # the full suite: 8192 (bench_suite._HOST_ROW_CAP)
SUITE_HOST_ITERS = 2  # the full suite: 5 (bench_suite.HOST_ITERS)
# Phases 4l and 5k: the sharded plans (fourier_tpu_torch.parallel) on a
# one-rank NCCL mesh at full width, each kernel row of the port on a sharded
# entry point: Fft2dPlan at BASELINE config 5 per chip (8 x 4096^2, B1) and
# 4096 x 1013 (B2); c128 4096^2 (B6) and 2187 x 1013 (B8 over B6, B7);
# FourStepPlan of 2^24 points, 4096 x 4096 (B1) and 256 x 65536 (its row
# leg the local four-step: B1 + B3); Rfft2dPlan 4096^2 (B4a/B4b) and
# 4096 x 1013 (B5a/B5b); Fft3dPlan and Rfft3dPlan at 256^3 on a 1x1 pencil
# mesh and as slabs, spectral round trips; the batch-sharded calls at
# 4096 x 16384.
SHARD_FFT2 = (8, 4096, 4096)  # batch, n1, n2
SHARD_FFT2_B2 = (4, 4096, 1013)
SHARD_FFT2_C128 = ((2, 4096, 4096), (16, 2187, 1013))
SHARD_FOUR = ((4096, 4096), (256, 65536))
SHARD_RFFT2 = ((4096, 4096), (4096, 1013))
SHARD_3D = (256, 256, 256)
SHARD_BATCHED = (4096, 16384)  # n, B
SHARD_CHUNKS = 4
SHARD_RFFT_GATE = 1e-5  # the real family's gate (the reference's rfft tests)
# B3's (n, B) under FourStepPlan(256, 65536) on one rank: checked in 3c.
SHARD_B3 = ((65536, 256),)
# Phase 4m: four gloo ranks on the one card, on a mesh of 4 and a 2x2 one.
SHARD_4M_RANKS = 4
SHARD_4M = {"fft2": (1024, 1024), "four": (256, 1024), "rfft2": (1024, 1013),
            "cube": (64, 64, 64)}
SHARD_4M_TIMEOUT = 240.0  # seconds for the four ranks, start-up included
# Phase 4n: the native FFI (fourier_tpu_torch/ffi), the host C++ core, at
# these sizes (every plan family: 1, Stockham 24/243/4096, Bluestein 73/1013)
# on FFI_ROWS rows, and timed once at FFI_TIME (n, B) c64 beside the card.
FFI_SIZES = (1, 24, 73, 243, 1013, 4096)
FFI_ROWS = 8
FFI_TIME = (4096, 256)
B9_TIME = (("B9a", 125, 65536), ("B9b", 4096, 16384), ("B9b", 16384, 1024))
B9_CHAIN = 16
# The bodies of B9a and B9b: the tensor cores' in 3xTF32 (csrc/dft_mma.cu,
# the kernel) and the CUDA cores' in fp32 FMA (csrc/bailey.cu, the first
# design).
B9_BODY_NAMES = {"mma": "tensor-core body (3xTF32)", "fma": "CUDA-core body (fp32 FMA)"}
# A batch that walks B9a's persistent loop over several tiles a block (one
# block an SM at n = 127) and ends on a partial tile.
B9A_WALK = ("B9a", 127, 20001)


def _kernels_of(tree, batch_minor: bool) -> set:
    """The kernels a plan tree launches: B1 for every VpuFftPlan, B2 for a
    VpuBluesteinPlan; a four-step whose row plan is a VpuFftPlan runs its
    rows through B3 on batch-minor calls, and through the row plan (B1) on
    batch-major ones, as the JAX package does."""
    name, out = tree[0], set()
    if name == "VpuFftPlan":
        out.add("B1")
    elif name == "VpuBluesteinPlan":
        out.add("B2")
    elif name == "BluesteinPlan":
        out |= _kernels_of(tree[2], batch_minor)
    elif name == "FourStepLocalPlan":
        out |= _kernels_of(tree[3], batch_minor)
        if tree[4][0] == "VpuFftPlan" and batch_minor:
            out.add("B3")
        else:
            out |= _kernels_of(tree[4], batch_minor)
    return out


def _fused_sizes(tree, kernel: str) -> list:
    """The sizes at which a batch-minor call of a plan tree runs B2 (the
    VpuBluesteinPlans) or B3 (the four-steps with a VpuFftPlan row plan);
    a composed Bluestein runs its inner at the caller's batch."""
    name = tree[0]
    if name == "BluesteinPlan":
        return _fused_sizes(tree[2], kernel)
    if kernel == "B2" and name == "VpuBluesteinPlan":
        return [tree[1]]
    if kernel == "B3" and name == "FourStepLocalPlan" and tree[4][0] == "VpuFftPlan":
        return [tree[1]]
    return []


def _route_cases(kernel: str) -> list:
    """(n, B) of every B2 or B3 call the routes of ROUTE_RUNS make."""
    return [(m, b) for n, b in ROUTE_RUNS
            for m in _fused_sizes(ROUTE_TREES[n], kernel)]


def _rfft_kernels(n: int, inner, call: str) -> set:
    """The kernels an RfftPlan(n) over the `inner` tree launches on `call`
    ("rfft_bm", "irfft_bm" or "major", the batch-major calls): B4a/B4b for
    even n over a VpuFftPlan and B5a/B5b for odd n over a VpuBluesteinPlan
    on the batch-minor calls, else the inner plan's kernels."""
    fused = {("VpuFftPlan", 0): ("B4a", "B4b"),
             ("VpuBluesteinPlan", 1): ("B5a", "B5b")}.get((inner[0], n % 2))
    if fused and call != "major":
        return {fused[call == "irfft_bm"]}
    return _kernels_of(inner, batch_minor=call != "major")


def _rf_route_b(n: int) -> int:
    """The batch phase 4c drives RfftPlan(n) at."""
    return RF_ROUTE_B if n < 32768 else RF_ROUTE_B_LARGE


def _rfft_route_cases() -> list:
    """(n, B) of every B4 or B5 call the rfft routes of phase 4c make, the
    suite rows phase 5d times, and B4A_WALK."""
    fused = [(n, _rf_route_b(n)) for n, inner in RFFT_TREES.items()
             if _rfft_kernels(n, inner, "rfft_bm") & {"B4a", "B5a"}]
    return fused + list(RF_TIME) + list(B4A_WALK)


def _dd_cases(tree, b: int) -> list:
    """(kernel, n, B) of every B6, B7 and B8 call a batch-minor call of a
    c128 plan tree at batch b makes: a split runs its sub-plan on r*b
    columns, a composed Bluestein its inner at b."""
    name = tree[0]
    if name == "VpuDdFftPlan":
        return [("B6", tree[1], b)]
    if name == "VpuDdBluesteinPlan":
        return [("B7", tree[1], b)]
    if name == "DdSplitPow2Plan":
        return [("B8", tree[1], b)] + _dd_cases(tree[2], 2 * b)
    if name == "DdSplitRadixPlan":
        return [("B8", tree[1], b)] + _dd_cases(tree[3], tree[2] * b)
    if name == "BluesteinPlan":
        return _dd_cases(tree[2], b)
    return []


def _dd_route_cases() -> list:
    """(kernel, n, B) of every kernel call the c128 routes of phase 4e make:
    the c2c plans at DD_ROUTE_B and the rfft inners (even n: n/2 at B; odd n:
    the B//2 column pairs and the single-column fallback)."""
    cases = [c for tree in DD_TREES.values() for c in _dd_cases(tree, DD_ROUTE_B)]
    for n, inner in DD_RFFT_TREES.items():
        batches = (DD_RFFT_B,) if n % 2 == 0 else (DD_RFFT_B // 2, 1)
        cases += [c for b in batches for c in _dd_cases(inner, b)]
    return sorted(set(cases)) + [("B7", n, b) for n, b in B7_WALK]


def _c2c_kernels(tree) -> set:
    """The kernels a batch-minor call of a complex64 or complex128 plan tree
    launches."""
    return _kernels_of(tree, True) | {k for k, _, _ in _dd_cases(tree, 1)}


def _real_kernels(n: int, inner, call: str) -> set:
    """The kernels an RfftPlan(n) over the `inner` tree (complex64 or
    complex128) launches on `call` ("rfft_bm" or "irfft_bm")."""
    return _rfft_kernels(n, inner, call) | {k for k, _, _ in _dd_cases(inner, 1)}


def _b9b_sweep_sizes() -> list:
    """The n of phase 5g's B9b sweep, in increasing order."""
    from fourier_tpu_torch.ops.dft_matrix import choose_split
    split = [n for n in range(129, 128 * 128 + 1) if choose_split(n)]
    return sorted(set(B9B_SIZES) | {n for n in split if n <= 640}
                  | set([n for n in split if n > 640][::16]))


def _b9_route_cases() -> list:
    """(kernel, n, B) of every B9 call phases 4f and 5f make, and B9A_WALK.
    Phase 4f runs each plan at B9_ROUTE_B: the Bluestein of 1013 its inner
    2048 at that batch, the four-step of 65536 (at B9_ROUTE_B_LARGE) both
    256 = (16, 16) legs on 256 * B rows; its gradient runs B9_GRAD forward
    and backward. Phase 4f checks that its calls are among these."""
    b = B9_ROUTE_B
    return ([("B9a", 100, b), ("B9a", 128, b), B9A_WALK, ("B9b", 1000, b),
             ("B9b", 2048, b), ("B9b", 256, 256 * B9_ROUTE_B_LARGE),
             ("B9b", *B9_GRAD)] + list(B9_TIME))


def bound(nbytes: float, flops: float, rate: float):
    """(least ms, what bounds it): the bytes over the HBM rate or the flops
    over the card's peak `rate` for their type, whichever is longer."""
    by_bytes, by_ops = nbytes / HBM_RATE * 1e3, flops / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def chirp_z_flops(n: int, m: int) -> float:
    """Flops of one column's chirp-z through an m-point inner transform: two
    m-point FFTs (5 m log2 m each) and three complex multiplies per point
    (6 flops each) over n, m and n points."""
    return 2 * 5 * m * math.log2(m) + 6 * (2 * n + m)


def ptxas_usage(report: str) -> list:
    """From an ``nvcc -Xptxas -v`` report: ([(kernel, registers, (spill
    bytes stored, loaded))] of each entry function, the most spill bytes
    (stored, loaded) of a non-inlined device function)."""
    spills, regs, fn, kernels = {}, {}, None, []
    for line in report.splitlines():
        m = re.search(r"(Compiling entry function|Function properties for) '?([\w$.]+)", line)
        if m:
            fn = m.group(2)
            if m.group(1).startswith("Compiling") and fn not in kernels:
                kernels.append(fn)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            spills[fn] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = int(m.group(1))
    callees = [f for f in spills if f not in kernels]
    worst = max((spills[f] for f in callees), default=(0, 0))
    names = kernels
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(kernels), text=True,
                               capture_output=True).stdout.split("\n")
    short = lambda name: re.sub(r"\(.*", "", name.replace(
        "(anonymous namespace)::", "").replace("void ", ""))
    return ([(short(name), regs.get(k), spills.get(k, (0, 0)))
             for name, k in zip(names, kernels)], worst)


def pair_heights(kerns) -> dict:
    """{template arguments: registers} of the clustered bodies
    `name_pair_c64<...>` and `name_pair_c128<...>` among ptxas_usage's
    kernels: the height H of a body with one argument, else the tuple
    (C, H) or (C, H, twiddle in a pass) (B3's)."""
    out = {}
    for k, r, _ in kerns:
        m = re.search(r"_pair_c(?:64|128)<([^>]*)>", k)
        if m:
            args = tuple(int(a) if a.strip().isdigit() else a.strip() == "true"
                         for a in m.group(1).split(","))
            out[args[0] if len(args) == 1 else args] = r
    return out


def _free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _local_block(t, mesh, placements):
    """The block of the whole tensor `t` that this rank holds under a
    DTensor's `placements` on `mesh` (even shards)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            k = t.shape[p.dim] // mesh.size(i)
            t = t.narrow(p.dim, coord[i] * k, k)
    return t


def _rel_t(got, want) -> float:
    """rel-L2 of two tensors on the card, in f64."""
    import torch

    dt = torch.complex128 if got.is_complex() or want.is_complex() else torch.float64
    g, w = got.to(dt), want.to(dt)
    return float((g - w).norm() / w.norm())


def _rank_4m(rank: int, store: str, out_dir: str) -> None:
    """Phase 4m, one rank of SHARD_4M_RANKS gloo ranks on the one card: the
    sharded plans on a mesh of 4 ("fft") and a 2x2 one ("x", "y"), each
    rank's block held against the block of the single-device result
    (torch.fft and the port's own surface); the kernels each launched, by
    rank, written to out_dir/rank<r>.json."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=SHARD_4M_RANKS, rank=rank)
    try:
        import fourier_tpu_torch as ftt
        from fourier_tpu_torch import parallel
        from fourier_tpu_torch.ops.cuda import stockham_vpu as sv

        dev = torch.device("cuda", 0)
        counters = {"B1": sv.vpu_fft_batch_minor, "B2": sv.vpu_bluestein_batch_minor,
                    "B3": sv.vpu_fft_four_step_row, "B4a": sv.vpu_rfft_pack_batch_minor,
                    "B4b": sv.vpu_irfft_unpack_batch_minor,
                    "B5a": sv.vpu_rfft_odd_pack_batch_minor,
                    "B5b": sv.vpu_irfft_odd_unpack_batch_minor}
        fft = init_device_mesh("cuda", (SHARD_4M_RANKS,), mesh_dim_names=("fft",))
        xy = init_device_mesh("cuda", (2, 2), mesh_dim_names=("x", "y"))
        gen = torch.Generator(device=dev).manual_seed(SEED)  # one input on every rank
        results = {}

        def rand(*shape, complex_=True):
            re = torch.randn(*shape, generator=gen, device=dev)
            return torch.complex(re, torch.randn(*shape, generator=gen, device=dev)
                                 ) if complex_ else re

        def case(name, run, wants, gate, crop=None):
            """`run` gives DTensors (planes); each (label, whole reference)
            of `wants`, blocked as the result is, against the result."""
            refs = [(label, want()) for label, want in wants]
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            outs = run()
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
            local = [o.to_local() for o in outs]
            got = torch.complex(*local) if len(local) == 2 else local[0]
            if crop is not None:
                got = got[..., :crop]
            errs = {}
            for label, ref in refs:
                if crop is not None and ref.shape[-1] != outs[0].shape[-1]:
                    ref = torch.nn.functional.pad(ref, (0, outs[0].shape[-1] - ref.shape[-1]))
                block = _local_block(ref, outs[0].device_mesh, outs[0].placements)
                errs[label] = _rel_t(got, block[..., :got.shape[-1]])
            results[name] = {"errs": errs, "gate": gate, "launches": launches}
            return outs

        n1, n2 = SHARD_4M["fft2"]
        x = rand(n1, n2)
        plan = parallel.Fft2dPlan(n1, n2, fft)
        one = case(f"Fft2dPlan({n1}, {n2})", lambda: plan.fft_planar(x.real, x.imag),
                   [("torch.fft.fft2", lambda: torch.fft.fft2(x)),
                    ("ftt.fft2", lambda: ftt.fft2(x))], REL_L2_GATE)
        chunked = parallel.Fft2dPlan(n1, n2, fft, pipeline_chunks=2)
        two = case(f"Fft2dPlan({n1}, {n2}, pipeline_chunks=2)",
                   lambda: chunked.fft_planar(x.real, x.imag),
                   [("torch.fft.fft2", lambda: torch.fft.fft2(x))], REL_L2_GATE)
        results["chunks bitwise"] = all(torch.equal(a.to_local(), b.to_local())
                                        for a, b in zip(one, two))
        p1, p2 = SHARD_4M["four"]
        xf = rand(p1 * p2)
        four = parallel.FourStepPlan(p1, p2, fft, natural_order=True)
        case(f"FourStepPlan({p1}, {p2}, natural_order=True)",
             lambda: four.fft_planar(xf.real.view(p1, p2), xf.imag.view(p1, p2)),
             [("torch.fft.fft", lambda: torch.fft.fft(xf)),
              ("create_fft_f32", lambda: ftt.create_fft_f32(p1 * p2, device=dev).fft(xf))],
             REL_L2_GATE)
        digit = parallel.FourStepPlan(p1, p2, fft)
        case(f"FourStepPlan({p1}, {p2})",
             lambda: digit.fft_planar(xf.real.view(p1, p2), xf.imag.view(p1, p2)),
             [("torch.fft.fft", lambda: torch.fft.fft(xf).view(p2, p1).T)], REL_L2_GATE)
        r1, r2 = SHARD_4M["rfft2"]
        xr = rand(r1, r2, complex_=False)
        rplan = parallel.Rfft2dPlan(r1, r2, fft)
        spec = case(f"Rfft2dPlan({r1}, {r2}).rfft_planar", lambda: rplan.rfft_planar(xr),
                    [("torch.fft.rfft2", lambda: torch.fft.rfft2(xr)),
                     ("ftt.rfft2", lambda: ftt.rfft2(xr))], SHARD_RFFT_GATE,
                    crop=rplan.out_len)
        case(f"Rfft2dPlan({r1}, {r2}).irfft_planar", lambda: (rplan.irfft_planar(*spec),),
             [("input", lambda: xr)], SHARD_RFFT_GATE)
        c = SHARD_4M["cube"]
        xc = rand(*c)
        cube = parallel.Fft3dPlan(*c, xy, spectral_output=True)
        sp = case(f"Fft3dPlan{c} 2x2 spectral", lambda: cube.fft_planar(xc.real, xc.imag),
                  [("torch.fft.fftn", lambda: torch.fft.fftn(xc)),
                   ("ftt.fftn", lambda: ftt.fftn(xc))], REL_L2_GATE)
        case(f"Fft3dPlan{c} 2x2 from_spectral",
             lambda: cube.transform_planar(*sp, ftt.Transform.IFFT, from_spectral=True),
             [("input", lambda: xc)], REL_L2_GATE)
        slab = parallel.Fft3dPlan(*c, fft, axes=("fft",))
        case(f"Fft3dPlan{c} slab", lambda: slab.fft_planar(xc.real, xc.imag),
             [("torch.fft.fftn", lambda: torch.fft.fftn(xc))], REL_L2_GATE)
        xrc = rand(*c, complex_=False)
        rcube = parallel.Rfft3dPlan(*c, xy, spectral_output=True)
        rsp = case(f"Rfft3dPlan{c} 2x2 spectral", lambda: rcube.rfft_planar(xrc),
                   [("torch.fft.rfftn", lambda: torch.fft.rfftn(xrc)),
                    ("ftt.rfftn", lambda: ftt.rfftn(xrc))], SHARD_RFFT_GATE,
                   crop=rcube.out_len)
        case(f"Rfft3dPlan{c} 2x2 from_spectral",
             lambda: (rcube.irfft_planar(*rsp, from_spectral=True),),
             [("input", lambda: xrc)], SHARD_RFFT_GATE)
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")

    import fourier_tpu_torch as ftt
    from fourier_tpu_torch import Transform
    from fourier_tpu_torch.ops import bailey as bp
    from fourier_tpu_torch.ops.cuda import bailey as bk
    from fourier_tpu_torch.ops.cuda import build
    from fourier_tpu_torch.ops.cuda import dd_combine as dc
    from fourier_tpu_torch.ops.cuda import stockham_vpu as sv
    from fourier_tpu_torch.ops.cuda import stockham_vpu_dd as dv
    from fourier_tpu_torch.plan import mxu as mxu_plan
    from fourier_tpu_torch.plan import plan_tree

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def planes(n, b):
        return (torch.randn(n, b, generator=gen, device=dev),
                torch.randn(n, b, generator=gen, device=dev))

    # 1. Device.
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"device: {name} | nvidia-smi: {smi}", flush=True)

    counters = {"B1": sv.vpu_fft_batch_minor, "B2": sv.vpu_bluestein_batch_minor,
                "B3": sv.vpu_fft_four_step_row,
                "B4a": sv.vpu_rfft_pack_batch_minor,
                "B4b": sv.vpu_irfft_unpack_batch_minor,
                "B5a": sv.vpu_rfft_odd_pack_batch_minor,
                "B5b": sv.vpu_irfft_odd_unpack_batch_minor,
                "B6": dv.vpu_dd_fft_batch_minor,
                "B7": dv.vpu_dd_bluestein_batch_minor,
                "B8": dc.dd_split_combine_batch_minor,
                "B9a": bk.mxu_fft_single, "B9b": bk.mxu_fft_two_phase}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    def host_cols(re, im):
        """The first HOST_COLUMNS columns of (n, B) planes, complex128 numpy."""
        return (re[:, :HOST_COLUMNS].double().cpu().numpy()
                + 1j * im[:, :HOST_COLUMNS].double().cpu().numpy())

    def np_want(x, mode, n):
        """np.fft of the (n, columns) host array in `mode`, in f64."""
        want = (np.fft.fft(x, axis=0) if mode.is_forward
                else np.fft.ifft(x, axis=0) * n)
        return want * (mode.scale(n) or 1.0)

    def vs_plain(k, p):
        """rel-L2 and max abs error of kernel planes `k` against plain `p`."""
        k = torch.stack(list(k)).double()
        p = torch.stack(list(p)).double()
        return ((torch.linalg.norm(k - p) / torch.linalg.norm(p)).item(),
                (k - p).abs().max().item())

    # 2. Build: the ten kernel libraries, one nvcc each, at once.
    t0 = time.perf_counter()
    libraries = (sv.FOUR_STEP_PAIR_LIBRARY, sv.LIBRARY, sv.PAIR_LIBRARY,
                 sv.FFT_PAIR_LIBRARY, sv.BLUESTEIN_PAIR_LIBRARY, sv.RFFT_ODD_PAIR_LIBRARY,
                 sv.IRFFT_UNPACK_PAIR_LIBRARY, sv.IRFFT_ODD_PAIR_LIBRARY, dv.LIBRARY,
                 dv.FFT_PAIR_DD_LIBRARY, bk.LIBRARY, bk.MMA_LIBRARY)
    build.load_all(libraries)
    sv.library()
    sv.pair_library()
    sv.fft_pair_library()
    sv.four_step_pair_library()
    sv.bluestein_pair_library()
    sv.rfft_odd_pair_library()
    sv.irfft_unpack_pair_library()
    sv.irfft_odd_pair_library()
    dv.library()
    dv.fft_pair_dd_library()
    bk.library()
    bk.mma_library()
    print(f"build: fourier_tpu_torch/csrc/{sv.LIBRARY}.cu (B1-B5, stage bodies), "
          f"{sv.PAIR_LIBRARY}.cu (B4a's paired-block bodies), {sv.FFT_PAIR_LIBRARY}.cu "
          f"(B1's clustered bodies), {sv.FOUR_STEP_PAIR_LIBRARY}.cu (B3's clustered "
          f"bodies), {sv.BLUESTEIN_PAIR_LIBRARY}.cu (B2's paired "
          f"bodies), {sv.RFFT_ODD_PAIR_LIBRARY}.cu (B5a's paired bodies), "
          f"{sv.IRFFT_UNPACK_PAIR_LIBRARY}.cu (B4b's paired bodies), "
          f"{sv.IRFFT_ODD_PAIR_LIBRARY}.cu (B5b's paired bodies), "
          f"{dv.LIBRARY}.cu (B6-B8, stage bodies and B7's paired bodies), "
          f"{dv.FFT_PAIR_DD_LIBRARY}.cu (B6's clustered bodies), {bk.LIBRARY}.cu "
          f"(the CUDA-core bodies of B9a and B9b) and {bk.MMA_LIBRARY}.cu (their "
          f"tensor-core bodies) in {time.perf_counter() - t0:.2f} s; each nvcc: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(build.build_seconds.items(),
                                                          key=lambda kv: -kv[1])),
          flush=True)
    pair_kernels = []
    body_regs = {}  # library -> {height: registers} of its clustered bodies
    for lib in libraries:
        kerns, worst = ptxas_usage(build.resource_usage(lib))
        print(f"ptxas ({lib}.cu): " + "; ".join(
            f"{k} {r} registers, spill {st}/{ld} bytes" for k, r, (st, ld) in kerns)
            + f"; the stage functions spill up to {worst[0]}/{worst[1]} bytes "
            "(stores/loads)", flush=True)
        pair_kernels += [(k, r, sp) for k, r, sp in kerns if "_pair_" in k]
        body_regs[lib] = pair_heights(kerns)
    spilled = [(k, sp) for k, _, sp in pair_kernels if sp != (0, 0)]
    n_b4a = sum(1 for m in range(2, sv.PAIR_MAX_M + 1) if sv.rfft_pack_geometry(m))
    n_b4b = sum(1 for m in range(2, sv.PAIR_MAX_M + 1) if sv.irfft_unpack_geometry(m))
    n_b7 = len(B7_INNER)
    n_b1 = sum(1 for n in range(2, 2 * sv.PAIR_MAX_M + 1) if sv.fft_pair_geometry(n))
    n_b2 = sum(1 for m in range(2, sv.PAIR_MAX_M + 1) if sv.bluestein_pair_geometry_c64(m))
    n_b5a = sum(1 for m in range(2, sv.PAIR_MAX_M + 1) if sv.rfft_odd_pack_geometry(m))
    n_b5b = sum(1 for m in range(2, sv.PAIR_MAX_M + 1) if sv.irfft_odd_unpack_geometry(m))
    n_b6 = sum(1 for n in range(2, 2 * sv.PAIR_MAX_M + 1) if dv.fft_pair_geometry_dd(n))
    n_b3 = sum(1 for p in range(2, 2 * sv.PAIR_MAX_M + 1) if sv.four_step_pair_geometry(p))
    counts_ = (n_b4a, n_b4b, n_b7, n_b1, n_b2, n_b5a, n_b5b, n_b6, n_b3)
    check(len(pair_kernels) == sum(counts_) and not spilled,
          f"the clustered-block bodies of B4a, B4b, B7, B1, B2, B5a, B5b, B6 and B3: "
          f"{len(pair_kernels)} built, {' + '.join(map(str, counts_))} expected; "
          f"spills {spilled}")
    regs = [r for _, r, _ in pair_kernels]
    print(f"ptxas (clustered-block bodies): {len(pair_kernels)} instantiations (B4a at "
          f"{n_b4a} m, B4b at {n_b4b} m, B7 at {n_b7} M, B1 at {n_b1} n, B2 at {n_b2} M, "
          f"B5a at {n_b5a} M, B5b at {n_b5b} M, B6 at {n_b6} n, B3 at {n_b3} p), "
          f"{min(regs)}-{max(regs)} registers, 0 spill bytes", flush=True)
    # The tensor-core bodies of B9a and B9b: registers, and no spill.
    # B9b's in two instantiations: tables staged in shared memory (<true>),
    # tables read from global memory with guarded reads (<false>).
    mma_kernels, _ = ptxas_usage(build.resource_usage(bk.MMA_LIBRARY))
    mma_regs = {("B9a" if "two_phase" not in k else "B9b staged" if "<true>" in k
                 else "B9b global"): (r, sp) for k, r, sp in mma_kernels}
    check(len(mma_kernels) == 3 and set(mma_regs) == {"B9a", "B9b staged", "B9b global"}
          and all(sp == (0, 0) for _, sp in mma_regs.values()),
          f"the tensor-core bodies of B9a and B9b: {mma_kernels}")
    print("ptxas (tensor-core bodies): " + ", ".join(
        f"{k} {r} registers, 0 spill bytes" for k, (r, _) in sorted(mma_regs.items())),
        flush=True)
    # B1's and B6's bodies beside their registers before fft_pair took an
    # I/O policy, and B3's beside B1's.
    for lib, parent in ((sv.FFT_PAIR_LIBRARY, PARENT_B1_REGS),
                        (dv.FFT_PAIR_DD_LIBRARY, PARENT_B6_REGS)):
        now = body_regs[lib]
        moved = {h: (parent.get(h), r) for h, r in now.items() if parent.get(h) != r}
        print(f"ptxas registers {lib} by (blocks, height), this build/before the "
              "policy: " + ", ".join(f"{h}: {r}/{parent.get(h, '-')}"
                                     for h, r in sorted(now.items()))
              + f"; {len(now) - len(moved)} of {len(now)} unchanged, moved: {moved}",
              flush=True)
    print("ptxas registers B3/B1 by (blocks, height): " + ", ".join(
        f"{h}: {r}/{body_regs[sv.FFT_PAIR_LIBRARY].get(h[:2], '-')}"
        for h, r in sorted(body_regs[sv.FOUR_STEP_PAIR_LIBRARY].items())), flush=True)
    for new, old, what in ((sv.IRFFT_UNPACK_PAIR_LIBRARY, sv.PAIR_LIBRARY, "B4b/B4a"),
                           (sv.IRFFT_ODD_PAIR_LIBRARY, sv.RFFT_ODD_PAIR_LIBRARY, "B5b/B5a")):
        print(f"ptxas registers {what} by height: " + ", ".join(
            f"{h}: {r}/{body_regs[old].get(h, '-')}"
            for h, r in sorted(body_regs[new].items())), flush=True)
    for kernel, geometry, count in (("B1", sv.fft_pair_geometry, sv.fft_pair_clusters),
                                    ("B3", sv.four_step_pair_geometry,
                                     sv.four_step_pair_clusters),
                                    ("B6", dv.fft_pair_geometry_dd, dv.fft_pair_clusters_dd)):
        clusters = {n: (geometry(n).ranks, count(n, dev)) for n in (1024, 2048, 2160, 4096)}
        print(f"{kernel} clusters on the card at once (cudaOccupancyMaxActiveClusters): "
              + ", ".join(f"n={n}: {c} clusters of {r} blocks"
                          for n, (r, c) in clusters.items()), flush=True)

    # 3. Kernel against its plain version, and against np.fft on the host.
    worst_plain = worst_host = max_abs = 0.0
    cases = [(n, b) for n in SIZES for b in BATCHES] + [(MAIN_N, MAIN_B)]
    for n, b in cases:
        plan = ftt.VpuFftPlan.create(n, device=dev)
        re, im = planes(n, b)
        x = host_cols(re, im)
        for mode in Transform:
            k = plan.transform_planar_bm(re, im, mode)
            p = sv.vpu_fft_batch_minor_reference(
                re, im, n, plan.tables(mode.is_forward), mode.is_forward,
                mode.scale(n))
            torch.cuda.synchronize()
            err, mx = vs_plain(k, p)
            check(err <= REL_L2_GATE,
                  f"B1 vs plain n={n} B={b} {mode.name}: rel-L2 {err:.3e}")
            herr = rel_l2(host_cols(*k), np_want(x, mode, n))
            check(herr <= REL_L2_GATE,
                  f"B1 vs np.fft n={n} B={b} {mode.name}: rel-L2 {herr:.3e}")
            worst_plain, worst_host = max(worst_plain, err), max(worst_host, herr)
            max_abs = max(max_abs, mx)
    print(f"B1 kernel vs plain: {len(cases)} (n, B) cases x 5 modes pass; worst "
          f"rel-L2 {worst_plain:.3e} vs plain, {worst_host:.3e} vs np.fft "
          f"(gate {REL_L2_GATE:g}); max abs err {max_abs:.3e}", flush=True)
    max_abs_err = {"B1": max_abs}

    def body_runs(kernel, n, b):
        """The cases of B1, B2, B4b, B5a, B5b or B6 at (n, B), n the real
        length for B4b, B5a and B5b: (bodies, [(mode, plain result, np.fft of
        the first columns, run(body) -> kernel result)]), every mode (B4b,
        B5a, B5b: their one), on both bodies where a clustered one exists,
        else the stage body."""
        if kernel == "B4b":
            m = n // 2
            plan = ftt.RfftPlan(n, device=dev)
            re, im = planes(m + 1, b)
            kw = dict(tables=plan.inner.tables(False), kernel_tables=plan.inner.kernel_inv,
                      pair_tables=plan.inner.pair_inv, w=plan.w)
            p = (sv.vpu_irfft_unpack_batch_minor_reference(re, im, m, kw["tables"], plan.w),)
            run = lambda body: (sv.vpu_irfft_unpack_batch_minor(re, im, m, _body=body, **kw),)
            geo = sv.irfft_unpack_geometry(m)
            return (("pair", "stage") if geo else ("stage",),
                    [("IRFFT", p, np.fft.irfft(host_cols(re, im), n, axis=0), run)])
        if kernel == "B5b":
            plan = ftt.VpuBluesteinPlan.create(n, device=dev)
            st = plan.stages
            re, im = planes((n + 1) // 2, b)
            kw = dict(tables=(st.tables(True), st.tables(False)),
                      kernel_tables=(st.kernel_fwd, st.kernel_inv),
                      pair_tables=(st.pair_fwd, st.pair_inv), chirps=plan.chirps(False))
            p = (sv.vpu_irfft_odd_unpack_batch_minor_reference(re, im, n, st.size, kw["tables"],
                                                               kw["chirps"]),)
            run = lambda body: (sv.vpu_irfft_odd_unpack_batch_minor(re, im, n, st.size,
                                                                    _body=body, **kw),)
            geo = sv.irfft_odd_unpack_geometry(st.size)
            return (("pair", "stage") if geo else ("stage",),
                    [("IRFFT", p, np.fft.irfft(host_cols(re, im), n, axis=0), run)])
        if kernel == "B5a":
            plan = ftt.VpuBluesteinPlan.create(n, device=dev)
            st = plan.stages
            x = planes(n, b)[0]
            kw = dict(tables=(st.tables(True), st.tables(False)),
                      kernel_tables=(st.kernel_fwd, st.kernel_inv),
                      pair_tables=(st.pair_fwd, st.pair_inv), chirps=plan.chirps(True))
            p = sv.vpu_rfft_odd_pack_batch_minor_reference(x, n, st.size, kw["tables"],
                                                           kw["chirps"])
            run = lambda body: sv.vpu_rfft_odd_pack_batch_minor(x, n, st.size,
                                                                _body=body, **kw)
            geo = sv.rfft_odd_pack_geometry(st.size)
            return ("pair", "stage") if geo else ("stage",), [("RFFT", p, rfft_host(x), run)]
        if kernel == "B1":
            plan = ftt.VpuFftPlan.create(n, device=dev)
            geo = sv.fft_pair_geometry(n)
            re, im = planes(n, b)
        elif kernel == "B2":
            plan = ftt.VpuBluesteinPlan.create(n, device=dev)
            st = plan.stages
            geo = sv.bluestein_pair_geometry_c64(st.size)
            re, im = planes(n, b)
        else:
            plan = ftt.VpuDdFftPlan.create(n, device=dev)
            geo = dv.fft_pair_geometry_dd(n)
            re, im = planes64(n, b)
        x = host_cols(re, im)
        cases = []
        for mode in Transform:
            fwd, scale = mode.is_forward, mode.scale(n)
            if kernel in ("B1", "B6"):
                ref, wrapper = ((sv.vpu_fft_batch_minor_reference, sv.vpu_fft_batch_minor)
                                if kernel == "B1" else (dv.vpu_dd_fft_batch_minor_reference,
                                                        dv.vpu_dd_fft_batch_minor))
                kw = dict(tables=plan.tables(fwd),
                          kernel_tables=plan.kernel_fwd if fwd else plan.kernel_inv,
                          pair_tables=plan.pair_fwd)
                p = ref(re, im, n, kw["tables"], fwd, scale)
                run = (lambda body, fwd=fwd, scale=scale, kw=kw, wrapper=wrapper:
                       wrapper(re, im, n, fwd, scale, _body=body, **kw))
            else:
                kw = dict(tables=(st.tables(True), st.tables(False)),
                          kernel_tables=(st.kernel_fwd, st.kernel_inv),
                          pair_tables=(st.pair_fwd, st.pair_inv),
                          chirps=plan.chirps(fwd))
                p = sv.vpu_bluestein_batch_minor_reference(
                    re, im, n, st.size, kw["tables"], kw["chirps"], scale)
                run = lambda body, scale=scale, kw=kw: sv.vpu_bluestein_batch_minor(
                    re, im, n, st.size, scale, _body=body, **kw)
            cases.append((mode.name, p, np_want(x, mode, n), run))
        return ("pair", "stage") if geo else ("stage",), cases

    def bodies_case(kernel, n, b):
        """body_runs of a kernel at (n, B), each result against the plain
        version and np.fft (gate DD_GATE for B6, else REL_L2_GATE): (bodies
        run, worst rel-L2 vs plain, vs np.fft, max abs)."""
        gate = DD_GATE if kernel == "B6" else REL_L2_GATE
        bodies, cases = body_runs(kernel, n, b)
        worst_p = worst_h = mx = 0.0
        for mode, p, want, run in cases:
            for body in bodies:
                k = run(body)
                torch.cuda.synchronize()
                err, m_ = vs_plain(k, p)
                got = (host_cols(*k) if len(k) == 2
                       else k[0][:, :HOST_COLUMNS].double().cpu().numpy())
                herr = rel_l2(got, want)
                check(err <= gate and herr <= gate,
                      f"{kernel} {body} body n={n} B={b} {mode}: rel-L2 "
                      f"{err:.3e} vs plain, {herr:.3e} vs np.fft (gate {gate:g})")
                worst_p, worst_h, mx = max(worst_p, err), max(worst_h, herr), max(mx, m_)
        return bodies, worst_p, worst_h, mx

    def boundary_checks(kernel, cases, want_pair):
        """bodies_case over `cases`; the sizes that have a clustered body must
        be `want_pair`."""
        worst_p = worst_h = 0.0
        ran = []
        for n, b in cases:
            bodies, e_p, e_h, mx = bodies_case(kernel, n, b)
            worst_p, worst_h = max(worst_p, e_p), max(worst_h, e_h)
            max_abs_err[kernel] = max(max_abs_err[kernel], mx)
            ran.append((n, b, "+".join(bodies)))
        paired = {n for n, _, bodies in ran if "pair" in bodies}
        check(paired == set(want_pair), f"{kernel}'s clustered bodies at {sorted(paired)}, "
              f"expected {sorted(want_pair)}")
        print(f"{kernel} bodies at their boundaries and walks {ran} x "
              f"{'1 mode' if kernel in ONE_MODE else '5 modes'} pass; worst rel-L2 "
              f"{worst_p:.3e} vs plain, {worst_h:.3e} vs np.fft (gate "
              f"{DD_GATE if kernel == 'B6' else REL_L2_GATE:g})", flush=True)

    boundary_checks("B1", [(n, B_BOUNDARY) for n in B1_BOUNDARY] + list(B1_WALK),
                    (2048, 2160, 4096))

    # 3b. B2 against its plain version and np.fft, at the listed sizes and at
    # the routes' shapes.
    worst_plain = worst_host = max_abs = 0.0
    b2_cases = [(n, b) for n in B2_SIZES for b in BATCHES] + _route_cases("B2")
    for n, b in b2_cases:
        plan = ftt.VpuBluesteinPlan.create(n, device=dev)
        st = plan.stages
        re, im = planes(n, b)
        x = host_cols(re, im)
        for mode in Transform:
            k = plan.transform_planar_bm(re, im, mode)
            p = sv.vpu_bluestein_batch_minor_reference(
                re, im, n, st.size, (st.tables(True), st.tables(False)),
                plan.chirps(mode.is_forward), mode.scale(n))
            torch.cuda.synchronize()
            err, mx = vs_plain(k, p)
            check(err <= REL_L2_GATE,
                  f"B2 vs plain n={n} B={b} {mode.name}: rel-L2 {err:.3e}")
            herr = rel_l2(host_cols(*k), np_want(x, mode, n))
            check(herr <= REL_L2_GATE,
                  f"B2 vs np.fft n={n} B={b} {mode.name}: rel-L2 {herr:.3e}")
            worst_plain, worst_host = max(worst_plain, err), max(worst_host, herr)
            max_abs = max(max_abs, mx)
    print(f"B2 kernel vs plain: {len(b2_cases)} (n, B) cases x 5 modes pass "
          f"(n in {B2_SIZES} x B in {BATCHES}, routes {_route_cases('B2')}); "
          f"worst rel-L2 {worst_plain:.3e} vs plain, {worst_host:.3e} vs np.fft "
          f"(gate {REL_L2_GATE:g}); max abs err {max_abs:.3e}", flush=True)
    max_abs_err["B2"] = max_abs
    boundary_checks("B2", [(n, B_BOUNDARY) for n in B2_BOUNDARY] + list(B2_WALK),
                    (1013,))

    # 3c. B3 on both bodies against its plain version on the same (q, p, B) input, and the whole
    # four-step plan (B1 columns, B3 rows) against np.fft, at the listed
    # sizes (B = 1, odd B, B a multiple of 4: 16-byte copies), on four-block
    # clusters (B3_QUAD) and at the routes' shapes, in every mode.
    worst_host = max_abs = 0.0
    b3_worst = {}
    b3_cases = ([(n, b) for n in B3_SIZES for b in BATCHES] + list(B3_QUAD)
                + _route_cases("B3") + list(SHARD_B3))
    for n, b in b3_cases:
        plan = ftt.create_fft_f32(n, device="cuda")
        check(isinstance(plan, ftt.FourStepLocalPlan)
              and isinstance(plan.row_plan, ftt.VpuFftPlan), f"n={n}: {plan!r}")
        p_, q_, rp = plan.p, plan.q, plan.row_plan
        re3, im3 = (t.view(q_, p_, b) for t in planes(n, b))
        for mode in Transform:
            fwd = mode.is_forward
            tw = plan.tw_fwd if fwd else plan.tw_inv
            kw = dict(tables=rp.tables(fwd), pre_tw=(tw[0], tw[1]),
                      tw_fwd=(plan.tw_fwd[0], plan.tw_fwd[1]),
                      kernel_tables=rp.kernel_fwd if fwd else rp.kernel_inv,
                      pair_tables=rp.pair_fwd)
            p = sv.vpu_fft_four_step_row_reference(
                re3, im3, p_, q_, kw["tables"], kw["pre_tw"], fwd, mode.scale(n))
            for body in ("stage", "pair"):
                k = sv.vpu_fft_four_step_row(re3, im3, p_, q_, fwd, mode.scale(n),
                                             _body=body, **kw)
                torch.cuda.synchronize()
                err, mx = vs_plain(k, p)
                check(err <= REL_L2_GATE, f"B3 {body} vs plain n={n} B={b} "
                      f"{mode.name}: rel-L2 {err:.3e}")
                b3_worst[body] = max(b3_worst.get(body, 0.0), err)
                max_abs = max(max_abs, mx)
                del k
            re, im = re3.view(n, b), im3.view(n, b)
            herr = rel_l2(host_cols(*plan.transform_planar_bm(re, im, mode)),
                          np_want(host_cols(re, im), mode, n))
            check(herr <= REL_L2_GATE,
                  f"four-step vs np.fft n={n} B={b} {mode.name}: rel-L2 {herr:.3e}")
            worst_host = max(worst_host, herr)
            del p
    print(f"B3 kernel vs plain: {len(b3_cases)} (n, B) cases x 5 modes pass on every "
          f"body (n in {B3_SIZES} x B in {BATCHES}, {B3_QUAD} on four-block clusters, "
          f"routes {_route_cases('B3')}, the sharded four-step's {SHARD_B3}); worst "
          "rel-L2 vs plain by body "
          + ", ".join(f"{k} {v:.3e}" for k, v in b3_worst.items())
          + f"; whole plan {worst_host:.3e} vs np.fft (gate {REL_L2_GATE:g}); max abs "
          f"err {max_abs:.3e}", flush=True)
    max_abs_err["B3"] = max_abs

    # 3d. B4a/B4b and B5a/B5b against their plain versions and np.fft (f64),
    # and the round trip irfft(rfft(x)) against x.
    def rfft_host(x):
        """np.fft.rfft of the first HOST_COLUMNS columns of an (n, B) plane."""
        return np.fft.rfft(x[:, :HOST_COLUMNS].double().cpu().numpy(), axis=0)

    def plain_fns(plan):
        """The plain versions of a fused plan's two kernels: (x -> (re, im),
        (re, im) -> x)."""
        inner = plan.inner
        if plan.even:
            return (lambda x: sv.vpu_rfft_pack_batch_minor_reference(
                        x, plan.m, inner.tables(True), plan.w),
                    lambda r, i: sv.vpu_irfft_unpack_batch_minor_reference(
                        r, i, plan.m, inner.tables(False), plan.w))
        st = inner.stages
        tables = (st.tables(True), st.tables(False))
        return (lambda x: sv.vpu_rfft_odd_pack_batch_minor_reference(
                    x, plan.n, st.size, tables, inner.chirps(True)),
                lambda r, i: sv.vpu_irfft_odd_unpack_batch_minor_reference(
                    r, i, plan.n, st.size, tables, inner.chirps(False)))

    def rfft_case(plan, x):
        """Kernel and plain results of one plan on (n, B) x: worst rel-L2
        of each check and the max abs errors against the plain versions."""
        plain_f, plain_i = plain_fns(plan)
        kre, kim = plan.rfft_planar_bm(x)
        back = plan.irfft_planar_bm(kre, kim)
        pre, pim = plain_f(x)
        pback = plain_i(kre, kim)
        torch.cuda.synchronize()
        ef, mf = vs_plain((kre, kim), (pre, pim))
        ei, mi = vs_plain((back,), (pback,))
        spec = host_cols(kre, kim)
        eh = rel_l2(spec, rfft_host(x))
        ehi = rel_l2(np.fft.irfft(spec, plan.n, axis=0),
                     back[:, :HOST_COLUMNS].double().cpu().numpy())
        rt = (torch.linalg.norm(back - x) / torch.linalg.norm(x)).item()
        return (ef, ei, eh, ehi, rt), mf, mi

    rf_routes = _rfft_route_cases()
    for fam, sizes, batches in (("B4", RF_EVEN, BATCHES), ("B5", RF_ODD, RF_BATCHES)):
        worst = [0.0] * 5
        mx = {f"{fam}a": 0.0, f"{fam}b": 0.0}
        routes = [(n, b) for n, b in rf_routes if n % 2 == (fam == "B5")]
        plans = {}
        for n, b in [(n, b) for n in sizes for b in batches] + routes:
            if n not in plans:
                plans[n] = ftt.RfftPlan(n, device=dev)
                check(plans[n].fused, f"RfftPlan({n}) on the card is not fused: "
                      f"{plans[n]!r}")
            errs, mf, mi = rfft_case(plans[n], planes(n, b)[0])
            check(max(errs) <= REL_L2_GATE,
                  f"{fam} n={n} B={b}: rel-L2 (rfft vs plain, irfft vs plain, "
                  f"rfft vs np.fft, irfft vs np.fft, round trip) {errs}")
            worst = [max(a, e) for a, e in zip(worst, errs)]
            mx[f"{fam}a"] = max(mx[f"{fam}a"], mf)
            mx[f"{fam}b"] = max(mx[f"{fam}b"], mi)
        print(f"{fam} kernels vs plain: n in {sizes} x B in {batches}, routes and "
              f"suite rows {routes} pass; worst rel-L2 {worst[0]:.3e} (rfft) and "
              f"{worst[1]:.3e} (irfft) vs plain, {worst[2]:.3e} and {worst[3]:.3e} "
              f"vs np.fft, round trip {worst[4]:.3e} (gate {REL_L2_GATE:g}); max "
              f"abs err {mx}", flush=True)
        max_abs_err.update(mx)
        del plans
    # B4a's two bodies where they meet: the paired-block body at its largest
    # m, and the stage body there and at the smallest even m it keeps.
    worst = [0.0, 0.0]
    ran = []
    for m in B4A_BOUNDARY:
        plan = ftt.RfftPlan(2 * m, device=dev)
        kw = dict(tables=plan.inner.tables(True), kernel_tables=plan.inner.kernel_fwd,
                  pair_tables=plan.inner.pair_fwd, w=plan.w)
        x = planes(2 * m, BATCHES[-1])[0]
        want = sv.vpu_rfft_pack_batch_minor_reference(x, m, kw["tables"], plan.w)
        bodies = ("pair", "stage") if sv.rfft_pack_geometry(m) else ("stage",)
        for body in bodies:
            k = sv.vpu_rfft_pack_batch_minor(x, m, _body=body, **kw)
            torch.cuda.synchronize()
            err, mx = vs_plain(k, want)
            herr = rel_l2(host_cols(*k), rfft_host(x))
            check(err <= REL_L2_GATE and herr <= REL_L2_GATE,
                  f"B4a {body} body at m={m}: rel-L2 {err:.3e} vs plain, {herr:.3e} "
                  f"vs np.fft")
            worst = [max(worst[0], err), max(worst[1], herr)]
            max_abs_err["B4a"] = max(max_abs_err["B4a"], mx)
            ran.append((m, body))
    check(ran == [(2048, "pair"), (2048, "stage"), (2160, "stage")],
          f"B4a's bodies meet elsewhere: {ran}")
    print(f"B4a bodies at their boundary {ran} (B={BATCHES[-1]}): worst rel-L2 "
          f"{worst[0]:.3e} vs plain, {worst[1]:.3e} vs np.fft (gate {REL_L2_GATE:g})",
          flush=True)
    boundary_checks("B5a", [(n, B_BOUNDARY) for n in B5A_BOUNDARY] + list(B5A_WALK),
                    (1013, 863, 73))
    # B4b and B5b on both bodies where they meet, at the walks, at B = 1 and
    # odd B, and at B a multiple of 8 (B_BOUNDARY, B4A_WALK's 1588 and
    # B5A_WALK's 1592: 16-byte copies and stores).
    boundary_checks("B4b", [(2 * m, B_BOUNDARY) for m in B4B_BOUNDARY] + list(B4A_WALK)
                    + [(4096, b) for b in B45B_BATCHES], (4096, 1024))
    boundary_checks("B5b", [(n, B_BOUNDARY) for n in B5A_BOUNDARY] + list(B5A_WALK)
                    + [(1013, b) for b in B45B_BATCHES], (1013, 863, 73))

    # 3e. B6, B7 and B8 (complex128 in f64) against their plain versions
    # and np.fft in f64, at the listed sizes and batches in every mode, and
    # at every shape phase 4e gives them (gate DD_GATE).
    def planes64(n, b):
        return tuple(t.double() for t in planes(n, b))

    def combine_want(x, n, r, mode, cols):
        """B8 from its definition, in numpy f64, on the first `cols` columns
        of each class of the (m, r*B) input x."""
        m, b = n // r, x.shape[1] // r
        k = np.arange(m)[:, None]
        sign = -1 if mode.is_forward else 1
        out = np.zeros((r, m, cols), np.complex128)
        for j in range(r):
            for t in range(r):
                w = np.exp(sign * 2j * np.pi * t * (j * m + k) / n)
                out[j] += x[:, t * b:t * b + cols] * w
        return out.reshape(n, cols) * (mode.scale(n) or 1.0)

    def dd_case(kernel, n, b):
        """One (n, B) case of B6, B7 or B8 in every mode: worst rel-L2 vs the
        plain version, vs np.fft, and the max abs error vs plain."""
        worst_p = worst_h = mx = 0.0
        if kernel == "B8":
            plan = ftt.create_fft_f64(n)
            r = plan.radix
            re, im = planes64(n // r, r * b)
            host = (re.cpu().numpy() + 1j * im.cpu().numpy())
        else:
            plan = (ftt.VpuDdFftPlan if kernel == "B6" else ftt.VpuDdBluesteinPlan
                    ).create(n, device=dev)
            re, im = planes64(n, b)
            x = host_cols(re, im)
        for mode in Transform:
            fwd, scale = mode.is_forward, mode.scale(n)
            if kernel == "B6":
                k = plan.transform_planar_bm(re, im, mode)
                p = dv.vpu_dd_fft_batch_minor_reference(
                    re, im, n, plan.tables(fwd), fwd, scale)
                want = np_want(x, mode, n)
            elif kernel == "B7":
                st = plan.stages
                k = plan.transform_planar_bm(re, im, mode)
                p = dv.vpu_dd_bluestein_batch_minor_reference(
                    re, im, n, st.size, (st.tables(True), st.tables(False)),
                    plan.chirps(fwd), scale)
                want = np_want(x, mode, n)
            else:
                tables = plan.tw_fwd if fwd else plan.tw_inv
                k = dc.dd_split_combine_batch_minor(re, im, n, r, fwd, scale,
                                                    tables=tables)
                p = dc.dd_split_combine_batch_minor_reference(
                    re, im, n, r, tables, fwd, scale)
                want = combine_want(host, n, r, mode, min(b, HOST_COLUMNS))
            torch.cuda.synchronize()
            err, m_ = vs_plain(k, p)
            herr = rel_l2(host_cols(*k)[:, :want.shape[1]], want)
            check(err <= DD_GATE and herr <= DD_GATE,
                  f"{kernel} n={n} B={b} {mode.name}: rel-L2 {err:.3e} vs plain, "
                  f"{herr:.3e} vs np.fft (gate {DD_GATE:g})")
            worst_p, worst_h, mx = max(worst_p, err), max(worst_h, herr), max(mx, m_)
        return worst_p, worst_h, mx

    dd_routes = _dd_route_cases()
    for kernel, sizes in (("B6", DD_B6_SIZES), ("B7", DD_B7_SIZES),
                          ("B8", DD_B8_SIZES)):
        routes = [(n, b) for k, n, b in dd_routes if k == kernel]
        worst_p = worst_h = mx = 0.0
        for n, b in [(n, b) for n in sizes for b in BATCHES] + routes:
            e_p, e_h, m_ = dd_case(kernel, n, b)
            worst_p, worst_h, mx = max(worst_p, e_p), max(worst_h, e_h), max(mx, m_)
        print(f"{kernel} kernel vs plain (f64): n in {sizes} x B in {BATCHES} and "
              f"the routes' shapes {routes} x 5 modes pass; worst rel-L2 "
              f"{worst_p:.3e} vs plain, {worst_h:.3e} vs np.fft (gate "
              f"{DD_GATE:g}); max abs err {mx:.3e}", flush=True)
        max_abs_err[kernel] = mx
    boundary_checks("B6", [(n, B_BOUNDARY) for n in B6_BOUNDARY] + list(B6_WALK),
                    (2048, 2160, 4096))
    # The split plans whole (B6 sub-plan, B8 combine) against np.fft.
    worst = 0.0
    for n in DD_B8_SIZES:
        plan = ftt.create_fft_f64(n)
        for b in BATCHES:
            re, im = planes64(n, b)
            x = host_cols(re, im)
            for mode in Transform:
                herr = rel_l2(host_cols(*plan.transform_planar_bm(re, im, mode)),
                              np_want(x, mode, n))
                check(herr <= DD_GATE, f"split plan n={n} B={b} {mode.name}: "
                      f"rel-L2 {herr:.3e} vs np.fft")
                worst = max(worst, herr)
    print(f"split plans {DD_B8_SIZES} (B6 + B8) vs np.fft: worst rel-L2 "
          f"{worst:.3e} (gate {DD_GATE:g})", flush=True)

    # 3f. B9a and B9b against their plain versions and np.fft in f64, at the
    # listed sizes and batches and at every shape phases 4f and 5f give them,
    # in every mode, with the caller's TF32 on (no product may take it); odd
    # batches also with the tile cap B9_TB, which must not change a bit.
    def b9_tables(plan, mode):
        """A pallas plan's flat table list for `mode`, the scale folded into
        the last table as the plan folds it."""
        tabs = plan.tables(mode.is_forward)
        scale = mode.scale(plan.size)
        if scale is not None:
            tabs[-1] = (tabs[-1][0] * scale, tabs[-1][1] * scale)
        return [t for pair in tabs for t in pair]

    def b9_fns(plan):
        """(kernel id, wrapper, plain version) of a pallas MxuFftPlan."""
        if plan.single_phase:
            return "B9a", bk.mxu_fft_single, bp.xla_fft_single
        return "B9b", bk.mxu_fft_two_phase, bp.reference_two_phase

    def rows_host(re, im):
        """The first HOST_COLUMNS rows of (B, n) planes, as (n, rows)."""
        return host_cols(re.T, im.T)

    caller_precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    b9_routes = _b9_route_cases()
    for kernel_id, sizes in (("B9a", B9A_SIZES), ("B9b", B9B_SIZES)):
        routes = [(n, b) for k, n, b in b9_routes if k == kernel_id]
        # Both bodies: the tensor cores' (the kernel) and the CUDA cores'
        # (the first design), each with its worst rel-L2.
        bodies = ("mma", "fma")
        worst = {body: [0.0, 0.0] for body in bodies}
        mx = 0.0
        for n, b in [(n, b) for n in sizes for b in BATCHES] + routes:
            plan = ftt.MxuFftPlan.create(n, impl="pallas", device=dev)
            got_id, kernel, plain = b9_fns(plan)
            check(got_id == kernel_id, f"MxuFftPlan({n}, impl='pallas') runs {got_id}")
            re, im = planes(b, n)
            x = rows_host(re, im)
            for mode in Transform:
                tabs = b9_tables(plan, mode)
                p = plain(re, im, *tabs)
                for body in bodies:
                    k = kernel(re, im, *tabs, _body=body)
                    if b % 2 and not (kernel_id == "B9b" and body == "mma"):
                        kt = kernel(re, im, *tabs, tb=B9_TB, _body=body)
                        torch.cuda.synchronize()
                        check(torch.equal(kt[0], k[0]) and torch.equal(kt[1], k[1]),
                              f"{kernel_id} {body} n={n} B={b}: tb={B9_TB} "
                              "changed the result")
                    if kernel_id == "B9b" and b > 1:
                        # Rows 1.. as a batch of their own: every transform
                        # in another block (the tensor-core body takes no
                        # tb, one transform a block at a time).
                        kt = kernel(re[1:], im[1:], *tabs, _body=body)
                        torch.cuda.synchronize()
                        check(torch.equal(kt[0], k[0][1:]) and torch.equal(kt[1], k[1][1:]),
                              f"{kernel_id} {body} n={n} B={b}: rows 1.. changed when "
                              "run without row 0")
                    torch.cuda.synchronize()
                    err, m_ = vs_plain(k, p)
                    herr = rel_l2(rows_host(*k), np_want(x, mode, n))
                    check(err <= REL_L2_GATE and herr <= REL_L2_GATE,
                          f"{kernel_id} {body} n={n} B={b} {mode.name}: rel-L2 "
                          f"{err:.3e} vs plain, {herr:.3e} vs np.fft (gate "
                          f"{REL_L2_GATE:g})")
                    worst[body] = [max(worst[body][0], err), max(worst[body][1], herr)]
                    if body == "mma":  # the kernel's own body
                        mx = max(mx, m_)
            del re, im, k, p
        check(torch.backends.cuda.matmul.allow_tf32,
              "a plain version did not restore the caller's TF32 setting")
        print(f"{kernel_id} kernel vs plain: n in {sizes} x B in {BATCHES} and the "
              f"routes' shapes {routes} x 5 modes pass with the caller's TF32 on (odd "
              f"B also at tb={B9_TB}"
              + (", but the tensor-core body, which takes no tb; rows 1.. also as a "
                 "batch of their own" if kernel_id == "B9b" else "")
              + "; bitwise equal); worst rel-L2 "
              + "; ".join(f"{B9_BODY_NAMES[body]} {w[0]:.3e} vs plain, "
                          f"{w[1]:.3e} vs np.fft" for body, w in worst.items())
              + f" (gate {REL_L2_GATE:g}); max abs err {mx:.3e}", flush=True)
        max_abs_err[kernel_id] = mx
    # B9a and B9b keep a NaN and an infinity in their rows at sizes whose
    # buffers are zero-padded: the padding must stay zero for the later
    # tiles or transforms of a block (three a block at least, whatever the
    # grid: at most 2048 threads an SM).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kernel_id, sizes in (("B9a", B9A_POISON), ("B9b", B9B_POISON)):
        for n in sizes:
            plan = ftt.MxuFftPlan.create(n, impl="pallas", device=dev)
            _, kernel, plain = b9_fns(plan)
            rows_ = bk.single_mma_geometry(n).valid if kernel_id == "B9a" else 1
            b = 3 * rows_ * 2048 // (32 * bk.MMA_WARPS) * sms
            re, im = planes(b, n)
            poisoned = (5, b // 2)
            re[poisoned[0], n // 2], im[poisoned[1], 0] = float("nan"), float("inf")
            tabs = b9_tables(plan, Transform.FFT)
            rest = torch.ones(b, dtype=torch.bool, device=dev)
            rest[list(poisoned)] = False
            p = tuple(t[rest] for t in plain(re, im, *tabs))
            for body in ("mma", "fma"):
                k = kernel(re, im, *tabs, _body=body)
                err, _ = vs_plain(tuple(t[rest] for t in k), p)
                finite = [bool(torch.isfinite(k[0][r]).all()
                               and torch.isfinite(k[1][r]).all()) for r in poisoned]
                check(err <= REL_L2_GATE and not any(finite),
                      f"{kernel_id} {body} n={n} B={b}, a NaN in row {poisoned[0]} and "
                      f"an infinity in row {poisoned[1]}: the other rows rel-L2 "
                      f"{err:.3e} vs plain, the poisoned rows finite {finite}")
            del re, im, k, p
        print(f"{kernel_id} with a NaN row and an infinite row (n in {sizes}, three "
              "tiles or transforms a block): both bodies keep them in their rows, the "
              "others pass", flush=True)
    torch.set_float32_matmul_precision(caller_precision)

    # Phases 4-4d note every (n, B) they give B1, B2, B4b, B5a and B5b (n the
    # real length for the last three), phase 4e every one it gives B6 (the
    # plans reach B1, B2 and B6 through their class's `run`, B4b, B5a and B5b
    # through rfft.py's reference to its module, here a namespace with their
    # wrappers recorded); phases 4g and 4h check each shape on both bodies.
    route_shapes = {"B1": set(), "B2": set(), "B4b": set(), "B5a": set(), "B5b": set(),
                    "B6": set()}

    def recording(kernel, fn, shape=lambda x_t, *args: tuple(x_t.shape)):
        def call(*args, **kwargs):
            route_shapes[kernel].add(shape(*args))
            return fn(*args, **kwargs)
        return call

    ftt.VpuFftPlan.run = staticmethod(recording("B1", sv.vpu_fft_batch_minor))
    ftt.VpuBluesteinPlan.run = staticmethod(recording("B2", sv.vpu_bluestein_batch_minor))
    rfft_module = sys.modules["fourier_tpu_torch.rfft"]
    rfft_module.stockham_vpu = types.SimpleNamespace(**{
        **vars(sv),
        "vpu_rfft_odd_pack_batch_minor": recording(
            "B5a", sv.vpu_rfft_odd_pack_batch_minor),
        "vpu_irfft_unpack_batch_minor": recording(
            "B4b", sv.vpu_irfft_unpack_batch_minor,
            lambda re_t, im_t, m, *a: (2 * m, re_t.shape[1])),
        "vpu_irfft_odd_unpack_batch_minor": recording(
            "B5b", sv.vpu_irfft_odd_unpack_batch_minor,
            lambda re_t, im_t, n, *a: (n, re_t.shape[1]))})

    # 4. Main path through the entry points, with the launch count.
    zero_counts()
    plan = ftt.create_fft_f32(MAIN_N, device="cuda")
    check(isinstance(plan, ftt.VpuFftPlan), f"create_fft_f32 gave {plan!r}")
    seen = 0

    def rose(what):
        nonlocal seen
        now = sv.vpu_fft_batch_minor.launches
        check(now > seen, f"{what} did not launch B1")
        seen = now

    re, im = planes(MAIN_N, MAIN_B)
    bre, bim = plan.transform_planar_bm(re, im)
    rose("transform_planar_bm")
    mre, mim = plan.transform_planar(re.T.contiguous(), im.T.contiguous())
    rose("transform_planar")
    check(tuple(mre.shape) == (MAIN_B, MAIN_N), f"batch-major shape {tuple(mre.shape)}")
    check(torch.equal(mre.T, bre) and torch.equal(mim.T, bim),
          "batch-major and batch-minor results differ")
    xc = torch.complex(re.T.contiguous(), im.T.contiguous())
    y = plan.fft(xc)
    rose("fft")
    back = plan.ifft(y)
    rose("ifft")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(torch.view_as_real(y)).all()), "fft output not finite")
    check(y.dtype == torch.complex64 and tuple(y.shape) == (MAIN_B, MAIN_N),
          f"fft output {y.dtype} {tuple(y.shape)}")
    rt = (torch.linalg.norm(back - xc) / torch.linalg.norm(xc)).item()
    check(rt <= REL_L2_GATE, f"ifft(fft(x)) rel-L2 {rt:.3e}")
    host = xc[:HOST_COLUMNS].cpu().numpy().astype(np.complex128)
    fe = rel_l2(y[:HOST_COLUMNS].cpu().numpy(), np.fft.fft(host, axis=-1))
    check(fe <= REL_L2_GATE, f"fft vs np.fft rel-L2 {fe:.3e}")
    prime = ftt.create_fft_f32(PRIME, device="cuda")
    check(isinstance(prime, ftt.BluesteinPlan)
          and isinstance(prime.inner, ftt.VpuFftPlan)
          and prime.inner.size == 16384, f"n={PRIME} planned as {prime!r}")
    xp = torch.complex(*planes(64, PRIME))
    yp = prime.fft(xp)
    rose(f"Bluestein n={PRIME}")
    pe = rel_l2(yp.cpu().numpy(),
                np.fft.fft(xp.cpu().numpy().astype(np.complex128), axis=-1))
    check(pe <= REL_L2_GATE, f"n={PRIME} vs np.fft rel-L2 {pe:.3e}")
    launches = sv.vpu_fft_batch_minor.launches
    check(launches > 0, "the main path launched B1 no time")
    path_launches = counts()
    print(f"main path: {plan!r}; bm, batch-major, fft, ifft and Bluestein "
          f"n={PRIME} each launched B1 ({launches} launches); roundtrip rel-L2 "
          f"{rt:.3e}, fft vs np.fft {fe:.3e}, n={PRIME} vs np.fft {pe:.3e}",
          flush=True)

    # 4b. The routes of the other sizes: plan trees, then each run through
    # the entry points with the counts of the kernels its plan holds rising.
    for n, want in ROUTE_TREES.items():
        got = plan_tree(ftt.create_fft_f32(n, device="cuda"))
        check(got == want, f"n={n} planned {got}, the JAX package plans {want}")
    print(f"route: the plan trees of {len(ROUTE_TREES)} sizes equal the JAX "
          f"package's vpu route", flush=True)
    caller_precision = torch.get_float32_matmul_precision()
    zero_counts()

    def route_run(n, b):
        """Drive the plan of size n at batch b through every entry point."""
        plan = ftt.create_fft_f32(n, device="cuda")
        held_bm = _kernels_of(plan_tree(plan), batch_minor=True)
        held = _kernels_of(plan_tree(plan), batch_minor=False)
        tf32 = n in MXU_TF32
        if tf32:
            torch.backends.cuda.matmul.allow_tf32 = True
        seen = counts()

        def ran(what, want):
            nonlocal seen
            now = counts()
            for k in counters:
                rose = now[k] > seen[k]
                check(rose == (k in want),
                      f"n={n} {what}: {k} {'rose' if rose else 'did not rise'}; "
                      f"the plan runs {sorted(want)} there")
            seen = now

        re, im = planes(n, b)
        bre, bim = plan.transform_planar_bm(re, im)
        ran("transform_planar_bm", held_bm)
        mre, mim = plan.transform_planar(re.T.contiguous(), im.T.contiguous())
        ran("transform_planar", held)
        xc = torch.complex(re.T.contiguous(), im.T.contiguous())
        y = plan.fft(xc)
        ran("fft", held)
        back = plan.ifft(y)
        ran("ifft", held)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(torch.view_as_real(y)).all()), f"n={n}: not finite")
        check(y.dtype == torch.complex64 and tuple(y.shape) == (b, n),
              f"n={n}: fft output {y.dtype} {tuple(y.shape)}")
        want = np_want(host_cols(re, im), Transform.FFT, n)
        errs = (rel_l2(host_cols(bre, bim), want), rel_l2(host_cols(mre.T, mim.T), want),
                rel_l2(y[:HOST_COLUMNS].cpu().numpy().T, want),
                (torch.linalg.norm(back - xc) / torch.linalg.norm(xc)).item())
        check(max(errs) <= REL_L2_GATE,
              f"n={n} B={b}: rel-L2 bm/batch-major/fft vs np.fft and roundtrip {errs}")
        if tf32:
            check(torch.backends.cuda.matmul.allow_tf32,
                  "the plan did not restore the caller's TF32 setting")
            torch.set_float32_matmul_precision(caller_precision)
        print(f"route: n={n} B={b} {plan_tree(plan)} launched "
              f"{sorted(held_bm) or 'no kernel'} batch-minor, "
              f"{sorted(held) or 'no kernel'} batch-major"
              f"{' (caller TF32 on)' if tf32 else ''}; worst rel-L2 "
              f"{max(errs):.3e}", flush=True)

    for n, b in ROUTE_RUNS:
        route_run(n, b)
    for k, v in counts().items():
        path_launches[k] += v
    for k in ("B2", "B3"):
        check(path_launches[k] > 0, f"the routes launched {k} no time")

    # 4c. The real transforms: the plan trees of RfftPlan(n, device="cuda"),
    # then every route through the entry points, with the counts of the
    # kernels its plan holds rising and no other.
    for n, want in RFFT_TREES.items():
        got = plan_tree(ftt.RfftPlan(n, device="cuda"))
        check(got == ("RfftPlan", n, want),
              f"RfftPlan({n}) planned {got}, the JAX package plans {want}")
    print(f"rfft route: the plan trees of {len(RFFT_TREES)} sizes equal the JAX "
          f"package's RfftPlan(backend='vpu')", flush=True)
    zero_counts()

    def rfft_route(n, b):
        """Drive RfftPlan(n) and the module functions at batch b."""
        plan = ftt.RfftPlan(n, device="cuda")
        inner = plan_tree(plan)[2]
        seen = counts()

        def ran(what, call):
            nonlocal seen
            want = _rfft_kernels(n, inner, call)
            now = counts()
            for k in counters:
                rose = now[k] > seen[k]
                check(rose == (k in want),
                      f"rfft n={n} {what}: {k} {'rose' if rose else 'did not rise'}; "
                      f"the plan runs {sorted(want)} there")
            seen = now

        x = planes(n, b)[0]
        xm = x.T.contiguous()
        re_t, im_t = plan.rfft_planar_bm(x)
        ran("rfft_planar_bm", "rfft_bm")
        back_bm = plan.irfft_planar_bm(re_t, im_t)
        ran("irfft_planar_bm", "irfft_bm")
        mre, mim = plan.rfft_planar(xm)
        ran("rfft_planar", "major")
        back = plan.irfft_planar(mre, mim)
        ran("irfft_planar", "major")
        spec = ftt.rfft(xm)
        ran("rfft", "major")
        sig = ftt.irfft(spec, n=n)
        ran("irfft", "major")
        hf = ftt.hfft(spec, n=n)
        ran("hfft", "major")
        ih = ftt.ihfft(xm)
        ran("ihfft", "major")
        torch.cuda.synchronize()
        L = n // 2 + 1
        for what, t, shape in (("rfft", spec, (b, L)), ("ihfft", ih, (b, L)),
                               ("irfft", sig, (b, n)), ("hfft", hf, (b, n))):
            check(tuple(t.shape) == shape and t.device == dev, f"rfft n={n} {what}: "
                  f"{tuple(t.shape)} on {t.device}")
            check(bool(torch.isfinite(torch.view_as_real(t) if t.is_complex() else t)
                       .all()), f"rfft n={n} {what}: not finite")
        check(spec.dtype == torch.complex64 and sig.dtype == torch.float32,
              f"rfft n={n}: dtypes {spec.dtype} {sig.dtype}")
        want = rfft_host(x)
        host_rows = lambda t: t[:HOST_COLUMNS].cpu().numpy().astype(np.complex128)
        sh = host_rows(spec)
        errs = (rel_l2(host_cols(re_t, im_t), want),
                rel_l2(host_cols(mre.T, mim.T), want), rel_l2(sh.T, want), rel_l2(host_rows(ih).T, np.conj(want) / n),
                rel_l2(host_rows(hf), np.fft.hfft(sh, n)),
                *((torch.linalg.norm(a - x) / torch.linalg.norm(x)).item()
                  for a in (back_bm, back.T, sig.T)))
        check(max(errs) <= REL_L2_GATE,
              f"rfft n={n} B={b}: rel-L2 bm/batch-major/rfft/ihfft/hfft vs np.fft "
              f"and round trips {errs}")
        kinds = {c: sorted(_rfft_kernels(n, inner, c)) or "no kernel"
                 for c in ("rfft_bm", "irfft_bm", "major")}
        print(f"rfft route: n={n} B={b} {plan_tree(plan)} launched {kinds['rfft_bm']} "
              f"/ {kinds['irfft_bm']} batch-minor, {kinds['major']} batch-major; "
              f"worst rel-L2 {max(errs):.3e}", flush=True)

    for n in RFFT_TREES:
        rfft_route(n, _rf_route_b(n))
    for k, v in counts().items():
        path_launches[k] += v
    for k in ("B4a", "B4b", "B5a", "B5b"):
        check(path_launches[k] > 0, f"the rfft routes launched {k} no time")

    # 4d. Gradients through the fused batch-minor path (the linear VJP: each
    # kernel's gradient is the other kernel) against the same plan's unfused
    # branch (plain autograd through the inner plan).
    worst_grad = 0.0
    for n in GRAD_SIZES:
        rplan = ftt.RfftPlan(n, device="cuda")
        check(rplan.fused, f"RfftPlan({n}) is not fused")
        b, L = 64, n // 2 + 1
        x, gt = planes(n, b)
        ctr, cti = planes(L, b)

        def grads(fwd, inv):
            xt = x.clone().requires_grad_(True)
            sr, si = fwd(xt)
            (sr * ctr + si * cti).sum().backward()
            re = ctr.clone().requires_grad_(True)
            im = cti.clone().requires_grad_(True)
            (inv(re, im) * gt).sum().backward()
            return xt.grad, re.grad, im.grad

        before = counts()
        got = grads(rplan.rfft_planar_bm, rplan.irfft_planar_bm)
        after = counts()
        fam = "B4" if rplan.even else "B5"
        for k in (f"{fam}a", f"{fam}b"):
            check(after[k] - before[k] == 2, f"grad n={n}: {k} launched "
                  f"{after[k] - before[k]} times, want 2 (forward and backward)")
        want = grads(rplan._rfft_bm_unfused, rplan._irfft_bm_unfused)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            excess = ((g - w).abs() - GRAD_TOL * (1.0 + w.abs())).max().item()
            check(excess <= 0.0, f"grad n={n}: off the unfused branch by more "
                  f"than atol=rtol={GRAD_TOL:g}")
            worst_grad = max(worst_grad, ((g - w).abs().max() / w.abs().max()).item())
    print(f"rfft grad: rfft_planar_bm and irfft_planar_bm through B4 "
          f"(n={GRAD_SIZES[0]}) and B5 (n={GRAD_SIZES[1]}) match the unfused branch within "
          f"atol=rtol={GRAD_TOL:g}; worst max|diff|/max|grad| {worst_grad:.3e}",
          flush=True)

    # 4g. B1, B2, B4b, B5a and B5b at every (n, B) that phases 4-4d gave
    # them, in every mode, on both bodies where a clustered one exists.
    ftt.VpuFftPlan.run = staticmethod(sv.vpu_fft_batch_minor)
    ftt.VpuBluesteinPlan.run = staticmethod(sv.vpu_bluestein_batch_minor)
    rfft_module.stockham_vpu = sv

    def route_checks(kernel, phases):
        worst_p = worst_h = 0.0
        ran = []
        for n, b in sorted(route_shapes[kernel]):
            bodies, e_p, e_h, mx = bodies_case(kernel, n, b)
            worst_p, worst_h = max(worst_p, e_p), max(worst_h, e_h)
            max_abs_err[kernel] = max(max_abs_err[kernel], mx)
            ran.append((n, b, "+".join(bodies)))
        check(ran, f"phases {phases} gave {kernel} no call")
        print(f"{kernel} at the routes' shapes {ran} x "
              f"{'1 mode' if kernel in ONE_MODE else '5 modes'} pass; worst rel-L2 "
              f"{worst_p:.3e} vs plain, {worst_h:.3e} vs np.fft (gate "
              f"{DD_GATE if kernel == 'B6' else REL_L2_GATE:g})", flush=True)

    for kernel in ("B1", "B2", "B4b", "B5a", "B5b"):
        route_checks(kernel, "4-4d")

    # 4e. The complex128 route: the plan trees of create_fft_f64(n) with no
    # device argument (the card by default), then every route through the
    # entry points with the counts of the kernels its tree holds rising and
    # no other; then the c128 RfftPlans.
    for n, want in DD_TREES.items():
        got = plan_tree(ftt.create_fft_f64(n))
        check(got == want, f"c128 n={n} planned {got}, the JAX package plans {want}")
    for n, want in DD_RFFT_TREES.items():
        got = plan_tree(ftt.RfftPlan(n, torch.complex128))
        check(got == ("RfftPlan", n, want),
              f"c128 RfftPlan({n}) planned {got}, the JAX package plans {want}")
    print(f"c128 route: the plan trees of {len(DD_TREES)} sizes and "
          f"{len(DD_RFFT_TREES)} rfft sizes equal the JAX package's dd route "
          f"on a TPU", flush=True)
    ftt.VpuDdFftPlan.run = staticmethod(recording("B6", dv.vpu_dd_fft_batch_minor))
    zero_counts()

    def only_ran(what, held, seen):
        """Check that the counts of the kernels in `held`, and no other,
        rose since `seen`; return the counts now."""
        now = counts()
        for k in counters:
            rose = now[k] > seen[k]
            check(rose == (k in held), f"{what}: {k} "
                  f"{'rose' if rose else 'did not rise'}; the plan runs "
                  f"{sorted(held)} there")
        return now

    def dd_route(n, b):
        """Drive create_fft_f64(n) at batch b through every entry point."""
        plan = ftt.create_fft_f64(n)
        check(plan.device == dev, f"c128 n={n} planned on {plan.device}")
        held = {k for k, _, _ in _dd_cases(plan_tree(plan), b)}
        seen = counts()
        re, im = planes64(n, b)
        bre, bim = plan.transform_planar_bm(re, im)
        seen = only_ran(f"c128 n={n} transform_planar_bm", held, seen)
        mre, mim = plan.transform_planar(re.T.contiguous(), im.T.contiguous())
        seen = only_ran(f"c128 n={n} transform_planar", held, seen)
        xc = torch.complex(re.T.contiguous(), im.T.contiguous())
        y = plan.fft(xc)
        seen = only_ran(f"c128 n={n} fft", held, seen)
        back = plan.ifft(y)
        only_ran(f"c128 n={n} ifft", held, seen)
        torch.cuda.synchronize()
        check(y.dtype == torch.complex128 and tuple(y.shape) == (b, n)
              and bool(torch.isfinite(torch.view_as_real(y)).all()),
              f"c128 n={n}: fft output {y.dtype} {tuple(y.shape)}")
        want = np_want(host_cols(re, im), Transform.FFT, n)
        errs = (rel_l2(host_cols(bre, bim), want),
                rel_l2(host_cols(mre.T, mim.T), want),
                rel_l2(y[:HOST_COLUMNS].cpu().numpy().T, want),
                (torch.linalg.norm(back - xc) / torch.linalg.norm(xc)).item())
        # A composed Bluestein (no kernel of its own) carries the reference's
        # chirp error: exp(-i*pi*j^2/n) at angles up to pi*n, each rounded
        # to ~1e-16 relative, so the JAX package's own plan is off np.fft by
        # ~1.6e-16*n (3.3e-12 at n=20000).
        gate = (max(DD_GATE, 2.5e-16 * n) if plan_tree(plan)[0] == "BluesteinPlan"
                else DD_GATE)
        check(max(errs) <= gate, f"c128 n={n} B={b}: rel-L2 bm/batch-major/fft "
              f"vs np.fft and round trip {errs} (gate {gate:g})")
        print(f"c128 route: n={n} B={b} {plan_tree(plan)} launched "
              f"{sorted(held) or 'no kernel'} on each call; worst rel-L2 "
              f"{max(errs):.3e} (gate {gate:g})", flush=True)

    def dd_rfft_route(n, b):
        """Drive the c128 RfftPlan(n) and the module functions at batch b."""
        plan = ftt.RfftPlan(n, torch.complex128)
        inner = plan_tree(plan)[2]
        eff = (b,) if n % 2 == 0 else (b // 2, 1)  # odd: pairs, then the rest
        held = {k for e in eff for k, _, _ in _dd_cases(inner, e)}
        seen = counts()
        x = planes64(n, b)[0]
        re_t, im_t = plan.rfft_planar_bm(x)
        seen = only_ran(f"c128 rfft n={n} rfft_planar_bm", held, seen)
        back_bm = plan.irfft_planar_bm(re_t, im_t)
        seen = only_ran(f"c128 rfft n={n} irfft_planar_bm", held, seen)
        spec = ftt.rfft(x.T.contiguous())
        seen = only_ran(f"c128 rfft n={n} rfft", held, seen)
        sig = ftt.irfft(spec, n=n)
        only_ran(f"c128 rfft n={n} irfft", held, seen)
        torch.cuda.synchronize()
        check(spec.dtype == torch.complex128 and sig.dtype == torch.float64,
              f"c128 rfft n={n}: dtypes {spec.dtype} {sig.dtype}")
        want = rfft_host(x)
        errs = (rel_l2(host_cols(re_t, im_t), want),
                rel_l2(spec[:HOST_COLUMNS].cpu().numpy().T, want),
                *((torch.linalg.norm(a - x) / torch.linalg.norm(x)).item()
                  for a in (back_bm, sig.T)))
        check(max(errs) <= DD_GATE, f"c128 rfft n={n} B={b}: rel-L2 bm/rfft vs "
              f"np.fft and round trips {errs}")
        print(f"c128 rfft route: n={n} B={b} {plan_tree(plan)} launched "
              f"{sorted(held)}; worst rel-L2 {max(errs):.3e}", flush=True)

    for n in DD_TREES:
        dd_route(n, DD_ROUTE_B)
    for n in DD_RFFT_TREES:
        dd_rfft_route(n, DD_RFFT_B)
    for k, v in counts().items():
        path_launches[k] += v
    for k in ("B6", "B7", "B8"):
        check(path_launches[k] > 0, f"the c128 routes launched {k} no time")

    # 4h. B6 at every (n, B) that phase 4e gave it, in every mode, on both
    # bodies where a clustered one exists.
    ftt.VpuDdFftPlan.run = staticmethod(dv.vpu_dd_fft_batch_minor)
    route_checks("B6", "4e")

    # 4f. The user-built paths of B9a and B9b: MxuFftPlan(impl="pallas") and
    # (impl="xla_packed") at n <= 128, pallas two-phase plans alone, as the
    # inner of a BluesteinPlan and as the legs of a FourStepLocalPlan, each
    # through every entry point with the B9 counts rising and no other; then
    # gradients through a pallas plan against the impl="xla" plan.
    zero_counts()

    def pallas(m, dt, device):
        return ftt.MxuFftPlan.create(m, dt, device, impl="pallas")

    b9_paths = (
        ("MxuFftPlan(100, impl='pallas')", lambda: ftt.MxuFftPlan.create(
            100, impl="pallas", device="cuda"), {"B9a"}),
        ("MxuFftPlan(128, impl='xla_packed')", lambda: ftt.MxuFftPlan.create(
            128, impl="xla_packed"), {"B9a"}),
        ("MxuFftPlan(1000, impl='pallas')", lambda: ftt.MxuFftPlan.create(
            1000, impl="pallas", device="cuda"), {"B9b"}),
        ("BluesteinPlan(1013) over pallas MxuFftPlan(2048)", lambda: ftt.BluesteinPlan.create(
            1013, inner_factory=pallas, device="cuda"), {"B9b"}),
        ("FourStepLocalPlan(65536) over pallas MxuFftPlan(256)",
         lambda: ftt.FourStepLocalPlan.create(65536, torch.complex64, 256, 256, pallas,
                                              device="cuda"), {"B9b"}),
    )
    def b9_path_runs():
        """Phase 4f's runs, in a scope of their own: phase 5 reads the main
        path's plan and planes."""
        for what, make, held in b9_paths:
            bplan = make()
            check(bplan.device == dev, f"{what} planned on {bplan.device}")
            n = bplan.size
            b = B9_ROUTE_B if n < 65536 else B9_ROUTE_B_LARGE
            seen = counts()
            re, im = planes(b, n)
            mre, mim = bplan.transform_planar(re, im)
            seen = only_ran(f"{what} transform_planar", held, seen)
            bre, bim = bplan.transform_planar_bm(re.T.contiguous(), im.T.contiguous())
            seen = only_ran(f"{what} transform_planar_bm", held, seen)
            xc = torch.complex(re, im)
            y = bplan.transform(xc, Transform.FFT)
            seen = only_ran(f"{what} transform", held, seen)
            y2 = bplan.fft(xc)
            seen = only_ran(f"{what} fft", held, seen)
            back = bplan.ifft(y2)
            only_ran(f"{what} ifft", held, seen)
            torch.cuda.synchronize()
            check(y.dtype == torch.complex64 and tuple(y.shape) == (b, n)
                  and bool(torch.isfinite(torch.view_as_real(y)).all()),
                  f"{what}: fft output {y.dtype} {tuple(y.shape)}")
            want = np_want(rows_host(re, im), Transform.FFT, n)
            errs = (rel_l2(rows_host(mre, mim), want), rel_l2(host_cols(bre, bim), want),
                    rel_l2(rows_host(y.real, y.imag), want),
                    rel_l2(rows_host(y2.real, y2.imag), want),
                    (torch.linalg.norm(back - xc) / torch.linalg.norm(xc)).item())
            check(max(errs) <= REL_L2_GATE, f"{what} B={b}: rel-L2 batch-major/bm/"
                  f"transform/fft vs np.fft and round trip {errs}")
            print(f"B9 path: {what} B={b} launched {sorted(held)} on each call; worst "
                  f"rel-L2 {max(errs):.3e}\n" + ftt.describe(bplan), flush=True)
        for k, v in counts().items():
            path_launches[k] += v
        for k in ("B9a", "B9b"):
            check(path_launches[k] > 0, f"the B9 paths launched {k} no time")

        n, b = B9_GRAD
        x, gt = planes(b, n), planes(b, n)

        def b9_grads(plan):
            re, im = (t.clone().requires_grad_(True) for t in x)
            yr, yi = plan.transform_planar(re, im, Transform.SQRT_SCALED_FFT)
            (yr * gt[0] + yi * gt[1]).sum().backward()
            return re.grad, im.grad

        before = counts()["B9b"]
        got = b9_grads(ftt.MxuFftPlan.create(n, impl="pallas", device="cuda"))
        check(counts()["B9b"] - before == 2, "the pallas gradient did not launch B9b "
              "twice (forward and backward)")
        want = b9_grads(ftt.MxuFftPlan.create(n, impl="xla", device="cuda"))
        gerr = max(rel_l2(g.cpu().numpy(), w.cpu().numpy()) for g, w in zip(got, want))
        check(gerr <= REL_L2_GATE, f"pallas gradient vs xla: rel-L2 {gerr:.3e}")
        print(f"B9 grad: d/dx through MxuFftPlan({n}, impl='pallas') (B9b forward and "
              f"backward) vs impl='xla': rel-L2 {gerr:.3e} (gate {REL_L2_GATE:g})",
              flush=True)

    # The plans reach the wrappers through plan/mxu.py's module reference;
    # for these runs it notes each call's (kernel, n, B) and passes it on.
    b9_calls = set()
    # B9b's calls at splits where the wrapper runs the tensor-core body.
    b9b_mma_calls = [0]

    def recorded(kernel_id, fn):
        def call(re, im, *tables, **kwargs):
            b9_calls.add((kernel_id, re.shape[1], re.shape[0]))
            if kernel_id == "B9b" and bk.two_phase_body(*tables[2].shape[::-1]) == "mma":
                b9b_mma_calls[0] += 1
            return fn(re, im, *tables, **kwargs)
        return call

    mxu_plan.bailey_kernels = types.SimpleNamespace(
        mxu_fft_single=recorded("B9a", bk.mxu_fft_single),
        mxu_fft_two_phase=recorded("B9b", bk.mxu_fft_two_phase))
    mma_before = bk.mxu_fft_two_phase.mma_launches
    try:
        b9_path_runs()
    finally:
        mxu_plan.bailey_kernels = bk
    mma_ran = bk.mxu_fft_two_phase.mma_launches - mma_before
    check(mma_ran == b9b_mma_calls[0] > 0, f"phase 4f launched B9b's tensor-core body "
          f"{mma_ran} times in {b9b_mma_calls[0]} calls at splits where "
          f"two_phase_body picks it (n * (n1 + n2) >= {bk.B9B_FMA_WORK})")
    print(f"B9 paths: B9b's tensor-core body took all {mma_ran} of their calls at "
          f"splits where two_phase_body picks it, the gradient's included", flush=True)
    unchecked = b9_calls - set(b9_routes)
    check(not unchecked, f"phase 4f gave B9 shapes that phase 3f did not check: "
          f"{sorted(unchecked)}")
    print(f"B9 paths: every (kernel, n, B) they gave a wrapper, {sorted(b9_calls)}, "
          "was checked against the plain version in phase 3f", flush=True)

    # 4i. The numpy-compatible surface at full width: every entry point on
    # device="cuda" (tensors already on the card, and a numpy input once),
    # with the counts of the kernels its per-axis plan trees hold rising and
    # no other; each result against np.fft / scipy.fft in f64 on the whole
    # array (rel-L2 gate REL_L2_GATE * sqrt(k) for complex64, DD_GATE *
    # sqrt(k) for complex128, k the transformed axes); then the kernels at
    # every (n, B) the surface gave them against their plain versions (B1,
    # B4b, B5a, B5b, B6 on both bodies in every mode as phase 4g; B4a and
    # B5a with their inverses through rfft_case, as phase 3d).
    def surface_runs():
        """Phase 4i's runs, in a scope of their own (phase 5 reads the main
        path's plan and planes); returns the inputs phase 5h times."""
        import scipy.fft as sfft

        ndim_module = sys.modules["fourier_tpu_torch.ndim"]
        dctdst_module = sys.modules["fourier_tpu_torch.dctdst"]
        for shapes in route_shapes.values():
            shapes.clear()
        route_shapes["B4a"] = set()
        ftt.VpuFftPlan.run = staticmethod(recording("B1", sv.vpu_fft_batch_minor))
        ftt.VpuBluesteinPlan.run = staticmethod(recording("B2", sv.vpu_bluestein_batch_minor))
        ftt.VpuDdFftPlan.run = staticmethod(recording("B6", dv.vpu_dd_fft_batch_minor))
        rfft_module.stockham_vpu = types.SimpleNamespace(**{
            **vars(sv),
            "vpu_rfft_pack_batch_minor": recording(
                "B4a", sv.vpu_rfft_pack_batch_minor,
                lambda x_t, m, *a: (2 * m, x_t.shape[1])),
            "vpu_rfft_odd_pack_batch_minor": recording(
                "B5a", sv.vpu_rfft_odd_pack_batch_minor),
            "vpu_irfft_unpack_batch_minor": recording(
                "B4b", sv.vpu_irfft_unpack_batch_minor,
                lambda re_t, im_t, m, *a: (2 * m, re_t.shape[1])),
            "vpu_irfft_odd_unpack_batch_minor": recording(
                "B5b", sv.vpu_irfft_odd_unpack_batch_minor,
                lambda re_t, im_t, n, *a: (n, re_t.shape[1]))})
        c64, c128 = torch.complex64, torch.complex128

        def c2c(shape, dt):
            """The kernels of the cached axis plans' trees."""
            return set().union(*(_c2c_kernels(plan_tree(p)) for p in
                                 ndim_module._axis_plans(shape, dt, dev)))

        def real(n, dt, call):
            return _real_kernels(n, plan_tree(rfft_module._rfft_plan(n, dt, dev))[2], call)

        def dct_kernels(kind, type_, n, dt=c64):
            """The kernels of the plan that dctdst.py reduces the type to."""
            plan = dctdst_module.reduction_plan(kind, type_, n, dt, dev)
            if isinstance(plan, ftt.RfftPlan):
                return _real_kernels(plan.n, plan_tree(plan)[2], "rfft_bm")
            return _c2c_kernels(plan_tree(plan))

        def host(t):
            a = t.detach().cpu().numpy()
            return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)

        seen = counts()
        worst = {}

        def ran(what, out, held, want, k, double=False):
            """`out` of entry `what` on the card: the counts of `held` and
            no other rose; rel-L2 against the f64 host `want` in the gate."""
            nonlocal seen
            torch.cuda.synchronize()
            seen = only_ran(f"surface {what}", held, seen)
            check(out.device == dev, f"surface {what}: output on {out.device}")
            err = rel_l2(host(out), want)
            gate = (DD_GATE if double else REL_L2_GATE) * math.sqrt(k)
            check(err <= gate, f"surface {what}: rel-L2 {err:.3e} vs np.fft/scipy.fft "
                  f"(gate {gate:.3g})")
            worst[what] = (err, gate, sorted(held))
            return out

        zero_counts()
        seen = counts()
        x2 = torch.complex(*planes(*SURF_2D))
        h2 = host(x2)
        ran(f"fft2 {SURF_2D} c64", ftt.fft2(x2), c2c(SURF_2D, c64), np.fft.fft2(h2), 2)
        ran(f"ifft2 {SURF_2D} c64", ftt.ifft2(x2), c2c(SURF_2D, c64), np.fft.ifft2(h2), 2)
        x3 = torch.complex(*planes(SURF_3D[0], SURF_3D[1] * SURF_3D[2])).reshape(SURF_3D)
        h3 = host(x3)
        ran(f"fftn {SURF_3D} c64", ftt.fftn(x3), c2c(SURF_3D, c64), np.fft.fftn(h3), 3)
        ran(f"ifftn {SURF_3D} c64", ftt.ifftn(x3), c2c(SURF_3D, c64), np.fft.ifftn(h3), 3)
        x3d = x3.to(c128)
        ran(f"fftn {SURF_3D} c128", ftt.fftn(x3d), c2c(SURF_3D, c128), np.fft.fftn(h3), 3,
            double=True)
        del h3
        n0, n1 = SURF_2D
        xr = planes(*SURF_2D)[0]
        hr = host(xr)
        fwd2 = real(n1, c64, "rfft_bm") | c2c((n0,), c64)
        inv2 = real(n1, c64, "irfft_bm") | c2c((n0,), c64)
        spec = ran(f"rfft2 {SURF_2D} f32", ftt.rfft2(xr), fwd2, np.fft.rfft2(hr), 2)
        hs = host(spec)
        ran(f"irfft2 {SURF_2D} c64", ftt.irfft2(spec, shape=SURF_2D), inv2,
            np.fft.irfft2(hs, s=SURF_2D), 2)
        ran(f"hfft2 {SURF_2D} c64", ftt.hfft2(spec, shape=SURF_2D), inv2,
            sfft.hfft2(hs, s=SURF_2D), 2)
        ran(f"ihfft2 {SURF_2D} f32", ftt.ihfft2(xr), fwd2, sfft.ihfft2(hr), 2)
        del hr, hs
        xo = planes(*SURF_ODD)[0]
        ho = host(xo)
        m0, m1 = SURF_ODD
        spec_o = ran(f"rfftn {SURF_ODD} f32", ftt.rfftn(xo),
                     real(m1, c64, "rfft_bm") | c2c((m0,), c64), np.fft.rfftn(ho), 2)
        ran(f"irfftn {SURF_ODD} c64", ftt.irfftn(spec_o, shape=SURF_ODD),
            real(m1, c64, "irfft_bm") | c2c((m0,), c64),
            np.fft.irfftn(host(spec_o), s=SURF_ODD), 2)
        xd = planes(*SURF_DCTN)[0]
        hd = host(xd)
        for name, kind, inverse in (("dctn", "dct", False), ("idctn", "dct", True),
                                    ("dstn", "dst", False)):
            type_ = 3 if inverse else 2
            held = set().union(*(dct_kernels(kind, type_, n) for n in SURF_DCTN))
            ran(f"{name} type 2 {SURF_DCTN} f32", getattr(ftt, name)(xd, 2), held,
                getattr(sfft, name)(hd, 2), 2)
        xt = planes(*SURF_DCT)[0]
        ht = host(xt)
        for kind in ("dct", "dst"):
            for type_ in (1, 2, 3, 4):
                for norm in (None, "ortho", "forward"):
                    for inv in ("", "i"):
                        eff = {1: 1, 2: 3, 3: 2, 4: 4}[type_] if inv else type_
                        name = f"{inv}{kind}"
                        ran(f"{name} type {type_} norm={norm} {SURF_DCT} f32",
                            getattr(ftt, name)(xt, type_, norm=norm),
                            dct_kernels(kind, eff, SURF_DCT[1]),
                            getattr(sfft, name)(ht, type_, norm=norm), 1)
        del hd, ht
        dln, mu, offset, bias = SURF_FHT_ARGS
        decay = torch.exp(-4.0 * torch.linspace(-1.0, 1.0, SURF_FHT[1], device=dev,
                                                dtype=torch.float64) ** 2)
        a = planes(*SURF_FHT)[0].double() * decay
        fht_held = real(SURF_FHT[1], c128, "rfft_bm") | real(SURF_FHT[1], c128, "irfft_bm")
        big = ran(f"fht {SURF_FHT} f64", ftt.fht(a, dln, mu, offset, bias), fht_held,
                  sfft.fht(host(a), dln, mu, offset=offset, bias=bias), 1, double=True)
        ran(f"ifht {SURF_FHT} f64", ftt.ifht(big, dln, mu, offset, bias), fht_held,
            sfft.ifht(host(big), dln, mu, offset=offset, bias=bias), 1, double=True)
        shifted = ftt.fftshift(x2)
        seen = only_ran("surface fftshift", set(), seen)
        check(torch.equal(shifted, torch.fft.fftshift(x2))
              and torch.equal(ftt.ifftshift(shifted), x2), "fftshift/ifftshift differ "
              "from torch.fft's")
        seen = counts()
        ore, oim = ftt.transform_planar(x2.real, x2.imag, Transform.FFT)
        ran(f"transform_planar {SURF_2D} c64", torch.complex(ore, oim), c2c((n1,), c64),
            np.fft.fft(h2, axis=-1), 1)
        # An NdFftPlan of its own: on the card, moved to the CPU (where the
        # kernels' plain versions run and no count rises), and back.
        nd = ftt.NdFftPlan(SURF_2D)
        check(nd.device == dev, f"NdFftPlan planned on {nd.device}")
        y_card = ran(f"NdFftPlan{SURF_2D}.fft", nd.fft(x2),
                     set().union(*(_c2c_kernels(plan_tree(p)) for p in nd.plans)),
                     np.fft.fft2(h2), 2)
        nd.to("cpu")
        y_cpu = nd.fft(x2.cpu())
        seen = only_ran("surface NdFftPlan on the CPU", set(), seen)
        check(nd.device.type == "cpu" and y_cpu.device.type == "cpu",
              f"NdFftPlan.to('cpu') left it on {nd.device}")
        cpu_err = rel_l2(y_cpu.numpy(), host(y_card))
        check(cpu_err <= 2 * REL_L2_GATE * math.sqrt(2),
              f"NdFftPlan on the CPU vs on the card: rel-L2 {cpu_err:.3e}")
        nd.to(dev)
        y_back = ran(f"NdFftPlan{SURF_2D}.fft after .to('cpu') and back", nd.fft(x2),
                     set().union(*(_c2c_kernels(plan_tree(p)) for p in nd.plans)),
                     np.fft.fft2(h2), 2)
        check(torch.equal(y_back, y_card), "NdFftPlan after .to('cpu') and back "
              "differs from its first run")
        del h2
        np_in = np.asarray(xo.cpu().numpy())
        out_np = ftt.rfftn(np_in)
        seen = only_ran("surface rfftn of a numpy array", real(m1, c64, "rfft_bm")
                        | c2c((m0,), c64), seen)
        check(isinstance(out_np, np.ndarray) and rel_l2(out_np, host(spec_o)) == 0.0,
              "rfftn of a numpy array differs from the tensor run")
        surface_launches = counts()
        for k, v in surface_launches.items():
            path_launches[k] += v
        for what, (err, gate, held) in worst.items():
            print(f"surface: {what} launched {held or 'no kernel'}; rel-L2 {err:.3e} vs "
                  f"np.fft/scipy.fft in f64 (gate {gate:.3g})", flush=True)
        print(f"surface: fftshift/ifftshift equal torch.fft's; NdFftPlan{SURF_2D} on "
              f"the CPU vs the card rel-L2 {cpu_err:.3e}, back on the card bitwise "
              f"equal; rfftn of a numpy array equals the tensor run; launches "
              f"{ {k: v for k, v in surface_launches.items() if v} }", flush=True)

        ftt.VpuFftPlan.run = staticmethod(sv.vpu_fft_batch_minor)
        ftt.VpuBluesteinPlan.run = staticmethod(sv.vpu_bluestein_batch_minor)
        ftt.VpuDdFftPlan.run = staticmethod(dv.vpu_dd_fft_batch_minor)
        rfft_module.stockham_vpu = sv
        check(route_shapes["B1"] and route_shapes["B4a"], "the surface gave B1 or B4a "
              "no call")
        for kernel in ("B1", "B2", "B4b", "B5a", "B5b", "B6"):
            if route_shapes[kernel]:
                route_checks(kernel, "4i")
        ran_b4a, worst_b4a = [], 0.0
        for n, b in sorted(route_shapes["B4a"]):
            errs, mf, mi = rfft_case(ftt.RfftPlan(n, device=dev), planes(n, b)[0])
            check(max(errs) <= REL_L2_GATE, f"B4a/B4b n={n} B={b}: rel-L2 (rfft vs "
                  f"plain, irfft vs plain, rfft vs np.fft, irfft vs np.fft, round trip) "
                  f"{errs}")
            max_abs_err["B4a"] = max(max_abs_err["B4a"], mf)
            max_abs_err["B4b"] = max(max_abs_err["B4b"], mi)
            worst_b4a = max(worst_b4a, max(errs))
            ran_b4a.append((n, b))
        print(f"B4a (with B4b) at the surface's shapes {ran_b4a} pass; worst rel-L2 "
              f"{worst_b4a:.3e} (gate {REL_L2_GATE:g})", flush=True)
        return dict(x2=x2, x3=x3, x3d=x3d, xr=xr, spec=spec, xo=xo, spec_o=spec_o,
                    xd=xd, xt=xt, a=a, big=big)

    surface = surface_runs()

    # 4j. signal.py, spectral.py and the scipy.fft backend at full width on
    # device="cuda": every entry point on tensors already on the card (the
    # backend on numpy arrays, as scipy code calls it), with the counts of
    # the kernels its plans hold rising and no other, each result on the
    # whole array against scipy.signal / scipy.fft in f64 (SIG_GATE for
    # complex64 results, SIG_PSD_GATE for PSD estimates, DD_GATE for
    # complex128; the backend's fft2, rfft and dctn at the surface's gate);
    # then the kernels at every (n, B) the slice gave them against their
    # plain versions (B1, B2, B4b, B5a, B5b, B6 on both bodies in every mode
    # as phase 4g; B4a with its inverse through rfft_case; B8 through
    # dd_case).
    def signal_runs():
        """Phase 4j's runs, in a scope of their own; returns the inputs
        phase 5i times."""
        import os

        import scipy.fft as sfft
        import scipy.signal as ss

        signal_module = sys.modules["fourier_tpu_torch.signal"]
        split_module = sys.modules["fourier_tpu_torch.precision.dd_split"]
        dctdst_module = sys.modules["fourier_tpu_torch.dctdst"]
        for shapes in route_shapes.values():
            shapes.clear()
        route_shapes["B8"] = set()
        ftt.VpuFftPlan.run = staticmethod(recording("B1", sv.vpu_fft_batch_minor))
        ftt.VpuBluesteinPlan.run = staticmethod(recording("B2", sv.vpu_bluestein_batch_minor))
        ftt.VpuDdFftPlan.run = staticmethod(recording("B6", dv.vpu_dd_fft_batch_minor))
        rfft_module.stockham_vpu = types.SimpleNamespace(**{
            **vars(sv),
            "vpu_rfft_pack_batch_minor": recording(
                "B4a", sv.vpu_rfft_pack_batch_minor,
                lambda x_t, m, *a: (2 * m, x_t.shape[1])),
            "vpu_rfft_odd_pack_batch_minor": recording(
                "B5a", sv.vpu_rfft_odd_pack_batch_minor),
            "vpu_irfft_unpack_batch_minor": recording(
                "B4b", sv.vpu_irfft_unpack_batch_minor,
                lambda re_t, im_t, m, *a: (2 * m, re_t.shape[1])),
            "vpu_irfft_odd_unpack_batch_minor": recording(
                "B5b", sv.vpu_irfft_odd_unpack_batch_minor,
                lambda re_t, im_t, n, *a: (n, re_t.shape[1]))})
        split_module.dd_combine = types.SimpleNamespace(**{
            **vars(dc),
            "dd_split_combine_batch_minor": recording(
                "B8", dc.dd_split_combine_batch_minor,
                lambda re_t, im_t, n, r, *a: (n, re_t.shape[1] // r))})
        c64, c128 = torch.complex64, torch.complex128
        oracle = lambda: sfft.set_workers(os.cpu_count() or 1)

        def c2c(sizes, dt):
            """The kernels of the cached axis plans' trees (batch-minor)."""
            return set().union(*(_c2c_kernels(plan_tree(p)) for p in
                                 signal_module._axis_plans(sizes, dt, dev)))

        def major(n):
            """The kernels of the cached complex64 plan of n, batch-major."""
            return _kernels_of(plan_tree(ftt.create_fft(n, c64, device=dev)), False)

        def real(n, dt, call):
            return _real_kernels(n, plan_tree(rfft_module._rfft_plan(n, dt, dev))[2], call)

        def host(t):
            return t if isinstance(t, np.ndarray) else t.detach().cpu().numpy()

        seen = counts()
        worst = {}

        def ran(what, out, held, want, gate, exact=True):
            """`out` of entry `what`: the counts of `held` and no other rose
            (not `exact`: some of them and no other, where the scipy version
            decides the dtype of the backend's calls); rel-L2 against the f64
            host `want` within `gate`."""
            nonlocal seen
            torch.cuda.synchronize()
            if exact:
                seen = only_ran(f"signal {what}", held, seen)
            else:
                now = counts()
                rose = {k for k in counters if now[k] > seen[k]}
                check(rose and rose <= held, f"signal {what}: {sorted(rose)} rose; "
                      f"the plans run {sorted(held)}")
                seen, held = now, rose
            if isinstance(out, torch.Tensor):
                check(out.device == dev, f"signal {what}: output on {out.device}")
            err = rel_l2(host(out), want)
            check(err <= gate, f"signal {what}: rel-L2 {err:.3e} vs scipy in f64 "
                  f"(gate {gate:g})")
            worst[what] = (err, gate, sorted(held))
            print(f"signal: {what} launched {sorted(held) or 'no kernel'}; rel-L2 "
                  f"{err:.3e} vs scipy in f64 (gate {gate:g})", flush=True)
            return out

        zero_counts()
        seen = counts()
        # Image pipeline: a 3968^2 image and a 129^2 point-spread function,
        # "same" mode, padded to 4096^2.
        img = planes(*SIG_IMAGE)[0]
        psf = planes(*SIG_PSF)[0] / SIG_PSF[0]
        h_img, h_psf = host(img).astype(np.float64), host(psf).astype(np.float64)
        full = [a + b - 1 for a, b in zip(SIG_IMAGE, SIG_PSF)]
        with oracle():
            want = ss.fftconvolve(h_img, h_psf, "same")
            want_corr = ss.correlate(h_img, h_psf, "same", method="fft")
        ran(f"fftconvolve {SIG_IMAGE} * {SIG_PSF} same f32",
            ftt.fftconvolve(img, psf, "same"), c2c(full, c64), want, SIG_GATE)
        ran(f"correlate {SIG_IMAGE} x {SIG_PSF} same f32", ftt.correlate(img, psf, "same"),
            c2c(full, c64), want_corr, SIG_GATE)
        ran(f"fftconvolve {SIG_IMAGE} * {SIG_PSF} same complex128",
            ftt.fftconvolve(img, psf, "same", dtype=c128), c2c(full, c128), want, DD_GATE)
        del want, want_corr
        # Audio: 64 channels of 2^20 samples, a bank of 1023-tap FIRs (one a
        # channel) and a second set of signals for the cross spectra.
        sig = planes(*SIG_AUDIO)[0]
        sig2 = planes(*SIG_AUDIO)[0]
        bank = planes(SIG_AUDIO[0], SIG_FIR)[0] / math.sqrt(SIG_FIR)
        h_sig, h_sig2 = host(sig).astype(np.float64), host(sig2).astype(np.float64)
        h_bank = host(bank).astype(np.float64)
        blocks = signal_module.next_fast_len(sum(signal_module._oa_lens(SIG_AUDIO[1],
                                                                        SIG_FIR)) - 1)
        with oracle():
            want = ss.oaconvolve(h_sig, h_bank, axes=-1)
        ran(f"oaconvolve {SIG_AUDIO} * {SIG_AUDIO[0]} FIRs of {SIG_FIR} f32 (blocks of "
            f"{blocks})", ftt.oaconvolve(sig, bank, axes=-1), c2c([blocks], c64), want,
            SIG_GATE)
        with oracle():
            want = ss.oaconvolve(h_sig, h_bank[:1], axes=-1)
        conv = ftt.ConvolvePlan(bank[0])
        conv128 = ftt.ConvolvePlan(bank[0], dtype=c128)
        check(conv.device == dev and conv128.device == dev,
              f"ConvolvePlan planned on {conv.device}, {conv128.device}")
        ran(f"ConvolvePlan({SIG_FIR} taps, block {conv.block}) on {SIG_AUDIO} f32",
            conv(sig), _c2c_kernels(plan_tree(conv.inner)), want, SIG_GATE)
        ran(f"ConvolvePlan({SIG_FIR} taps, complex128) on {SIG_AUDIO}", conv128(sig),
            _c2c_kernels(plan_tree(conv128.inner)), want, DD_GATE)
        del want
        # Rows: hilbert, czt and zoom_fft over the last axis of 16384 x 4096.
        rows = planes(*SIG_ROWS)[0]
        with oracle():
            want = ss.hilbert(host(rows).astype(np.float64))
        ran(f"hilbert {SIG_ROWS} f32", ftt.hilbert(rows), major(SIG_ROWS[1]), want, SIG_GATE)
        im2 = planes(*SURF_2D)[0]
        with oracle():
            want = ss.hilbert2(host(im2).astype(np.float64))
        ran(f"hilbert2 {SURF_2D} f32", ftt.hilbert2(im2), c2c(SURF_2D, c64), want, SIG_GATE)
        (rb, rn), rnum = SIG_RESAMPLE
        aud = planes(rb, rn)[0]
        with oracle():
            want = ss.resample(host(aud).astype(np.float64), rnum, axis=-1)
        ran(f"resample ({rb}, {rn}) to {rnum} f32", ftt.resample(aud, rnum),
            major(rn) | major(rnum), want, SIG_GATE)
        rowsc = torch.complex(*planes(*SIG_ROWS))
        h_rowsc = host(rowsc).astype(np.complex128)
        m, f1, f2 = SIG_BAND
        w, a = np.exp(-2j * np.pi * (f2 - f1) / m), np.exp(2j * np.pi * f1)
        inner = signal_module.next_fast_len(SIG_ROWS[1] + m - 1)
        with oracle():
            want = ss.czt(h_rowsc, m, w, a)
            want_zoom = ss.zoom_fft(h_rowsc, [f1, f2], m, fs=1)
        ran(f"czt {SIG_ROWS} c64 to {m} points (inner {inner})", ftt.czt(rowsc, m, w, a),
            major(inner), want, SIG_GATE)
        ran(f"zoom_fft {SIG_ROWS} c64 to [{f1}, {f2}) in {m} points",
            ftt.zoom_fft(rowsc, [f1, f2], m, fs=1), major(inner), want_zoom, SIG_GATE)
        del want, want_zoom, h_rowsc
        # STFT and the Welch family on the audio signals.
        nper, hop = SIG_STFT
        stft_kw = dict(nperseg=nper, noverlap=nper - hop)
        with oracle():
            want = ss.stft(h_sig, **stft_kw)[2]
        zxx = ran(f"stft {SIG_AUDIO} nperseg {nper} hop {hop} f32",
                  ftt.stft(sig, **stft_kw)[2], real(nper, c64, "rfft_bm"), want, SIG_GATE)
        # StftPlan frames the signal with no boundary extension: its frame k
        # is the default stft's frame k + 2 (two hops of zeros lead there).
        sp = ftt.StftPlan(nper, hop=hop)
        check(sp.device == dev, f"StftPlan planned on {sp.device}")
        lead = nper // 2 // hop
        sre, sim = sp.stft_planar(sig)
        k = sre.shape[-2]
        ran(f"StftPlan({nper}, hop={hop}).stft_planar {SIG_AUDIO}", torch.complex(sre, sim),
            real(nper, c64, "rfft_bm"), np.moveaxis(want[..., lead:lead + k], -1, -2),
            SIG_GATE)
        del want
        with oracle():
            want = ss.istft(host(zxx).astype(np.complex128), **stft_kw)[1]
        back = ran(f"istft {tuple(zxx.shape)} nperseg {nper} hop {hop}",
                   ftt.istft(zxx, **stft_kw)[1], real(nper, c64, "irfft_bm"), want,
                   SIG_GATE)
        del want
        rt = rel_l2(host(back[..., :SIG_AUDIO[1]]), h_sig)
        check(rt <= SIG_GATE, f"istft(stft(x)) rel-L2 {rt:.3e} vs x")
        sback = sp.istft_planar(sre, sim)
        torch.cuda.synchronize()
        seen = only_ran("signal StftPlan.istft_planar", real(nper, c64, "irfft_bm"), seen)
        n_sp = sback.shape[-1]
        core = slice(nper, n_sp - nper)
        srt = rel_l2(host(sback[..., core]), h_sig[..., core])
        check(srt <= SIG_GATE, f"StftPlan round trip rel-L2 {srt:.3e} vs x")
        print(f"signal: istft(stft(x)) rel-L2 {rt:.3e} vs x; StftPlan.istft_planar "
              f"launched {sorted(real(nper, c64, 'irfft_bm'))}, its round trip rel-L2 "
              f"{srt:.3e} vs x off the first and last {nper} samples (gate "
              f"{SIG_GATE:g})", flush=True)
        del zxx, back, sre, sim, sback
        welch_kw = dict(nperseg=SIG_WELCH)
        fwd = real(SIG_WELCH, c64, "rfft_bm")
        with oracle():
            pxx = ss.welch(h_sig, **welch_kw)[1]
            pyy = ss.welch(h_sig2, **welch_kw)[1]
            pxy = ss.csd(h_sig, h_sig2, **welch_kw)[1]
            pmed = ss.welch(h_sig, average="median", **welch_kw)[1]
            sxx = ss.spectrogram(h_sig, **welch_kw)[2]
            records = h_sig.reshape(-1, SIG_WELCH)
            prec = ss.periodogram(records)[1]
        ran(f"welch {SIG_AUDIO} nperseg {SIG_WELCH} f32", ftt.welch(sig, **welch_kw)[1],
            fwd, pxx, SIG_PSD_GATE)
        ran(f"welch {SIG_AUDIO} nperseg {SIG_WELCH} median f32",
            ftt.welch(sig, average="median", **welch_kw)[1], fwd, pmed, SIG_PSD_GATE)
        ran(f"csd {SIG_AUDIO} nperseg {SIG_WELCH} f32", ftt.csd(sig, sig2, **welch_kw)[1],
            fwd, pxy, SIG_PSD_GATE)
        # scipy's coherence is |Pxy|^2 / (Pxx Pyy) of its welch and csd
        ran(f"coherence {SIG_AUDIO} nperseg {SIG_WELCH} f32",
            ftt.coherence(sig, sig2, **welch_kw)[1], fwd, np.abs(pxy) ** 2 / (pxx * pyy),
            SIG_PSD_GATE)
        ran(f"spectrogram {SIG_AUDIO} nperseg {SIG_WELCH} f32",
            ftt.spectrogram(sig, **welch_kw)[2], fwd, sxx, SIG_PSD_GATE)
        ran(f"periodogram {records.shape} f32", ftt.periodogram(
            sig.reshape(-1, SIG_WELCH))[1], fwd, prec, SIG_PSD_GATE)
        ran(f"welch {SIG_AUDIO} nperseg {SIG_WELCH} f64 (complex128)",
            ftt.welch(sig.double(), **welch_kw)[1], real(SIG_WELCH, c128, "rfft_bm"), pxx,
            DD_GATE)
        del pyy, pxy, pmed, sxx, prec, records
        # scipy code on the card through the backend (numpy in and out).
        hx2 = host(torch.complex(*planes(*SURF_2D)))
        hr2 = host(planes(*SURF_2D)[0])
        dct_plan = dctdst_module.reduction_plan("dct", 2, SURF_2D[0], c64, dev)
        dct_held = (_real_kernels(dct_plan.n, plan_tree(dct_plan)[2], "rfft_bm")
                    if isinstance(dct_plan, ftt.RfftPlan) else _c2c_kernels(plan_tree(dct_plan)))
        h_imgc = host(torch.complex(img, img.flip(0)))
        h_psfc = host(torch.complex(psf, psf.flip(1)))
        with oracle():
            want = [np.fft.fft2(hx2.astype(np.complex128)),
                    np.fft.rfft(hr2.astype(np.float64)),
                    sfft.dctn(hr2.astype(np.float64), 2),
                    ss.fftconvolve(h_imgc.astype(np.complex128),
                                   h_psfc.astype(np.complex128), "same")]
        backend_calls = [
            (f"fft2 {SURF_2D} c64", lambda: sfft.fft2(hx2), c2c(SURF_2D, c64),
             REL_L2_GATE * math.sqrt(2)),
            (f"rfft {SURF_2D} f32", lambda: sfft.rfft(hr2), real(SURF_2D[1], c64, "major"),
             REL_L2_GATE),
            (f"dctn type 2 {SURF_2D} f32", lambda: sfft.dctn(hr2, 2), dct_held,
             REL_L2_GATE * math.sqrt(2)),
            (f"scipy.signal.fftconvolve {SIG_IMAGE} * {SIG_PSF} same c64",
             lambda: ss.fftconvolve(h_imgc, h_psfc, "same"), c2c(full, c64), SIG_GATE)]
        for (what, call, held, gate), w_ in zip(backend_calls, want):
            with sfft.set_backend(ftt.scipy_fft_backend, only=True):
                out = call()
            check(isinstance(out, np.ndarray) and out.flags.writeable,
                  f"backend {what}: {type(out)}")
            ran(f"scipy_fft_backend {what}", out, held, w_, gate)
        with sfft.set_backend(ftt.scipy_fft_backend, only=True):
            out = ss.welch(host(sig), **welch_kw)[1]
        ran(f"scipy_fft_backend scipy.signal.welch {SIG_AUDIO} nperseg {SIG_WELCH} f32",
            out, real(SIG_WELCH, c64, "major") | real(SIG_WELCH, c128, "major"), pxx,
            SIG_PSD_GATE, exact=False)
        del want, out, pxx, hx2, hr2, h_imgc, h_psfc, h_sig, h_sig2, h_bank
        slice_launches = counts()
        for k, v in slice_launches.items():
            path_launches[k] += v
        print(f"signal: phase 4j launches {({k: v for k, v in slice_launches.items() if v})}",
              flush=True)

        ftt.VpuFftPlan.run = staticmethod(sv.vpu_fft_batch_minor)
        ftt.VpuBluesteinPlan.run = staticmethod(sv.vpu_bluestein_batch_minor)
        ftt.VpuDdFftPlan.run = staticmethod(dv.vpu_dd_fft_batch_minor)
        rfft_module.stockham_vpu = sv
        split_module.dd_combine = dc
        for kernel in ("B1", "B4a", "B4b", "B6"):
            check(slice_launches[kernel] > 0, f"phase 4j launched {kernel} no time")
        for kernel in ("B1", "B2", "B4b", "B5a", "B5b", "B6"):
            if route_shapes[kernel]:
                route_checks(kernel, "4j")
        ran_b4a, worst_b4a = [], 0.0
        for n, b in sorted(route_shapes["B4a"]):
            errs, mf, mi = rfft_case(ftt.RfftPlan(n, device=dev), planes(n, b)[0])
            check(max(errs) <= REL_L2_GATE, f"B4a/B4b n={n} B={b}: rel-L2 (rfft vs "
                  f"plain, irfft vs plain, rfft vs np.fft, irfft vs np.fft, round trip) "
                  f"{errs}")
            max_abs_err["B4a"] = max(max_abs_err["B4a"], mf)
            max_abs_err["B4b"] = max(max_abs_err["B4b"], mi)
            worst_b4a = max(worst_b4a, max(errs))
            ran_b4a.append((n, b))
        print(f"B4a (with B4b) at phase 4j's shapes {ran_b4a} pass; worst rel-L2 "
              f"{worst_b4a:.3e} (gate {REL_L2_GATE:g})", flush=True)
        ran_b8, worst_b8 = [], [0.0, 0.0]
        for n, b in sorted(route_shapes["B8"]):
            e_p, e_h, m_ = dd_case("B8", n, b)
            worst_b8 = [max(worst_b8[0], e_p), max(worst_b8[1], e_h)]
            max_abs_err["B8"] = max(max_abs_err["B8"], m_)
            ran_b8.append((n, b))
        print(f"B8 at phase 4j's shapes {ran_b8} x 5 modes pass; worst rel-L2 "
              f"{worst_b8[0]:.3e} vs plain, {worst_b8[1]:.3e} vs np.fft (gate "
              f"{DD_GATE:g})", flush=True)
        return dict(img=img, psf=psf, sig=sig, sig2=sig2, bank=bank, conv=conv,
                    conv128=conv128, rows=rows, im2=im2, aud=aud, rowsc=rowsc, sp=sp)

    slice_inputs = signal_runs()

    # 4k. The plan tooling on the card: plan files, measured planning and
    # the exported programs, each with the counts zeroed before it and the
    # kernels of its trees launched.
    def tooling_runs():
        """Phase 4k's runs, in a scope of their own (phase 5 reads the main
        path's plan and planes)."""
        from fourier_tpu_torch.plan import measure
        from fourier_tpu_torch.tools.bench_suite import default_batch

        t0 = time.perf_counter()

        def launched(before):
            return {k: v - before[k] for k, v in counts().items() if v != before[k]}

        def trip_plan(kind, n):
            if kind == "rfft":
                return ftt.RfftPlan(n, device=dev)
            if kind == "mxu":
                return ftt.MxuFftPlan.create(n, impl="pallas", device=dev)
            return ftt.create_fft(n, "complex64" if kind == "c64" else "complex128",
                                  device=dev, cache=False)

        def trip_run(plan):
            """The plan's batch-minor calls (batch-major for B9b's plan) on
            one seeded input, forward and inverse."""
            g = torch.Generator(device=dev).manual_seed(SEED)
            if isinstance(plan, ftt.RfftPlan):
                x = torch.randn(plan.n, TOOL_B, generator=g, device=dev)
                spec = plan.rfft_planar_bm(x)
                return (*spec, plan.irfft_planar_bm(*spec))
            real = plan.real_dtype
            if isinstance(plan, ftt.MxuFftPlan):
                re_, im_ = (torch.randn(TOOL_B, plan.size, generator=g, device=dev)
                            for _ in range(2))
                return (*plan.transform_planar(re_, im_), *plan.transform_planar(
                    re_, im_, Transform.SQRT_SCALED_IFFT))
            re_, im_ = (torch.randn(plan.size, TOOL_B, generator=g, device=dev).to(real)
                        for _ in range(2))
            return (*plan.transform_planar_bm(re_, im_),
                    *plan.transform_planar_bm(re_, im_, Transform.SQRT_SCALED_IFFT))

        def slots(module):
            return [(f"{p}.{k}", b) for p, mod in module.named_modules()
                    for k, b in mod._buffers.items()]

        zero_counts()
        for kind, n in TOOL_TRIPS:
            plan = trip_plan(kind, n)
            before = counts()
            want = trip_run(plan)
            ran = launched(before)
            path = "build/phase4k_plan.npz"
            ftt.save_plan(plan, path)
            for how, loaded in (("file", ftt.load_plan(path, device=dev)),
                                ("bytes", ftt.load_plan(ftt.plan_to_bytes(plan), device=dev))):
                check(plan_tree(loaded) == plan_tree(plan), f"{kind} {n} {how}: tree "
                      f"{plan_tree(loaded)}, saved {plan_tree(plan)}")
                for (name_, a), (_, b_) in zip(slots(plan), slots(loaded)):
                    check((a is None and b_ is None) or (
                        a is not None and b_ is not None and a.dtype == b_.dtype
                        and a.device == b_.device and torch.equal(a, b_)),
                        f"{kind} {n} {how}: buffer {name_} differs after the round trip")
                before = counts()
                got = trip_run(loaded)
                again = launched(before)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b_) for a, b_ in zip(got, want)),
                      f"{kind} {n} {how}: the loaded plan's output is not bitwise the "
                      "saved plan's")
                check(again == ran, f"{kind} {n} {how}: the loaded plan launched {again}, "
                      f"the saved one {ran}")
            print(f"tooling: save_plan/load_plan {kind} n={n} {plan_tree(plan)}: buffers "
                  f"and outputs bitwise equal through a file and through bytes; "
                  f"launches {ran or 'none (no kernel on this tree)'} each", flush=True)

        # Measured planning on the card, then the same plans from wisdom.
        measure.forget_wisdom()
        winners = {}
        for n, dtype in TOOL_MEASURE:
            res = ftt.measure_fft(n, dtype, device=dev)
            winners[(n, dtype)] = type(res.plan)
            print(f"tooling: measure_fft n={n} {dtype}: " + ", ".join(
                f"{k} {v:.1f} us" for k, v in res.timings_us.items())
                + f" a transform (batch {max(64, default_batch(n) // 4)}); winner "
                f"{res.best} ({type(res.plan).__name__}) on {card}", flush=True)
            check(len(res.timings_us) == (3 if dtype == "complex64" else 2)
                  and all(v > 0 for v in res.timings_us.values()),
                  f"measure_fft n={n}: {res.timings_us}")
        time_plan = measure._time_plan

        def no_timing(*_a, **_k):
            raise AssertionError("backend='measure' timed a plan that wisdom names")

        measure._time_plan = no_timing
        try:
            for (n, dtype), cls in winners.items():
                plan = ftt.create_fft(n, dtype, backend="measure", device=dev, cache=False)
                check(type(plan) is cls, f"backend='measure' n={n} planned "
                      f"{type(plan).__name__}, wisdom names {cls.__name__}")
            doc = ftt.export_wisdom()
            ftt.forget_wisdom()
            check(ftt.import_wisdom(doc) == len(TOOL_MEASURE)
                  and json.loads(ftt.export_wisdom()) == json.loads(doc),
                  "the wisdom did not round-trip")
            for n, dtype in TOOL_MEASURE:
                check(measure.plan_from_wisdom(n, dtype, device=dev) is not None,
                      f"no plan from the imported wisdom at n={n}")
        finally:
            measure._time_plan = time_plan
        entries = json.loads(doc)["entries"]
        print(f"tooling: create_fft(backend='measure') planned the winners from wisdom "
              f"with the timer poisoned; export_wisdom/import_wisdom round trip of "
              f"{len(entries)} entries ({sorted(entries)}) on {card}", flush=True)

        # Ahead-of-time export: the programs call the kernel operators, and
        # the loaded artifact launches the kernels.
        for n, dtype, batch_shape, batches in TOOL_EXPORT:
            plan = ftt.create_fft(n, dtype, device=dev)
            path = "build/phase4k_compiled.npz"
            t_export = time.perf_counter()
            ftt.export_compiled(plan, path, batch_shape=batch_shape)
            t_export = time.perf_counter() - t_export
            t_load = time.perf_counter()
            comp = ftt.load_compiled(path)
            t_load = time.perf_counter() - t_load
            ops = comp.meta["kernels"]
            check(all(ops[m] for m in comp.modes), f"export n={n}: no kernel operator in "
                  f"the graph: {ops}")
            for b in batches:
                re_, im_ = (torch.randn(b, n, generator=gen, device=dev).to(plan.real_dtype)
                            for _ in range(2))
                for mode in (Transform.FFT, Transform.IFFT):
                    before = counts()
                    got = comp.transform_planar(re_, im_, mode)
                    by_artifact = launched(before)
                    want = plan.transform_planar(re_, im_, mode)
                    torch.cuda.synchronize()
                    check(sum(by_artifact.values()) > 0, f"export n={n} B={b}: the loaded "
                          "artifact launched no kernel")
                    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                          f"export n={n} B={b} {mode.name}: the artifact's output is not "
                          "bitwise the plan's")
            print(f"tooling: export_compiled n={n} {dtype} batch {batch_shape} "
                  f"({type(plan).__name__}): graph {ops}; export {t_export:.2f} s, load "
                  f"{t_load:.2f} s; the loaded artifact at B in {batches} launched the "
                  f"kernels, outputs bitwise equal to the plan's", flush=True)
        tool_launches = counts()
        for k, v in tool_launches.items():
            path_launches[k] += v
        print(f"tooling: phase 4k launches {({k: v for k, v in tool_launches.items() if v})}"
              f" in {time.perf_counter() - t0:.1f} s", flush=True)

    tooling_runs()

    # 4l. The sharded plans (fourier_tpu_torch.parallel) at full width on a
    # one-rank NCCL mesh (the card's one rank: its exchanges are NCCL's
    # all-to-all with itself): every entry point, each against torch.fft
    # and the port's single-device surface (gates REL_L2_GATE c64,
    # SHARD_RFFT_GATE for the real family, DD_GATE c128), pipeline_chunks
    # bitwise equal to one chunk, the counts zeroed before each and the
    # kernels its sub-plans hold launched; then the kernels at every (n, B)
    # the sharded legs gave them against their plain versions (as phase 4j;
    # B3's shape is among phase 3c's).
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, device_id=dev)
    meshes = {"fft": init_device_mesh("cuda", (1,), mesh_dim_names=("fft",)),
              "batch": init_device_mesh("cuda", (1,), mesh_dim_names=("batch",)),
              "xy": init_device_mesh("cuda", (1, 1), mesh_dim_names=("x", "y"))}

    def sharded_runs():
        """Phase 4l's runs, in a scope of their own (phase 5 reads the main
        path's plan and planes)."""
        from fourier_tpu_torch import parallel

        split_module = sys.modules["fourier_tpu_torch.precision.dd_split"]
        four_module = sys.modules["fourier_tpu_torch.plan.four_step_local"]
        for shapes in route_shapes.values():
            shapes.clear()
        for k in ("B3", "B4a", "B7", "B8"):
            route_shapes[k] = set()
        ftt.VpuFftPlan.run = staticmethod(recording("B1", sv.vpu_fft_batch_minor))
        ftt.VpuBluesteinPlan.run = staticmethod(recording("B2", sv.vpu_bluestein_batch_minor))
        ftt.VpuDdFftPlan.run = staticmethod(recording("B6", dv.vpu_dd_fft_batch_minor))
        ftt.VpuDdBluesteinPlan.run = staticmethod(recording(
            "B7", dv.vpu_dd_bluestein_batch_minor))
        rfft_module.stockham_vpu = types.SimpleNamespace(**{
            **vars(sv),
            "vpu_rfft_pack_batch_minor": recording(
                "B4a", sv.vpu_rfft_pack_batch_minor,
                lambda x_t, m, *a: (2 * m, x_t.shape[1])),
            "vpu_rfft_odd_pack_batch_minor": recording(
                "B5a", sv.vpu_rfft_odd_pack_batch_minor),
            "vpu_irfft_unpack_batch_minor": recording(
                "B4b", sv.vpu_irfft_unpack_batch_minor,
                lambda re_t, im_t, m, *a: (2 * m, re_t.shape[1])),
            "vpu_irfft_odd_unpack_batch_minor": recording(
                "B5b", sv.vpu_irfft_odd_unpack_batch_minor,
                lambda re_t, im_t, n, *a: (n, re_t.shape[1]))})
        four_module.stockham_vpu = types.SimpleNamespace(**{
            **vars(sv),
            "vpu_fft_four_step_row": recording(
                "B3", sv.vpu_fft_four_step_row,
                lambda re3, im3, p_, q_, *a: (p_ * q_, re3.shape[2]))})
        split_module.dd_combine = types.SimpleNamespace(**{
            **vars(dc),
            "dd_split_combine_batch_minor": recording(
                "B8", dc.dd_split_combine_batch_minor,
                lambda re_t, im_t, n, r, *a: (n, re_t.shape[1] // r))})
        t0 = time.perf_counter()
        c64, c128 = torch.complex64, torch.complex128
        m_fft, m_batch, m_xy = meshes["fft"], meshes["batch"], meshes["xy"]
        launched, worst = counts(), {}
        for k in launched:
            launched[k] = 0
        sharded_launches = dict(launched)

        def rand(*shape, dtype=c64):
            rt = torch.float32 if dtype in (c64, torch.float32) else torch.float64
            re = torch.randn(*shape, generator=gen, device=dev, dtype=rt)
            if dtype in (torch.float32, torch.float64):
                return re
            return torch.complex(re, torch.randn(*shape, generator=gen, device=dev,
                                                 dtype=rt))

        def entry(what, run, wants, gate, held):
            """`run` (DTensor planes out, or a complex/real tensor) against
            each (label, reference) of `wants`, computed first; the counts
            zeroed before the run, the kernels of `held` launched."""
            refs = [(label, want()) for label, want in wants]
            torch.cuda.synchronize()
            zero_counts()
            out = run()
            torch.cuda.synchronize()
            now = counts()
            if isinstance(out, tuple):
                shapes = {tuple(o.shape) for o in out}
                local = [o.to_local() for o in out]
                check(len(shapes) == 1 and tuple(local[0].shape) == shapes.pop(),
                      f"{what}: the one rank does not hold the whole result")
                out = torch.complex(*local) if len(local) == 2 else local[0]
            errs = []
            for label, ref in refs:
                err = _rel_t(out[..., :ref.shape[-1]], ref)
                check(err <= gate, f"{what}: rel-L2 {err:.3e} vs {label} (gate {gate:g})")
                errs.append(f"{label} {err:.3e}")
                worst[what] = max(worst.get(what, 0.0), err)
            ran = {k: v for k, v in now.items() if v}
            for k in held:
                check(now[k] > 0, f"{what} launched {k} no time ({ran})")
            for k, v in now.items():
                sharded_launches[k] += v
            print(f"sharded: {what}: rel-L2 " + ", ".join(errs) + f" (gate {gate:g}); "
                  f"launched {ran}", flush=True)
            return out

        # Fft2dPlan: BASELINE config 5 per chip; inverse; pipeline_chunks.
        b, n1, n2 = SHARD_FFT2
        x = rand(b, n1, n2)
        plan2 = parallel.Fft2dPlan(n1, n2, m_fft)
        y1 = entry(f"Fft2dPlan({n1}, {n2}) {b}x fft", lambda: plan2.fft_planar(x.real, x.imag),
                   [("torch.fft.fft2", lambda: torch.fft.fft2(x)),
                    ("ftt.fft2", lambda: ftt.fft2(x))], REL_L2_GATE, {"B1"})
        entry(f"Fft2dPlan({n1}, {n2}) {b}x ifft", lambda: plan2.ifft_planar(x.real, x.imag),
              [("torch.fft.ifft2", lambda: torch.fft.ifft2(x)),
               ("ftt.ifft2", lambda: ftt.ifft2(x))], REL_L2_GATE, {"B1"})
        chunked = parallel.Fft2dPlan(n1, n2, m_fft, pipeline_chunks=SHARD_CHUNKS)
        y4 = entry(f"Fft2dPlan({n1}, {n2}, pipeline_chunks={SHARD_CHUNKS}) {b}x fft",
                   lambda: chunked.fft_planar(x.real, x.imag),
                   [("torch.fft.fft2", lambda: torch.fft.fft2(x))], REL_L2_GATE, {"B1"})
        check(torch.equal(y1, y4), f"pipeline_chunks={SHARD_CHUNKS} differs from one chunk")
        print(f"sharded: pipeline_chunks={SHARD_CHUNKS} bitwise equal to one chunk",
              flush=True)
        del x, y1, y4, plan2, chunked
        b, n1, n2 = SHARD_FFT2_B2
        x = rand(b, n1, n2)
        plan2 = parallel.Fft2dPlan(n1, n2, m_fft)
        entry(f"Fft2dPlan({n1}, {n2}) {b}x fft", lambda: plan2.fft_planar(x.real, x.imag),
              [("torch.fft.fft2", lambda: torch.fft.fft2(x)),
               ("ftt.fft2", lambda: ftt.fft2(x))], REL_L2_GATE, {"B1", "B2"})
        for b, n1, n2 in SHARD_FFT2_C128:
            x = rand(b, n1, n2, dtype=c128)
            plan2 = parallel.Fft2dPlan(n1, n2, m_fft, dtype=c128)
            held = {"B6"} if n2 == n1 else {"B6", "B7", "B8"}
            entry(f"Fft2dPlan({n1}, {n2}) c128 {b}x fft",
                  lambda: plan2.fft_planar(x.real, x.imag),
                  [("torch.fft.fft2", lambda: torch.fft.fft2(x)),
                   ("ftt.fft2", lambda: ftt.fft2(x))], DD_GATE, held)
            entry(f"Fft2dPlan({n1}, {n2}) c128 {b}x ifft",
                  lambda: plan2.ifft_planar(x.real, x.imag),
                  [("torch.fft.ifft2", lambda: torch.fft.ifft2(x))], DD_GATE, held)
        del x, plan2
        # FourStepPlan: 2^24 points, digit and natural order; the 256 x 65536
        # split, whose row leg is the local four-step.
        for p1, p2 in SHARD_FOUR:
            xf = rand(p1 * p2)
            held = {"B1"} if p2 <= 16384 else {"B1", "B3"}
            for natural in (False, True):
                fs = parallel.FourStepPlan(p1, p2, m_fft, natural_order=natural)
                want = ((lambda: torch.fft.fft(xf)) if natural
                        else (lambda: torch.fft.fft(xf).view(p2, p1).T))
                wants = [("torch.fft.fft", want)]
                if natural:
                    wants.append(("create_fft_f32", lambda: ftt.create_fft_f32(
                        p1 * p2, device=dev).fft(xf)))
                entry(f"FourStepPlan({p1}, {p2}, natural_order={natural}) fft",
                      lambda: fs.fft_planar(xf.real.view(p1, p2), xf.imag.view(p1, p2)),
                      wants, REL_L2_GATE, held)
            del xf, fs
        # Rfft2dPlan: even n2 (B4a/B4b) and odd (B5a/B5b), rfft and irfft.
        for n1, n2 in SHARD_RFFT2:
            xr = rand(n1, n2, dtype=torch.float32)
            rp = parallel.Rfft2dPlan(n1, n2, m_fft)
            fwd, inv = ({"B1", "B4a"}, {"B1", "B4b"}) if n2 % 2 == 0 else (
                {"B1", "B5a"}, {"B1", "B5b"})
            spec = entry(f"Rfft2dPlan({n1}, {n2}) rfft", lambda: rp.rfft_planar(xr),
                         [("torch.fft.rfft2", lambda: torch.fft.rfft2(xr)),
                          ("ftt.rfft2", lambda: ftt.rfft2(xr))], SHARD_RFFT_GATE, fwd)
            sre = spec.real.contiguous()
            sim = spec.imag.contiguous()
            entry(f"Rfft2dPlan({n1}, {n2}) irfft", lambda: (rp.irfft_planar(sre, sim),),
                  [("torch.fft.irfft2", lambda: torch.fft.irfft2(spec, s=(n1, n2))),
                   ("input", lambda: xr)], SHARD_RFFT_GATE, inv)
            del xr, rp, spec, sre, sim
        # 3-D: a 1x1 pencil mesh and the slab, natural and the spectral
        # round trip.
        shape3 = SHARD_3D
        xc = rand(*shape3)
        for label, mesh, axes in (("1x1 pencils", m_xy, ("x", "y")),
                                  ("slab", m_fft, ("fft",))):
            nat = parallel.Fft3dPlan(*shape3, mesh, axes=axes)
            entry(f"Fft3dPlan{shape3} {label} fft", lambda: nat.fft_planar(xc.real, xc.imag),
                  [("torch.fft.fftn", lambda: torch.fft.fftn(xc)),
                   ("ftt.fftn", lambda: ftt.fftn(xc))], REL_L2_GATE, {"B1"})
            spc = parallel.Fft3dPlan(*shape3, mesh, axes=axes, spectral_output=True)
            sp = entry(f"Fft3dPlan{shape3} {label} spectral fft",
                       lambda: spc.fft_planar(xc.real, xc.imag),
                       [("torch.fft.fftn", lambda: torch.fft.fftn(xc))], REL_L2_GATE, {"B1"})
            entry(f"Fft3dPlan{shape3} {label} ifft from_spectral",
                  lambda: spc.transform_planar(sp.real, sp.imag, Transform.IFFT,
                                               from_spectral=True),
                  [("input", lambda: xc)], REL_L2_GATE, {"B1"})
        xr3 = rand(*shape3, dtype=torch.float32)
        for label, mesh, axes in (("1x1 pencils", m_xy, ("x", "y")),
                                  ("slab", m_fft, ("fft",))):
            for spectral in (False, True):
                r3 = parallel.Rfft3dPlan(*shape3, mesh, axes=axes, spectral_output=spectral)
                sp = entry(f"Rfft3dPlan{shape3} {label} spectral_output={spectral} rfft",
                           lambda: r3.rfft_planar(xr3),
                           [("torch.fft.rfftn", lambda: torch.fft.rfftn(xr3)),
                            ("ftt.rfftn", lambda: ftt.rfftn(xr3))], SHARD_RFFT_GATE,
                           {"B1", "B4a"})
                spr, spi = sp.real.contiguous(), sp.imag.contiguous()
                entry(f"Rfft3dPlan{shape3} {label} irfft from_spectral={spectral}",
                      lambda: (r3.irfft_planar(spr, spi, from_spectral=spectral),),
                      [("input", lambda: xr3)], SHARD_RFFT_GATE, {"B1", "B4b"})
        del xc, xr3
        # Batch sharding at the main path's shape.
        n, bb = SHARD_BATCHED
        xb = rand(n, bb).T  # (B, n), the batch-minor layout's view
        bplan = ftt.create_fft_f32(n, device=dev)
        entry(f"batched_transform {n}x{bb}",
              lambda: parallel.batched_transform(bplan, xb.real, xb.imag, m_batch),
              [("torch.fft.fft", lambda: torch.fft.fft(xb)),
               ("plan.fft", lambda: bplan.fft(xb))], REL_L2_GATE, {"B1"})
        rplan = ftt.RfftPlan(n, device=dev)
        xrb = rand(n, bb, dtype=torch.float32).T
        sb = entry(f"batched_rfft {n}x{bb}", lambda: parallel.batched_rfft(rplan, xrb, m_batch),
                   [("torch.fft.rfft", lambda: torch.fft.rfft(xrb)),
                    ("plan.rfft", lambda: rplan.rfft(xrb))], SHARD_RFFT_GATE, {"B4a"})
        entry(f"batched_irfft {n}x{bb}",
              lambda: (parallel.batched_irfft(rplan, sb.real, sb.imag, m_batch),),
              [("input", lambda: xrb)], SHARD_RFFT_GATE, {"B4b"})
        del xb, xrb, sb

        ftt.VpuFftPlan.run = staticmethod(sv.vpu_fft_batch_minor)
        ftt.VpuBluesteinPlan.run = staticmethod(sv.vpu_bluestein_batch_minor)
        ftt.VpuDdFftPlan.run = staticmethod(dv.vpu_dd_fft_batch_minor)
        ftt.VpuDdBluesteinPlan.run = staticmethod(dv.vpu_dd_bluestein_batch_minor)
        rfft_module.stockham_vpu = sv
        four_module.stockham_vpu = sv
        split_module.dd_combine = dc
        for kernel in ("B1", "B2", "B3", "B4a", "B4b", "B5a", "B5b", "B6", "B7", "B8"):
            check(sharded_launches[kernel] > 0, f"phase 4l launched {kernel} no time")
        t_runs = time.perf_counter() - t0
        for kernel in ("B1", "B2", "B4b", "B5a", "B5b", "B6"):
            route_checks(kernel, "4l")
        ran_b4a, worst_b4a = [], 0.0
        for n, b in sorted(route_shapes["B4a"]):
            errs, mf, mi = rfft_case(ftt.RfftPlan(n, device=dev), planes(n, b)[0])
            check(max(errs) <= REL_L2_GATE, f"B4a/B4b n={n} B={b}: rel-L2 (rfft vs "
                  f"plain, irfft vs plain, rfft vs np.fft, irfft vs np.fft, round trip) "
                  f"{errs}")
            max_abs_err["B4a"] = max(max_abs_err["B4a"], mf)
            max_abs_err["B4b"] = max(max_abs_err["B4b"], mi)
            worst_b4a = max(worst_b4a, max(errs))
            ran_b4a.append((n, b))
        print(f"B4a (with B4b) at phase 4l's shapes {ran_b4a} pass; worst rel-L2 "
              f"{worst_b4a:.3e} (gate {REL_L2_GATE:g})", flush=True)
        for kernel in ("B7", "B8"):
            ran_dd, worst_dd = [], [0.0, 0.0]
            for n, b in sorted(route_shapes[kernel]):
                e_p, e_h, m_ = dd_case(kernel, n, b)
                worst_dd = [max(worst_dd[0], e_p), max(worst_dd[1], e_h)]
                max_abs_err[kernel] = max(max_abs_err[kernel], m_)
                ran_dd.append((n, b))
            print(f"{kernel} at phase 4l's shapes {ran_dd} x 5 modes pass; worst rel-L2 "
                  f"{worst_dd[0]:.3e} vs plain, {worst_dd[1]:.3e} vs np.fft (gate "
                  f"{DD_GATE:g})", flush=True)
        unchecked = route_shapes["B3"] - set(b3_cases)
        check(route_shapes["B3"] and not unchecked, f"phase 4l gave B3 {unchecked}, "
              f"not among phase 3c's cases")
        print(f"B3 at phase 4l's shapes {sorted(route_shapes['B3'])}: checked in phase 3c",
              flush=True)
        for k, v in sharded_launches.items():
            path_launches[k] += v
        print(f"sharded: phase 4l launches {({k: v for k, v in sharded_launches.items() if v})}"
              f"; runs {t_runs:.1f} s, kernel checks {time.perf_counter() - t0 - t_runs:.1f} s",
              flush=True)

    sharded_runs()

    # 4m. Four gloo ranks on the one card (NCCL takes one rank a card), on a
    # mesh of 4 and a 2x2 one: the exchanges between ranks, their block
    # order and the uneven pad of the one-sided axis, which a one-rank mesh
    # cannot show. Each rank's block against the block of the single-device
    # result; the kernels launched in every rank.
    def four_rank_runs():
        import shutil as shutil_
        import tempfile

        import torch.multiprocessing as tmp

        t0 = time.perf_counter()
        work = tempfile.mkdtemp()
        try:
            context = tmp.start_processes(
                _rank_4m, args=(f"{work}/store", work), nprocs=SHARD_4M_RANKS,
                join=False, start_method="spawn")
            deadline = time.monotonic() + SHARD_4M_TIMEOUT
            try:
                while not context.join(timeout=5):
                    check(time.monotonic() < deadline,
                          f"phase 4m's ranks did not finish in {SHARD_4M_TIMEOUT} s")
            finally:
                for proc in context.processes:
                    if proc.is_alive():
                        proc.terminate()
                    proc.join(10)
            ranks = []
            for r in range(SHARD_4M_RANKS):
                with open(f"{work}/rank{r}.json") as f:
                    ranks.append(json.load(f))
        finally:
            shutil_.rmtree(work, ignore_errors=True)
        for r, res in enumerate(ranks):
            check(res.pop("chunks bitwise"), f"rank {r}: pipeline_chunks=2 differs from one "
                  "chunk")
            for what, case in res.items():
                for label, err in case["errs"].items():
                    check(err <= case["gate"], f"rank {r} {what}: rel-L2 {err:.3e} vs "
                          f"{label} (gate {case['gate']:g})")
            launched = {k for case in res.values() for k in case["launches"]}
            check({"B1", "B5a", "B5b"} <= launched,
                  f"rank {r} launched {sorted(launched)}, not B1, B5a and B5b")
        for what in ranks[0]:
            print(f"4 gloo ranks on the card: {what}: worst rel-L2 " + ", ".join(
                f"{label} {max(res[what]['errs'][label] for res in ranks):.3e}"
                for label in ranks[0][what]["errs"])
                + f" (gate {ranks[0][what]['gate']:g}); launches by rank "
                + str([res[what]["launches"] for res in ranks]), flush=True)
        print(f"4 gloo ranks on the card: pipeline_chunks=2 bitwise in every rank; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    four_rank_runs()

    # 4n. The native FFI (fourier_tpu_torch/ffi): the host C++ core, built by
    # the host compiler with no CMake, against np.fft in f64 and against the
    # port's plans on the card on the same data; its operator under
    # torch.compile(fullgraph=True) on CPU tensors and a CUDA tensor refused;
    # the plan-parity gate; one call timed on the host beside the card's.
    # The card's launches here compare, so they stay out of path_launches.
    def native_ffi_runs():
        from concurrent.futures import ThreadPoolExecutor

        from fourier_tpu_torch import ffi
        from fourier_tpu_torch.ffi import build as ffi_build
        from fourier_tpu_torch.ffi import op as ffi_op
        from fourier_tpu_torch.ffi import plan_parity

        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            so, dump_bin = (f.result() for f in (pool.submit(ffi_build.build_library),
                                                 pool.submit(ffi_build.build_dump_plan)))
        ffi.load_library()
        print(f"native FFI: built {so.name} and {dump_bin.name} under "
              f"build/fourier_tpu_torch/ffi/ with {' '.join(ffi_build.compiler())} "
              f"{' '.join(ffi_build.CXX_FLAGS)} (no CMake) in "
              f"{time.perf_counter() - t0:.2f} s; each: " + ", ".join(
                  f"{k} {v:.2f} s" for k, v in sorted(ffi_build.build_seconds.items())),
              flush=True)
        rng = np.random.default_rng(SEED)
        zero_counts()
        for dtype, card_plan, gate in ((np.complex64, ftt.create_fft_f32, REL_L2_GATE),
                                       (np.complex128, ftt.create_fft_f64, DD_GATE)):
            worst_np = worst_card = 0.0
            for n in FFI_SIZES:
                x = (rng.standard_normal((FFI_ROWS, n))
                     + 1j * rng.standard_normal((FFI_ROWS, n))).astype(dtype)
                plan, cplan = ffi.NativeFftPlan(n, dtype), card_plan(n)
                for mode in Transform:
                    got = x.copy()
                    plan.transform_batch_in_place(got, mode)
                    x64 = x.astype(np.complex128)
                    want = (np.fft.fft(x64, axis=-1) if mode.is_forward
                            else np.fft.ifft(x64, axis=-1) * n) * (mode.scale(n) or 1.0)
                    e_np = rel_l2(got, want)
                    e_card = rel_l2(got, cplan.transform(x, mode))
                    check(e_np <= gate and e_card <= gate,
                          f"native FFI {np.dtype(dtype).name} n={n} {mode.name}: rel-L2 "
                          f"{e_np:.3e} vs np.fft, {e_card:.3e} vs {type(cplan).__name__} "
                          f"on the card (gate {gate:g})")
                    worst_np, worst_card = max(worst_np, e_np), max(worst_card, e_card)
            print(f"native FFI {np.dtype(dtype).name} at n {FFI_SIZES} x {FFI_ROWS} rows x "
                  f"5 modes: worst rel-L2 {worst_np:.3e} vs np.fft (f64), "
                  f"{worst_card:.3e} vs the card's {card_plan.__name__}(n) (gate {gate:g})",
                  flush=True)
        print(f"native FFI: the card's plans launched "
              f"{ {k: v for k, v in counts().items() if v} } (comparisons)", flush=True)

        # The operator in a compiled graph on CPU tensors.
        xc = torch.as_tensor(rng.standard_normal((4, 1013))
                             + 1j * rng.standard_normal((4, 1013)))
        f = torch.compile(lambda a: ffi_op.native_fft(2.0 * a, Transform.SQRT_SCALED_FFT),
                          fullgraph=True, backend="aot_eager")
        e_op = rel_l2(f(xc).numpy(), np.fft.fft(2.0 * xc.numpy(), axis=-1, norm="ortho"))
        check(e_op <= DD_GATE, f"native_fft under torch.compile: rel-L2 {e_op:.3e}")
        # A CUDA tensor is refused: by native_fft, by the operator's dispatcher
        # (no CUDA kernel) and by NativeFftPlan.
        xd = torch.ones(1013, dtype=torch.complex128, device=dev)
        refused = []
        for what, call in (("native_fft", lambda: ffi_op.native_fft(xd, 0)),
                           ("the operator", lambda: ffi_op._native_fft_op(xd, 0)),
                           ("NativeFftPlan", lambda: ffi.NativeFftPlan(
                               1013, np.complex128).transform(xd))):
            try:
                call()
            except (TypeError, NotImplementedError, RuntimeError) as e:
                refused.append(f"{what}: {type(e).__name__}")
            else:
                check(False, f"{what} took a CUDA tensor")
        print(f"native FFI: under torch.compile(fullgraph=True) rel-L2 {e_op:.3e} "
              f"(gate {DD_GATE:g}); a CUDA tensor refused by " + ", ".join(refused),
              flush=True)
        failures = plan_parity.run(dump_bin)
        check(not failures, f"plan parity: {failures}")
        print(f"native FFI: plan parity with the port's plan-time math OK at "
              f"{plan_parity.SIZES} x {list(plan_parity.DTYPES)}", flush=True)

        # One call at FFI_TIME c64: the core on the host, the port on the card.
        n, b = FFI_TIME
        x = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))).astype(
            np.complex64)
        plan = ffi.NativeFftPlan(n, np.complex64)
        host = []
        for _ in range(REPS + 1):
            buf = x.copy()
            t1 = time.perf_counter()
            plan.transform_batch_in_place(buf, Transform.FFT)
            host.append((time.perf_counter() - t1) * 1e3)
        cplan, xd = ftt.create_fft_f32(n), torch.as_tensor(x, device=dev)
        card_ms = []
        for _ in range(REPS + 1):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            yd = cplan.transform(xd, Transform.FFT)
            stop.record()
            torch.cuda.synchronize()
            card_ms.append(start.elapsed_time(stop))
        e_t = rel_l2(buf, yd.cpu().numpy())
        check(e_t <= REL_L2_GATE, f"native FFI {n}x{b}: rel-L2 {e_t:.3e} vs the card")
        with open("/proc/cpuinfo") as info:  # the first processor's fields
            fields = dict(ln.split(":", 1) for ln in info.read().split("\n\n")[0]
                          .splitlines() if ":" in ln)
        cpu = {k.strip(): v.strip() for k, v in fields.items()}
        cpu = (f"{cpu.get('model name', '?')}: {cpu.get('vendor_id', '?')} family "
               f"{cpu.get('cpu family', '?')} model {cpu.get('model', '?')}, "
               f"{os.cpu_count()} CPUs")
        print(f"time: native FFI c64 {n}x{b}, one call (transform_batch_in_place), "
              f"median of {REPS} after one: {float(np.median(host[1:])):.4f} ms on the "
              f"host ({cpu}); create_fft_f32({n}).transform on the card "
              f"{float(np.median(card_ms[1:])):.4f} ms ({smi}); rel-L2 {e_t:.3e}; "
              f"phase 4n {time.perf_counter() - t0:.1f} s", flush=True)

    native_ffi_runs()

    # 5. Timing: CHAIN dependent SQRT_SCALED_FFT calls, median of REPS.
    mode = Transform.SQRT_SCALED_FFT
    tables = plan.tables(True)
    scale = mode.scale(MAIN_N)

    def kernel(a, b):
        return sv.vpu_fft_batch_minor(a, b, MAIN_N, True, scale, tables=tables,
                                      kernel_tables=plan.kernel_fwd,
                                      pair_tables=plan.pair_fwd)

    def plain(a, b):
        return sv.vpu_fft_batch_minor_reference(a, b, MAIN_N, tables, True, scale)

    def entry(a, b):
        return plan.transform_planar_bm(a, b, mode)

    def same_run_ab(what, stage, pair, chain):
        """The stage body against the paired-block body of one kernel on the
        same input, timed stage, pair, pair, stage (median of REPS each);
        returns the pair body's two medians."""
        got = {"stage": [], "pair": []}
        for body in ("stage", "pair", "pair", "stage"):
            fn = stage if body == "stage" else pair
            got[body].append(median_ms(lambda *_: (fn(), None), None, None, chain))
        print(f"time: {what} A/B, same run: stage body {got['stage'][0]:.4f} / "
              f"{got['stage'][1]:.4f} ms, paired-block body {got['pair'][0]:.4f} / "
              f"{got['pair'][1]:.4f} ms (median of {REPS} each, in the order "
              f"stage, pair, pair, stage) on {card}", flush=True)
        return got["pair"]

    def median_ms(step, a, b, chain=CHAIN):
        """Median over REPS of `chain` dependent calls, ms per call."""
        step(a, b)
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            x, y = a, b
            for _ in range(chain):
                x, y = step(x, y)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop) / chain)
        return float(np.median(times))

    flops = 5.0 * MAIN_N * math.log2(MAIN_N) * MAIN_B
    xc = torch.complex(re.T.contiguous(), im.T.contiguous())
    timed = {
        "B1 kernel": median_ms(kernel, re, im),
        "plan.transform_planar_bm": median_ms(entry, re, im),
        "plain PyTorch B1": median_ms(plain, re, im),
        "torch.fft.fft": median_ms(
            lambda a, _b: (torch.fft.fft(a, norm="ortho"), None), xc, None),
    }
    for what, ms in timed.items():
        print(f"time: {what}: {ms:.4f} ms per call, "
              f"{flops / ms / 1e6:.2f} GFLOP/s (n={MAIN_N}, B={MAIN_B}, "
              f"chain {CHAIN}, median of {REPS}) on {card}", flush=True)
    ratio = timed["torch.fft.fft"] / timed["plan.transform_planar_bm"]
    print(f"time: port / torch.fft throughput ratio {ratio:.4f} on {card}",
          flush=True)
    kernel_ms = {"B1": (timed["B1 kernel"], timed["plain PyTorch B1"],
                        timed["torch.fft.fft"])}
    bounds = {"B1": bound(16.0 * MAIN_N * MAIN_B, flops, F32_RATE)}
    print(f"time: B1 n={MAIN_N} B={MAIN_B} kernel {timed['B1 kernel']:.4f} ms, "
          f"{bounds['B1'][0] / timed['B1 kernel']:.4f} of its bound "
          f"{bounds['B1'][0]:.4f} ms ({bounds['B1'][1]}) on {card}", flush=True)

    def b1_bodies(n, a, c, scale_, plan_, tables_):
        """B1's stage and clustered bodies on (a, c), for same_run_ab."""
        return [lambda body=body: sv.vpu_fft_batch_minor(
            a, c, n, True, scale_, tables=tables_, kernel_tables=plan_.kernel_fwd,
            pair_tables=plan_.pair_fwd, _body=body) for body in ("stage", "pair")]

    same_run_ab(f"B1 n={MAIN_N} B={MAIN_B}",
                *b1_bodies(MAIN_N, re, im, scale, plan, tables), CHAIN)
    plan_1k = ftt.create_fft_f32(1024, device="cuda")
    a1k, c1k = planes(1024, 65536)
    same_run_ab("B1 n=1024 B=65536", *b1_bodies(1024, a1k, c1k, 1024 ** -0.5,
                                                  plan_1k, plan_1k.tables(True)), CHAIN)
    del a1k, c1k

    # 5b. B2 at n=1013, B=65536: kernel, plain version, torch.fft.
    n, b = B2_TIME
    plan = ftt.create_fft_f32(n, device="cuda")
    st, scale = plan.stages, mode.scale(n)
    chirps = plan.chirps(True)
    kw = dict(tables=(st.tables(True), st.tables(False)), chirps=chirps,
              pair_tables=(st.pair_fwd, st.pair_inv))
    re, im = planes(n, b)
    xc = torch.complex(re.T.contiguous(), im.T.contiguous())
    flops = 5.0 * n * math.log2(n) * b
    t2 = {
        f"B2 kernel (chain {CHAIN_NEW})": median_ms(
            lambda a, c: sv.vpu_bluestein_batch_minor(
                a, c, n, st.size, scale,
                kernel_tables=(st.kernel_fwd, st.kernel_inv), **kw),
            re, im, CHAIN_NEW),
        f"plain PyTorch B2 (chain {PLAIN_CHAIN})": median_ms(
            lambda a, c: sv.vpu_bluestein_batch_minor_reference(
                a, c, n, st.size, kw["tables"], chirps, scale),
            re, im, PLAIN_CHAIN),
        f"torch.fft.fft (chain {CHAIN_NEW})": median_ms(
            lambda a, _c: (torch.fft.fft(a, norm="ortho"), None), xc, None,
            CHAIN_NEW),
    }
    for what, ms in t2.items():
        print(f"time: {what}: {ms:.4f} ms per call, {flops / ms / 1e6:.2f} "
              f"GFLOP/s (n={n}, B={b}, SQRT_SCALED_FFT, 5 n log2 n, median of "
              f"{REPS}) on {card}", flush=True)
    kernel_ms["B2"] = tuple(t2.values())
    bounds["B2"] = bound(16.0 * n * b, chirp_z_flops(n, st.size) * b, F32_RATE)
    print(f"time: B2 n={n} B={b} kernel {kernel_ms['B2'][0]:.4f} ms, "
          f"{bounds['B2'][0] / kernel_ms['B2'][0]:.4f} of its bound "
          f"{bounds['B2'][0]:.4f} ms ({bounds['B2'][1]}) on {card}", flush=True)
    same_run_ab(f"B2 n={n} B={b}", *[
        lambda body=body: sv.vpu_bluestein_batch_minor(
            re, im, n, st.size, scale, kernel_tables=(st.kernel_fwd, st.kernel_inv),
            _body=body, **kw) for body in ("stage", "pair")], CHAIN_NEW)
    del re, im, xc

    # 5c. B3 at n=65536, B=1024: kernel alone (its (q, p, B) input), the
    # whole FourStepLocalPlan, torch.fft; B3's stage body against its
    # clustered one in the same run; then the plans of B3_PLANS beside torch.fft, each also
    # with B3 on its stage body (the parent's path).
    n, b = B3_TIME
    plan = ftt.create_fft_f32(n, device="cuda")
    p_, q_, rp = plan.p, plan.q, plan.row_plan
    s3 = p_ ** -0.5  # a unitary row leg keeps the chained values bounded
    kw = dict(tables=rp.tables(True), pre_tw=(plan.tw_fwd[0], plan.tw_fwd[1]),
              pair_tables=rp.pair_fwd)
    re, im = planes(n, b)
    xc = torch.complex(re.T.contiguous(), im.T.contiguous())

    def b3(a, c, body=None):
        return sv.vpu_fft_four_step_row(a.view(q_, p_, b), c.view(q_, p_, b), p_,
                                        q_, True, s3, kernel_tables=rp.kernel_fwd,
                                        _body=body, **kw)

    def b3_plain(a, c):
        return sv.vpu_fft_four_step_row_reference(
            a.view(q_, p_, b), c.view(q_, p_, b), p_, q_, kw["tables"],
            kw["pre_tw"], True, s3)

    flops = 5.0 * n * math.log2(n) * b
    t3 = {
        f"B3 kernel (chain {CHAIN_NEW})": median_ms(b3, re, im, CHAIN_NEW),
        f"plain PyTorch B3 (chain {PLAIN_CHAIN})": median_ms(b3_plain, re, im,
                                                           PLAIN_CHAIN),
        f"plan.transform_planar_bm (chain {CHAIN_NEW})": median_ms(
            lambda a, c: plan.transform_planar_bm(a, c, mode), re, im, CHAIN_NEW),
        f"torch.fft.fft (chain {CHAIN_NEW})": median_ms(
            lambda a, _c: (torch.fft.fft(a, norm="ortho"), None), xc, None,
            CHAIN_NEW),
    }
    for what, ms in t3.items():
        rate = (f"{16.0 * n * b / ms / 1e6:.2f} GB/s of 16 n B bytes" if "B3" in what
                else f"{flops / ms / 1e6:.2f} GFLOP/s (5 n log2 n)")
        print(f"time: {what}: {ms:.4f} ms per call, {rate} (n={n}, B={b}, "
              f"median of {REPS}) on {card}", flush=True)
    kernel_ms["B3"] = (*tuple(t3.values())[:2], None)
    bounds["B3"] = bound(16.0 * n * b, (5 * p_ * math.log2(p_) + 6 * p_) * q_ * b,
                         F32_RATE)
    print(f"time: B3 n={n} B={b} kernel {kernel_ms['B3'][0]:.4f} ms, "
          f"{bounds['B3'][0] / kernel_ms['B3'][0]:.4f} of its bound "
          f"{bounds['B3'][0]:.4f} ms ({bounds['B3'][1]}) on {card}", flush=True)
    same_run_ab(f"B3 n={n} B={b}", *[lambda body=body: b3(re, im, body)
                                     for body in ("stage", "pair")], CHAIN_NEW)
    del re, im, xc
    for n, b in B3_PLANS:
        plan = ftt.create_fft_f32(n, device="cuda")
        re, im = planes(n, b)
        xc = torch.complex(re.T.contiguous(), im.T.contiguous())
        step = lambda a, c: plan.transform_planar_bm(a, c, mode)
        got = {"plan": median_ms(step, re, im, CHAIN_NEW)}
        kept = sv.B3_STAGE_FASTER
        sv.B3_STAGE_FASTER = kept | {plan.p}  # the parent's path: B3's stage body
        try:
            got["plan, B3 on its stage body"] = median_ms(step, re, im, CHAIN_NEW)
        finally:
            sv.B3_STAGE_FASTER = kept
        got["plan again"] = median_ms(step, re, im, CHAIN_NEW)
        got["torch.fft.fft"] = median_ms(
            lambda a, _c: (torch.fft.fft(a, norm="ortho"), None), xc, None, CHAIN_NEW)
        print(f"time: four-step n={n} B={b} ({plan.p}, {plan.q}): " + ", ".join(
            f"{what} {ms:.4f} ms" for what, ms in got.items())
              + f" (chain {CHAIN_NEW}, median of {REPS}) on {card}", flush=True)
        del re, im, xc

    # 5d. rfft + irfft round trips at the suite's rows, batch-minor, chained:
    # the fused plan, the same plan's unfused branch around the same inner
    # plan, torch.fft.rfft/irfft on the same data as (B, n), and the plain
    # versions (shorter chain); then each kernel alone, repeated on one input.
    for n, b in RF_TIME:
        plan = ftt.RfftPlan(n, device="cuda")
        plain_f, plain_i = plain_fns(plan)
        x = planes(n, b)[0]
        xb = x.T.contiguous()
        fam = "B4" if plan.even else "B5"
        spec = plan.rfft_planar_bm(x)
        spec_c = torch.complex(spec[0].T.contiguous(), spec[1].T.contiguous())
        trip = {
            f"fused {fam} round trip (chain {RF_CHAIN})": median_ms(
                lambda a, _c: (plan.irfft_planar_bm(*plan.rfft_planar_bm(a)), None),
                x, None, RF_CHAIN),
            f"unfused round trip (chain {RF_CHAIN})": median_ms(
                lambda a, _c: (plan._irfft_bm_unfused(*plan._rfft_bm_unfused(a)),
                               None), x, None, RF_CHAIN),
            f"torch.fft.rfft/irfft round trip (chain {RF_CHAIN})": median_ms(
                lambda a, _c: (torch.fft.irfft(torch.fft.rfft(a), n=n), None),
                xb, None, RF_CHAIN),
            f"plain {fam} round trip (chain {RF_PLAIN_CHAIN})": median_ms(
                lambda a, _c: (plain_i(*plain_f(a)), None), x, None,
                RF_PLAIN_CHAIN),
            f"{fam}a kernel": median_ms(
                lambda *_: (plan._rfft_bm(x), None), None, None, RF_CHAIN),
            f"{fam}b kernel": median_ms(
                lambda *_: (plan._irfft_bm(*spec), None), None, None, RF_CHAIN),
            f"plain {fam}a": median_ms(
                lambda *_: (plain_f(x), None), None, None, RF_PLAIN_CHAIN),
            f"plain {fam}b": median_ms(
                lambda *_: (plain_i(*spec), None), None, None, RF_PLAIN_CHAIN),
            "torch.fft.rfft": median_ms(
                lambda *_: (torch.fft.rfft(xb), None), None, None, RF_CHAIN),
            "torch.fft.irfft": median_ms(
                lambda *_: (torch.fft.irfft(spec_c, n=n), None), None, None,
                RF_CHAIN),
        }
        for what, ms in trip.items():
            print(f"time: rfft n={n} B={b} {what}: {ms:.4f} ms per call "
                  f"(inner {plan_tree(plan)[2]}, median of {REPS}) on {card}",
                  flush=True)
        if (n, b) == (4096, 16384):
            m = n // 2
            kw = dict(tables=plan.inner.tables(True), kernel_tables=plan.inner.kernel_fwd,
                      pair_tables=plan.inner.pair_fwd, w=plan.w)
            same_run_ab(f"B4a n={n} B={b}",
                        lambda: sv.vpu_rfft_pack_batch_minor(x, m, _body="stage", **kw),
                        lambda: sv.vpu_rfft_pack_batch_minor(x, m, _body="pair", **kw),
                        RF_CHAIN)
            ikw = dict(tables=plan.inner.tables(False), kernel_tables=plan.inner.kernel_inv,
                       pair_tables=plan.inner.pair_inv, w=plan.w)
            same_run_ab(f"B4b n={n} B={b}", *[
                lambda body=body: sv.vpu_irfft_unpack_batch_minor(*spec, m, _body=body, **ikw)
                for body in ("stage", "pair")], RF_CHAIN)
            stage_back = lambda re_, im_: sv.vpu_irfft_unpack_batch_minor(
                re_, im_, m, _body="stage", **ikw)
        if (n, b) == (1013, 65536):
            st = plan.inner.stages
            kw = dict(tables=(st.tables(True), st.tables(False)),
                      kernel_tables=(st.kernel_fwd, st.kernel_inv),
                      pair_tables=(st.pair_fwd, st.pair_inv),
                      chirps=plan.inner.chirps(True))
            same_run_ab(f"B5a n={n} B={b}", *[
                lambda body=body: sv.vpu_rfft_odd_pack_batch_minor(
                    x, n, st.size, _body=body, **kw) for body in ("stage", "pair")],
                RF_CHAIN)
            ikw = dict(kw, chirps=plan.inner.chirps(False))
            same_run_ab(f"B5b n={n} B={b}", *[
                lambda body=body: sv.vpu_irfft_odd_unpack_batch_minor(
                    *spec, n, st.size, _body=body, **ikw) for body in ("stage", "pair")],
                RF_CHAIN)
            stage_back = lambda re_, im_: sv.vpu_irfft_odd_unpack_batch_minor(
                re_, im_, n, st.size, _body="stage", **ikw)
        if (n, b) in ((4096, 16384), (1013, 65536)):
            # The parent's path in this run: the fused trip with the inverse
            # on its stage body.
            parent_trip = median_ms(
                lambda a, _c: (stage_back(*plan.rfft_planar_bm(a)), None), x, None, RF_CHAIN)
            print(f"time: rfft n={n} B={b} fused {fam} round trip, {fam}b on its stage "
                  f"body (the parent's path; chain {RF_CHAIN}): {parent_trip:.4f} ms per "
                  f"call, against {trip[f'fused {fam} round trip (chain {RF_CHAIN})']:.4f} "
                  f"(median of {REPS}) on {card}", flush=True)
            library = {"a": trip["torch.fft.rfft"], "b": trip["torch.fft.irfft"]}
            for k in ("a", "b"):
                kernel_ms[fam + k] = (trip[f"{fam}{k} kernel"], trip[f"plain {fam}{k}"],
                                      library[k])
            L = n // 2 + 1
            io = n * b * 4 + L * b * 8  # real plane one way, planar spectrum the other
            if plan.even:
                m = n // 2
                flops = (5 * m * math.log2(m) + 16 * (m + 1)) * b
            else:
                flops = (b + 1) // 2 * chirp_z_flops(n, plan.inner.m_inner) + 8 * L * b
            bounds[fam + "a"] = bounds[fam + "b"] = bound(io, flops, F32_RATE)
        del x, xb, spec, spec_c

    # 5e. The suite's c128 rows, batch-minor, chained SQRT_SCALED_FFT: the
    # plan, its kernel alone, the kernel's plain version and torch.fft.fft on
    # the same complex128 tensor as (B, n); ms, GB/s of the 32 n B bytes a
    # c2c pass moves, and the share of the kernel's bound.
    def dd_row(n, b):
        plan = ftt.create_fft_f64(n)
        scale = mode.scale(n)
        re, im = planes64(n, b)
        xc = torch.complex(re.T.contiguous(), im.T.contiguous())
        tree = plan_tree(plan)
        rows = {
            f"plan.transform_planar_bm (chain {DD_CHAIN})": median_ms(
                lambda a, c: plan.transform_planar_bm(a, c, mode), re, im, DD_CHAIN),
            f"torch.fft.fft (chain {DD_CHAIN})": median_ms(
                lambda a, _c: (torch.fft.fft(a, norm="ortho"), None), xc, None,
                DD_CHAIN),
        }
        if tree[0] == "VpuDdFftPlan":
            k, tb = "B6", plan.tables(True)
            kernel = lambda a, c, body=None: dv.vpu_dd_fft_batch_minor(
                a, c, n, True, scale, tables=tb, kernel_tables=plan.kernel_fwd,
                pair_tables=plan.pair_fwd, _body=body)
            plain = lambda a, c: dv.vpu_dd_fft_batch_minor_reference(
                a, c, n, tb, True, scale)
            kb = bound(32.0 * n * b, 5.0 * n * math.log2(n) * b, F64_RATE)
            args = (re, im)
        elif tree[0] == "VpuDdBluesteinPlan":
            k, st = "B7", plan.stages
            tb, chirps = (st.tables(True), st.tables(False)), plan.chirps(True)
            kernel = lambda a, c: dv.vpu_dd_bluestein_batch_minor(
                a, c, n, st.size, scale, tables=tb,
                kernel_tables=(st.kernel_fwd, st.kernel_inv),
                pair_tables=(st.pair_fwd, st.pair_inv), chirps=chirps)
            plain = lambda a, c: dv.vpu_dd_bluestein_batch_minor_reference(
                a, c, n, st.size, tb, chirps, scale)
            kb = bound(32.0 * n * b, chirp_z_flops(n, st.size) * b, F64_RATE)
            args = (re, im)
        elif tree[0] == "DdSplitRadixPlan":
            k, r = "B8", plan.radix
            m = n // r
            kernel = lambda a, c: dc.dd_split_combine_batch_minor(
                a.view(m, r * b), c.view(m, r * b), n, r, True, scale,
                tables=plan.tw_fwd)
            plain = lambda a, c: dc.dd_split_combine_batch_minor_reference(
                a.view(m, r * b), c.view(m, r * b), n, r, plan.tw_fwd, True, scale)
            kb = bound(32.0 * n * b, (6 * (r - 1) + 2 + {2: 4, 3: 16, 5: 60}[r])
                       * m * b, F64_RATE)
            args = (re, im)
        else:  # the composed Bluestein: its B6 inner alone, at the inner's shape
            k, inner = "B6", plan.inner
            ni = inner.size
            tb = inner.tables(True)
            kernel = lambda a, c: dv.vpu_dd_fft_batch_minor(
                a, c, ni, True, ni ** -0.5, tables=tb, kernel_tables=inner.kernel_fwd,
                pair_tables=inner.pair_fwd)
            plain = lambda a, c: dv.vpu_dd_fft_batch_minor_reference(
                a, c, ni, tb, True, ni ** -0.5)
            kb = bound(32.0 * ni * b, 5.0 * ni * math.log2(ni) * b, F64_RATE)
            args = planes64(ni, b)
        # B8 alone maps (n, B) onto (n, B); run on one input, not chained.
        chain = (lambda f: (lambda *_: (f(*args)[0], None))) if k == "B8" else None
        rows[f"{k} kernel"] = (median_ms(chain(kernel), None, None, DD_CHAIN)
                               if chain else median_ms(kernel, *args, DD_CHAIN))
        rows[f"plain {k}"] = (median_ms(chain(plain), None, None, PLAIN_CHAIN)
                              if chain else median_ms(plain, *args, PLAIN_CHAIN))
        if k == "B7":
            bodies = {body: (lambda body=body: dv.vpu_dd_bluestein_batch_minor(
                re, im, n, st.size, scale, tables=tb,
                kernel_tables=(st.kernel_fwd, st.kernel_inv),
                pair_tables=(st.pair_fwd, st.pair_inv), chirps=chirps,
                _body=body)) for body in ("stage", "pair")}
            same_run_ab(f"B7 n={n} B={b}", bodies["stage"], bodies["pair"], DD_CHAIN)
        if tree[0] == "VpuDdFftPlan" and dv.fft_pair_geometry_dd(n):
            same_run_ab(f"B6 n={n} B={b}", *[lambda body=body: kernel(re, im, body)
                                              for body in ("stage", "pair")], DD_CHAIN)
        for what, ms in rows.items():
            nb = 32.0 * (args[0].shape[0] if "kernel" in what or "plain" in what
                         else n) * b
            share = f", {kb[0] / ms:.4f} of the {k} bound {kb[0]:.4f} ms ({kb[1]})" \
                if what == f"{k} kernel" else ""
            print(f"time: c128 n={n} B={b} {tree} {what}: {ms:.4f} ms per call, "
                  f"{nb / ms / 1e6:.2f} GB/s{share} (median of {REPS}) on {card}",
                  flush=True)
        return k, rows, kb

    for n, b in DD_TIME:
        k, rows, kb = dd_row(n, b)
        if (n, b) in ((1024, 65536), (1013, 65536), (2187, 16384)):
            kernel_ms[k] = (rows[f"{k} kernel"], rows[f"plain {k}"],
                            None if k == "B8" else rows[f"torch.fft.fft (chain {DD_CHAIN})"])
            bounds[k] = kb

    # 5f. B9a and B9b at the bound table's shapes, chained SQRT_SCALED_FFT:
    # the kernel alone, its plain version, the impl="xla" plan (cuBLAS, for
    # information) and torch.fft.fft on the same (B, n) complex64 tensor; the
    # bound from the plan's own summary (flops and min bytes per transform),
    # restated for the tensor cores: 3 TF32 products for each f32 one. Both
    # bodies of each kernel in the same run, fma, mma, mma, fma.
    for kernel_id, n, b in B9_TIME:
        plan = ftt.MxuFftPlan.create(n, impl="pallas", device=dev)
        _, kernel, plain = b9_fns(plan)
        tabs = b9_tables(plan, mode)
        xla = ftt.MxuFftPlan.create(n, impl="xla", device=dev)
        re, im = planes(b, n)
        xc = torch.complex(re, im)
        summary = ftt.summarize(plan)
        kb_ = bound(summary.min_hbm_bytes_per_transform * b,
                    3 * summary.flops_per_transform * b, TF32_RATE)
        rows = {
            f"{kernel_id} kernel": median_ms(lambda a, c: kernel(a, c, *tabs), re, im,
                                             B9_CHAIN),
            f"plain {kernel_id}": median_ms(lambda a, c: plain(a, c, *tabs), re, im,
                                            PLAIN_CHAIN),
            f"impl='xla' plan {plan_tree(xla)[2]}": median_ms(
                lambda a, c: xla.transform_planar(a, c, mode), re, im, B9_CHAIN),
            "torch.fft.fft": median_ms(
                lambda a, _c: (torch.fft.fft(a, norm="ortho"), None), xc, None,
                B9_CHAIN),
        }
        ab = {body: [] for body in B9_BODY_NAMES}
        for body in ("fma", "mma", "mma", "fma"):
            ab[body].append(median_ms(
                lambda a, c: kernel(a, c, *tabs, _body=body), re, im, B9_CHAIN))
        print(f"time: {kernel_id} n={n} B={b} A/B, same run: " + ", ".join(
            f"{B9_BODY_NAMES[body]} {t[0]:.4f} / {t[1]:.4f} ms"
            for body, t in ab.items()) + f" (median of {REPS} each, in the order "
            f"fma, mma, mma, fma); the tensor-core body {min(ab['fma']) / max(ab['mma']):.2f}x "
            f"as fast; {kb_[0] / min(ab['mma']):.4f} and {kb_[0] / min(ab['fma']):.4f} of "
            f"the bound {kb_[0]:.4f} ms ({kb_[1]}) on {card}", flush=True)
        check(kernel_id != "B9b" or max(ab["mma"]) < min(ab["fma"]),
              f"B9b n={n} B={b}: the tensor-core body {ab['mma']} ms is not faster "
              f"than the CUDA-core body {ab['fma']} ms")
        for what, ms in rows.items():
            share = (f", {kb_[0] / ms:.4f} of the bound {kb_[0]:.4f} ms ({kb_[1]})"
                     if "kernel" in what else "")
            print(f"time: {kernel_id} n={n} {(plan.n1, plan.n2)} B={b} {what}: "
                  f"{ms:.4f} ms per call, {summary.flops_per_transform * b / ms / 1e9:.2f} "
                  f"TFLOP/s of the plan's flops{share} (median of {REPS}) on {card}",
                  flush=True)
        if kernel_id not in kernel_ms:  # the first row of each kernel
            kernel_ms[kernel_id] = (rows[f"{kernel_id} kernel"],
                                    rows[f"plain {kernel_id}"], rows["torch.fft.fft"])
            bounds[kernel_id] = kb_
        del re, im, xc

    # 5g. Both bodies of B1, B2, B3, B4b, B5a, B5b and B6 at every size that
    # has a clustered one, about AB_POINTS points a call, timed stage, pair,
    # pair, stage (median of REPS each): the same-run A/B behind the sizes at
    # which the wrappers keep the stage body (B1_STAGE_FASTER,
    # B2_STAGE_FASTER, B3_STAGE_FASTER, B4B_STAGE_FASTER, B5A_STAGE_FASTER,
    # B5B_STAGE_FASTER, B6_STAGE_FASTER).
    def ab_sweep(kernel, sizes, stage_faster, batches=lambda n: (AB_POINTS // n,)):
        """`batches(n)`: the batches timed at length n; with more than one,
        the sizes where the clustered body lost are listed as (size, B)."""
        slower = []
        for size in sizes:
            if kernel == "B4b":
                m, n = size, 2 * size
                rows = m + 1
                plan_ = ftt.RfftPlan(n, backend="vpu", device=dev)
                check(plan_.fused, f"B4b at m={m}: RfftPlan({n}) is not fused")
                kw_ = dict(tables=plan_.inner.tables(False),
                           kernel_tables=plan_.inner.kernel_inv,
                           pair_tables=plan_.inner.pair_inv, w=plan_.w)
                run = lambda a, c, body: sv.vpu_irfft_unpack_batch_minor(
                    a, c, m, _body=body, **kw_)
            elif kernel == "B3":
                p_, q_ = size, B3_AB_Q
                n = rows = p_ * q_
                plan_ = ftt.FourStepLocalPlan.create(
                    n, torch.complex64, p_, q_,
                    lambda m, dt, dv_: ftt.VpuFftPlan.create(m, dt, dv_), device=dev)
                rp_ = plan_.row_plan
                kw_ = dict(tables=rp_.tables(True), kernel_tables=rp_.kernel_fwd,
                           pair_tables=rp_.pair_fwd,
                           pre_tw=(plan_.tw_fwd[0], plan_.tw_fwd[1]))
                run = lambda a, c, body: sv.vpu_fft_four_step_row(
                    a.view(q_, p_, -1), c.view(q_, p_, -1), p_, q_, True, None,
                    _body=body, **kw_)
            elif kernel in ("B1", "B6"):
                n = rows = size
                plan_ = (ftt.VpuFftPlan if kernel == "B1" else ftt.VpuDdFftPlan).create(
                    n, device=dev)
                kw_ = dict(tables=plan_.tables(True), kernel_tables=plan_.kernel_fwd,
                           pair_tables=plan_.pair_fwd)
                wrapper = sv.vpu_fft_batch_minor if kernel == "B1" else dv.vpu_dd_fft_batch_minor
                run = lambda a, c, body: wrapper(a, c, n, True, None, _body=body, **kw_)
            else:
                # The largest n whose inner size is M (odd for B5a and B5b).
                n = rows = size // 2 - (kernel in ("B5a", "B5b") and size % 4 == 0)
                plan_ = ftt.VpuBluesteinPlan.create(n, device=dev)
                st_ = plan_.stages
                check(st_.size == size, f"{kernel} at n={n} plans M={st_.size}, not {size}")
                kw_ = dict(tables=(st_.tables(True), st_.tables(False)),
                           kernel_tables=(st_.kernel_fwd, st_.kernel_inv),
                           pair_tables=(st_.pair_fwd, st_.pair_inv),
                           chirps=plan_.chirps(kernel != "B5b"))
                if kernel == "B2":
                    run = lambda a, c, body: sv.vpu_bluestein_batch_minor(
                        a, c, n, size, None, _body=body, **kw_)
                elif kernel == "B5a":
                    run = lambda a, c, body: sv.vpu_rfft_odd_pack_batch_minor(
                        a, n, size, _body=body, **kw_)
                else:
                    rows = (n + 1) // 2
                    run = lambda a, c, body: sv.vpu_irfft_odd_unpack_batch_minor(
                        a, c, n, size, _body=body, **kw_)
            bs = batches(n)
            for b in bs:
                a, c = planes64(rows, b) if kernel == "B6" else planes(rows, b)
                got = {"stage": [], "pair": []}
                for body in ("stage", "pair", "pair", "stage"):
                    got[body].append(median_ms(lambda *_: (run(a, c, body), None), None,
                                               None, AB_CHAIN))
                ratio = min(got["stage"]) / max(got["pair"])
                if ratio < 1.0:
                    slower.append(size if len(bs) == 1 else (size, b))
                what = {"B1": "n", "B6": "n", "B4b": "m", "B3": "p"}.get(kernel, "M")
                print(f"time: A/B {kernel} {what}={size} (n={n}, "
                      f"B={b}): stage body {got['stage'][0]:.4f} / {got['stage'][1]:.4f} ms, "
                      f"clustered body {got['pair'][0]:.4f} / {got['pair'][1]:.4f} ms, "
                      f"slower stage / faster pair {ratio:.3f}; the wrapper runs the "
                      f"{'stage' if size in stage_faster else 'clustered'} body", flush=True)
                del a, c
        print(f"time: A/B {kernel}: the clustered body was the slower at {slower} in "
              f"this run; the wrapper keeps the stage body at {sorted(stage_faster)} "
              f"(chain {AB_CHAIN}, median of {REPS}, order stage, pair, pair, stage) "
              f"on {card}", flush=True)

    ab_sweep("B1", [n for n in range(64, 2 * sv.PAIR_MAX_M + 1)
                    if sv.fft_pair_geometry(n)], sv.B1_STAGE_FASTER)
    ab_sweep("B2", [m for m in range(64, sv.PAIR_MAX_M + 1)
                    if sv.bluestein_pair_geometry_c64(m)], sv.B2_STAGE_FASTER)
    ab_sweep("B5a", [m for m in range(64, sv.PAIR_MAX_M + 1)
                     if sv.rfft_odd_pack_geometry(m)], sv.B5A_STAGE_FASTER)
    ab_sweep("B5b", [m for m in range(64, sv.PAIR_MAX_M + 1)
                     if sv.irfft_odd_unpack_geometry(m)], sv.B5B_STAGE_FASTER)
    ab_sweep("B4b", [m for m in range(64, sv.PAIR_MAX_M + 1)
                     if sv.irfft_unpack_geometry(m)], sv.B4B_STAGE_FASTER)
    ab_sweep("B6", [n for n in range(64, 2 * sv.PAIR_MAX_M + 1)
                    if dv.fft_pair_geometry_dd(n)], dv.B6_STAGE_FASTER)
    # B3 at a batch that is a multiple of 4 (16-byte copies and stores) and
    # at an odd one (4-byte ones).
    ab_sweep("B3", [p_ for p_ in range(64, 2 * sv.PAIR_MAX_M + 1)
                    if sv.four_step_pair_geometry(p_)], sv.B3_STAGE_FASTER,
             lambda n: ((AB_POINTS // n) & ~3, ((AB_POINTS // n) & ~3) - 1))

    # B9b's bodies at every split of _b9b_sweep_sizes(), about
    # AB_POINTS_B9B points a call, timed fma, mma, mma, fma: the same-run
    # A/B behind B9B_FMA_WORK. One line a split, then a summary: each side
    # of the rule, where it went against the run, and what the rule cost
    # (its body's time over the faster one's, summed over the splits).
    fma_won, against, ratios = [], [], {"fma": [], "mma": []}
    excess = 0.0
    for n in _b9b_sweep_sizes():
        plan_ = ftt.MxuFftPlan.create(n, impl="pallas", device=dev)
        split = (plan_.n1, plan_.n2)
        tabs_ = b9_tables(plan_, mode)
        b = AB_POINTS_B9B // n
        a, c = planes(b, n)
        got = {"fma": [], "mma": []}
        for body in ("fma", "mma", "mma", "fma"):
            got[body].append(median_ms(
                lambda x, y: bk.mxu_fft_two_phase(x, y, *tabs_, _body=body), a, c,
                AB_CHAIN))
        ratio = sum(got["fma"]) / sum(got["mma"])
        runs = bk.two_phase_body(*split)
        if ratio < 1.0:
            fma_won.append(split)
        if (ratio < 1.0) != (runs == "fma"):
            against.append((split, round(ratio, 3)))
            excess += max(ratio, 1.0 / ratio) - 1.0
        ratios[runs].append(ratio)
        print(f"time: A/B B9b n={n} {split} B={b}: CUDA-core body {got['fma'][0]:.4f} / "
              f"{got['fma'][1]:.4f} ms, tensor-core body {got['mma'][0]:.4f} / "
              f"{got['mma'][1]:.4f} ms, fma / mma {ratio:.3f}; the wrapper runs the "
              f"{B9_BODY_NAMES[runs]}", flush=True)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tpb, threads = bk.two_phase_geometry(*split, b, sms)
        if n == B9B_WIDE_N and threads <= bk.SMALL_THREADS:
            # The CUDA-core body's blocks with 32 idle threads more take its
            # 1024-bound instantiation (64 registers a thread): what the
            # 512-bound one (128) gains, in this run.
            def wide(x, y):
                out = torch.empty_like(x), torch.empty_like(y)
                build.call(bk.library(), "fourier_dft_two_phase_c64", "B9b wide",
                           x.data_ptr(), y.data_ptr(), out[0].data_ptr(),
                           out[1].data_ptr(), *(t.data_ptr() for t in tabs_),
                           *split, b, tpb, threads + 32, dev.index, sv.stream_of(x))
                return out
            werr, _ = vs_plain(wide(a, c), bk.mxu_fft_two_phase(a, c, *tabs_, _body="fma"))
            check(werr <= REL_L2_GATE, f"B9b on the 1024-bound instantiation: "
                  f"rel-L2 {werr:.3e} against the CUDA-core body")
            print(f"time: B9b n={n} {split} B={b} CUDA-core body, {threads + 32} threads "
                  f"(1024-bound): {median_ms(wide, a, c, AB_CHAIN):.4f} ms per call, "
                  f"against {min(got['fma']):.4f} on {threads} (512-bound) on {card}",
                  flush=True)
        del a, c
    print(f"time: A/B B9b fma / mma (count, min, median, max) where the wrapper runs "
          f"the CUDA-core body (n * (n1 + n2) < {bk.B9B_FMA_WORK}) and the "
          "tensor-core body: " + "; ".join(
              f"{body} {len(v)}, {min(v):.3f}, {float(np.median(v)):.3f}, {max(v):.3f}"
              for body, v in ratios.items() if v), flush=True)
    print(f"time: A/B B9b: the CUDA-core body was the faster at {len(fma_won)} of "
          f"{sum(map(len, ratios.values()))} splits in this run; the wrapper's choice "
          f"went against this run at {len(against)}: {against}, costing {excess:.3f} "
          f"of one split's time in all (chain {AB_CHAIN}, median of {REPS}, "
          f"order fma, mma, mma, fma) on {card}", flush=True)

    # 5h. The surface's entry points on tensors already on the card (phase
    # 4i's inputs), SURF_CHAIN calls, median of REPS, each beside the
    # matching torch.fft call (for a DCT/DST or the FHT: the real FFTs it
    # runs, alone) and beside its byte bound: one read of the input and one
    # write of the output at HBM_RATE. fft2 and rfft2 also on the literal
    # port's layout (each axis moved last, the batch-major calls, the
    # unfused rfft pack), the layout that ndim.py does not take.
    def surface_times(s):
        c64 = torch.complex64

        def t_ms(fn):
            return median_ms(lambda *_: (fn(), None), None, None, SURF_CHAIN)

        def nbytes(*ts):
            return sum(t.numel() * t.element_size() for t in ts)

        def literal_c2c(y, axes):
            """The JAX package's N-D layout: each axis moved last, the plan's
            batch-major call, moved back."""
            for axis in axes:
                p = ftt.create_fft(y.shape[axis], y.dtype, device=dev)
                t = y.movedim(axis, -1)
                y = torch.complex(*p.transform_planar(t.real, t.imag)).movedim(-1, axis)
            return y

        def literal_rfft2(x):
            spec = rfft_module._rfft_plan(x.shape[-1], c64, dev).rfft(x)
            return literal_c2c(spec, (0,))

        x2, x3, x3d, xr, spec = s["x2"], s["x3"], s["x3d"], s["xr"], s["spec"]
        xo, spec_o, xd, xt, a, big = (s[k] for k in ("xo", "spec_o", "xd", "xt", "a",
                                                     "big"))
        dln, mu, offset, bias = SURF_FHT_ARGS
        n0, n1 = SURF_2D
        check(rel_l2(host_c(literal_c2c(x2, (1, 0))), host_c(ftt.fft2(x2))) <= REL_L2_GATE
              and rel_l2(host_c(literal_rfft2(xr)), host_c(ftt.rfft2(xr))) <= REL_L2_GATE,
              "the literal layout's fft2/rfft2 differ from the port's")
        rp = rfft_module._rfft_plan(2 * SURF_DCTN[0], c64, dev)
        u = torch.cat([xd, xd.flip(0)]).contiguous()
        cp = ftt.create_fft(SURF_DCTN[0], c64, device=dev)
        fp = rfft_module._rfft_plan(SURF_FHT[1], torch.complex128, dev)
        a_t = a.T.contiguous()
        rows = [
            (f"fft2 {SURF_2D} c64", lambda: ftt.fft2(x2), "torch.fft.fft2",
             lambda: torch.fft.fft2(x2), nbytes(x2, x2)),
            (f"fft2 {SURF_2D} c64, literal layout", lambda: literal_c2c(x2, (1, 0)),
             None, None, nbytes(x2, x2)),
            (f"ifft2 {SURF_2D} c64", lambda: ftt.ifft2(x2), "torch.fft.ifft2",
             lambda: torch.fft.ifft2(x2), nbytes(x2, x2)),
            (f"fftn {SURF_3D} c64", lambda: ftt.fftn(x3), "torch.fft.fftn",
             lambda: torch.fft.fftn(x3), nbytes(x3, x3)),
            (f"ifftn {SURF_3D} c64", lambda: ftt.ifftn(x3), "torch.fft.ifftn",
             lambda: torch.fft.ifftn(x3), nbytes(x3, x3)),
            (f"fftn {SURF_3D} c128", lambda: ftt.fftn(x3d), "torch.fft.fftn",
             lambda: torch.fft.fftn(x3d), nbytes(x3d, x3d)),
            (f"rfft2 {SURF_2D} f32", lambda: ftt.rfft2(xr), "torch.fft.rfft2",
             lambda: torch.fft.rfft2(xr), nbytes(xr, spec)),
            (f"rfft2 {SURF_2D} f32, literal layout", lambda: literal_rfft2(xr), None,
             None, nbytes(xr, spec)),
            (f"irfft2 {SURF_2D} c64", lambda: ftt.irfft2(spec, shape=SURF_2D),
             "torch.fft.irfft2", lambda: torch.fft.irfft2(spec, s=SURF_2D),
             nbytes(spec, xr)),
            (f"hfft2 {SURF_2D} c64", lambda: ftt.hfft2(spec, shape=SURF_2D),
             "torch.fft.hfft2", lambda: torch.fft.hfft2(spec, s=SURF_2D), nbytes(spec, xr)),
            (f"ihfft2 {SURF_2D} f32", lambda: ftt.ihfft2(xr), "torch.fft.ihfft2",
             lambda: torch.fft.ihfft2(xr), nbytes(xr, spec)),
            (f"rfftn {SURF_ODD} f32", lambda: ftt.rfftn(xo), "torch.fft.rfftn",
             lambda: torch.fft.rfftn(xo), nbytes(xo, spec_o)),
            (f"irfftn {SURF_ODD} c64", lambda: ftt.irfftn(spec_o, shape=SURF_ODD),
             "torch.fft.irfftn", lambda: torch.fft.irfftn(spec_o, s=SURF_ODD),
             nbytes(spec_o, xo)),
            (f"dctn type 2 {SURF_DCTN} f32", lambda: ftt.dctn(xd, 2),
             "its rfft, one of its two passes", lambda: rp.rfft_planar_bm(u), nbytes(xd, xd)),
            (f"dstn type 2 {SURF_DCTN} f32", lambda: ftt.dstn(xd, 2),
             "its rfft, one of its two passes", lambda: rp.rfft_planar_bm(u), nbytes(xd, xd)),
            (f"idctn type 2 {SURF_DCTN} f32", lambda: ftt.idctn(xd, 2),
             "its c2c, one of its two passes", lambda: cp.transform_planar_bm(
                 xd, xd, Transform.UNSCALED_IFFT), nbytes(xd, xd)),
            *[(f"{kind} type {type_} {SURF_DCT} f32",
               lambda kind=kind, type_=type_: getattr(ftt, kind)(xt, type_), None, None,
               nbytes(xt, xt)) for kind in ("dct", "dst") for type_ in (1, 2, 3, 4)],
            (f"fht {SURF_FHT} f64", lambda: ftt.fht(a, dln, mu, offset, bias),
             "its rfft + irfft", lambda: fp.irfft_planar_bm(*fp.rfft_planar_bm(a_t)),
             nbytes(a, a)),
            (f"ifht {SURF_FHT} f64", lambda: ftt.ifht(big, dln, mu, offset, bias),
             "its rfft + irfft", lambda: fp.irfft_planar_bm(*fp.rfft_planar_bm(a_t)),
             nbytes(a, a)),
            (f"fftshift {SURF_2D} c64", lambda: ftt.fftshift(x2), "torch.fft.fftshift",
             lambda: torch.fft.fftshift(x2), nbytes(x2, x2)),
            (f"transform_planar {SURF_2D} c64 (last axis)",
             lambda: ftt.transform_planar(x2.real, x2.imag, Transform.FFT),
             "torch.fft.fft", lambda: torch.fft.fft(x2), nbytes(x2, x2)),
        ]
        timed_ms = {}
        for what, port, lib_name, lib, moved in rows:
            ms = timed_ms[what] = t_ms(port)
            bound_ms = moved / HBM_RATE * 1e3
            beside = ""
            if lib is not None:
                lib_ms = t_ms(lib)
                beside = (f", {lib_name} {lib_ms:.4f} ms (port / it "
                          f"{ms / lib_ms:.3f})")
            print(f"time: surface {what}: {ms:.4f} ms per call{beside}, byte bound "
                  f"{bound_ms:.4f} ms ({bound_ms / ms:.4f} of it; chain {SURF_CHAIN}, "
                  f"median of {REPS}) on {card}", flush=True)

        # Where an entry point's time goes: its kernels' device time in one
        # call under torch.profiler, largest first, beside the call's time
        # above (the rest is the card idle, waiting for the host).
        from torch.profiler import ProfilerActivity, profile

        def kernel_name(key):
            key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
            return key.split("(")[0][:70]

        for what, port, *_ in rows:
            if not what.startswith(("fft2", "ifft2", "rfft2", "irfftn", "dctn", "idctn",
                                    "fht", "transform_planar")):
                continue
            port()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                port()
                torch.cuda.synchronize()
            kern = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                           for e in prof.key_averages() if e.self_device_time_total > 0),
                          key=lambda r: -r[2])
            device_ms = sum(ms for _, _, ms in kern)
            print(f"profile: surface {what}: {device_ms:.4f} ms of device time in "
                  f"{sum(c for _, c, _ in kern)} kernels, {device_ms / timed_ms[what]:.3f} of "
                  f"its {timed_ms[what]:.4f} ms: " + "; ".join(
                      f"{kernel_name(k)} x{c} {ms:.4f}" for k, c, ms in kern[:6])
                  + f" on {card}", flush=True)

    def host_c(t):
        return t.detach().cpu().numpy().astype(np.complex128)

    surface_times(surface)
    del surface

    # 5i. The slice's entry points on tensors already on the card (phase
    # 4j's inputs), SURF_CHAIN calls, median of REPS, each beside its byte
    # bound (one read of each input and one write of the output at
    # HBM_RATE), the share of one call's time that torch.profiler finds in
    # kernels on the device, and the PyTorch calls that compute the same
    # result where there are some: torch.stft / torch.istft (the same window
    # and hop) for stft, istft and StftPlan, torch.fft.rfft2 -> product ->
    # irfft2 for fftconvolve, torch.fft.fft -> mask -> ifft for hilbert. They
    # are comparators only. The backend's calls take numpy arrays and are not
    # timed here.
    def signal_times(s):
        from torch.profiler import ProfilerActivity, profile

        def t_ms(fn):
            return median_ms(lambda *_: (fn(), None), None, None, SURF_CHAIN)

        def nbytes(*ts):
            flat = [t for x in ts for t in (x if isinstance(x, (tuple, list)) else (x,))]
            return sum(t.numel() * t.element_size() for t in flat)

        img, psf, sig, sig2, bank = (s[k] for k in ("img", "psf", "sig", "sig2", "bank"))
        conv, conv128, rows, im2, aud, rowsc, sp = (
            s[k] for k in ("conv", "conv128", "rows", "im2", "aud", "rowsc", "sp"))
        nper, hop = SIG_STFT
        stft_kw = dict(nperseg=nper, noverlap=nper - hop)
        welch_kw = dict(nperseg=SIG_WELCH)
        (rb, rn), rnum = SIG_RESAMPLE
        m, f1, f2 = SIG_BAND
        w, a = np.exp(-2j * np.pi * (f2 - f1) / m), np.exp(2j * np.pi * f1)
        zxx = ftt.stft(sig, **stft_kw)[2]
        sre, sim = sp.stft_planar(sig)
        sig64 = sig.double()
        records = sig.reshape(-1, SIG_WELCH)
        window = torch.hann_window(nper, periodic=True, device=dev)
        fshape = [a_ + b_ - 1 for a_, b_ in zip(SIG_IMAGE, SIG_PSF)]
        start = [(p - 1) // 2 for p in SIG_PSF]

        def torch_fftconvolve():
            y = torch.fft.irfft2(torch.fft.rfft2(img, s=fshape) * torch.fft.rfft2(psf, s=fshape),
                                 s=fshape)
            return y[start[0]:start[0] + SIG_IMAGE[0], start[1]:start[1] + SIG_IMAGE[1]]

        hmask = torch.zeros(SIG_ROWS[1], device=dev)
        hmask[0] = hmask[SIG_ROWS[1] // 2] = 1.0
        hmask[1:SIG_ROWS[1] // 2] = 2.0
        tz = torch.stft(sig, nper, hop, window=window, center=True, return_complex=True)
        rows_ = [
            (f"fftconvolve {SIG_IMAGE} * {SIG_PSF} same f32",
             lambda: ftt.fftconvolve(img, psf, "same"), (img, psf),
             "torch.fft.rfft2 -> product -> irfft2", torch_fftconvolve),
            (f"correlate {SIG_IMAGE} x {SIG_PSF} same f32",
             lambda: ftt.correlate(img, psf, "same"), (img, psf), None, None),
            (f"fftconvolve {SIG_IMAGE} * {SIG_PSF} same complex128",
             lambda: ftt.fftconvolve(img, psf, "same", dtype=torch.complex128), (img, psf),
             None, None),
            (f"oaconvolve {SIG_AUDIO} * FIRs of {SIG_FIR} f32",
             lambda: ftt.oaconvolve(sig, bank, axes=-1), (sig, bank), None, None),
            (f"ConvolvePlan({SIG_FIR} taps) on {SIG_AUDIO} f32", lambda: conv(sig), (sig,),
             None, None),
            (f"ConvolvePlan({SIG_FIR} taps, complex128) on {SIG_AUDIO}",
             lambda: conv128(sig), (sig,), None, None),
            (f"hilbert {SIG_ROWS} f32", lambda: ftt.hilbert(rows), (rows,),
             "torch.fft.fft -> mask -> ifft",
             lambda: torch.fft.ifft(torch.fft.fft(rows) * hmask)),
            (f"hilbert2 {SURF_2D} f32", lambda: ftt.hilbert2(im2), (im2,), None, None),
            (f"resample ({rb}, {rn}) to {rnum} f32", lambda: ftt.resample(aud, rnum), (aud,),
             None, None),
            (f"czt {SIG_ROWS} c64 to {m} points", lambda: ftt.czt(rowsc, m, w, a), (rowsc,),
             None, None),
            (f"zoom_fft {SIG_ROWS} c64 to {m} points",
             lambda: ftt.zoom_fft(rowsc, [f1, f2], m, fs=1), (rowsc,), None, None),
            (f"stft {SIG_AUDIO} nperseg {nper} hop {hop} f32",
             lambda: ftt.stft(sig, **stft_kw)[2], (sig,), "torch.stft (center=False)",
             lambda: torch.stft(sig, nper, hop, window=window, center=False,
                                return_complex=True)),
            (f"istft {tuple(zxx.shape)} nperseg {nper} hop {hop}",
             lambda: ftt.istft(zxx, **stft_kw)[1], (zxx,),
             "torch.istft (center=True: it refuses center=False with a Hann window)",
             lambda: torch.istft(tz, nper, hop, window=window, center=True)),
            (f"StftPlan({nper}, hop={hop}).stft_planar {SIG_AUDIO}",
             lambda: sp.stft_planar(sig), (sig,), "torch.stft (center=False)",
             lambda: torch.stft(sig, nper, hop, window=window, center=False,
                                return_complex=True)),
            (f"StftPlan({nper}, hop={hop}).istft_planar", lambda: sp.istft_planar(sre, sim),
             (sre, sim), "torch.istft (center=True)",
             lambda: torch.istft(tz, nper, hop, window=window, center=True)),
            (f"welch {SIG_AUDIO} nperseg {SIG_WELCH} f32",
             lambda: ftt.welch(sig, **welch_kw)[1], (sig,), None, None),
            (f"welch {SIG_AUDIO} nperseg {SIG_WELCH} median f32",
             lambda: ftt.welch(sig, average="median", **welch_kw)[1], (sig,), None, None),
            (f"csd {SIG_AUDIO} nperseg {SIG_WELCH} f32",
             lambda: ftt.csd(sig, sig2, **welch_kw)[1], (sig, sig2), None, None),
            (f"coherence {SIG_AUDIO} nperseg {SIG_WELCH} f32",
             lambda: ftt.coherence(sig, sig2, **welch_kw)[1], (sig, sig2), None, None),
            (f"spectrogram {SIG_AUDIO} nperseg {SIG_WELCH} f32",
             lambda: ftt.spectrogram(sig, **welch_kw)[2], (sig,), None, None),
            (f"periodogram {tuple(records.shape)} f32",
             lambda: ftt.periodogram(records)[1], (records,), None, None),
            (f"welch {SIG_AUDIO} nperseg {SIG_WELCH} f64 (complex128)",
             lambda: ftt.welch(sig64, **welch_kw)[1], (sig64,), None, None),
        ]
        for what, port, inputs, lib_name, lib in rows_:
            ms = t_ms(port)
            bound_ms = (nbytes(*inputs) + nbytes(port())) / HBM_RATE * 1e3
            port()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                port()
                torch.cuda.synchronize()
            kern = sorted(((e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
                            .split("(")[0][:60], e.count, e.self_device_time_total / 1e3)
                           for e in prof.key_averages() if e.self_device_time_total > 0),
                          key=lambda r: -r[2])
            device_ms = sum(ms_ for _, _, ms_ in kern)
            beside = ""
            if lib is not None:
                lib_ms = t_ms(lib)
                beside = f", {lib_name} {lib_ms:.4f} ms (port / it {ms / lib_ms:.3f})"
            print(f"time: signal {what}: {ms:.4f} ms per call{beside}, byte bound "
                  f"{bound_ms:.4f} ms ({bound_ms / ms:.4f} of it), device time "
                  f"{device_ms:.4f} ms in one profiled call ({device_ms / ms:.3f} of the "
                  f"call's time; chain {SURF_CHAIN}, median of {REPS}): " + "; ".join(
                      f"{k} x{c} {ms_:.4f}" for k, c, ms_ in kern[:5]) + f" on {card}",
                  flush=True)

    signal_times(slice_inputs)
    del slice_inputs

    # 5j. The comparative suite's rows at one size a family, the large and
    # rfft rows among them (tools/bench_suite.py, the full run's code):
    # the port, torch.fft and the host libraries, each row within its gate.
    def suite_rows():
        from fourier_tpu_torch.tools import bench_suite

        t0 = time.perf_counter()
        # The host columns at SUITE_HOST_ROWS rows and SUITE_HOST_ITERS calls
        # (scaled to the row's batch, as the suite scales its 8192): this
        # phase checks the rows; the full run keeps the suite's depth.
        depth = bench_suite._HOST_ROW_CAP, bench_suite.HOST_ITERS
        bench_suite._HOST_ROW_CAP, bench_suite.HOST_ITERS = SUITE_HOST_ROWS, SUITE_HOST_ITERS
        try:
            rows = bench_suite.run(max_sizes=1, device=dev)
        finally:
            bench_suite._HOST_ROW_CAP, bench_suite.HOST_ITERS = depth
        for row in rows:
            gate = DD_GATE if row["dtype"] == "c128" else SUITE_GATE
            check(row["rel_l2"] <= gate, f"suite {row['family']} n={row['n']} "
                  f"{row['dtype']} {row['direction']}: rel-L2 {row['rel_l2']:.3e} (gate "
                  f"{gate:g})")
            check(all(f"{k}_us" in row for k in ("fourier_tpu_torch", "torch_fft", "numpy",
                                                  "scipy")),
                  f"suite row lacks a time: {row}")
        check(len(rows) == SUITE_ROWS, f"the suite ran {len(rows)} rows, not {SUITE_ROWS}")
        print(f"suite: {len(rows)} rows (one size a family, the large and rfft rows) "
              "within their gates; port / torch.fft us a transform: " + "; ".join(
                  f"{r['family']} {r['n']} {r['dtype']} {r['direction']} "
                  f"{r['fourier_tpu_torch_us']} / {r['torch_fft_us']}" for r in rows)
              + f" on {card}; {time.perf_counter() - t0:.1f} s", flush=True)

    suite_rows()

    # 5k. The sharded plans on the one-rank mesh beside the port's own
    # single-device call and torch.fft on the same tensor: ms a call
    # (SURF_CHAIN calls, median of REPS) and the byte bound (the input read
    # once, the output written once at HBM_RATE): what the sharded layout
    # and the rank's exchanges cost over the single-device route. Beside
    # each call's time, the host's time to issue it (SURF_CHAIN calls with
    # no synchronisation between them, median of REPS): near the call's own
    # time where the host, not the card, sets the pace. (torch.profiler's
    # record of one sharded call held only part of its kernels, a memcpy
    # and unnamed entries, so it does not read the device's share here.)
    def sharded_times():
        from fourier_tpu_torch import parallel

        t0 = time.perf_counter()

        def t_ms(fn):
            return median_ms(lambda *_: (fn(), None), None, None, SURF_CHAIN)

        def host_ms(fn):
            fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(REPS):
                start = time.perf_counter()
                for _ in range(SURF_CHAIN):
                    fn()
                times.append((time.perf_counter() - start) * 1e3 / SURF_CHAIN)
                torch.cuda.synchronize()
            return float(np.median(times))

        def rand(*shape):
            return torch.complex(torch.randn(*shape, generator=gen, device=dev),
                                 torch.randn(*shape, generator=gen, device=dev))

        def row(what, nbytes, calls):
            times = [(label, t_ms(fn), host_ms(fn)) for label, fn in calls]
            print(f"sharded time: {what}: " + "; ".join(
                f"{label} {ms:.4f} ms (host {h:.4f})" for label, ms, h in times)
                + f"; byte bound {nbytes / HBM_RATE * 1e3:.4f} ms; sharded / "
                f"single-device {times[0][1] / times[-2][1]:.3f}, / torch.fft "
                f"{times[0][1] / times[-1][1]:.3f} on {card}", flush=True)

        b, n1, n2 = SHARD_FFT2
        x = rand(b, n1, n2)
        plan2 = parallel.Fft2dPlan(n1, n2, meshes["fft"])
        chunked = parallel.Fft2dPlan(n1, n2, meshes["fft"], pipeline_chunks=SHARD_CHUNKS)
        row(f"Fft2dPlan({n1}, {n2}) {b}x c64", 16.0 * x.numel(), [
            ("Fft2dPlan.fft_planar", lambda: plan2.fft_planar(x.real, x.imag)),
            (f"pipeline_chunks={SHARD_CHUNKS}", lambda: chunked.fft_planar(x.real, x.imag)),
            ("ftt.fft2", lambda: ftt.fft2(x)), ("torch.fft.fft2", lambda: torch.fft.fft2(x))])
        del x, plan2, chunked
        p1, p2 = SHARD_FOUR[0]
        xf = rand(p1 * p2)
        fs = parallel.FourStepPlan(p1, p2, meshes["fft"], natural_order=True)
        one = ftt.create_fft_f32(p1 * p2, device=dev)
        row(f"FourStepPlan({p1}, {p2}, natural_order=True) c64", 16.0 * xf.numel(), [
            ("FourStepPlan.fft_planar",
             lambda: fs.fft_planar(xf.real.view(p1, p2), xf.imag.view(p1, p2))),
            (f"create_fft_f32({p1 * p2}).fft", lambda: one.fft(xf)),
            ("torch.fft.fft", lambda: torch.fft.fft(xf))])
        del xf, fs, one
        xr = torch.randn(*SHARD_3D, generator=gen, device=dev)
        r3 = parallel.Rfft3dPlan(*SHARD_3D, meshes["xy"])
        r3s = parallel.Rfft3dPlan(*SHARD_3D, meshes["xy"], spectral_output=True)
        out_bytes = 8.0 * math.prod(SHARD_3D[:2]) * r3.out_len
        row(f"Rfft3dPlan{SHARD_3D} f32 on 1x1 pencils", 4.0 * xr.numel() + out_bytes, [
            ("Rfft3dPlan.rfft_planar", lambda: r3.rfft_planar(xr)),
            ("spectral_output=True", lambda: r3s.rfft_planar(xr)),
            ("ftt.rfftn", lambda: ftt.rfftn(xr)), ("torch.fft.rfftn", lambda: torch.fft.rfftn(xr))])
        print(f"sharded time: phase 5k {time.perf_counter() - t0:.1f} s", flush=True)

    sharded_times()
    dist.destroy_process_group()

    kernels = (
        ("B1", "B1 fused Stockham c64 (vpu_fft_batch_minor; clustered-block body, "
         "the stage body of stockham_vpu.cu at the other n)", 422),
        ("B2", "B2 fused Bluestein c64 (vpu_bluestein_batch_minor; paired-block "
         "body, the stage body of stockham_vpu.cu at the other M)", 881),
        ("B3", "B3 four-step row leg c64 (vpu_fft_four_step_row; clustered-block "
         "body, the stage body of stockham_vpu.cu at the other p)", 778),
        ("B4a", "B4a even-n rfft pack (vpu_rfft_pack_batch_minor; paired-block "
         "body, the stage body of stockham_vpu.cu for odd m and m > 2048)", 529),
        ("B4b", "B4b even-n irfft unpack (vpu_irfft_unpack_batch_minor; paired-block "
         "body, the stage body of stockham_vpu.cu for odd m and m > 2048)", 574),
        ("B5a", "B5a odd-n rfft two-for-one (vpu_rfft_odd_pack_batch_minor; "
         "paired-block body, the stage body of stockham_vpu.cu at the other M)", 1029),
        ("B5b", "B5b odd-n irfft two-for-one (vpu_irfft_odd_unpack_batch_minor; "
         "paired-block body, the stage body of stockham_vpu.cu at the other M)", 1051),
    )
    dd_kernels = (
        ("B6", "B6 fused Stockham c128 f64 (vpu_dd_fft_batch_minor; clustered-block "
         "body, the stage body of stockham_vpu_dd.cu at the other n)",
         "stockham_vpu_dd.py:344"),
        ("B7", "B7 fused Bluestein c128 f64 (vpu_dd_bluestein_batch_minor; "
         "paired-block body)",
         "stockham_vpu_dd.py:465"),
        ("B8", "B8 split combine c128 f64 (dd_split_combine_batch_minor)",
         "dd_combine.py:58"),
    )
    b9_kernels = (
        ("B9a", "B9a dense DFT product c64 (mxu_fft_single; 3xTF32 on the tensor "
         "cores)", "bailey.py:81"),
        ("B9b", "B9b fused two-phase DFT c64 (mxu_fft_two_phase; 3xTF32 on the "
         "tensor cores)", "bailey.py:92"),
    )
    pair_libs = {"B1": sv.FFT_PAIR_LIBRARY, "B2": sv.BLUESTEIN_PAIR_LIBRARY,
                 "B3": sv.FOUR_STEP_PAIR_LIBRARY,
                 "B4a": sv.PAIR_LIBRARY, "B4b": sv.IRFFT_UNPACK_PAIR_LIBRARY,
                 "B5a": sv.RFFT_ODD_PAIR_LIBRARY, "B5b": sv.IRFFT_ODD_PAIR_LIBRARY,
                 "B6": dv.FFT_PAIR_DD_LIBRARY}
    rows = ([(k, name, pair_libs.get(k, sv.LIBRARY),
              f"stockham_vpu.py:{line}") for k, name, line in kernels]
            + [(k, name, pair_libs.get(k, dv.LIBRARY), where)
               for k, name, where in dd_kernels]
            + [(k, name, bk.MMA_LIBRARY, where) for k, name, where in b9_kernels])
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"fourier_tpu_torch/csrc/{lib}.cu",
        "replaces": f"fourier_tpu/ops/pallas/{where}",
        "launches": path_launches[k],
        "max_abs_err": max_abs_err[k],
        "ms": kernel_ms[k][0],
        "plain_ms": kernel_ms[k][1],
        "bound_ms": bounds[k][0],
        "bound_by": bounds[k][1],
        "library_ms": kernel_ms[k][2],
    } for k, name, lib, where in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
