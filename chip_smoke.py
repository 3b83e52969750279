#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the repository root; one CUDA card,
                                 # nvcc and nvidia-smi on the machine

It imports nothing of JAX or of the JAX package: the port carries its own
host setup.  Phases, in order (any failure exits non-zero before the
result lines):

1. toolchain record: Python, torch and CUDA versions, nvcc, the card;
2. build every kernel of pyamg_tpu_torch/csrc with nvcc (one process per
   source, all started together);
3. the port's host smoothed-aggregation setup of BASELINE config 1 (2-D
   5-point Poisson, 2048^2, Jacobi omega=4/3 before and after) and its
   compile to the card (coarse_cutoff=1024, float32 hierarchy + float64
   A64);
4. the device-built hierarchy of the same operator on the card
   (device_sa_setup, float32, max_coarse=400, float64 A64): the setup
   time of a second call after a warm one, and each level's forms; then
   the same with lane_align=True (the interleaved route's layout);
5. each kernel against its plain PyTorch twin on the same inputs, at the
   paths' shapes: the host-built level-0 and level-1 DIA operators in
   float32 and float64 (three DIA modes) and tentative operators T, T^T;
   the device-built level-0 and level-1 zero-entry chain (K5) and level
   0's Jacobi-plus-residual (K4), each with its strip march's plan, equal
   to its per-row kernel bit for bit, two launches bit-identical, and its
   composed alternative timed beside it, and the two SpMV epilogues on
   level 0's S and S^T; the K-lane kernels at K = 8 on the device-built
   level-0 and level-1 operators (K8 in its three modes, K9, K11) and K9
   and K8 plain at host level 0, K8 and K9 also bit for bit against their
   thread-per-row form; K10 at host levels 0 and 1 (K = 8, and K = 19
   at level 0), bit for bit against its thread-per-row form in one
   launch a call, and K12, K13 on the host-built T at K = 8; K15's five
   modes on the
   lane-aligned level-0 operators at K = 8; K6 on the host-built T equal
   to its per-row kernel bit for bit, with its plan printed: max error,
   CUDA-event times of both, the bound from the bytes and operations the
   call needs, and one PyTorch library call as a yardstick where one
   computes the same function (never on the path); the transposes (K7,
   K13) and K12 launched twice, bit-identical, the transposes equal to the
   CPU twins bit for bit, with their column plan's build time and size;
   K12 and K13 one launch per call; K11's branch at each shape (the strip
   march's plan, or the per-row kernel), the strip march equal to the
   per-row kernel bit for bit and two launches bit-identical, its composed
   alternative (K10, then K8's scale epilogue) timed beside it, at K = 16
   in float64 (lane groups) and on a 3-D 7-point pattern whose +-n^2
   offset takes the per-row kernel, as K5 and K4 do there; K7's tile form
   on columns longer than a warp and one longer than its tile budget, the
   CPU twin's bits (held to the twin run on CPU copies; the twin on the
   card is timed only);
5b. K16 (dia_halo_spmv) at host level 0, float32 and float64: the ring of
   one against its twin and bit for bit against K1 in one launch a call
   (its row-block plan printed), four in-process row blocks (halos copied
   on a side stream) against K1, and the interior alone, the halo copies
   alone and the overlapped total;
6. a small-input reference check: a 128^2 float64 host-built solve on the
   card against the same hierarchy copied to the CPU (the plain twins);
7. host-built config 1: mixed-precision CG to 1e-8 with
   b = default_rng(1).random(n), launch counters zeroed just before and
   read just after; the iteration count, the residual, the solve time;
8. device-built config 1: the same with b = default_rng(0).random(n)
   (the reference bench's right-hand side);
9. batched config 1, B = default_rng(3).random((n, 8)), native float32 CG
   to 1e-5 and mixed CG to 1e-8, launch counters zeroed before and read
   after; per-lane counts against each column's 1-D solve, residuals, and
   the wall time per solve and per right-hand side beside the 1-D solve:
   on the device-built hierarchy (K8, K9, K11), on the host-built one
   (K10, K12, K13), then on the lane-aligned device-built hierarchy the
   interleaved route (native, K15's five modes) and the K-major mixed
   solve; on every batched path K8 and K9 through their lane kernel only
   (no thread-per-row launch), on the 1-D paths K5 and K4 through
   their strip march only, and on every path K6 and K14 through their
   gather kernel only;
10. a stationary phase (accel=None, native float32, 5 V-cycles) on a
    256^2 device-built hierarchy, one right-hand side and then K = 4,
    each against the same run on a CPU copy of that hierarchy (the plain
    twins), with launch counters;
11. one V-cycle of the 2048^2 device-built hierarchy under
    torch.cuda.set_sync_debug_mode("error"), on one vector, on a K = 8
    stack and (interleaved) on the lane-aligned hierarchy: no host read in
    any; the lane-aligned V-cycle's time per right-hand side, interleaved
    and K-major; then a torch.profiler trace of the batched solves and
    the 1-D one (wall, kernel time, launches, busy share, largest
    kernels);
12. the unstructured device setup (device_unstructured_sa_setup): the
    reference's 640k case (a P1 stiffness matrix on a regular 800^2
    triangle mesh plus 1e-2 I, max_coarse=1000) twice, with per-stage
    seconds, peak memory and levels (0-2 against the reference's), counters
    zeroed before the first; K14 (windowed_select, float32 and float64
    payloads, bit-exact; torch.take as the yardstick) on level 0's and
    level 1's A, and K6/K7 (level 0's A and P, level 1's A; K6 and K14
    with their plans, K6 equal to its per-row kernel bit for bit) and
    K12/K13
    (K = 64, level 0's A and P; one launch per call; their launches in
    the first setup beside the 16-lane kernels') at this hierarchy's
    shapes; float32 CG to
    1e-6 with b = default_rng(0).standard_normal(n) (counters around the
    solve; the reference's 7 +- 1 iterations); a V-cycle under sync-debug
    "error"; then a 200^2 jittered mesh, scrambled, routed by
    device_sa_setup through RCM (float64; its float64 kernel instances
    K14, K6/K7 and K12/K13 at K = 64 checked on its level 0's A and P,
    K6 and K14 beside an empty kernel launched with their plan's grid),
    and aggressive with smooth_passes=2 in float64 and in float32 (twice),
    each solved to 1e-6 through the ReorderedSolver; the two 640k setups
    must give identical levels and f32 CG histories, the two float32
    aggressive runs identical true residuals (the transposes sum in a
    fixed order), and levels 3+ and that true relres must be the ones
    recorded since the transposes sum in that order (every kernel keeps
    its arithmetic, so the hierarchy keeps its bits);
12b. the unstructured classical setups (device_unstructured_rs_setup,
    device_unstructured_air_setup): RS with the setup's defaults on the
    640k mesh, modified interpolation twice (per-stage seconds, peak
    memory, each level's n, nc, period, k and widths, the two runs'
    levels identical and equal to the ones recorded on the card) and
    direct once, each with float32 CG to 1e-6 and b =
    default_rng(0).standard_normal(n) on the card (iterations recorded
    likewise), K14 on level 0's A, K6 / K7 and K12 / K13 (K = 64) on level
    0's M and P_direct; both at 200^2 against the JAX package's levels
    and counts; AIR through device_air_setup(grid=None) on RCM-permuted
    upwind advection at 256^2 (the 512^2 and 384^2 coarsest levels would
    pass 8192 rows: the dense pseudo-inverse), twice, its first cycle's
    drop (>= 1e4) and FGMRES to 1e-8 (<= 10 iterations), K6 / K7 / K12 /
    K13 on its level 0's A and injection Tinj, and at 128^2 in float64
    against the JAX package's levels and count; counters around every
    setup and solve, the three solves profiled, a V-cycle of each
    hierarchy with no host sync;
13. row-sharded solves (pyamg_tpu_torch.parallel) in a world of one NCCL
    rank: host-built config 1 (native f32 CG to 1e-5, K16 on its DIA
    levels) and the 640k unstructured SA and RS hierarchies (f32 CG to
    1e-6), each at its unsharded solve's iteration count, with counters;
    the process group is destroyed before the result lines;
14. config 2 (bench.py:446-455, :698-712): the device-built hierarchy of
    3-D 7-point Poisson 64^3 (float32, max_coarse=400, float64 A64), its
    setup time (a second call) and levels; K5, K4, K1 (plain and both
    epilogues), K2, and at K = 8 K11, K9 and K8 in its three modes on its
    levels 0 and 1 in float32 and float64, each against its twin with its
    branch (strip march or per-row kernel, the march equal to the per-row
    kernel bit for bit) and composed alternative; mixed W-cycle CG to
    1e-8 with b = default_rng(1).random(n) (the reference's 20 +- 1
    iterations, true relres <= 1e-8) and native V-cycle CG to 1e-5 (14),
    then F and AMLI CG to 1e-8 against the same solves on a CPU copy of
    the hierarchy, each with counters; the W, F and AMLI cycles under
    set_sync_debug_mode("error"); each cycle's CUDA-event time and
    profile, and the W-cycle solve's;
15. the Krylov methods: BiCGStab, GMRES and FGMRES (restart 30) mixed to
    1e-8 on the 2048^2 device-built and host-built hierarchies (counters
    around each; BiCGStab and FGMRES to true relres <= 1e-8, GMRES to its
    preconditioned 1e-8, its true relres reported), GMRES in float64 on a
    float64 device-built 2048^2 hierarchy (true relres <= 1e-8), and every
    accel (V-cycle) and the W, F and AMLI cycles (CG) on a float64 256^2
    device-built hierarchy against the same solve on its CPU copy;
16. lanes: the 64^3 W-cycle CG native float32 to 1e-5 at K = 8 and GMRES
    (restart 4) at K = 4 on 256^2, each lane within one iteration of its
    1-D solve, K8 / K9 through their lane kernel only;
17. the other smoothers: config 2's host-built column (bench.py:423-429,
    :479-480): the port's SA setup of 64^3 with symmetric Gauss-Seidel,
    the JP colourings of levels 0 and 1 and the compile (float32, float64
    A64, cut at 1024 rows), each timed; multicolour GS with 6 colours at
    level 0 and the Chebyshev fallback at level 1; K2 with one colour's
    inverse diagonal and K9 at K = 8 at level 0, the one-launch
    multicolour sweep (S1) there bit for bit against the chain of K2
    colour steps it replaced, K1 there in both types,
    K6 / K7 / K12 / K13 (K = 8) on level 0's T and level 1's windowed
    operators; the mixed stationary W-cycle to 1e-8 with b =
    default_rng(1).random(n) (the reference's 14 +- 1 iterations, true
    relres <= 1e-8, its factor beside the reference's 0.2427), native
    W-cycle CG to 1e-5 and K = 8 lanes of it (each lane its 1-D count),
    with counters; one W-cycle under set_sync_debug_mode("error"), its
    time and profile; the device-built 64^3 hierarchy with Chebyshev
    smoothers, mixed CG to 1e-8 at its CPU copy's count, K1 SPMV_ADD at
    its level 0, its W-cycle with no host read; the host-built hierarchy
    sharded in a world of one (K16), its native stationary W-cycle to 1e-4
    against the unsharded history, and K16 at its level 0 (7 diagonals)
    against its twin and bit for bit against K1 in one launch, and on
    four in-process row blocks, with their times; and Richardson, SOR,
    Cimmino NE and NR, windowed Schwarz, polynomial and Chebyshev on a
    float64 256^2 host-built hierarchy, each CG solve at its CPU copy's
    count (S1 in float64 at SOR's level 0);
18. the classical device setups: config 3's classical column
    (bench.py:502-520; rotated anisotropic diffusion 512^2,
    device_rs_setup float32, max_coarse=400): its levels against the JAX
    package's, levels 0 and 1 against the port's CPU copy of the setup,
    K1 (A, R_emb), K1 SPMV_ADD (P_emb), K3 and K2 and at K = 8 K10 (bit
    for bit against its thread-per-row form), K9, K8 and K8 add at its
    level 0, CG to 1e-5 with b = default_rng(2).random(n)
    (the reference's 13 iterations) and K = 8 lanes of it
    (default_rng(5)), each lane within one of its 1-D count; config 3's
    device SA column with stride="auto" (its strides, 10 iterations); the
    setup primitives (Luby MIS, JP colours, PMIS from three seeds,
    Bellman-Ford from three seed points) on its level-0 DIA against the
    same calls on the CPU; config 5's classical column (bench.py:612-626,
    :715-726; recirc_flow 1024^2, mixed): its 7 levels, K1 (A, R_emb,
    the float64 A64), K1 SPMV_ADD, K3 and K2 at level 0, mixed FGMRES to
    1e-8 with b = default_rng(4).random(n) (the reference's 43 +- 2
    iterations, true relres <= 1e-8); AIR (bench.py:633-652; advection
    256^2): its levels, K2 with the F-masked inverse diagonal against its
    twin and the composed where-form, 5 stationary cycles (first drop >=
    1e5); counters around every solve, each solve profiled, the setup and
    solve walls beside the card's name and power limit;
19. config 4, the block device setup (bench.py:540-559, :729-736;
    linear_elasticity 128^2, 2x2 blocks, the three rigid-body modes,
    device_sa_setup_block float32 with the float64 A64, max_coarse=400):
    its levels (n, bs, ndiags) against the JAX package's on the CPU, the
    setup time (a second call), mixed CG to 1e-8 with b =
    default_rng(3).random(n) (the reference's 22 +- 1 iterations, true
    relres <= 1e-8) and native float32 CG to 1e-5 (JAX on the CPU: 15), a
    V-cycle under set_sync_debug_mode("error"); the block operations on
    the card (through the block-DIA kernels) against scipy's BSR product
    in float64 and against the CPU twins in float32 (the BlockDIAMatrix
    apply and its transpose, the block Jacobi sweep of the setup's level
    0, block multicolour Gauss-Seidel on the operator's JP node colouring,
    the host-built compile's form); then 1024^2 (2.1 M unknowns): setup
    (second call) with peak memory, mixed CG to 1e-8 (25 +- 1 iterations,
    true relres <= 1e-8, two solves bit-identical; walls, the solve's peak
    memory), each solve profiled; the block-DIA kernels (B1
    block_dia_spmv: PLAIN, RESID, K = 4; B2 block_dia_jacobi: STEP, ZERO,
    ZERO_RES beside its composed alternative, one COLOUR step and the
    4-colour forward sweep as a chain of COLOUR steps; B3
    block_mcgs_sweep, the whole sweep in one launch, bit for bit against
    that chain) at its level 0 (bs 2, float32, and A64 in
    float64) and level 1 (bs 3) against their twins on the same tensors,
    two launches bit-identical, with launches per call (one call captured
    in a CUDA graph), the bound and torch.mv / torch.sparse.mm on the
    operator as CSR; then adaptive SA (device_adaptive_sa_setup,
    stages=2) on Poisson 512^2, its levels and native CG count to 1e-5
    against JAX's (13), and the kernels at its level 0 (bs 1); counters
    around every solve, every block kernel of the path launched and no
    block twin run on a CUDA tensor;
20. the device-built hierarchies row-sharded in a world of one NCCL rank
    (configs 1-5, both AIR forms, config 4 at 128^2 and 1024^2), each
    solve at its unsharded count, K16 at their level-0 shapes and B1's
    halo mode at config 4's 1024^2 level 0;
21. sharded lanes, A^T and the cross-shard sweeps (a world of one): K16's
    lane mode at K = 8 at config 1's device-built level-0 S and S^T
    (float32 and float64) and the 64^3 level-0 S, each against its twin,
    bit for bit against K8 in one launch a call (K8's time beside it) and
    in 4 in-process row blocks; B1's halo mode on K = 8 lanes at config
    4's 1024^2 level 0 against B1's lanes; the transposed DIA and block
    DIA against the unsharded transposes; sharded batched K = 8 solves
    against the unsharded batched ones (config 1 device-built and
    host-built, config 3 RS 512^2, config 4 1024^2, the 640k unstructured
    SA): every lane's count, true relres, walls and launches, never the
    interleaved route; CGNR and CGNE on config 5's RS 1024^2 and AIR
    256^2; the Cimmino sweep and windowed Schwarz at 256^2 float64;
22. the partitioned device SA setup (device_sa_setup(..., mesh=mesh),
    each rank building only its rows of every large level) in a world of
    one NCCL rank at config 1's 2048^2, float32: every level's arrays
    equal to device_sa_setup + shard_hierarchy's bit for bit, both
    setups' times (second calls, synchronised, in the order whole,
    partitioned, partitioned, whole) and peak device memory, the K16
    launches of the partitioned setup (its power iterations), K16 at its
    level-0 A, and the sharded CG to 1e-5 in 13 iterations with the
    whole route's history;
23. the host-built columns of configs 3 and 4: the port's own
    ruge_stuben_solver (512^2) and rootnode_solver (128^2), their level
    sizes against the reference's, compiled float32 with the float64 A64;
    mixed GMRES to 1e-8 (5 iterations) and mixed CG to 1e-8 (13), each
    smoother call one launch of the multicolour sweep (S1 on config 3's
    DIA levels, B3 on config 4's block levels; no K2 colour step and no
    B2 COLOUR launch), counters around each solve; at levels 0 and 1 of
    both, each sweep bit for bit against the colour-by-colour chain of the
    parent kernels in every form (its plan's barrier route, the other
    route, staged), within tolerance of its twin, one launch a call, with
    the chain's time; both routes timed at every multicolour level of
    config 3; K1, K6 / K7 and B1 at their shapes; both solves profiled;
24. result lines: the script's seconds, the kernels' JSON (with the
    64^3 checks of config 2's paths and the classical paths' checks under
    ``at_paths``, and every check of the block-DIA and sweep kernels under
    ``checks``), the card's name and power limit, and last {"ok": true,
    "device": {...}}.
"""

import dataclasses
import itertools
import json
import subprocess
import sys
import time
import warnings

F32_REL_TOL = 1e-5     # f32 kernels vs twin: FMA contraction and other
                       # summation orders (the windowed transposes K7, K13
                       # sum in their CPU twins' order: held bit for bit)
F64_REL_TOL = 1e-12    # f64 kernels vs twin
STATIONARY_RTOL = 1e-4  # f32 card vs f32 CPU twins over 5 cycles
DEVICE = "cuda:0"
GRID = (2048, 2048)
COARSE_CUTOFF = 1024
REF_ITERS = 16         # bench_detail.json config1.iters_to_1e8
REF_ITERS_DEVICE = 18  # bench_detail.json config1.device_setup_iters_to_1e8
# bench_detail.json config1.device_setup_cg_iters_to_1e-5 and
# batched_rhs.solve_iters
REF_ITERS_BATCHED_1E5 = 13
LANES = 8
STATIONARY_GRID = (256, 256)
STATIONARY_LANES = 4
# config 2 (bench.py:446-455, :698-712): 3-D 7-point Poisson 64^3, the
# device-built hierarchy, b = default_rng(1).random(n)
GRID3 = (64, 64, 64)
REF_ITERS_C2 = 20       # bench_detail.json config2.device_setup_iters_to_1e8
REF_ITERS_C2_1E5 = 14   # config2.device_setup_cg_iters_to_1e-5
# the Krylov methods timed at 2048^2 (configs 3 and 5 and the blackbox
# run GMRES, BiCGStab and FGMRES), and every accel of the solve
KRYLOV_2048 = ("bicgstab", "gmres", "fgmres")
ACCELS = ("cg", "bicgstab", "gmres", "fgmres", "cgnr", "cgne", "cr",
          "minimal_residual", "steepest_descent")
GMRES_LANES = 4
CYCLE_KINDS = ("V", "W", "F", "AMLI")
# config 2's host-built column (bench.py:423-429, :479-480, :737-747): the
# port's SA setup of 64^3 with symmetric Gauss-Seidel, compiled f32 with
# the f64 A64 and cut at 1024 rows, the stationary W-cycle in mixed
# precision to 1e-8; bench_detail.json config2.iters_to_1e8, conv_factor
C2_GS = ("gauss_seidel", {"sweep": "symmetric"})
REF_ITERS_C2_HOST = 14
REF_FACTOR_C2_HOST = 0.2427
C2_CHEBYSHEV = ("chebyshev", {"degree": 3})
# the other smoother kinds at 256^2, host-built, float64 (each against its
# CPU copy); the polynomial spec on level 0 only, Chebyshev below it
SMOOTHER_KINDS = ("richardson", "sor", "jacobi_ne", "gauss_seidel_nr",
                  "schwarz", "polynomial", "chebyshev")
# the classical device setups (phase 18): config 3 (bench.py:482-520),
# rotated anisotropic diffusion 512^2 (epsilon=1e-3, theta=0, FD), b =
# default_rng(2).random(n), device_rs_setup and device_sa_setup with
# stride="auto", CG to 1e-5; config 5 (bench.py:612-626, :715-726),
# recirc_flow 1024^2 (epsilon=1e-2), b = default_rng(4).random(n),
# device_rs_setup mixed, FGMRES to 1e-8; AIR (bench.py:633-652), upwind
# advection 256^2 (theta=pi/4), device_air_setup, stationary cycles.
# Levels as (n, strides, ndiags), the JAX package's on the CPU;
# bench_detail.json config3.classical_device_cg_iters_to_1e-5,
# config3.device_setup_strides and device_setup_cg_iters_to_1e-5,
# config5.device_setup_iters_to_1e8 and device_setup_final_relres,
# air.first_cycle_residual_drop (6.09e5)
C3_GRID = (512, 512)
C3_LEVELS = [(262144, (1, 2), 5), (131072, (1, 2), 9), (65536, (1, 2), 9),
             (32768, (1, 2), 9), (16384, (2, 2), 9), (4096, (2, 2), 9),
             (1024, (2, 2), 9)]
C3_COARSE = 256
REF_ITERS_C3_RS = 13
C3_SA_STRIDES = [(1, 3)] * 3 + [(3, 3)] * 2
REF_ITERS_C3_SA = 10
C5_GRID = (1024, 1024)
C5_LEVELS = [(1048576, (2, 2), 5)] + [(n, (2, 2), 9) for n in (
    262144, 65536, 16384, 4096, 1024)]
C5_COARSE = 256
REF_ITERS_C5 = 43
REF_RELRES_C5 = 8.59e-9
AIR_GRID = (256, 256)
AIR_LEVELS = [65536, 16384, 4096]
AIR_COARSE = 1024
AIR_MIN_DROP = 1e5
PRIMITIVE_SEEDS = (0, 1, 2)
# config 4 (bench.py:540-559, :729-736): 2-D linear elasticity, the block
# device setup; levels (n, bs, ndiags) and the dense coarsest n from
# scripts/jax_block_counts.py (the JAX package on the CPU);
# bench_detail.json config4.device_setup_iters_to_1e8; adaptive SA
# (stages=2) on Poisson 512^2, JAX on the CPU
C4_GRID = (128, 128)
C4_NODE_GRID = (128, 127)
C4_LEVELS = [(33282, 2, 9), (6075, 3, 9), (675, 3, 9)]
C4_COARSE = 75
REF_ITERS_C4 = 22
REF_ITERS_C4_1E5 = 15
C4_BIG = (1024, 1024)
C4_BIG_NODE_GRID = (1024, 1023)
C4_BIG_LEVELS = [2099196, 350892, 38988, 4563, 675]
REF_ITERS_C4_BIG = 25   # the port's count on the H100 (no reference run)
# the host-built columns of configs 3 and 4 (phase 23; bench.py:482-486,
# :536-539, :562-568, :737-747): the port's own ruge_stuben_solver (the
# reference's defaults) and rootnode_solver (strength="symmetric") on the
# host, compile_hierarchy f32 with the f64 A64 and cut at 1024 rows, mixed
# GMRES and CG to 1e-8 (history relres res[-1] / res[0]); the level sizes
# are the JAX package's host setups' (on the CPU), the iterations
# bench_detail.json config3.iters_to_1e8 and config4.iters_to_1e8
C3_HOST_LEVELS = [262144, 131072, 65536, 32768, 16384, 8192, 3586, 897, 256,
                  105, 22, 11]
REF_ITERS_C3_HOST = 5
C4_HOST_LEVELS = [32512, 3698, 450, 50, 8]
REF_ITERS_C4_HOST = 13
ADAPT_GRID = (512, 512)
ADAPT_LEVELS = [(263169, 1, 5), (58482, 2, 9), (6498, 2, 9), (882, 2, 9)]
ADAPT_COARSE = 98
REF_ITERS_ADAPT = 13
# the card's peaks (NVIDIA H100 SXM data sheet, at the 700 W limit): HBM3
# bytes/s, and float32 / float64 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}

# the block-DIA kernels (B1, B2, B1's halo mode) and the one-launch
# multicolour sweeps (S1, B3): the kernels line lists each of their checks
# (every mode, form and shape) beside the row
BLOCK_KERNELS = ("block_dia_spmv", "block_dia_jacobi", "block_dia_halo",
                 "block_dia_halo_spmm")
SWEEP_KERNELS = ("dia_mcgs_sweep", "block_mcgs_sweep")
# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    "dia_spmv": ("pyamg_tpu_torch/csrc/dia.cu",
                 "pyamg_tpu/sparse/dia.py:449"),
    "dia_spmv_scaled": ("pyamg_tpu_torch/csrc/dia.cu",
                        "pyamg_tpu/sparse/dia.py:449"),
    "dia_spmv_add": ("pyamg_tpu_torch/csrc/dia.cu",
                     "pyamg_tpu/sparse/dia.py:449"),
    "dia_jacobi": ("pyamg_tpu_torch/csrc/dia.cu",
                   "pyamg_tpu/sparse/dia.py:579"),
    "dia_jacobi_zero_res": ("pyamg_tpu_torch/csrc/dia.cu",
                            "pyamg_tpu/sparse/dia.py:642"),
    "dia_jacobi_res": ("pyamg_tpu_torch/csrc/dia_chain.cu",
                       "pyamg_tpu/sparse/dia.py:715"),
    "dia_zero_chain": ("pyamg_tpu_torch/csrc/dia_chain.cu",
                       "pyamg_tpu/sparse/dia.py:861"),
    "windowed_matvec": ("pyamg_tpu_torch/csrc/window.cu",
                        "pyamg_tpu/sparse/window.py:152"),
    "windowed_rmatvec": ("pyamg_tpu_torch/csrc/window.cu",
                         "pyamg_tpu/sparse/window.py:226"),
    "dia_spmm": ("pyamg_tpu_torch/csrc/dia_k.cu",
                 "pyamg_tpu/sparse/dia.py:353"),
    "dia_spmm_scaled": ("pyamg_tpu_torch/csrc/dia_k.cu",
                        "pyamg_tpu/sparse/dia.py:353"),
    "dia_spmm_add": ("pyamg_tpu_torch/csrc/dia_k.cu",
                     "pyamg_tpu/sparse/dia.py:353"),
    "dia_jacobi_k": ("pyamg_tpu_torch/csrc/dia_k.cu",
                     "pyamg_tpu/sparse/dia.py:1262"),
    "dia_zero_chain_k": ("pyamg_tpu_torch/csrc/dia_k.cu",
                         "pyamg_tpu/sparse/dia.py:975"),
    "dia_jacobi_zero_res_k": ("pyamg_tpu_torch/csrc/dia_k.cu",
                              "pyamg_tpu/sparse/dia.py:1141"),
    "windowed_matmat_k": ("pyamg_tpu_torch/csrc/window.cu",
                          "pyamg_tpu/sparse/window.py:505"),
    "windowed_rmatmat_k": ("pyamg_tpu_torch/csrc/window.cu",
                           "pyamg_tpu/sparse/window.py:600"),
    "windowed_select": ("pyamg_tpu_torch/csrc/window.cu",
                        "pyamg_tpu/sparse/window.py:361"),
    "dia_halo_spmv": ("pyamg_tpu_torch/csrc/halo.cu",
                      "pyamg_tpu/parallel/pallas_halo.py:50"),
    # K16's lane mode: K8's arithmetic on a rank's rows (the reference
    # applies a sharded lane stack through K8 under GSPMD)
    "dia_halo_spmm": ("pyamg_tpu_torch/csrc/halo.cu",
                      "pyamg_tpu/sparse/dia.py:353"),
    **{name: ("pyamg_tpu_torch/csrc/interleaved.cu",
              "pyamg_tpu/sparse/interleaved.py:160")
       for name in ("int_jacobi_zero_res", "int_spmv_scaled", "int_spmv",
                    "int_spmv_add", "int_jacobi_step")},
    # no Pallas kernel: the reference's block algebra is plain jnp
    **{name: ("pyamg_tpu_torch/csrc/block_dia.cu",
              "none: plain jnp in pyamg_tpu/sparse/block_dia.py:77 / "
              "engine/relaxation.py:232")
       for name in BLOCK_KERNELS[:2]},
    **{name: ("pyamg_tpu_torch/csrc/block_dia.cu",
              "none: plain jnp in pyamg_tpu/sparse/block_dia.py:77, "
              "row-sharded by GSPMD (tests/test_parallel.py:277)")
       for name in BLOCK_KERNELS[2:]},
    # a multicolour GS call in one launch: it replaces the chain of K2
    # colour steps (each the reference's step, engine/relaxation.py:400)
    "dia_mcgs_sweep": ("pyamg_tpu_torch/csrc/mcgs.cu",
                       "pyamg_tpu/sparse/dia.py:579 (K2, one launch a colour "
                       "step of pyamg_tpu/engine/relaxation.py:400)"),
    "block_mcgs_sweep": ("pyamg_tpu_torch/csrc/block_dia.cu",
                         "none: plain jnp in "
                         "pyamg_tpu/engine/relaxation.py:417 (block_mcgs)"),
}
# path -> the kernel instances it must launch
PATHS = {
    "host-built config 1": (
        "dia_spmv.float32", "dia_spmv.float64", "dia_jacobi.float32",
        "dia_jacobi_zero_res.float32", "windowed_matvec.float32",
        "windowed_rmatvec.float32"),
    "device-built config 1": (
        "dia_zero_chain.float32", "dia_spmv_add.float32",
        "dia_jacobi.float32", "dia_spmv.float64"),
    "device-built stationary": (
        "dia_jacobi_res.float32", "dia_spmv_scaled.float32"),
    "device-built batched config 1": (
        "dia_zero_chain_k.float32", "dia_spmm_add.float32",
        "dia_jacobi_k.float32", "dia_spmm.float32", "dia_spmm.float64"),
    "device-built batched stationary": (
        "dia_jacobi_k.float32", "dia_spmm.float32",
        "dia_spmm_scaled.float32"),
    "host-built batched config 1": (
        "dia_jacobi_zero_res_k.float32", "windowed_matmat_k.float32",
        "windowed_rmatmat_k.float32", "dia_jacobi_k.float32",
        "dia_spmm.float32", "dia_spmm.float64"),
    "interleaved batched config 1": (
        "int_jacobi_zero_res.float32", "int_spmv_scaled.float32",
        "int_spmv.float32", "int_spmv_add.float32", "int_jacobi_step.float32",
        "dia_zero_chain_k.float32"),
    "lane-aligned batched mixed": (
        "dia_zero_chain_k.float32", "dia_spmm_add.float32",
        "dia_jacobi_k.float32", "dia_spmm.float64"),
    "unstructured setup": (
        "windowed_select.float32", "windowed_matvec.float32",
        "windowed_rmatvec.float32", "windowed_matmat_k.float32",
        "windowed_rmatmat_k.float32"),
    "unstructured solve": (
        "windowed_matvec.float32", "windowed_rmatvec.float32"),
    "routed unstructured setup": (
        "windowed_select.float64", "windowed_select.float32",
        "windowed_matvec.float64", "windowed_rmatvec.float64",
        "windowed_matmat_k.float64", "windowed_rmatmat_k.float64"),
    "sharded host-built config 1": (
        "dia_halo_spmv.float32", "windowed_matvec.float32",
        "windowed_rmatvec.float32"),
    "sharded unstructured": (
        "windowed_matvec.float32", "windowed_rmatvec.float32"),
    "sharded unstructured RS": (
        "windowed_matvec.float32", "windowed_rmatvec.float32"),
    # config 2 at 64^3: the W and F cycles' second visits enter through K4
    # and restrict through K1 SPMV_SCALED; AMLI's coarse products are K1
    "config 2 W-cycle": (
        "dia_zero_chain.float32", "dia_jacobi_res.float32",
        "dia_spmv_scaled.float32", "dia_spmv_add.float32",
        "dia_jacobi.float32", "dia_spmv.float64"),
    "config 2 V-cycle native": (
        "dia_zero_chain.float32", "dia_spmv_add.float32",
        "dia_jacobi.float32", "dia_spmv.float32"),
    "config 2 F-cycle": (
        "dia_zero_chain.float32", "dia_jacobi_res.float32",
        "dia_spmv_scaled.float32", "dia_spmv_add.float32",
        "dia_jacobi.float32", "dia_spmv.float64"),
    "config 2 AMLI": (
        "dia_zero_chain.float32", "dia_spmv.float32", "dia_spmv_add.float32",
        "dia_jacobi.float32", "dia_spmv.float64"),
    "config 2 batched W-cycle": (
        "dia_zero_chain_k.float32", "dia_jacobi_k.float32",
        "dia_spmm.float32", "dia_spmm_scaled.float32",
        "dia_spmm_add.float32"),
    "device-built batched GMRES": (
        "dia_zero_chain_k.float32", "dia_jacobi_k.float32",
        "dia_spmm.float32", "dia_spmm_add.float32"),
    "device-built float64 config 1 gmres": (
        "dia_zero_chain.float64", "dia_spmv_add.float64",
        "dia_jacobi.float64", "dia_spmv.float64"),
    # config 2 host-built: every multicolour GS call at level 0 is one S1
    # launch (a colour step K9 on lanes); level 1 (windowed) smooths by
    # Chebyshev through K6 (K12); R = T^T S^T and level 1's R through K7
    # (K13)
    "config 2 host-built W-cycle": (
        "dia_mcgs_sweep.float32", "dia_spmv.float32", "dia_spmv.float64",
        "windowed_matvec.float32", "windowed_rmatvec.float32"),
    "config 2 host-built W-cycle CG native": (
        "dia_mcgs_sweep.float32", "dia_spmv.float32",
        "windowed_matvec.float32", "windowed_rmatvec.float32"),
    "config 2 host-built batched W-cycle": (
        "dia_jacobi_k.float32", "dia_spmm.float32",
        "windowed_matmat_k.float32", "windowed_rmatmat_k.float32"),
    "sharded config 2 host-built W-cycle": (
        "dia_halo_spmv.float32", "windowed_matvec.float32",
        "windowed_rmatvec.float32"),
    # the device-built Chebyshev solve: Horner steps and the correction
    # add through K1 SPMV_ADD, the restriction through SPMV_SCALED
    "config 2 device-built Chebyshev": (
        "dia_spmv_add.float32", "dia_spmv_scaled.float32",
        "dia_spmv.float32", "dia_spmv.float64"),
    **{f"256^2 float64 {kind}": (
        ("dia_mcgs_sweep.float64", "dia_spmv.float64") if kind == "sor" else
        ("dia_spmv_add.float64", "dia_spmv.float64")
        if kind in ("polynomial", "chebyshev") else ("dia_spmv.float64",))
       for kind in SMOOTHER_KINDS},
}
# the classical device setups: the embedded R and the CG / outer-loop
# applies through K1, the correction through K1 SPMV_ADD, the Jacobi
# pre-smoother's zero-guess sweep and residual through K3, the post-sweep
# through K2 (K10, K8, K8 add and K9 on lanes); AIR's masked F-then-C
# sweeps are K2 with the masked inverse diagonal
PATHS.update({
    "config 3 classical CG": (
        "dia_jacobi_zero_res.float32", "dia_spmv.float32",
        "dia_spmv_add.float32", "dia_jacobi.float32"),
    "config 3 classical batched CG": (
        "dia_jacobi_zero_res_k.float32", "dia_spmm.float32",
        "dia_spmm_add.float32", "dia_jacobi_k.float32"),
    "config 3 SA stride auto CG": (
        "dia_zero_chain.float32", "dia_spmv_add.float32",
        "dia_jacobi.float32", "dia_spmv.float32"),
    "config 5 classical mixed FGMRES": (
        "dia_jacobi_zero_res.float32", "dia_spmv.float32",
        "dia_spmv_add.float32", "dia_jacobi.float32", "dia_spmv.float64"),
    "AIR stationary": (
        "dia_spmv.float32", "dia_spmv_add.float32", "dia_jacobi.float32"),
})
# config 4: the block applies (A, S, S^T, the float64 A64) through B1,
# the level entry (ZERO_RES), the post-sweep (STEP) and the residuals
# (RESID) through B2 and B1, the transfers' candidate remap Q through K6
# and its transpose through K7; adaptive SA's native CG likewise
_BLOCK_REMAP = ("windowed_matvec.float32", "windowed_rmatvec.float32")
PATHS.update({
    "config 4 block mixed CG": (
        "block_dia_spmv.float32", "block_dia_spmv.float64",
        "block_dia_jacobi.float32") + _BLOCK_REMAP,
    "config 4 1024^2 block mixed CG": (
        "block_dia_spmv.float32", "block_dia_spmv.float64",
        "block_dia_jacobi.float32") + _BLOCK_REMAP,
    "adaptive SA CG": ("block_dia_spmv.float32",
                       "block_dia_jacobi.float32") + _BLOCK_REMAP,
})
# the host-built configs 3 and 4 (phase 23): config 3's DIA levels apply
# A through K1 and smooth by multicolour GS, one S1 launch a smoother call;
# its windowed P through K6 and R = P^T through K7; config 4's block-DIA
# levels 0 and 1 apply A through B1 (PLAIN, RESID) and smooth by block
# multicolour GS, one B3 launch a smoother call; the float64 A64 of both
# is a DIAMatrix (K1).  The colour-step kernels these sweeps replaced (K2
# with a colour's inverse diagonal, B2 COLOUR) must not launch there.
_HOST_TRANSFERS = ("windowed_matvec.float32", "windowed_rmatvec.float32")
PATHS.update({
    "host-built config 3 mixed GMRES": (
        "dia_spmv.float32", "dia_spmv.float64", "dia_mcgs_sweep.float32")
    + _HOST_TRANSFERS,
    "host-built config 4 mixed CG": (
        "block_dia_spmv.float32", "block_mcgs_sweep.float32",
        "dia_spmv.float64") + _HOST_TRANSFERS,
})
# path -> (the sweep kernel instance it smooths with, the colour-step
# instance that sweep replaced, which must not launch on the path)
HOST_SWEEPS = {
    "host-built config 3 mixed GMRES": ("dia_mcgs_sweep.float32",
                                        "dia_jacobi.float32"),
    "host-built config 4 mixed CG": ("block_mcgs_sweep.float32",
                                     "block_dia_jacobi.float32"),
}
# the unstructured classical setups: PMIS's selects (K14) and lambda (K7),
# the power iteration (K6), the probe chains (K12 on P's factors and A, K13
# on P^T's factors or the Neumann restriction's injection); their solves
# apply A, P's factors, the smoothers and the Neumann restriction's A
# through K6, P^T's factors and the injection's transpose through K7
PATHS.update({
    **{f"unstructured {what} setup": (
        "windowed_select.float32", "windowed_matvec.float32",
        "windowed_rmatvec.float32", "windowed_matmat_k.float32",
        "windowed_rmatmat_k.float32")
       for what in ("RS modified", "RS direct")},
    # no spectral radius: no K6 in the AIR setup
    "unstructured AIR setup": (
        "windowed_select.float32", "windowed_rmatvec.float32",
        "windowed_matmat_k.float32", "windowed_rmatmat_k.float32"),
    **{f"unstructured {what} solve": (
        "windowed_matvec.float32", "windowed_rmatvec.float32")
       for what in ("RS modified", "RS direct", "AIR")},
})
# the device-built hierarchies row-sharded (a world of one): every DIA
# operator (A, S, S^T, P_emb, R_emb) through K16, the grid remaps (T, the
# embedding E, the block candidates' Q) through K6 and their transposes
# through K7; the block levels through B1's halo mode (RESID for the
# sweeps' residuals) and the local B2 ZERO update; the routed AIR's
# windowed levels and Neumann restriction through K6 and K7
_SHARDED_GRID = ("dia_halo_spmv.float32", "windowed_matvec.float32",
                 "windowed_rmatvec.float32")
_SHARDED_BLOCK = ("block_dia_halo.float32", "block_dia_jacobi.float32",
                  "windowed_matvec.float32", "windowed_rmatvec.float32")
# the sharded device-built float32 histories against the unsharded ones
# (the same hierarchy; K7's column sums and the composed cycle round in
# another order than the unsharded cycle's fused kernels)
SHARDED_HIST_RTOL = 1e-2
# the grid remap each sharded path's level-0 transfers apply, checked
# at the block shard_hierarchy picks (``remap_checks``)
REMAPS = {"sharded device-built config 1": "T",
          "sharded config 2 V-cycle": "T", "sharded config 3 RS": "E",
          "sharded config 5 RS": "E", "sharded config 4 1024^2": "Q",
          "sharded config 4 128^2": "Q"}
PATHS.update({
    "sharded device-built config 1": _SHARDED_GRID,
    "sharded config 2 V-cycle": _SHARDED_GRID,
    "sharded config 2 W-cycle": _SHARDED_GRID,
    "sharded config 3 RS": _SHARDED_GRID,
    "sharded config 5 RS": _SHARDED_GRID,
    "sharded structured AIR": _SHARDED_GRID,
    "sharded routed AIR": ("windowed_matvec.float32",
                           "windowed_rmatvec.float32"),
    "sharded config 4 1024^2": _SHARDED_BLOCK,
    "sharded config 4 128^2": _SHARDED_BLOCK,
})
# the sharded batched solves (phase 21, a world of one, K = 8): the DIA
# levels through K16's lane mode, the block levels through B1's halo mode
# on lanes and the local B2 ZERO update, the grid remaps through K12 and
# K13; the sharded CGNR / CGNE and the Cimmino / Schwarz sweeps apply A
# and A^T (each DIA level's transposed diagonals) through K16
_LANE_REMAP = ("windowed_matmat_k.float32", "windowed_rmatmat_k.float32")
# the grid remap each sharded batched path's level-0 transfers apply on
# lanes, checked through K12 / K13 at K = LANES (``remap_checks``)
LANE_REMAPS = {"sharded batched device-built config 1": "T",
               "sharded batched config 3 RS": "E",
               "sharded batched config 4 1024^2": "Q"}
PATHS.update({
    "sharded batched device-built config 1": ("dia_halo_spmm.float32",)
    + _LANE_REMAP,
    "sharded batched host-built config 1": ("dia_halo_spmm.float32",)
    + _LANE_REMAP,
    "sharded batched config 3 RS": ("dia_halo_spmm.float32",) + _LANE_REMAP,
    "sharded batched config 4 1024^2": (
        "block_dia_halo_spmm.float32", "block_dia_jacobi.float32")
    + _LANE_REMAP,
    # its unsharded twin: B1 (PLAIN, RESID) and B2 (ZERO_RES, STEP, ZERO)
    # on the lanes of every block level
    "batched config 4 1024^2": ("block_dia_spmv.float32",
                                "block_dia_jacobi.float32"),
    "sharded batched unstructured": _LANE_REMAP,
    "sharded CGNR config 5 RS": _SHARDED_GRID,
    "sharded CGNE config 5 RS": _SHARDED_GRID,
    "sharded CGNR structured AIR": _SHARDED_GRID,
    "sharded CGNE structured AIR": _SHARDED_GRID,
    "sharded Cimmino 256^2 float64": ("dia_halo_spmv.float64",),
    "sharded Schwarz 256^2 float64": ("dia_halo_spmv.float64",),
})
# the partitioned setups (phase 22, a world of one): every large level's
# power iterations through K16 on its A in the solve layout (SA, RS), or
# through B1's halo mode (the block setup); their sharded solves as phase
# 20's
PATHS.update({
    "partitioned setup config 1": ("dia_halo_spmv.float32",),
    "partitioned sharded config 1": _SHARDED_GRID,
    "partitioned setup config 3 RS": ("dia_halo_spmv.float32",),
    "partitioned sharded config 3 RS": _SHARDED_GRID,
    "partitioned setup config 5 RS": ("dia_halo_spmv.float32",),
    "partitioned sharded config 5 RS": _SHARDED_GRID,
    "partitioned setup config 4 1024^2": ("block_dia_halo.float32",),
    "partitioned sharded config 4 1024^2": _SHARDED_BLOCK,
})
REF_ITERS_PARTITIONED = 13   # phase 20's sharded config 1 CG to 1e-5
# the partitioned RS and block routes' sharded solves: config 3 CG to 1e-5
# (13, the reference's), config 4 1024^2 CG to 1e-5 (18, phase 20's), and
# config 5 FGMRES as phase 20 runs it (its count the whole route's)
REF_ITERS_PARTITIONED_C3 = REF_ITERS_C3_RS
REF_ITERS_PARTITIONED_C4 = 18
# the Krylov solves at 2048^2 run their hierarchy's CG path's kernels
PATHS.update({f"{h} config 1 {a}": PATHS[f"{h} config 1"]
              for h in ("device-built", "host-built") for a in KRYLOV_2048})
# K8, K9 and K10's thread-per-row form (the wrapper counts it apart)
K8_ROWS = ("dia_spmm_rows", "dia_spmm_scaled_rows", "dia_spmm_add_rows",
           "dia_jacobi_k_rows", "dia_jacobi_zero_res_k_rows")
# K5 and K4's per-row kernel (for the shapes the strip march refuses)
CHAIN_ROWS = {"dia_zero_chain": "dia_zero_chain_rows",
              "dia_jacobi_res": "dia_jacobi_res_rows"}
# K6's per-row kernel: its bit reference, which no path launches
GATHER_ROWS = "windowed_matvec_rows"
# the lane-aligned 2048^2 fine grid and its solve padding (the reference's)
LANE_GRID_P = (2064, 2304)
LANE_N_PAD = 4784128


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_SLEEP_MS_PER_CYCLE = []


def _sleep_cycles(ms):
    """GPU clock cycles that ``torch.cuda._sleep`` needs to hold the card
    for ``ms`` milliseconds (calibrated once by CUDA events)."""
    import torch

    if not _SLEEP_MS_PER_CYCLE:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10**7)
        stop.record()
        torch.cuda.synchronize()
        _SLEEP_MS_PER_CYCLE.append(start.elapsed_time(stop) / 10**7)
    return int(ms / _SLEEP_MS_PER_CYCLE[0])


def time_ms(fn, iters=30):
    """Mean device milliseconds per call over ``iters`` back-to-back
    calls, by CUDA events, after a warm-up.  The calls are queued behind a
    sleep kernel longer than the host needs to issue them, so the events
    time the card's work and not the wrappers' host cost (which exceeds a
    small kernel's run time)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_sleep_cycles(min(2 * iters * host_ms + 1.0, 2000.0)))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


class Checks:
    def __init__(self):
        self.failures = []

    def __call__(self, ok, what):
        log(("  ok   " if ok else "  FAIL ") + what)
        if not ok:
            self.failures.append(what)


def compare(check, name, dtype, kernel_fn, plain_fn, results, nbytes, ops,
            library_fn=None, path=None, exact=False, repeat_exact=False,
            want_fn=None):
    """Run a kernel and its plain twin on the same inputs; record errors
    and times (the twin first, then the kernel, twice over).  ``nbytes``
    and ``ops``: the bytes the call must move (each input read once, each
    output written once) and the operations it must do, for its bound.
    ``library_fn``: one PyTorch call computing the same function, timed as
    a yardstick only.  ``path``: the path (a key of PATHS) whose shapes
    these are; the kernels line takes a kernel's numbers from the check
    at its first path's shapes where there is one.  ``exact``: the kernel
    must equal its twin bit for bit.  ``repeat_exact``: a second launch
    must give the first one's bits (a fixed summation order).
    ``want_fn``: the outputs the kernel is held to, where they are not the
    timed twin's (the twin run on CPU copies, moved to the card)."""
    import torch

    got = kernel_fn()
    again = kernel_fn() if repeat_exact else got
    want = (want_fn or plain_fn)()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    want = want if isinstance(want, tuple) else (want,)
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-300))
                  for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    tol = F32_REL_TOL if dtype == torch.float32 else F64_REL_TOL
    if exact:
        tol = 0.0
        finite = finite and all(torch.equal(g, w) for g, w in zip(got, want))
    t_plain, t_kernel = [], []
    for _ in range(2):
        t_plain.append(time_ms(plain_fn))
        t_kernel.append(time_ms(kernel_fn))
    ms, plain_ms = min(t_kernel), min(t_plain)
    library_ms = time_ms(library_fn) if library_fn is not None else None
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[str(dtype).removeprefix("torch.")] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
    check(finite and rel_err <= tol and same,
          f"{name}: max_rel_err {rel_err:.3e} "
          f"({'bit-exact required' if exact else f'tol {tol:g}'}), "
          + (f"two launches {'bit-identical' if same else 'DIFFER'}, "
             if repeat_exact else "") +
          f"max_abs_err {abs_err:.3e}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{nbytes / ms / 1e6:.0f} GB/s")
    results.append(dict(name=name, max_abs_err=abs_err, max_rel_err=rel_err,
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms, path=path))


def transpose_checks(check, label, W, r, Rk):
    """The column plan of the windowed transposes (K7, K13): its build on
    a fresh copy of ``W`` with every host sync an error (CUDA-synchronised
    ms, int32 bytes), and K7 (and K13 on ``Rk`` when given) against the
    plain twins run on the CPU, bit for bit (the kernels sum each column in
    the CPU twin's order, with separately rounded products and sums)."""
    import torch

    from pyamg_tpu_torch.sparse import window

    fresh = dataclasses.replace(W)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        torch.cuda.set_sync_debug_mode("error")
        perm, colptr = fresh.column_plan
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    mb = (perm.numel() + colptr.numel()) * 4 / 1e6
    live = int(colptr[-1])
    W_cpu = dataclasses.replace(W, data=W.data.cpu(), idx=W.idx.cpu(),
                                starts=W.starts.cpu())
    same = torch.equal(window.windowed_rmatvec(W, r).cpu(),
                       window.windowed_rmatvec_ref(W_cpu, r.cpu()))
    if Rk is not None:
        same = same and torch.equal(
            window.windowed_rmatmat_k(W, Rk).cpu(),
            window.windowed_rmatmat_k_ref(W_cpu, Rk.cpu()))
    check(same, f"{label}: column plan of {perm.numel()} entries ({live} "
          f"live), {mb:.2f} MB int32 (perm + colptr), built with no host "
          f"sync in {build_ms:.2f} ms; "
          f"K7{' and K13' if Rk is not None else ''} equal the CPU twins "
          "bit for bit")


def k11_checks(check, name, A, St, Bk, dinv, tv, omega, results, path=None):
    """K11 against its twin at a path shape, with its branch (the strip
    march's plan, or the per-row kernel), the strip march equal to the
    per-row kernel bit for bit, and its composed alternative timed beside
    it (K10, then K8's scale epilogue: the (K, n) residual stored and read
    back)."""
    import torch

    from pyamg_tpu_torch import _build
    from pyamg_tpu_torch.sparse import dia

    K, m = Bk.shape
    nd, nds, sz = A.ndiags, St.ndiags, A.data.element_size()
    plan = dia.k11_plan(A.offsets, St.offsets, m, K, A.dtype,
                        _build.sm_count(A.device))
    if plan is None:
        log(f"  {name}: per-row kernel (St reach {min(St.offsets)}.."
            f"{max(St.offsets)} too far for one lane's ring), "
            f"{-(-K // _build.MAX_LANES)} launch(es) per call")
    else:
        log(f"  {name}: strip march, {plan.strips} strips of {plan.strip} "
            f"rows x {plan.groups} lane group(s) of {plan.group}, steps of "
            f"{plan.step} rows, ring {plan.ring} rows ({plan.smem(sz)} B of "
            "shared memory), one launch per call")
    compare(check, name, A.dtype,
            lambda: dia.dia_zero_chain_k(A, St, Bk, dinv, tv, omega),
            lambda: dia.dia_zero_chain_k_ref(A, St, Bk, dinv, tv, omega),
            results, (nd + nds + 2 + 3 * K) * m * sz,
            (2 * nd + 2 * nds + 4) * m * K, repeat_exact=True, path=path)
    if plan is not None:
        got = dia.dia_zero_chain_k(A, St, Bk, dinv, tv, omega)
        rows = (torch.empty_like(Bk), torch.empty_like(Bk))
        dia._zero_chain_k_rows(A, St, Bk, dinv, tv, omega, *rows)
        torch.cuda.synchronize()
        check(all(torch.equal(g, r) for g, r in zip(got, rows)),
              f"{name}: the strip march equals the per-row kernel bit for "
              "bit")

    def composed():
        X, R = dia.dia_jacobi_zero_res_k(A, Bk, dinv, omega)
        return X, dia.dia_spmm_scaled(St, R, tv)
    log(f"  composed alternative of {name}: "
        f"{min(time_ms(composed), time_ms(composed)):.4f} ms (K10, then K8 "
        "scale)")


def chain_checks(check, name, mode, A, St, x, b, dinv, tv, omega,
                 results, path=None):
    """K5 (mode "K5": St, b, dinv, tv) or K4 ("K4": x, b, dinv) against its
    twin at a path shape, with its branch (the strip march's plan, or the
    per-row kernel), the strip march equal to the per-row kernel bit for
    bit, two launches bit-identical, and its composed alternative timed
    beside it (K5: K3, then K1 SPMV_SCALED; K4: K2, then K1 and b - A y)."""
    import torch

    from pyamg_tpu_torch import _build
    from pyamg_tpu_torch.sparse import dia

    m, nd, sz = A.n_pad, A.ndiags, A.data.element_size()
    outer = St if mode == "K5" else A
    sms = _build.sm_count(A.device)
    plan = dia.chain_plan(A.offsets, outer.offsets, m, A.dtype, sms)
    if plan is None:
        log(f"  {name}: per-row kernel (reach {min(outer.offsets)}.."
            f"{max(outer.offsets)} too far for the rings)")
    else:
        log(f"  {name}: strip march, {plan.strips} strips of {plan.strip} "
            f"rows, {plan.threads} threads x {plan.vec} row(s), steps of "
            f"{plan.step} rows, rings {plan.caps[0]} + {plan.caps[1]} rows "
            f"({plan.smem(sz)} B of shared memory), "
            f"{-(-plan.strips // sms)} CTA(s) per SM, one launch per call")
    if mode == "K5":
        nds = St.ndiags
        kernel = lambda: dia.dia_zero_chain(A, St, b, dinv, tv, omega)  # noqa
        plain = lambda: dia.dia_zero_chain_ref(A, St, b, dinv, tv, omega)  # noqa
        rows = lambda: dia._zero_chain_rows(A, St, b, dinv, tv, omega)  # noqa
        cost = ((nd + nds + 5) * m * sz, (2 * nd + 2 * nds + 4) * m)

        def composed():
            _, r = dia.dia_jacobi_zero_res(A, b, dinv, omega)
            return dia.dia_spmv_scaled(St, r, tv)
        what = "K3, then K1 SPMV_SCALED"
    else:
        kernel = lambda: dia.dia_jacobi_res(A, x, b, dinv, omega)  # noqa
        plain = lambda: dia.dia_jacobi_res_ref(A, x, b, dinv, omega)  # noqa
        rows = lambda: dia._jacobi_res_rows(A, x, b, dinv, omega)  # noqa
        cost = dia_cost(A, 5, extra_ops=6)

        def composed():
            y = dia.dia_jacobi(A, x, b, dinv, omega)
            return b - dia.dia_spmv(A, y)
        what = "K2, then K1 and b - A y"
    compare(check, name, A.dtype, kernel, plain, results, *cost,
            repeat_exact=True, path=path)
    if plan is not None:
        got, want = kernel(), rows()
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{name}: the strip march equals the per-row kernel bit for "
              "bit")
    log(f"  composed alternative of {name}: "
        f"{min(time_ms(composed), time_ms(composed)):.4f} ms ({what})")


def k11_per_row_checks(check, rand, results):
    """K11's per-row branch in float32 and float64, K = 8, on random
    diagonals of a 100 x 180 x 180 grid's 7-point pattern (A = St's
    pattern; its +-32 400 offset exceeds one lane's ring), and K5's and
    K4's per-row branch on lanes 0 and 1 of the same inputs."""
    import numpy as np
    import torch

    from pyamg_tpu_torch.sparse import DIAMatrix

    n = 100 * 180 * 180
    offsets = (-32400, -180, -1, 0, 1, 180, 32400)
    i = torch.arange(n, device=DEVICE)
    for dtype in (torch.float32, torch.float64):
        ops = []
        for _ in range(2):
            data = rand((len(offsets), n), dtype)
            for d, off in enumerate(offsets):
                data[d][(i + off < 0) | (i + off >= n)] = 0
            ops.append(DIAMatrix(data=data, offsets=offsets, shape=(n, n),
                                 nnz=int(np.count_nonzero(
                                     data.cpu().numpy()))))
        dinv, tv = rand(n, dtype), rand(n, dtype)
        Bk = rand((LANES, n), dtype)
        k11_checks(check, f"dia_zero_chain_k.{str(dtype)[6:]} [3-D 7-point "
                   f"100x180x180 nd=7 K={LANES}, per-row]", *ops, Bk, dinv,
                   tv, 0.8, results)
        # K5 and K4 take their per-row kernel on the same pattern
        b, x = Bk[0].contiguous(), Bk[1].contiguous()
        for mode, kname in (("K5", "dia_zero_chain"),
                            ("K4", "dia_jacobi_res")):
            chain_checks(check, f"{kname}.{str(dtype)[6:]} [3-D 7-point "
                         "100x180x180 nd=7, per-row]", mode, ops[0], ops[1],
                         x, b, dinv, tv, 0.8, results)


def k7_long_column_checks(check, rand, results):
    """K7's tile form on a 2**19 x 2**12 operator with ~128 entries per
    column (longer than a warp) and one column of 2**17 entries (longer
    than the tile budget), float32 and float64: the CPU twin's bits,
    twice."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from pyamg_tpu_torch.sparse import window, windowed_from_scipy

    n, m = 2 ** 19, 2 ** 12
    rng = np.random.default_rng(8)
    rows = np.arange(n)
    cols = np.clip(rows * m // n + rng.integers(-8, 9, n), 0, m - 1)
    extra = np.arange(0, n, 4)
    P = sp.csr_matrix((rng.standard_normal(n + extra.size),
                       (np.concatenate([rows, extra]),
                        np.concatenate([cols, np.full(extra.size,
                                                      m // 2)]))),
                      shape=(n, m))
    for dtype in (torch.float32, torch.float64):
        W = windowed_from_scipy(P, dtype=dtype, device=DEVICE)
        r = rand(W.n_pad, dtype)
        budget, _ = W.column_tiles(window._K7_COLS, window._K7_MIN_BUDGET)
        check(W.data.numel() >= window._K7_TILE_SLOTS * W.m_chunks * W.w2,
              f"long columns {str(dtype)[6:]}: K7 takes its tile form")
        lens = W.column_plan[1].diff()
        sz = W.data.element_size()
        meta = W.data.numel() * sz + (W.idx.numel() + W.starts.numel()) * 4
        mm = W.m_chunks * W.w2
        Wt_csr = windowed_to_csr(W, transpose=True)
        # held to the twin run on CPU copies, bit for bit (the order the
        # kernel sums in); the twin on the card is timed only
        W_cpu = dataclasses.replace(W, data=W.data.cpu(), idx=W.idx.cpu(),
                                    starts=W.starts.cpu())
        r_cpu = r.cpu()
        compare(check, f"windowed_rmatvec.{str(dtype)[6:]} [{n}x{m}, "
                f"columns of {float(lens.float().mean()):.0f} entries on "
                f"average, longest {int(lens.max())}, tile budget {budget}]",
                dtype, lambda: window.windowed_rmatvec(W, r),
                lambda: window.windowed_rmatvec_ref(W, r), results,
                meta + (mm + W.n_pad) * sz, 2 * int((W.data != 0).sum()),
                library_fn=lambda: torch.mv(Wt_csr, r), exact=True,
                repeat_exact=True,
                want_fn=lambda: window.windowed_rmatvec_ref(
                    W_cpu, r_cpu).to(r.device))
        transpose_checks(check, f"long columns {str(dtype)[6:]}", W, r, None)


def lane_launches(check, label, key, fn):
    """Launches of the K-lane kernel instance ``key`` in one call of
    ``fn`` (K12, K13: one per call, every lane in one launch)."""
    import torch

    from pyamg_tpu_torch import _build

    before = _build.launches.get(key, 0)
    fn()
    torch.cuda.synchronize()
    n = _build.launches.get(key, 0) - before
    check(n == 1, f"{label}: {n} launch(es) per call (one expected)")


def path_launches(check, label, counts):
    """Every kernel instance of PATHS[label] launched in ``counts``, K8,
    K9 and K10 only in their lane kernel and K4 / K5 (where the path runs them)
    only in their strip march (the thread-per-row forms, counted as
    ``<kernel>_rows``, are for the shapes those refuse)."""
    for k in PATHS[label]:
        check(counts.get(k, 0) > 0, f"{label}: {k} launched "
              f"({counts.get(k, 0)} launches)")
    rows = {k: c for k, c in counts.items() if k.split(".")[0] in K8_ROWS}
    check(not rows, f"{label}: K8 / K9 / K10 through the lane kernel "
          f"only (thread-per-row launches {rows or 'none'})")
    chain = [CHAIN_ROWS[k.split(".")[0]] for k in PATHS[label]
             if k.split(".")[0] in CHAIN_ROWS]
    if chain:
        per_row = {k: c for k, c in counts.items()
                   if k.split(".")[0] in chain}
        check(not per_row, f"{label}: K4 / K5 through the strip march only "
              f"(per-row launches {per_row or 'none'})")
    gather_only(check, label, counts)


def gather_only(check, label, counts):
    """K6 and K14 (where the path runs them) only in the gather kernel."""
    if not any(k.split(".")[0] in ("windowed_matvec", "windowed_select")
               for k in counts):
        return
    rows = {k: c for k, c in counts.items() if k.split(".")[0] == GATHER_ROWS}
    check(not rows, f"{label}: K6 / K14 through the gather kernel only "
          f"(per-row launches {rows or 'none'})")


def gather_form(plan):
    """A K6 / K14 plan in words."""
    return (f"{plan.grid} CTAs ({plan.ctas_per_block} a row block) of "
            f"{plan.threads} threads, {plan.items} items of {plan.vec} "
            "a CTA")


def k6_rows_check(check, name, W, x):
    """K6 by its plan equal to the per-row kernel bit for bit on the same
    inputs (the plan printed)."""
    import torch

    from pyamg_tpu_torch.sparse import window

    got = window.windowed_matvec(W, x)
    rows = window._windowed_matvec_rows(W, x)
    torch.cuda.synchronize()
    plan = window._gather_plan_for(W, x, got, False)
    check(torch.equal(got, rows), f"{name}: the gather kernel "
          f"({gather_form(plan)}) equals the per-row kernel bit for bit")
    return plan


def empty_floor(W, x, select):
    """Device ms of an empty kernel launched with the grid of W's K6
    (``select`` False) or K14 plan: the floor a launch of that grid
    reaches in ``time_ms``."""
    import torch

    from pyamg_tpu_torch import _build
    from pyamg_tpu_torch.sparse import window

    out = torch.empty(W.idx.shape if select else (W.n_pad,), dtype=x.dtype,
                      device=x.device)
    plan = window._gather_plan_for(W, x, out, select)
    lib = _build.library()
    return time_ms(lambda: _build.check("pyamg_empty_launch",
                                        lib.pyamg_empty_launch(
                                            plan.grid, plan.threads,
                                            torch.cuda.current_stream(
                                            ).cuda_stream)))


def k8_rows_check(check, name, kernel, mode, A, X, b, dinv, omega, lane_fn):
    """K8 / K9's lane kernel equal to its thread-per-row form bit for bit
    on the same inputs (the wrapper's plan taken and printed)."""
    import torch

    from pyamg_tpu_torch.sparse import dia

    plan = dia.k8_plan(A.offsets, A.n_pad, X.shape[0], A.dtype)
    got = lane_fn()
    rows = dia._dia_k_rows(kernel, mode, A, X, b, dinv, omega)
    torch.cuda.synchronize()
    form = (f"{plan.blocks} blocks of {plan.rows} rows, {plan.vec} a "
            f"thread, row blocks [{plan.lo}, {plan.hi}) unchecked"
            if plan is not None else "not taken")
    check(plan is not None and torch.equal(got, rows),
          f"{name}: the lane kernel ({form}) equals the thread-per-row "
          "kernel bit for bit")


def k10_checks(check, name, A, Bk, dinv, omega, results, path=None):
    """K10 against its twin at a path shape, two launches bit-identical,
    its launches a call, and bit for bit against its thread-per-row form,
    with the lane kernel's plan printed (one row a thread in float64 and
    for an odd n_pad or an unaligned operand)."""
    import torch

    from pyamg_tpu_torch.sparse import dia

    K, m = Bk.shape
    kernel = lambda: dia.dia_jacobi_zero_res_k(A, Bk, dinv, omega)  # noqa
    compare(check, name, A.dtype, kernel,
            lambda: dia.dia_jacobi_zero_res_k_ref(A, Bk, dinv, omega),
            results, *dia_cost(A, 1, K, 3, extra_ops=3), path=path,
            repeat_exact=True)
    k = launches_per_call(kernel)
    results[-1]["launches_per_call"] = k
    plan = dia.k8_plan(A.offsets, m, K, A.dtype,
                       dia._aligned(A.data, Bk, dinv))
    got = kernel()
    rows = dia._zero_res_k_rows(A, Bk, dinv, omega)
    torch.cuda.synchronize()
    form = (f"{plan.blocks} blocks of {plan.rows} rows, {plan.vec} a "
            f"thread{' (one row a thread)' if plan.vec == 1 else ''}, row "
            f"blocks [{plan.lo}, {plan.hi}) unchecked"
            if plan is not None else "not taken")
    check(plan is not None and k == 1
          and all(torch.equal(g, r) for g, r in zip(got, rows)),
          f"{name}: the lane kernel ({form}) equals the thread-per-row "
          f"kernel bit for bit; {k} launch(es) a call (the thread-per-row "
          f"form {-(-K // 16)})")


def device_level_checks(check, where, h, rand, results, paths, wide=False):
    """The device-built hierarchy ``h``'s kernels against their twins on
    its levels 0 and 1, float32 and float64: K5, the K-lane K11 (its
    branch and composed alternative), K9 and K8 in its three modes at K =
    8 (each equal to its thread-per-row form bit for bit), and on level 0
    K4 with K1's two epilogues.  ``paths``: the paths whose shapes these
    are, by kind of check ("chain": K5, K4, K2 and K1's epilogues in
    float32, K1 plain in float64; "lanes": the K-lane kernels; "scale":
    K8's scale epilogue; "spmv": K1 plain in float32).  ``wide``:
    also K2 and K1 plain on both levels and K4 and the epilogues on level
    1 (the 3-D W-cycle runs them there); without it, K11 with 16 float64
    lanes (lane groups) at level 0."""
    import torch

    from pyamg_tpu_torch.sparse import DIAMatrix, dia

    def as_dtype(M, dtype):
        return DIAMatrix(data=M.data.to(dtype), offsets=M.offsets,
                         shape=M.shape, nnz=M.nnz)

    path_k, path_scale = paths.get("lanes"), paths.get("scale")
    for label, lvl in (("level0", h.levels[0]), ("level1", h.levels[1])):
        for dtype in (torch.float32, torch.float64):
            Ad, St = as_dtype(lvl.A, dtype), as_dtype(lvl.R.St, dtype)
            S = as_dtype(lvl.P.S, dtype)
            dinv, omega = (a.to(dtype) for a in lvl.pre.arrays)
            tv = lvl.R.tv.to(dtype)
            m = Ad.n_pad
            b, x, t = (rand(m, dtype) for _ in range(3))
            nds = St.ndiags
            tag = f"{where} {label} nd={Ad.ndiags} St nd={nds} n_pad={m}"
            dt = str(dtype).removeprefix("torch.")
            p1 = paths.get("chain") if dtype == torch.float32 else None
            chain_checks(check, f"dia_zero_chain.{dt} [{tag}]", "K5", Ad,
                         St, None, b, dinv, tv, omega, results, path=p1)
            Xk, Bk, Vk = (rand((LANES, m), dtype) for _ in range(3))
            ktag = f"{tag} K={LANES}"
            k11_checks(check, f"dia_zero_chain_k.{dt} [{ktag}]", Ad, St,
                       Bk, dinv, tv, omega, results, path=path_k)
            if label == "level0" and dtype == torch.float64 and not wide:
                # lane groups: 16 float64 lanes, four rings of 4 lanes
                B16 = rand((2 * LANES, m), dtype)
                k11_checks(check, f"dia_zero_chain_k.{dt} [{tag} "
                           f"K={2 * LANES}]", Ad, St, B16, dinv, tv, omega,
                           results)
                del B16
            compare(check, f"dia_jacobi_k.{dt} [{ktag}]", dtype,
                    lambda: dia.dia_jacobi_k(Ad, Xk, Bk, dinv, omega),
                    lambda: dia.dia_jacobi_k_ref(Ad, Xk, Bk, dinv, omega),
                    results, *dia_cost(Ad, 1, LANES, 3, extra_ops=4),
                    path=path_k)
            k8_rows_check(check, f"dia_jacobi_k.{dt} [{ktag}]",
                          "dia_jacobi_k", dia._JACOBI_K, Ad, Xk, Bk, dinv,
                          omega, lambda: dia.dia_jacobi_k(Ad, Xk, Bk, dinv,
                                                          omega))
            lib = lib_add = None
            A_csr = S_csr = None
            if label == "level0" or wide:
                A_csr, S_csr = dia_to_csr(Ad), dia_to_csr(S)
                Xcols, Vcols = Xk.T.contiguous(), Vk.T.contiguous()
                lib = lambda: torch.sparse.mm(A_csr, Xcols)   # noqa: E731
                lib_add = lambda: torch.addmm(               # noqa: E731
                    Vcols, S_csr, Xcols)
            compare(check, f"dia_spmm.{dt} [{ktag}]", dtype,
                    lambda: dia.dia_spmm(Ad, Xk),
                    lambda: dia.dia_spmm_ref(Ad, Xk), results,
                    *dia_cost(Ad, 0, LANES, 2), library_fn=lib, path=path_k)
            k8_rows_check(check, f"dia_spmm.{dt} [{ktag}]", "dia_spmm",
                          dia._SPMM, Ad, Xk, None, None, 0.0,
                          lambda: dia.dia_spmm(Ad, Xk))
            stag = f"{where} {label} St nd={nds} n_pad={m} K={LANES}"
            compare(check, f"dia_spmm_scaled.{dt} [{stag}]", dtype,
                    lambda: dia.dia_spmm_scaled(St, Xk, tv),
                    lambda: dia.dia_spmm_scaled_ref(St, Xk, tv), results,
                    *dia_cost(St, 1, LANES, 2, extra_ops=1),
                    path=path_scale)
            k8_rows_check(check, f"dia_spmm_scaled.{dt} [{stag}]",
                          "dia_spmm_scaled", dia._SPMM_SCALED, St, Xk, tv,
                          None, 0.0, lambda: dia.dia_spmm_scaled(St, Xk, tv))
            atag = f"{where} {label} S nd={S.ndiags} n_pad={m} K={LANES}"
            compare(check, f"dia_spmm_add.{dt} [{atag}]", dtype,
                    lambda: dia.dia_spmm_add(S, Xk, Vk),
                    lambda: dia.dia_spmm_add_ref(S, Xk, Vk), results,
                    *dia_cost(S, 0, LANES, 3, extra_ops=1),
                    library_fn=lib_add, path=path_k)
            k8_rows_check(check, f"dia_spmm_add.{dt} [{atag}]",
                          "dia_spmm_add", dia._SPMM_ADD, S, Xk, Vk, None,
                          0.0, lambda: dia.dia_spmm_add(S, Xk, Vk))
            del Xk, Bk, Vk
            if label != "level0" and not wide:
                continue
            chain_checks(check, f"dia_jacobi_res.{dt} [{tag}]", "K4", Ad,
                         None, x, b, dinv, None, omega, results, path=p1)
            compare(check, f"dia_spmv_add.{dt} [{where} {label} S nd="
                    f"{S.ndiags} n_pad={m}]", dtype,
                    lambda: dia.dia_spmv_add(S, t, x),
                    lambda: dia.dia_spmv_add_ref(S, t, x),
                    results, *dia_cost(S, 3, extra_ops=1),
                    library_fn=lambda: torch.addmv(x, S_csr, t), path=p1)
            compare(check, f"dia_spmv_scaled.{dt} [{where} {label} St nd="
                    f"{nds} n_pad={m}]", dtype,
                    lambda: dia.dia_spmv_scaled(St, x, tv),
                    lambda: dia.dia_spmv_scaled_ref(St, x, tv),
                    results, *dia_cost(St, 3, extra_ops=1), path=p1)
            if not wide:
                continue
            # the outer loop's A64 apply (float64) and AMLI's coarse
            # products (float32) are K1 plain; every post-smoothing is K2
            compare(check, f"dia_spmv.{dt} [{tag}]", dtype,
                    lambda: dia.dia_spmv(Ad, x),
                    lambda: dia.dia_spmv_ref(Ad, x), results,
                    *dia_cost(Ad, 2),
                    path=paths.get("chain" if p1 is None else "spmv"),
                    library_fn=lambda: torch.mv(A_csr, x))
            compare(check, f"dia_jacobi.{dt} [{tag}]", dtype,
                    lambda: dia.dia_jacobi(Ad, x, b, dinv, omega),
                    lambda: dia.dia_jacobi_ref(Ad, x, b, dinv, omega),
                    results, *dia_cost(Ad, 4, extra_ops=4), path=p1)
            del A_csr, S_csr


def dia_cost(A, vectors, lanes=1, stacks=0, extra_ops=0):
    """(bytes, operations) of a DIA pass: A's diagonals, ``vectors``
    shared (n_pad,) vectors and ``stacks`` (lanes, n_pad) stacks, each
    read or written once; 2 operations per stored diagonal entry per lane
    plus ``extra_ops`` per row and lane."""
    n, sz = A.n_pad, A.data.element_size()
    nbytes = (A.ndiags + vectors + stacks * lanes) * n * sz
    return nbytes, (2 * A.ndiags + extra_ops) * n * lanes


def dia_to_csr(A, transpose=False):
    """The DIA operator (its transpose where ``transpose``) as a torch CSR
    matrix on its device (the library yardstick's input)."""
    import torch

    n = A.n_pad
    i = torch.arange(n, device=A.device)
    rows, cols, vals = [], [], []
    for d, off in enumerate(A.offsets):
        j = i + off
        m = (j >= 0) & (j < n) & (A.data[d] != 0)
        rows.append(i[m])
        cols.append(j[m])
        vals.append(A.data[d][m])
    rows, cols = (cols, rows) if transpose else (rows, cols)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n, n)).coalesce()
    return coo.to_sparse_csr()


def scipy_to_csr(M, dtype, dev):
    import torch

    M = M.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(M.indptr, dtype=torch.int64),
        torch.as_tensor(M.indices, dtype=torch.int64),
        torch.as_tensor(M.data), size=M.shape).to(dtype=dtype, device=dev)


def to_device(obj, dev):
    """A copy of a hierarchy (frozen dataclasses, tuples, tensors) with
    every tensor on ``dev``."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple):
        return tuple(to_device(o, dev) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj)})
    return obj


def forms(lvl):
    out = []
    for op in (lvl.A, lvl.P, lvl.R):
        if op is None:
            continue
        name = type(op).__name__
        if hasattr(op, "ops"):
            name += "(" + ",".join(type(o).__name__ for o in op.ops) + ")"
        for attr in ("S", "St"):
            if hasattr(op, attr):
                name += f"({attr} nd={getattr(op, attr).ndiags})"
        if hasattr(op, "ndiags"):
            name += f"(nd={op.ndiags})"
        out.append(name)
    return " ".join(out)


def solve_phase(check, label, solver, A, b, ref_iters, launches):
    """Mixed CG to 1e-8 on ``solver``: counters zeroed just before the
    timed solve and read just after; four repeats for the median."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import _build

    kw = dict(tol=1e-8, maxiter=100, accel="cg", precision="mixed")
    solver.solve(b, **kw)                      # warm-up (library handles)
    torch.cuda.synchronize()
    _build.reset_launches()
    res = []
    t0 = time.perf_counter()
    x = solver.solve(b, residuals=res, **kw)
    times = [time.perf_counter() - t0]
    counts = dict(_build.launches)
    for _ in range(4):
        t0 = time.perf_counter()
        solver.solve(b, **kw)
        times.append(time.perf_counter() - t0)
    n = A.shape[0]
    iters = len(res) - 1
    normb = float(np.linalg.norm(b))
    relres_hist = res[-1] / normb
    relres_true = float(np.linalg.norm(b - A @ x)) / normb
    log(f"{label} (2048^2, mixed, CG to 1e-8): {iters} iterations, "
        f"history relres {relres_hist:.3e}, true relres {relres_true:.3e}, "
        f"solve {times[0]:.4f} s (repeats "
        f"{', '.join(f'{t:.4f}' for t in times[1:])} s, median "
        f"{float(np.median(times)):.4f} s)")
    log(f"  history: {' '.join(f'{r / normb:.3e}' for r in res)}")
    log(f"  launches in that solve: {json.dumps(counts, sort_keys=True)}")
    check(x.shape == (n,) and bool(np.isfinite(x).all()),
          f"{label}: solution finite, shape (n,)")
    check(relres_hist <= 1e-8 and relres_true <= 1e-8,
          f"{label}: relative residual <= 1e-8")
    check(abs(iters - ref_iters) <= 1,
          f"{label}: {iters} CG iterations within {ref_iters} +- 1 "
          "(reference)")
    path_launches(check, label, counts)
    launches[label] = counts


def stationary_phase(check, label, solver, b, launches):
    """accel=None, native, 5 V-cycles on the card (counters zeroed just
    before, read just after) against the same run on a CPU copy of the
    hierarchy (the plain twins).  ``b`` is a vector or an (n, K) stack."""
    import numpy as np

    from pyamg_tpu_torch import _build

    kw = dict(tol=0.0, maxiter=5, accel=None, precision="native")
    _build.reset_launches()
    res_g = []
    solver.solve(b, residuals=res_g, **kw)
    launches[label] = dict(_build.launches)
    res_c = []
    cpu_copy_of(solver).solve(b, residuals=res_c, **kw)
    if np.ndim(b) == 1:
        res_g, res_c = [res_g], [res_c]
    st_err = max(float(np.max(np.abs(np.subtract(g, c)) / np.asarray(c)))
                 for g, c in zip(res_g, res_c))
    for k, g in enumerate(res_g):
        log(f"{label} lane {k} (256^2, f32, accel=None, 5 cycles): card "
            f"history {' '.join(f'{r:.6e}' for r in g)}")
    log(f"  launches: {json.dumps(launches[label], sort_keys=True)}")
    check(all(len(g) == len(c) == 6 for g, c in zip(res_g, res_c))
          and st_err <= STATIONARY_RTOL,
          f"{label}: history vs the CPU copy (twins) rel diff {st_err:.2e} "
          f"(tol {STATIONARY_RTOL:g}); factor lane 0 "
          f"{(res_g[0][-1] / res_g[0][0]) ** 0.2:.4f}")
    path_launches(check, label, launches[label])


def batched_phase(check, label, solver, A, launches, ref_native,
                  ref_mixed):
    """Batched config 1: K = 8 lanes, native f32 CG to 1e-5 and mixed CG to
    1e-8 (counters zeroed before both, read after both), then wall times
    per solve and per right-hand side beside the 1-D solve of column 0.
    Every lane takes its own column's 1-D native solve's count +- 1, and
    the reference's counts +- 1 where given (``ref_native`` None: the
    reference has no batched count for this hierarchy).  B lives on the
    card, so the times exclude the host copies of the (n, 8) float64
    stack."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import _build

    n = A.shape[0]
    B = np.random.default_rng(3).random((n, LANES))
    Bt = torch.as_tensor(B, device=solver.hierarchy.device)
    native = dict(tol=1e-5, maxiter=100, accel="cg", precision="native")
    mixed = dict(tol=1e-8, maxiter=100, accel="cg", precision="mixed")
    solver.solve(Bt, **native)                 # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    res_n, res_m = [], []
    Xn, info_n = solver.solve(Bt, residuals=res_n, return_info=True,
                              **native)
    Xm, info_m = solver.solve(Bt, residuals=res_m, return_info=True, **mixed)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    launches[label] = counts
    Xn, Xm = Xn.cpu().numpy(), Xm.cpu().numpy()
    normb = np.linalg.norm(B, axis=0)
    it_n = [len(r) - 1 for r in res_n]
    it_m = [len(r) - 1 for r in res_m]
    true_n = np.linalg.norm(B - A @ Xn, axis=0) / normb
    true_m = np.linalg.norm(B - A @ Xm, axis=0) / normb
    hist_m = np.array([r[-1] for r in res_m]) / normb
    it_1 = []
    for j in range(LANES):
        res_1 = []
        solver.solve(Bt[:, j].contiguous(), residuals=res_1, **native)
        it_1.append(len(res_1) - 1)
    times = {}
    for key, b, kw in (("batched native", Bt, native),
                       ("1-D native", Bt[:, 0].contiguous(), native),
                       ("batched mixed", Bt, mixed),
                       ("1-D mixed", Bt[:, 0].contiguous(), mixed)):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            solver.solve(b, **kw)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[key] = float(np.median(ts))
    log(f"{label} (2048^2, K={LANES}, b on the card):")
    log(f"  native f32 CG to 1e-5: iterations per lane {it_n} (info "
        f"{info_n}); true relres max {true_n.max():.3e}; 1-D solves of the "
        f"columns: {it_1} iterations")
    log(f"  mixed CG to 1e-8: iterations per lane {it_m} (info {info_m}); "
        f"history relres max {hist_m.max():.3e}, true relres max "
        f"{true_m.max():.3e}")
    for kind in ("native", "mixed"):
        tb, t1 = times[f"batched {kind}"], times[f"1-D {kind}"]
        log(f"  {kind}: batched solve {tb:.4f} s = {tb / LANES:.4f} s per "
            f"right-hand side; 1-D solve {t1:.4f} s; amortization "
            f"{t1 * LANES / tb:.2f}x (median of 3)")
    log(f"  launches in those two solves: {json.dumps(counts, sort_keys=True)}")
    check(Xn.shape == Xm.shape == (n, LANES)
          and bool(np.isfinite(Xn).all() and np.isfinite(Xm).all()),
          f"{label}: solutions finite, shape (n, {LANES})")
    if ref_native is not None:
        check(all(abs(i - ref_native) <= 1 for i in it_n) and info_n == 0,
              f"{label}: native f32 lanes {it_n} within {ref_native} +- 1 "
              "(reference) to 1e-5")
    check(all(abs(i - i1) <= 1 for i, i1 in zip(it_n, it_1))
          and info_n == 0,
          f"{label}: native f32 lanes {it_n} within +- 1 of their 1-D "
          f"solves {it_1} to 1e-5")
    check(all(abs(i - ref_mixed) <= 1 for i in it_m) and info_m == 0,
          f"{label}: mixed lanes {it_m} within {ref_mixed} +- 1 "
          "(reference) to 1e-8")
    check(bool(hist_m.max() <= 1e-8 and true_m.max() <= 1e-8),
          f"{label}: every lane's true relres <= 1e-8 ({true_m.max():.3e})")
    path_launches(check, label, counts)


def interleaved_phase(check, dla, A, launches):
    """The lane-aligned device-built config 1, K = 8, B =
    default_rng(3).random((n, 8)) on the card: native f32 CG to 1e-5 takes
    the interleaved route (every K15 mode launched, the reference's 13 +-
    1 iterations per lane), then mixed CG to 1e-8 takes the K-major path
    at the lane-aligned n_pad (no K15 launch; every lane's true relres <=
    1e-8); counters zeroed just before each solve and read just after;
    wall times per solve and per right-hand side."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import _build

    n = A.shape[0]
    B = np.random.default_rng(3).random((n, LANES))
    Bt = torch.as_tensor(B, device=dla.hierarchy.device)
    native = dict(tol=1e-5, maxiter=100, accel="cg")
    mixed = dict(tol=1e-8, maxiter=100, accel="cg", precision="mixed")
    dla.solve(Bt, **native)                    # warm-up
    dla.solve(Bt, **mixed)
    torch.cuda.synchronize()
    label = "interleaved batched config 1"
    _build.reset_launches()
    res_n = []
    Xn, info_n = dla.solve(Bt, residuals=res_n, return_info=True, **native)
    torch.cuda.synchronize()
    counts_n = launches[label] = dict(_build.launches)
    label_m = "lane-aligned batched mixed"
    _build.reset_launches()
    res_m = []
    Xm, info_m = dla.solve(Bt, residuals=res_m, return_info=True, **mixed)
    torch.cuda.synchronize()
    counts_m = launches[label_m] = dict(_build.launches)
    Xn, Xm = Xn.cpu().numpy(), Xm.cpu().numpy()
    normb = np.linalg.norm(B, axis=0)
    it_n = [len(r) - 1 for r in res_n]
    it_m = [len(r) - 1 for r in res_m]
    hist_n = np.array([r[-1] for r in res_n]) / normb
    true_n = np.linalg.norm(B - A @ Xn, axis=0) / normb
    true_m = np.linalg.norm(B - A @ Xm, axis=0) / normb
    times = {}
    for key, kw in (("interleaved native", native),
                    ("K-major mixed", mixed)):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            dla.solve(Bt, **kw)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[key] = float(np.median(ts))
    log(f"{label} (2048^2 lane-aligned, grid_p {dla.grid_p}, n_pad "
        f"{dla.hierarchy.levels[0].n_pad}, K={LANES}, b on the card):")
    log(f"  native f32 CG to 1e-5 (interleaved route): iterations per lane "
        f"{it_n} (info {info_n}); history relres max {hist_n.max():.3e}, "
        f"true relres max {true_n.max():.3e}")
    log(f"  mixed CG to 1e-8 (K-major path): iterations per lane {it_m} "
        f"(info {info_m}); true relres max {true_m.max():.3e}")
    for key, t in times.items():
        log(f"  {key}: {t:.4f} s per solve = {t / LANES:.4f} s per "
            "right-hand side (median of 3)")
    log(f"  launches, native: {json.dumps(counts_n, sort_keys=True)}")
    log(f"  launches, mixed: {json.dumps(counts_m, sort_keys=True)}")
    check(Xn.shape == Xm.shape == (n, LANES)
          and bool(np.isfinite(Xn).all() and np.isfinite(Xm).all()),
          f"{label}: solutions finite, shape (n, {LANES})")
    check(all(abs(i - REF_ITERS_BATCHED_1E5) <= 1 for i in it_n)
          and info_n == 0 and hist_n.max() <= 1e-5,
          f"{label}: native f32 lanes {it_n} within {REF_ITERS_BATCHED_1E5}"
          " +- 1 (reference) to 1e-5")
    check(info_m == 0 and true_m.max() <= 1e-8
          and not any(k.startswith("int_") for k in counts_m),
          f"{label_m}: lanes {it_m} converged to true relres "
          f"{true_m.max():.3e} <= 1e-8 on the K-major path")
    for lab, counts in ((label, counts_n), (label_m, counts_m)):
        path_launches(check, lab, counts)


def profile_phase(title, runs, top=6):
    """A torch.profiler trace of each (label, fn) call, after a warm one:
    wall time, CUDA kernel time, kernel launches, the device's busy share,
    and the ``top`` largest kernels (by name with their template
    arguments: a block-DIA kernel's <T, BS, lane tile, mode>)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    log(f"profile (torch.profiler, CUDA kernels; {title}):")
    for label, fn in runs:
        fn()                                   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                          e.name)
            name = name if len(name) < 60 else name[:57] + "..."
            t, c = kern.get(name, (0.0, 0))
            kern[name] = (t + e.device_time_total / 1e3, c + 1)
        busy = sum(t for t, _ in kern.values())
        launches = sum(c for _, c in kern.values())
        share = (f"{busy / (wall * 1e3):.3f}" if busy > 0
                 else "not measured (no device events in the trace)")
        log(f"  {label}: wall {wall * 1e3:.2f} ms, kernel time {busy:.2f} "
            f"ms, {launches} kernels, device busy share {share}")
        for name, (t, c) in sorted(kern.items(),
                                   key=lambda kv: -kv[1][0])[:top]:
            log(f"    {t:8.3f} ms {c:5d}x  {name}")


def sync_free_cycle(check, cycle, r, what, kind="V"):
    """One ``kind`` cycle ``cycle(r)`` with every host sync an error."""
    import torch

    cycle(r)                                   # warm: cached offsets
    torch.cuda.synchronize()
    y = None
    try:
        torch.cuda.set_sync_debug_mode("error")
        y = cycle(r)
        sync_err = None
    except RuntimeError as exc:
        sync_err = str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(sync_err is None and y is not None and y.shape == r.shape
          and bool(torch.isfinite(y).all()),
          f"one {kind}-cycle on {what} under set_sync_debug_mode('error'): "
          + ("no host sync" if sync_err is None else sync_err))


def lane_cycle_times(check, dla, rand):
    """The lane-aligned hierarchy's zero V-cycle on K = 8 lanes, the
    interleaved one against the K-major one (CUDA events, 20 cycles each,
    min of 2 turns), per right-hand side; the layout conversion beside
    them; and the two corrections against each other (f32)."""
    import torch

    from pyamg_tpu_torch import DeviceMultilevelSolver
    from pyamg_tpu_torch.engine.batched_cycle import interleaved_zero_vcycle
    from pyamg_tpu_torch.sparse.interleaved import (from_interleaved,
                                                    to_interleaved)

    h = dla.hierarchy
    Bk = rand((LANES, h.levels[0].n_pad), torch.float32)
    Bi = to_interleaved(Bk)
    kmajor = DeviceMultilevelSolver(h).cycle_operator("V")
    t_int, t_km = [], []
    for _ in range(2):
        t_int.append(time_ms(lambda: interleaved_zero_vcycle(h, Bi), 20))
        t_km.append(time_ms(lambda: kmajor(Bk), 20))
    t_conv = time_ms(lambda: from_interleaved(to_interleaved(Bk)), 20)
    err = float((from_interleaved(interleaved_zero_vcycle(h, Bi))
                 - kmajor(Bk)).abs().max() / kmajor(Bk).abs().max())
    log(f"lane-aligned V-cycle, K={LANES} (CUDA events, 20 cycles, min of "
        f"2): interleaved {min(t_int):.4f} ms = {min(t_int) / LANES:.4f} ms "
        f"per right-hand side; K-major {min(t_km):.4f} ms = "
        f"{min(t_km) / LANES:.4f} ms per right-hand side; to_interleaved + "
        f"from_interleaved of the stack {t_conv:.4f} ms")
    check(err <= 1e-4, f"interleaved V-cycle vs the K-major one: max rel "
          f"diff {err:.2e} (tol 1e-4, f32 sums in another order)")
    sync_free_cycle(check, lambda r: interleaved_zero_vcycle(h, r), Bi,
                    f"a K={LANES} interleaved stack (lane-aligned)")

def halo_ring_check(check, A, rand, results, tag, path):
    """K16 as a ring of one on the DIA operator A: against its plain twin
    (the rolled sum over [tail, x, head]) at the kernel tolerance, a second
    launch with the first one's bits, one launch a call (its plan printed:
    the row blocks, rows a thread and the interior), and bit for bit
    against K1.  Returns (x, K1's y, the bytes of one SpMV)."""
    import torch

    from pyamg_tpu_torch.parallel import halo_width
    from pyamg_tpu_torch.parallel.dist_spmv import dia_halo_rows_ref
    from pyamg_tpu_torch.parallel.halo_spmv import halo_plan, halo_spmv
    from pyamg_tpu_torch.parallel.partition import SolverMesh
    from pyamg_tpu_torch.sparse import dia

    one = SolverMesh(rank=0, world=1, device=A.device)
    dtype, n, halo = A.dtype, A.n_pad, halo_width(A)
    dt = str(dtype).removeprefix("torch.")
    x = rand(n, dtype)
    A_csr = dia_to_csr(A)

    def ring():
        return halo_spmv(A.data, A.offsets, A.offsets_t, x, halo, one, 1)

    def plain():
        return dia_halo_rows_ref(A.data, A.offsets, x[n - halo:], x,
                                 x[:halo], halo, ((0, n),),
                                 torch.empty_like(x))

    nbytes, ops = dia_cost(A, 2)
    compare(check, f"dia_halo_spmv.{dt} [{tag} ring of one]", dtype, ring,
            plain, results, nbytes, ops,
            library_fn=lambda: torch.mv(A_csr, x), path=path,
            repeat_exact=True)
    k = launches_per_call(ring)
    results[-1]["launches_per_call"] = k
    plan = halo_plan(tuple(A.offsets), n, dtype)
    k1 = dia.dia_spmv(A, x)
    torch.cuda.synchronize()
    check(torch.equal(ring(), k1) and k == 1,
          f"dia_halo_spmv.{dt} [{tag}]: the ring of one ({plan.row_blocks} "
          f"row blocks of {plan.rows} rows, {plan.vec} a thread"
          f"{' (one row a thread)' if plan.vec == 1 else ''}, interior "
          f"[{plan.lo}, {plan.hi})) equals K1 (dia_spmv) bit for bit in "
          f"{k} launch(es) a call (the split form took two)")
    return x, k1, nbytes


def halo_shards_check(check, A, x, k1, nbytes, tag, side, shards=4):
    """K16 on ``shards`` in-process row blocks of A (halos copied on the
    side stream ``side``) against K1's ``k1`` bit for bit; then the
    interior alone, the halo copies alone and the overlapped total beside
    K1, the plain twin (the rolled-DIA SpMV), ``torch.mv`` on A as CSR
    (the same product) and the bound (``nbytes`` of one SpMV)."""
    import torch

    from pyamg_tpu_torch.parallel.halo_spmv import (halo_plan,
                                                    halo_spmv_shards)
    from pyamg_tpu_torch.sparse import dia

    dt = str(A.dtype).removeprefix("torch.")
    split = halo_spmv_shards(A, x, shards, side)
    torch.cuda.synchronize()
    plan = halo_plan(tuple(A.offsets), A.n_pad // shards, A.dtype)
    check(torch.equal(split, k1),
          f"dia_halo_spmv.{dt} [{tag}]: {shards} in-process shards (each "
          f"{plan.row_blocks} row blocks of {plan.rows} rows, interior "
          f"[{plan.lo}, {plan.hi})) equal K1 (dia_spmv) bit for bit")
    t = {}
    for label, phases in (("interior", ("interior",)),
                          ("halo copies", ("halos",)),
                          ("overlapped", ("interior", "halos",
                                          "boundary"))):
        t[label] = min(time_ms(lambda: halo_spmv_shards(
            A, x, shards, side, phases=phases)) for _ in range(2))
    t_k1 = min(time_ms(lambda: dia.dia_spmv(A, x)) for _ in range(2))
    A_csr = dia_to_csr(A)
    t_plain = time_ms(lambda: dia.dia_spmv_ref(A, x))
    t_lib = time_ms(lambda: torch.mv(A_csr, x))
    log(f"  K16 {shards} shards in one process [{dt} {tag}]: interior "
        f"alone {t['interior']:.4f} ms, halo copies alone (side stream, "
        f"{2 * shards} copies) {t['halo copies']:.4f} ms, overlapped "
        f"total {t['overlapped']:.4f} ms; K1 on the whole operator "
        f"{t_k1:.4f} ms; plain {t_plain:.4f} ms; library {t_lib:.4f} ms "
        f"(torch.mv, CSR); bound {nbytes / PEAK_BYTES * 1e3:.4f} ms (bytes)")


def halo_phase(check, h, rand, results):
    """K16 at host level 0 of 2048^2 (nd = 5, n = 4.19M, halo 2048), in
    float32 (the level's operator) and float64 (A64): the ring of one
    against its plain twin (the rolled sum over [tail, x, head]) and bit
    for bit against K1 in one launch; P = 4 in-process row blocks (halos
    copied on a side stream) against K1; then the interior alone, the halo
    copies alone and the overlapped total beside K1 and the bound.  One
    H100 gives no scaling number."""
    import torch

    from pyamg_tpu_torch.parallel import halo_width

    side = torch.cuda.Stream()
    for A in (h.levels[0].A, h.A64):
        tag = (f"host level0 nd={A.ndiags} n_pad={A.n_pad} "
               f"halo={halo_width(A)}")
        x, k1, nbytes = halo_ring_check(
            check, A, rand, results, tag, "sharded host-built config 1"
            if A.dtype == torch.float32 else None)
        halo_shards_check(check, A, x, k1, nbytes, tag, side)


def sharded_phase(check, dev, dml, A, dus, A_un, drs, launches):
    """Row-sharded solves in a world of one NCCL rank (file:// rendezvous
    in a temporary directory): the host-built config 1 hierarchy sharded
    (every level a ring of one; its DIA levels through K16), native f32 CG
    to 1e-5, and the 640k unstructured SA and RS (modified: P's two
    windowed factors sharded one by one) hierarchies sharded, f32 CG to
    1e-6; each against the unsharded solve of the same b in this run (the same
    iterations; the reference's 7 +- 1 for the unstructured one),
    counters zeroed just before each sharded solve and read just after,
    wall times (numpy b and x, median of 3).  The process group is
    destroyed before returning."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from pyamg_tpu_torch import DeviceMultilevelSolver, _build
    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh, shard_hierarchy)

    with tempfile.TemporaryDirectory() as tmp:
        rank, world, _ = initialize_distributed(
            init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
            device=dev)
        try:
            mesh = make_solver_mesh(device=dev)
            log(f"sharded solves: torch.distributed {dist.get_backend()}, "
                f"rank {rank} of {world} (file:// rendezvous)")
            # the solves below send nothing (every level is a ring of one),
            # so the NCCL collectives on card tensors run here once
            v = torch.arange(1024.0, device=dev)
            parts, s = [torch.empty_like(v)], v.clone()
            dist.all_gather(parts, v)
            dist.all_reduce(s)
            check(torch.equal(parts[0], v) and torch.equal(s, v),
                  "NCCL all_gather and all_reduce of a card tensor in the "
                  "world of one")
            for label, solver, M, b, tol, ref in (
                    ("sharded host-built config 1", dml, A,
                     np.random.default_rng(1).random(A.shape[0]), 1e-5, None),
                    ("sharded unstructured", dus, A_un,
                     np.random.default_rng(0).standard_normal(A_un.shape[0]),
                     1e-6, UNSTR_REF_ITERS),
                    ("sharded unstructured RS", drs, A_un,
                     np.random.default_rng(0).standard_normal(A_un.shape[0]),
                     1e-6, None)):
                kw = dict(tol=tol, maxiter=100, accel="cg")
                t0 = time.perf_counter()
                sharded = DeviceMultilevelSolver(
                    shard_hierarchy(solver.hierarchy, mesh))
                t_shard = time.perf_counter() - t0
                res0 = []
                solver.solve(b, residuals=res0, **kw)
                sharded.solve(b, **kw)                 # warm-up
                torch.cuda.synchronize()
                _build.reset_launches()
                res1 = []
                x = sharded.solve(b, residuals=res1, **kw)
                torch.cuda.synchronize()
                counts = launches[label] = dict(_build.launches)
                times = {}
                for key, s in (("sharded", sharded), ("unsharded", solver)):
                    ts = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        s.solve(b, **kw)
                        ts.append(time.perf_counter() - t0)
                    times[key] = float(np.median(ts))
                normb = float(np.linalg.norm(b))
                it0, it1 = len(res0) - 1, len(res1) - 1
                true_rel = float(np.linalg.norm(
                    b - M @ x.astype(np.float64))) / normb
                m = min(it0, it1) + 1
                hist_diff = float(np.max(np.abs(np.subtract(
                    res1[:m], res0[:m])) / np.asarray(res0[:m])))
                log(f"{label} (world of one, native f32 CG to {tol:g}): "
                    f"{it1} iterations (unsharded {it0}), history relres "
                    f"{res1[-1] / normb:.3e}, true relres {true_rel:.3e}, "
                    f"history vs unsharded max rel diff {hist_diff:.2e}; "
                    f"shard_hierarchy {t_shard:.3f} s; solve "
                    f"{times['sharded']:.4f} s sharded, "
                    f"{times['unsharded']:.4f} s unsharded (numpy b, "
                    "median of 3)")
                log(f"  launches in that solve: "
                    f"{json.dumps(counts, sort_keys=True)}")
                check(x.shape == (M.shape[0],) and bool(np.isfinite(x).all())
                      and res1[-1] <= tol * normb,
                      f"{label}: solution finite, relres <= {tol:g}")
                check(it1 == it0, f"{label}: {it1} CG iterations, the "
                      f"unsharded solve's {it0}")
                if ref is not None:
                    check(abs(it1 - ref) <= 1, f"{label}: {it1} iterations "
                          f"within {ref} +- 1 (reference)")
                for k in PATHS[label]:
                    check(counts.get(k, 0) > 0, f"{label}: {k} launched "
                          f"({counts.get(k, 0)} launches)")
        finally:
            dist.destroy_process_group()


# the reference's 640k unstructured case (scripts/measure_unstructured_tpu.py:
# a P1 stiffness matrix on a regular 800^2 triangle mesh plus 1e-2 I)
UNSTR_NX = 800
UNSTR_MAX_COARSE = 1000
UNSTR_LEVELS = (640000, 207874, 24773)   # levels 0-2, JAX on the CPU and TPU
UNSTR_DEEP_CPU = (1700, 118)             # levels 3+, JAX on the CPU
# levels 3+ and the routed float32 aggressive run's true relres on the
# card on every run since the transposes sum in a fixed order (PERF.md
# §6); a change that keeps every kernel's arithmetic keeps them
UNSTR_DEEP_FIXED = (1698, 114)
ROUTED_F32_TRUE_FIXED = "4.458e-04"
UNSTR_REF_ITERS = 7                      # f32 CG to 1e-6, JAX CPU and TPU
PROBE_LANES = 64                         # the setup's probe chunk width
ROUTED_NX = 200
# the jittered mesh has many inverted elements, so CG takes far more
# iterations than on the regular mesh (tests/test_torch_unstructured.py
# holds the count equal to the reference's on the 40^2 stand-in)
ROUTED_MAXITER = 400


def fem_operator(nx, jitter_seed=None):
    """The P1 stiffness matrix of a regular nx^2 triangle mesh plus 1e-2 I;
    with ``jitter_seed`` the interior vertices move by 0.25/nx standard
    normal steps (the reference's airfoil stand-in,
    pyamg_tpu/gallery/example.py:38-48)."""
    import numpy as np
    import scipy.sparse as sp

    from pyamg_tpu_torch import gradgradform, regular_triangle_mesh

    V, E = regular_triangle_mesh(nx, nx)
    if jitter_seed is not None:
        rng = np.random.default_rng(jitter_seed)
        interior = ((V[:, 0] > 0) & (V[:, 0] < 1) & (V[:, 1] > 0)
                    & (V[:, 1] < 1))
        V = V + 0.25 / nx * rng.standard_normal(V.shape) * interior[:, None]
    A = sp.csr_matrix(gradgradform(V, E))
    return (A + 1e-2 * sp.eye(A.shape[0], format="csr")).tocsr()


def windowed_to_csr(W, transpose=False):
    """A windowed operator (or its transpose) as a torch CSR matrix on its
    device (the library yardstick's input)."""
    import torch

    from pyamg_tpu_torch.sparse.window import _global_index

    rows = torch.arange(W.n_pad, device=W.device).reshape(
        -1, 1, W.block).expand(W.data.shape)
    cols = _global_index(W)
    live = W.data != 0
    ij = torch.stack([rows[live], cols[live]])
    shape = (W.n_pad, W.m_chunks * W.w2)
    if transpose:
        ij, shape = ij.flip(0), shape[::-1]
    return torch.sparse_coo_tensor(ij, W.data[live], shape).coalesce(
    ).to_sparse_csr()


def windowed_kernel_checks(check, where, selects, ops, probes, dtype, rand,
                           results, path, lanes=None, lane_path=None,
                           vectors=True):
    """The windowed kernels at a hierarchy's shapes, in ``dtype`` (the
    operators' dtype), results tagged with ``path``: K14 on each (label,
    W) of ``selects`` (bit-exact against its twin; torch.take on the
    precomputed int64 index as the yardstick), K6/K7 on each of ``ops``
    (unless ``vectors`` is False), and K12/K13 at ``lanes`` lanes (the
    unstructured setup's probe width by default), tagged with
    ``lane_path`` (default ``path``), on those of ``ops`` whose labels
    are in ``probes``."""
    import torch

    from pyamg_tpu_torch.sparse import window

    dt = str(dtype).removeprefix("torch.")
    for label, W in selects:
        gidx = window._global_index(W)
        m = W.m_chunks * W.w2
        tag = (f"{where} {label} n_pad={W.n_pad} k={W.k} block={W.block} "
               f"w2={W.w2}")
        x = rand(m, dtype)
        sz = x.element_size()
        nbytes = W.idx.numel() * (4 + sz) + W.starts.numel() * 4 + m * sz
        compare(check, f"windowed_select.{dt} [{tag}]", dtype,
                lambda: window.windowed_select(W, x),
                lambda: window.windowed_select_ref(W, x), results,
                nbytes, 0, library_fn=lambda: torch.take(x, gidx),
                path=path, exact=True)
        out = torch.empty(W.idx.shape, dtype=dtype, device=x.device)
        log(f"  windowed_select.{dt} [{tag}]: "
            f"{gather_form(window._gather_plan_for(W, x, out, True))}"
            + (f"; an empty launch of that grid {empty_floor(W, x, True):.4f}"
               " ms" if where == "routed" else ""))
    for label, W in ops:
        assert W.dtype == dtype
        W_csr, Wt_csr = windowed_to_csr(W), windowed_to_csr(W, True)
        m = W.m_chunks * W.w2
        x, r = rand(m, dtype), rand(W.n_pad, dtype)
        sz = W.data.element_size()
        meta = W.data.numel() * sz + (W.idx.numel() + W.starts.numel()) * 4
        flops = 2 * int((W.data != 0).sum())
        tag = (f"{where} {label} {W.shape[0]}x{W.shape[1]} k={W.k} "
               f"block={W.block} w2={W.w2}")
        if vectors:
            compare(check, f"windowed_matvec.{dt} [{tag}]", dtype,
                    lambda: window.windowed_matvec(W, x),
                    lambda: window.windowed_matvec_ref(W, x), results,
                    meta + (m + W.n_pad) * sz, flops,
                    library_fn=lambda: torch.mv(W_csr, x), path=path)
            k6_rows_check(check, f"windowed_matvec.{dt} [{tag}]", W, x)
            if where == "routed":
                log(f"  windowed_matvec.{dt} [{tag}]: an empty launch of "
                    f"its grid {empty_floor(W, x, False):.4f} ms")
            compare(check, f"windowed_rmatvec.{dt} [{tag}]", dtype,
                    lambda: window.windowed_rmatvec(W, r),
                    lambda: window.windowed_rmatvec_ref(W, r), results,
                    meta + (m + W.n_pad) * sz, flops,
                    library_fn=lambda: torch.mv(Wt_csr, r), path=path,
                    repeat_exact=True)
        if label not in probes:
            transpose_checks(check, f"{where} {label} {dt}", W, r, None)
            continue
        K = lanes or PROBE_LANES
        lpath = lane_path or path
        Xk, Rk = rand((K, m), dtype), rand((K, W.n_pad), dtype)
        Xc, Rc = Xk.T.contiguous(), Rk.T.contiguous()
        ktag = f"{tag} K={K}"
        compare(check, f"windowed_matmat_k.{dt} [{ktag}]", dtype,
                lambda: window.windowed_matmat_k(W, Xk),
                lambda: window.windowed_matmat_k_ref(W, Xk), results,
                meta + K * (m + W.n_pad) * sz, flops * K,
                library_fn=lambda: torch.sparse.mm(W_csr, Xc), path=lpath,
                repeat_exact=True)
        compare(check, f"windowed_rmatmat_k.{dt} [{ktag}]", dtype,
                lambda: window.windowed_rmatmat_k(W, Rk),
                lambda: window.windowed_rmatmat_k_ref(W, Rk), results,
                meta + K * (m + W.n_pad) * sz, flops * K,
                library_fn=lambda: torch.sparse.mm(Wt_csr, Rc), path=lpath,
                repeat_exact=True)
        for kind, fn in (("matmat_k", lambda: window.windowed_matmat_k(W, Xk)),
                         ("rmatmat_k",
                          lambda: window.windowed_rmatmat_k(W, Rk))):
            lane_launches(check, f"windowed_{kind}.{dt} [{ktag}]",
                          f"windowed_{kind}.{dt}", fn)
        transpose_checks(check, f"{where} {label} {dt}", W, r, Rk)


def unstructured_kernel_checks(check, h, rand, results):
    """On the 640k float32 hierarchy: K14 on level 0's and level 1's A
    (float32 payloads, the path's; and float64 payloads, the routed
    float64 path's dtype at this hierarchy's shapes); K6/K7 on level 0's A
    and P and level 1's A; K12/K13 at the probe width on level 0's A and
    P."""
    import torch

    lv0, lv1 = h.levels[0], h.levels[1]
    selects = (("level0 A", lv0.A), ("level1 A", lv1.A))
    windowed_kernel_checks(
        check, "unstructured", selects,
        (("level0 A", lv0.A), ("level0 P", lv0.P), ("level1 A", lv1.A)),
        ("level0 A", "level0 P"), torch.float32, rand, results,
        "unstructured setup")
    windowed_kernel_checks(check, "unstructured", selects, (), (),
                           torch.float64, rand, results, None)


def routed_kernel_checks(check, h, rand, results):
    """On the routed float64 hierarchy (RCM-reordered 200^2 jittered
    mesh), the float64 instances that its setup launches, at its level 0's
    shapes: K14 on A, K6/K7 and K12/K13 at the probe width on A and P."""
    import torch

    lv0 = h.levels[0]
    windowed_kernel_checks(
        check, "routed", (("level0 A", lv0.A),),
        (("level0 A", lv0.A), ("level0 P", lv0.P)),
        ("level0 A", "level0 P"), torch.float64, rand, results,
        "routed unstructured setup")


def unstructured_phase(check, dev, rand, results, launches):
    """The unstructured device setup: (a) the reference's 640k case twice
    (per-stage seconds, peak memory, setup_info, levels), counters zeroed
    before the first and read after it; (b) its kernels against their
    twins; (c) f32 CG to 1e-6, counters around the solve; (d) a sync-free
    V-cycle; (e) a 200^2 jittered mesh, scrambled, routed by
    device_sa_setup through RCM (float64, with its float64 kernel
    checks), and aggressive with smooth_passes=2 in float64 and
    float32."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import (_build, DeviceMultilevelSolver,
                                 ReorderedSolver, device_sa_setup,
                                 device_unstructured_sa_setup)

    t0 = time.perf_counter()
    A = fem_operator(UNSTR_NX)
    n = A.shape[0]
    log(f"unstructured: {UNSTR_NX}^2 P1 mesh + 1e-2 I, n={n}, nnz={A.nnz}, "
        f"assembled on the host in {time.perf_counter() - t0:.2f} s")
    kw = dict(device=dev, max_coarse=UNSTR_MAX_COARSE)
    runs = []
    for i in range(2):
        prof = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        if i == 0:
            _build.reset_launches()
        t0 = time.perf_counter()
        dus = device_unstructured_sa_setup(A, profile=prof, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if i == 0:
            launches["unstructured setup"] = dict(_build.launches)
        peak = (torch.cuda.max_memory_allocated(dev) - live) / 2**30
        sizes = [lv.n for lv in dus.hierarchy.levels]
        runs.append((dus, sizes))
        stages = {}
        for key, sec in prof.items():
            stage = key.split(".", 1)[1]
            stages[stage] = stages.get(stage, 0.0) + sec
        log(f"unstructured setup run {i + 1}: {wall:.3f} s (CUDA-"
            f"synchronised, host CSR -> windowed included), peak device "
            f"memory {peak:.2f} GiB above the {live / 2**30:.2f} GiB live "
            f"before it, levels {sizes}")
        log(f"  stage totals (s): {json.dumps(stages)}")
        log(f"  per level and stage (s): {json.dumps(prof)}")
    dus, sizes = runs[1]
    log(f"  launches in the first setup: "
        f"{json.dumps(launches['unstructured setup'], sort_keys=True)}")
    for info in dus.setup_info["levels"]:
        log(f"  setup_info {json.dumps(info)}")
    for i, lvl in enumerate(dus.hierarchy.levels):
        log(f"  level {i}: n={lvl.n} n_pad={lvl.n_pad} {forms(lvl)}")
    # the transposes sum in a fixed order (K7/K13's column plan), so the
    # two setups must agree at every level: with theta = 0 a coarse entry
    # that cancels to a few ulp would otherwise move the deep levels
    check(runs[0][1] == runs[1][1], f"unstructured setup: the two runs' "
          f"levels identical: {runs[0][1]} / {runs[1][1]}")
    check(tuple(sizes[:3]) == UNSTR_LEVELS, f"unstructured setup: levels "
          f"0-2 {sizes[:3]} (the reference's {list(UNSTR_LEVELS)}); levels "
          f"3+ {sizes[3:]} (JAX on the CPU: {list(UNSTR_DEEP_CPU)})")
    check(tuple(sizes[3:]) == UNSTR_DEEP_FIXED, f"unstructured setup: levels "
          f"3+ {sizes[3:]} (recorded {list(UNSTR_DEEP_FIXED)}: the same "
          "hierarchy bit for bit)")
    for k in PATHS["unstructured setup"]:
        c = launches["unstructured setup"].get(k, 0)
        check(c > 0, f"unstructured setup: {k} launched ({c} launches)")
    gather_only(check, "unstructured setup", launches["unstructured setup"])
    log("  K12 / K13 launches in the first setup: "
        f"{launches['unstructured setup'].get('windowed_matmat_k.float32')} /"
        f" {launches['unstructured setup'].get('windowed_rmatmat_k.float32')}"
        " (508 / 508 with the 16-lane kernels: four per K = 64 call)")

    # (b) the kernels at this hierarchy's shapes
    unstructured_kernel_checks(check, dus.hierarchy, rand, results)

    # (c) f32 CG to 1e-6
    b = np.random.default_rng(0).standard_normal(n)
    skw = dict(tol=1e-6, maxiter=100, accel="cg")
    dus.solve(b, **skw)                        # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    res = []
    t0 = time.perf_counter()
    x = dus.solve(b, residuals=res, **skw)
    t_solve = time.perf_counter() - t0
    counts = launches["unstructured solve"] = dict(_build.launches)
    bt = torch.as_tensor(b, dtype=torch.float32, device=dev)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        dus.solve(bt, **skw)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    res_first = []
    runs[0][0].solve(b, residuals=res_first, **skw)
    check(res_first == res, f"unstructured solve: the two setups' f32 CG "
          f"histories identical ({len(res_first) - 1} and {len(res) - 1} "
          "iterations)")
    normb = float(np.linalg.norm(b))
    iters = len(res) - 1
    rel = res[-1] / normb
    true_rel = float(np.linalg.norm(b - A @ x.astype(np.float64))) / normb
    log(f"unstructured solve (f32 CG to 1e-6): {iters} iterations, history "
        f"relres {rel:.3e}, true relres {true_rel:.3e}; {t_solve:.4f} s with "
        f"numpy b/x, {float(np.median(ts)):.4f} s with b on the card "
        f"(median of 3)")
    log(f"  history: {' '.join(f'{r / normb:.3e}' for r in res)}")
    log(f"  launches in that solve: {json.dumps(counts, sort_keys=True)}")
    check(abs(iters - UNSTR_REF_ITERS) <= 1 and rel <= 1e-6
          and true_rel <= 1e-5 and bool(np.isfinite(x).all()),
          f"unstructured solve: {iters} iterations within {UNSTR_REF_ITERS} "
          f"+- 1 (reference), relres {rel:.2e} <= 1e-6, true {true_rel:.2e} "
          "<= 1e-5")
    for k in PATHS["unstructured solve"]:
        check(counts.get(k, 0) > 0, f"unstructured solve: {k} launched "
              f"({counts.get(k, 0)} launches)")
    gather_only(check, "unstructured solve", counts)

    profile_phase(f"unstructured {UNSTR_NX}^2", (
        ("unstructured setup", lambda: device_unstructured_sa_setup(A, **kw)),
        ("unstructured f32 CG to 1e-6, b on the card",
         lambda: dus.solve(bt, **skw))))

    # (d) one V-cycle, no host read
    sync_free_cycle(check, DeviceMultilevelSolver(dus.hierarchy)
                    .cycle_operator("V"),
                    rand(dus.hierarchy.levels[0].n_pad, torch.float32),
                    "one vector (unstructured 640k)")
    del runs

    # (e) a jittered, scrambled mesh routed through RCM
    A0 = fem_operator(ROUTED_NX, jitter_seed=5)
    q = np.random.default_rng(11).permutation(A0.shape[0])
    Ar = A0[q][:, q].tocsr()
    br = np.random.default_rng(12).standard_normal(Ar.shape[0])
    aggr = dict(device=dev, max_coarse=400, aggregate="aggressive",
                smooth_passes=2)
    true_rels = []
    # (label, setup, true-relres limit): float64 closes the gap between
    # the history and the true residual; in float32 the true relres stalls
    # near 1e-4 on this distorted mesh in the JAX package as in the port
    # (tests/test_torch_unstructured.py::
    # test_f32_true_residual_floor_matches_reference)
    for label, make, true_tol in (
            ("routed unstructured setup", lambda: device_sa_setup(
                Ar, dtype=torch.float64, device=dev), 1e-5),
            ("routed aggressive smooth_passes=2", lambda:
             device_unstructured_sa_setup(Ar, dtype=torch.float64, **aggr),
             1e-5),
            ("routed aggressive smooth_passes=2 float32", lambda:
             device_unstructured_sa_setup(Ar, dtype=torch.float32, **aggr),
             1e-3),
            ("routed aggressive smooth_passes=2 float32, again", lambda:
             device_unstructured_sa_setup(Ar, dtype=torch.float32, **aggr),
             1e-3)):
        _build.reset_launches()
        t0 = time.perf_counter()
        rs = make()
        torch.cuda.synchronize()
        t_set = time.perf_counter() - t0
        launches[label] = dict(_build.launches)
        res = []
        xr = rs.solve(br, tol=1e-6, maxiter=ROUTED_MAXITER, accel="cg",
                      residuals=res)
        normb = float(np.linalg.norm(br))
        true_rel = float(np.linalg.norm(br - Ar @ xr.astype(np.float64))
                         ) / normb
        log(f"{label} ({ROUTED_NX}^2 jittered, scrambled, n={Ar.shape[0]}): "
            f"{type(rs).__name__}, setup {t_set:.3f} s, levels "
            f"{[lv.n for lv in rs.hierarchy.levels]}; CG to 1e-6 in "
            f"{len(res) - 1} iterations, history relres "
            f"{res[-1] / normb:.3e}, true relres {true_rel:.3e}")
        log(f"  launches in the setup: "
            f"{json.dumps(launches[label], sort_keys=True)}")
        check(isinstance(rs, ReorderedSolver)
              and rs.setup_info.get("reordered") == "rcm"
              and res[-1] <= 1e-6 * normb and true_rel <= true_tol,
              f"{label}: RCM-reordered, converged to 1e-6 (true relres "
              f"{true_rel:.2e} <= {true_tol:g})")
        for k in PATHS.get(label, ()):
            check(launches[label].get(k, 0) > 0, f"{label}: {k} launched "
                  f"({launches[label].get(k, 0)} launches)")
        gather_only(check, label, launches[label])
        if label == "routed unstructured setup":
            routed_kernel_checks(check, rs.hierarchy, rand, results)
        true_rels.append(true_rel)
    # the float32 true relres sits at this mesh's f32 floor, where any
    # change of summation order shows: the two f32 runs must agree exactly
    check(true_rels[-1] == true_rels[-2], f"routed aggressive float32: true "
          f"relres identical in two runs ({true_rels[-2]!r} / "
          f"{true_rels[-1]!r})")
    check(f"{true_rels[-1]:.3e}" == ROUTED_F32_TRUE_FIXED, f"routed "
          f"aggressive float32: true relres {true_rels[-1]:.3e} (recorded "
          f"{ROUTED_F32_TRUE_FIXED})")
    return dus, A


# the unstructured classical setups (engine/unstructured_classical.py): RS
# with the setup's defaults on the 640k mesh of phase 12, and AIR through
# device_air_setup's route (its max_coarse 400 and max_levels 4) on upwind
# advection, RCM-permuted so that detect_grid finds no grid
UCL_PARITY_NX = 200
# levels and float32 CG iterations to 1e-6 at 200^2, the JAX package on the
# CPU (float32 and float64 alike; tests/test_torch_unstructured_classical.py
# holds the two packages' hierarchies equal at smaller sizes)
UCL_PARITY = {"modified": ((40000, 14567, 2745, 541), 7),
              "direct": ((40000, 14567, 3649, 781), 10)}
# the 640k levels and float32 CG iterations of the port on the card,
# recorded from its first run there (the JAX package was not run at this
# size on the CPU; the reference's TPU record is 8 / 11 iterations): a
# regression check, as UNSTR_DEEP_FIXED is
UCL_FIXED = {"modified": ((640000, 233341, 43355, 8282, 1479), 8),
             "direct": ((640000, 233341, 57046, 12185, 2598, 546), 11)}
UCL_AIR_NX = 256
UCL_AIR_PARITY_NX = 128
# levels and FGMRES iterations to 1e-8 of the routed 128^2 setup, the JAX
# package on the CPU in float64.  In float32 the probe chains' rounding
# breaks the advection operator's exact strength ties at level 1's coarse
# operator, so the deeper levels move with the summation order (JAX float32
# on the CPU: 3302, 1154 and 4 iterations; the port's CPU twins 3302, 1159)
UCL_AIR_PARITY = ((16384, 8398, 3148, 1073), 3)
UCL_AIR_MIN_DROP = 1e4           # the reference test's bars
UCL_AIR_MAX_ITERS = 10


def advection_operator(nx):
    """Upwind advection on an nx^2 grid (theta = pi/4) and its right-hand
    side, in the RCM order of |A| + |A^T| (no grid stencil left)."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from pyamg_tpu_torch import advection_2d

    A, b = advection_2d((nx, nx), theta=np.pi / 4)
    A = sp.csr_matrix(A)
    perm = csgraph.reverse_cuthill_mckee(sp.csr_matrix(abs(A) + abs(A.T)),
                                         symmetric_mode=True)
    return sp.csr_matrix(A[perm][:, perm]), np.asarray(b)[perm]


def ucl_levels(solver):
    return tuple(lv.n for lv in solver.hierarchy.levels)


def ucl_solve(check, label, solver, A, b, kw, launches):
    """``solver.solve(b, **kw)`` with ``b`` on the card, warm, then counted:
    iterations, history and true relres (at most 1e-5, the float32 floor of
    x), wall (median of 3); its launches under ``launches[label]``.
    Returns the iterations."""
    import numpy as np
    import torch

    bt = torch.as_tensor(b, dtype=torch.float32, device=solver.hierarchy
                         .device)
    solver.solve(bt, **kw)                           # warm-up
    res = []
    x, counts, wall = counted(lambda: solver.solve(bt, residuals=res, **kw))
    launches[label] = counts
    walls = [wall]
    for _ in range(2):
        walls.append(counted(lambda: solver.solve(bt, **kw))[2])
    normb = float(np.linalg.norm(b))
    iters = len(res) - 1
    x = x.double().cpu().numpy()
    true = float(np.linalg.norm(b - A @ x)) / normb
    log(f"{label} ({kw['accel']} to {kw['tol']:g}, b on the card): {iters} "
        f"iterations, history relres {res[-1] / normb:.3e}, true relres "
        f"{true:.3e}; solve {float(np.median(walls)):.4f} s (median of 3)")
    log(f"  history: {' '.join(f'{r / normb:.3e}' for r in res)}")
    log(f"  launches in that solve: {json.dumps(counts, sort_keys=True)}")
    check(bool(np.isfinite(x).all()) and res[-1] <= kw["tol"] * normb
          and true <= 1e-5, f"{label}: relres {res[-1] / normb:.2e} <= "
          f"{kw['tol']:g}, true {true:.2e} <= 1e-5")
    path_launches(check, label, counts)
    return iters


def unstructured_classical_phase(check, dev, rand, results, launches, A,
                                 card):
    """Phase 12b: the unstructured classical setups on the card.  (a) RS
    on the 640k mesh ``A`` with the setup's defaults, modified
    interpolation twice (per-stage seconds of the second, peak memory,
    each level's n, nc, period, k and widths; the two runs' levels
    identical and the recorded ones), counters zeroed before the first;
    K14 on level 0's A (a PMIS round's payload), K6 / K7 on level 0's M
    and P_direct, K12 / K13 at the probe width on them; float32 CG to
    1e-6, then the same with direct interpolation; (b) both at 200^2
    against the JAX package's levels and counts; (c) AIR through
    device_air_setup's route on RCM-permuted advection at UCL_AIR_NX^2,
    twice, its first cycle's drop and FGMRES to 1e-8, K6 / K7 / K12 / K13
    on level 0's A and the injection Tinj, and at 128^2 against the JAX
    package's levels and count (float64); (d) the three solves profiled and
    a V-cycle of each hierarchy with no host sync.  Returns the 640k
    modified RS solver."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import (DeviceMultilevelSolver, _build,
                                 device_air_setup,
                                 device_unstructured_rs_setup)

    f32 = torch.float32
    n = A.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    cg = dict(tol=1e-6, maxiter=100, accel="cg")
    solvers = {}
    for interp in ("modified", "direct"):
        kw = dict(device=dev, interpolation=interp)
        runs = []
        for i in range(2 if interp == "modified" else 1):
            prof = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            live = torch.cuda.memory_allocated(dev)
            _build.reset_launches()
            t0 = time.perf_counter()
            drs = device_unstructured_rs_setup(A, profile=prof, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if i == 0:
                launches[f"unstructured RS {interp} setup"] = dict(
                    _build.launches)
            peak = (torch.cuda.max_memory_allocated(dev) - live) / 2**30
            runs.append(ucl_levels(drs))
            stages = {}
            for key, sec in prof.items():
                stage = key.split(".", 1)[1]
                stages[stage] = stages.get(stage, 0.0) + sec
            log(f"unstructured RS ({interp}) setup run {i + 1}, {UNSTR_NX}^2 "
                f"P1 mesh + 1e-2 I (n={n}): {wall:.3f} s (CUDA-synchronised, "
                f"host CSR -> windowed included; {card}), peak device memory "
                f"{peak:.2f} GiB above the {live / 2**30:.2f} GiB live, "
                f"levels {list(runs[-1])}")
            log(f"  stage totals (s): {json.dumps(stages)}")
            log(f"  per level and stage (s): {json.dumps(prof)}")
        solvers[interp] = drs
        label = f"unstructured RS {interp} setup"
        log(f"  launches in the first setup: "
            f"{json.dumps(launches[label], sort_keys=True)}")
        for info in drs.setup_info["levels"]:
            log(f"  setup_info {json.dumps(info)}")
        for i, lvl in enumerate(drs.hierarchy.levels):
            log(f"  level {i}: n={lvl.n} n_pad={lvl.n_pad} {forms(lvl)}")
        check(len(set(runs)) == 1, f"{label}: the runs' levels identical: "
              f"{runs}")
        path_launches(check, label, launches[label])
        if interp == "modified":
            lv0 = drs.hierarchy.levels[0]
            M, Pd = lv0.P.factors
            log("unstructured RS kernels at level 0 (kernel vs plain twin):")
            windowed_kernel_checks(
                check, "unstructured RS", (("level0 A", lv0.A),),
                (("level0 M", M), ("level0 P_direct", Pd)),
                ("level0 M", "level0 P_direct"), f32, rand, results, label)
        iters = ucl_solve(check, f"unstructured RS {interp} solve", drs, A,
                          b, cg, launches)
        fixed = UCL_FIXED[interp]
        got = (ucl_levels(drs), iters)
        log(f"unstructured RS ({interp}) 640k: levels {list(got[0])}, "
            f"{iters} CG iterations (recorded {fixed}; the reference's TPU "
            "record, context only: 8 modified / 11 direct)")
        if fixed is not None:
            check(got == fixed, f"unstructured RS ({interp}) 640k: levels "
                  f"and iterations {got}, the recorded {fixed}")
        sync_free_cycle(check, DeviceMultilevelSolver(drs.hierarchy)
                        .cycle_operator("V"),
                        rand(drs.hierarchy.levels[0].n_pad, f32),
                        f"one vector (unstructured RS {interp} 640k)")

    # (b) 200^2 against the JAX package's levels and counts
    Ap = fem_operator(UCL_PARITY_NX)
    bp = np.random.default_rng(0).standard_normal(Ap.shape[0])
    for (interp, (levels, iters)), dtype in itertools.product(
            UCL_PARITY.items(), (f32, torch.float64)):
        s = device_unstructured_rs_setup(Ap, dtype=dtype, device=dev,
                                         interpolation=interp)
        res = []
        s.solve(bp, residuals=res, **cg)
        got = (ucl_levels(s), len(res) - 1)
        check(got == (levels, iters), f"unstructured RS ({interp}) "
              f"{UCL_PARITY_NX}^2 {str(dtype)[6:]}: levels {list(got[0])}, "
              f"{got[1]} CG iterations (JAX on the CPU: {list(levels)}, "
              f"{iters})")

    # (c) AIR through device_air_setup's route
    Aa, ba = advection_operator(UCL_AIR_NX)
    _, launches["unstructured AIR setup"], t_first = counted(
        lambda: device_air_setup(Aa, device=dev))
    torch.cuda.reset_peak_memory_stats(dev)
    live = torch.cuda.memory_allocated(dev)
    dair, _, t_air = counted(lambda: device_air_setup(Aa, device=dev))
    peak = (torch.cuda.max_memory_allocated(dev) - live) / 2**30
    log(f"unstructured AIR setup (device_air_setup route), RCM-permuted "
        f"advection {UCL_AIR_NX}^2 (n={Aa.shape[0]}): {t_air:.3f} s (first "
        f"call {t_first:.3f} s; {card}), peak device memory {peak:.2f} GiB "
        f"above the {live / 2**30:.2f} GiB live, levels "
        f"{list(ucl_levels(dair))}, dense coarse {dair.hierarchy.nc}")
    log(f"  launches in the first setup: "
        f"{json.dumps(launches['unstructured AIR setup'], sort_keys=True)}")
    for info in dair.setup_info["levels"]:
        log(f"  setup_info {json.dumps(info)}")
    for i, lvl in enumerate(dair.hierarchy.levels):
        log(f"  level {i}: n={lvl.n} n_pad={lvl.n_pad} {forms(lvl)}")
    check(type(dair).__name__ == "DeviceMultilevelSolver"
          and {i["family"] for i in dair.setup_info["levels"]} == {"air"},
          "unstructured AIR: device_air_setup(grid=None) routed to the "
          "unstructured AIR setup")
    path_launches(check, "unstructured AIR setup",
                  launches["unstructured AIR setup"])
    lv0 = dair.hierarchy.levels[0]
    log("unstructured AIR kernels at level 0 (kernel vs plain twin):")
    windowed_kernel_checks(
        check, "unstructured AIR", (("level0 A", lv0.A),),
        (("level0 A", lv0.A), ("level0 Tinj", lv0.R.Tinj)),
        ("level0 A", "level0 Tinj"), f32, rand, results,
        "unstructured AIR setup")
    res = []
    dair.solve(ba, tol=1e-8, maxiter=1, residuals=res)
    drop = res[0] / res[1]
    check(drop >= UCL_AIR_MIN_DROP, f"unstructured AIR: first cycle drops "
          f"the residual {drop:.3e}x (>= {UCL_AIR_MIN_DROP:g})")
    fg = dict(tol=1e-8, maxiter=30, accel="fgmres")
    it = ucl_solve(check, "unstructured AIR solve", dair, Aa, ba, fg,
                   launches)
    check(it <= UCL_AIR_MAX_ITERS, f"unstructured AIR: {it} FGMRES "
          f"iterations (<= {UCL_AIR_MAX_ITERS})")
    Ap, bp = advection_operator(UCL_AIR_PARITY_NX)
    s = device_air_setup(Ap, dtype=torch.float64, device=dev)
    res = []
    s.solve(bp, residuals=res, **fg)
    got = (ucl_levels(s), len(res) - 1)
    check(got == UCL_AIR_PARITY, f"unstructured AIR {UCL_AIR_PARITY_NX}^2 "
          f"float64: levels {list(got[0])}, {got[1]} FGMRES iterations (JAX "
          f"on the CPU: {list(UCL_AIR_PARITY[0])}, {UCL_AIR_PARITY[1]})")
    sync_free_cycle(check, DeviceMultilevelSolver(dair.hierarchy)
                    .cycle_operator("V"), rand(lv0.n_pad, f32),
                    f"one vector (unstructured AIR {UCL_AIR_NX}^2)")

    # (d) the three solves profiled
    bt = torch.as_tensor(b, dtype=f32, device=dev)
    bat = torch.as_tensor(ba, dtype=f32, device=dev)
    profile_phase("unstructured classical", (
        ("unstructured RS modified f32 CG to 1e-6, 640k",
         lambda: solvers["modified"].solve(bt, **cg)),
        ("unstructured RS direct f32 CG to 1e-6, 640k",
         lambda: solvers["direct"].solve(bt, **cg)),
        (f"unstructured AIR f32 FGMRES to 1e-8, {UCL_AIR_NX}^2",
         lambda: dair.solve(bat, **fg))))
    return solvers["modified"]


def levels_log(solver, rho=True):
    """Each level of a device-built hierarchy: its grid (and its rho(D^-1
    A) estimate), sizes and forms."""
    for i, lvl in enumerate(solver.hierarchy.levels):
        grid = (f"grid_p={lvl.P.fine_grid_p}" if lvl.P is not None
                else f"dense {lvl.n}x{lvl.n}")
        if rho and lvl.P is not None:
            rho = float(solver.setup_info["levels"][i]["rho_D_inv_A"])
            grid += f" rho={rho:.6f}"
        log(f"  level {i}: {grid} n={lvl.n} n_pad={lvl.n_pad} {forms(lvl)}")


def counted(fn):
    """``fn()`` with the launch counters zeroed just before and read just
    after: (its result, the counts, its wall seconds)."""
    import torch

    from pyamg_tpu_torch import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, dict(_build.launches), wall


def cpu_copy_of(solver):
    """The structured solver with its hierarchy copied to the CPU (the
    plain twins)."""
    return type(solver)(to_device(solver.hierarchy, "cpu"), solver.grid,
                        solver.grid_p)


def config2_phase(check, dev, rand, results, launches):
    """Config 2's device-built hierarchy of 3-D Poisson 64^3 on the card:
    its setup (a second call after a warm one) and levels; the kernels at
    its level-0 and level-1 shapes with each branch; the mixed W-cycle CG
    to 1e-8 and the native V-cycle CG to 1e-5 with the reference's b, with
    counters; F and AMLI CG to 1e-8 against the same solves on a CPU copy;
    one W-cycle with every host sync an error, and its CUDA-event time;
    the W-cycle solve's profile.  Returns (solver, operator)."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import device_sa_setup, poisson

    A3 = poisson(GRID3, format="csr")
    n3 = A3.shape[0]
    kw = dict(grid=GRID3, dtype=torch.float32, device=dev, max_coarse=400,
              mixed_precision=True)
    t0 = time.perf_counter()
    d2 = device_sa_setup(A3, **kw)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    del d2
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    d2 = device_sa_setup(A3, **kw)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    log(f"config 2 device SA setup, 3-D Poisson {GRID3} (n={n3}): "
        f"{t_setup:.4f} s (first call {t_first:.3f} s, CUDA-synchronised, "
        f"host CSR -> DIA included); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; "
        f"{len(d2.hierarchy.levels)} levels")
    levels_log(d2)

    log("config 2 kernels at the 64^3 shapes (kernel vs plain twin):")
    device_level_checks(check, "config2", d2.hierarchy, rand, results,
                        {"chain": "config 2 W-cycle",
                         "lanes": "config 2 batched W-cycle",
                         "scale": "config 2 batched W-cycle",
                         "spmv": "config 2 V-cycle native"}, wide=True)

    b = np.random.default_rng(1).random(n3)
    normb = float(np.linalg.norm(b))
    mixed = dict(tol=1e-8, maxiter=40, accel="cg", precision="mixed")
    d2.solve(b, cycle="W", **mixed)             # warm-up
    res = []
    x, counts, wall = counted(lambda: d2.solve(b, cycle="W", residuals=res,
                                               **mixed))
    launches["config 2 W-cycle"] = counts
    times = [wall]
    for _ in range(4):
        t0 = time.perf_counter()
        d2.solve(b, cycle="W", **mixed)
        times.append(time.perf_counter() - t0)
    iters = len(res) - 1
    true = float(np.linalg.norm(b - A3 @ x)) / normb
    log(f"config 2 (64^3 device-built, mixed, W-cycle CG to 1e-8): {iters} "
        f"iterations, history relres {res[-1] / normb:.3e}, true relres "
        f"{true:.3e}, solve {times[0]:.4f} s (repeats "
        f"{', '.join(f'{t:.4f}' for t in times[1:])} s, median "
        f"{float(np.median(times)):.4f} s)")
    log(f"  history: {' '.join(f'{r / normb:.3e}' for r in res)}")
    log(f"  launches in that solve: {json.dumps(counts, sort_keys=True)}")
    check(x.shape == (n3,) and bool(np.isfinite(x).all()),
          "config 2 W-cycle: solution finite, shape (n,)")
    check(abs(iters - REF_ITERS_C2) <= 1 and true <= 1e-8
          and res[-1] <= 1e-8 * normb,
          f"config 2 W-cycle: {iters} CG iterations within {REF_ITERS_C2} "
          f"+- 1 (reference), true relres {true:.3e} <= 1e-8")
    path_launches(check, "config 2 W-cycle", counts)

    res_v = []
    x_v, counts, wall = counted(lambda: d2.solve(
        b, tol=1e-5, maxiter=40, accel="cg", residuals=res_v))
    launches["config 2 V-cycle native"] = counts
    log(f"config 2 native f32 V-cycle CG to 1e-5: {len(res_v) - 1} "
        f"iterations, history relres {res_v[-1] / normb:.3e}, wall "
        f"{wall:.4f} s")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    check(len(res_v) - 1 == REF_ITERS_C2_1E5,
          f"config 2 native V-cycle CG: {len(res_v) - 1} iterations to "
          f"1e-5 (reference {REF_ITERS_C2_1E5})")
    path_launches(check, "config 2 V-cycle native", counts)

    cpu = cpu_copy_of(d2)
    for cycle, label in (("F", "config 2 F-cycle"), ("AMLI", "config 2 AMLI")):
        res_g, res_c = [], []
        x_g, counts, wall = counted(lambda: d2.solve(
            b, cycle=cycle, residuals=res_g, **mixed))
        launches[label] = counts
        cpu.solve(b, cycle=cycle, residuals=res_c, **mixed)
        true = float(np.linalg.norm(b - A3 @ x_g)) / normb
        log(f"{label} CG to 1e-8 (mixed): card {len(res_g) - 1} iterations "
            f"(wall {wall:.4f} s), its CPU copy {len(res_c) - 1}; true "
            f"relres {true:.3e}; launches {json.dumps(counts, sort_keys=True)}")
        check(abs(len(res_g) - len(res_c)) <= 1 and true <= 1e-8,
              f"{label}: {len(res_g) - 1} iterations, the CPU copy's "
              f"{len(res_c) - 1} +- 1 (f32), true relres {true:.3e} <= 1e-8")
        path_launches(check, label, counts)

    # each cycle from zero: sync-free, its device time by CUDA events over
    # 3 cycles (more would overflow the launch queue behind the sleep
    # kernel: an AMLI cycle makes ~200 launches), and profiled alone
    h2 = d2.hierarchy
    r = rand(h2.levels[0].n_pad, torch.float32)
    cycles = {kind: d2.cycle_operator(kind) for kind in CYCLE_KINDS}
    for kind, cyc in cycles.items():
        if kind != "V":
            sync_free_cycle(check, cyc, r, "64^3 (config 2)", kind)
        log(f"  one {kind}-cycle at 64^3, f32: "
            f"{min(time_ms(lambda: cyc(r), 3), time_ms(lambda: cyc(r), 3)):.4f}"
            " ms (CUDA events, 3 cycles, min of 2)")
    profile_phase("config 2 64^3", (
        ("mixed W-cycle CG to 1e-8", lambda: d2.solve(b, cycle="W",
                                                      **mixed)),
        ("native V-cycle CG to 1e-5", lambda: d2.solve(b, tol=1e-5,
                                                       maxiter=40,
                                                       accel="cg")),
        *((f"one {kind}-cycle", lambda cyc=cyc: cyc(r))
          for kind, cyc in cycles.items())))
    return d2, A3


def krylov_phase(check, label, solver, A, b, launches):
    """BiCGStab, GMRES and FGMRES (restart 30) in mixed precision to 1e-8
    on a 2048^2 hierarchy, counters around each: iterations, residuals,
    wall.  BiCGStab and FGMRES stop on the true residual's norm and must
    reach true relres <= 1e-8; GMRES is left preconditioned (the
    reference's semantics): it stops on ||M r|| <= tol ||M b||, which it
    must reach, and its true relres, bounded by the float32 cycle's
    rounding in its Arnoldi relation, is reported."""
    import numpy as np

    normb = float(np.linalg.norm(b))
    for accel in KRYLOV_2048:
        path = f"{label} config 1 {accel}"
        res = []
        x, counts, wall = counted(lambda: solver.solve(
            b, tol=1e-8, maxiter=100, accel=accel, precision="mixed",
            restart=30, residuals=res))
        launches[path] = counts
        iters = len(res) - 1
        true = float(np.linalg.norm(b - A @ x)) / normb
        log(f"{path} (2048^2, mixed, to 1e-8): {iters} iterations, history "
            f"{res[-1] / res[0]:.3e} of its first entry, true relres "
            f"{true:.3e}, wall {wall:.4f} s")
        log(f"  launches: {json.dumps(counts, sort_keys=True)}")
        ok = bool(np.isfinite(x).all()) and res[-1] <= 1e-8 * res[0]
        if accel == "gmres":
            check(ok, f"{path}: preconditioned relres {res[-1] / res[0]:.3e}"
                  f" <= 1e-8 (its stop test) in {iters} iterations; true "
                  f"relres {true:.3e} (reported)")
        else:
            check(ok and true <= 1e-8, f"{path}: {iters} iterations, true "
                  f"relres {true:.3e} <= 1e-8")
        path_launches(check, path, counts)


def gmres_float64_phase(check, dev, A, launches):
    """Native float64 GMRES (restart 30) to 1e-8 on the float64
    device-built 2048^2 hierarchy: with a cycle free of float32 rounding
    the left-preconditioned GMRES's true relres reaches 1e-8."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import device_sa_setup

    d64 = device_sa_setup(A, grid=GRID, dtype=torch.float64, device=dev,
                          max_coarse=400)
    b = np.random.default_rng(0).random(A.shape[0])
    path = "device-built float64 config 1 gmres"
    res = []
    x, counts, wall = counted(lambda: d64.solve(
        b, tol=1e-8, maxiter=100, accel="gmres", restart=30, residuals=res))
    launches[path] = counts
    true = float(np.linalg.norm(b - A @ x)) / float(np.linalg.norm(b))
    log(f"{path} (native float64, to 1e-8): {len(res) - 1} iterations, "
        f"history {res[-1] / res[0]:.3e} of its first entry, true relres "
        f"{true:.3e}, wall {wall:.4f} s")
    check(res[-1] <= 1e-8 * res[0] and true <= 1e-8,
          f"{path}: true relres {true:.3e} <= 1e-8")
    path_launches(check, path, counts)


def accel_parity_phase(check, dev, A_st):
    """Every accel (V-cycle) and the W, F and AMLI cycles (CG) on the
    float64 256^2 device-built hierarchy against the same solve on its
    CPU copy (the plain twins): the same count, histories to rtol 1e-8."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import device_sa_setup

    d64 = device_sa_setup(A_st, grid=STATIONARY_GRID, dtype=torch.float64,
                          device=dev, max_coarse=400)
    cpu = cpu_copy_of(d64)
    b = np.random.default_rng(5).random(A_st.shape[0])
    cases = ([("V", a) for a in ACCELS]
             + [(c, "cg") for c in ("W", "F", "AMLI")])
    for cycle, accel in cases:
        kw = dict(tol=1e-8, maxiter=40, cycle=cycle, accel=accel,
                  restart=30)
        res_g, res_c = [], []
        d64.solve(b, residuals=res_g, **kw)
        cpu.solve(b, residuals=res_c, **kw)
        m = min(len(res_g), len(res_c))
        err = float(np.max(np.abs(np.subtract(res_g[:m], res_c[:m]))
                           / np.asarray(res_c[:m])))
        check(len(res_g) == len(res_c) and err <= 1e-8,
              f"256^2 float64 {cycle}-cycle {accel}: card {len(res_g) - 1} "
              f"iterations, CPU copy {len(res_c) - 1}, history rel diff "
              f"{err:.2e} (tol 1e-8), last {res_g[-1] / res_g[0]:.3e} of "
              "the first")


def lane_solves_phase(check, label, solver, B, kw, launches,
                      need_info=True):
    """A K-lane solve on the card (B on the card, counters around it),
    every lane within one iteration of its own 1-D solve; K8 and K9
    through their lane kernel only.  ``need_info``: the solve's info must
    be 0 (GMRES's is not: it stops on ||M r|| against ||M b||, its info
    holds ||M r|| against ||b||, as the reference's does)."""
    import numpy as np
    import torch

    Bt = torch.as_tensor(B, device=solver.hierarchy.device)
    res = []
    (X, info), counts, wall = counted(lambda: solver.solve(
        Bt, residuals=res, return_info=True, **kw))
    launches[label] = counts
    its = [len(r) - 1 for r in res]
    its1 = []
    for j in range(B.shape[1]):
        res1 = []
        solver.solve(Bt[:, j].contiguous(), residuals=res1, **kw)
        its1.append(len(res1) - 1)
    log(f"{label} (K={B.shape[1]}, {kw}): iterations per lane {its} (info "
        f"{info}), 1-D solves {its1}, wall {wall:.4f} s")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    check(X.shape == B.shape and bool(torch.isfinite(X).all())
          and (info == 0 or not need_info)
          and all(abs(i - i1) <= 1 for i, i1 in zip(its, its1)),
          f"{label}: lanes {its} within +- 1 of their 1-D solves {its1}")
    path_launches(check, label, counts)


def config2_host_phase(check, dev, rand, results, launches):
    """Config 2's host-built column on the card: the port's SA setup of 3-D
    Poisson 64^3 with symmetric Gauss-Seidel, the JP colourings of levels
    0 and 1, and the compile (float32, float64 A64, cut at 1024 rows), each
    timed on its own; K2 with a colour's inverse diagonal and K9 at K = 8
    at level 0, K1 there in both types, and K6 / K7 / K12 / K13 at the
    windowed shapes (level 0's T, level 1's A and P); the mixed stationary
    W-cycle to 1e-8 with the reference's b (its 14 +- 1 iterations and
    factor), native W-cycle CG to 1e-5 and K = 8 lanes of it, each lane its
    1-D count, with counters; one W-cycle with every host sync an error,
    and its time; then, on the device-built hierarchy ``d2``'s setup with
    Chebyshev smoothers, mixed CG to 1e-8 against the same solve on its CPU
    copy, and its W-cycle with every host sync an error.  Returns the
    host-built solver and its b."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import (DeviceMultilevelSolver, compile_hierarchy,
                                 device_sa_setup, poisson,
                                 smoothed_aggregation_solver)
    from pyamg_tpu_torch.graph import vertex_coloring
    from pyamg_tpu_torch.sparse import (ComposedOperator, DIAMatrix,
                                        TransposedWindowed, WindowedELL, dia)

    A3 = poisson(GRID3, format="csr")
    n3 = A3.shape[0]
    t0 = time.perf_counter()
    ml2 = smoothed_aggregation_solver(A3, presmoother=C2_GS,
                                      postsmoother=C2_GS)
    t_setup = time.perf_counter() - t0
    t_col, ncol = [], []
    for lvl in ml2.levels[:2]:
        t0 = time.perf_counter()
        ncol.append(int(vertex_coloring(lvl.A, method="JP").max()) + 1)
        t_col.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    h2 = compile_hierarchy(ml2, dtype=torch.float32, device=dev,
                           mixed_precision=True, coarse_cutoff=1024)
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    dml2 = DeviceMultilevelSolver(h2)
    log(f"config 2 host-built, 3-D Poisson {GRID3}: the port's SA setup "
        f"(symmetric GS) {t_setup:.3f} s, levels "
        f"{[lvl.A.shape[0] for lvl in ml2.levels]}; JP colourings "
        f"{ncol} colours in {', '.join(f'{t:.3f}' for t in t_col)} s "
        f"(levels 0, 1); compile to the card {t_compile:.3f} s "
        "(colouring and rho included)")
    for i, lvl in enumerate(h2.levels):
        cfg = lvl.pre.config
        sm = (f"mcgs {cfg[1]} colours {cfg[2]}" if cfg[0] == "mcgs"
              else f"{cfg[0]} degree {len(cfg[1])}" if cfg[0] == "poly"
              else cfg[0])
        log(f"  level {i}: n={lvl.n} n_pad={lvl.n_pad} {forms(lvl)}; "
            f"smoother {sm}")
    lv0, lv1 = h2.levels[0], h2.levels[1]
    check(lv0.pre.config[:2] == ("mcgs", 6) and lv1.pre.config[0] == "poly"
          and len(h2.levels) == 3,
          f"config 2 host-built smoothers: multicolour GS with "
          f"{lv0.pre.config[1]} colours at level 0, {lv1.pre.config[0]} at "
          "level 1 (the reference's: 6 colours, then Chebyshev for 19)")

    log("config 2 host-built kernels at the 64^3 shapes (kernel vs plain "
        "twin):")
    A0 = lv0.A
    assert isinstance(A0, DIAMatrix)
    path, lpath = "config 2 host-built W-cycle", \
        "config 2 host-built batched W-cycle"
    f32 = torch.float32
    x, b = rand(A0.n_pad, f32), rand(A0.n_pad, f32)
    dinv_c = lv0.pre.color_dinv[0]
    tag = f"config2 host level0 nd={A0.ndiags} n_pad={A0.n_pad}"
    A0_csr = dia_to_csr(A0)
    compare(check, f"dia_jacobi.float32 [{tag} colour 0 of "
            f"{lv0.pre.config[1]}]", f32,
            lambda: dia.dia_jacobi(A0, x, b, dinv_c, 1.0),
            lambda: dia.dia_jacobi_ref(A0, x, b, dinv_c, 1.0), results,
            *dia_cost(A0, 4, extra_ops=4), path=path)
    compare(check, f"dia_spmv.float32 [{tag}]", f32,
            lambda: dia.dia_spmv(A0, x), lambda: dia.dia_spmv_ref(A0, x),
            results, *dia_cost(A0, 2),
            library_fn=lambda: torch.mv(A0_csr, x), path=path)
    scalar_sweep_checks(check, "config2 host level0", A0, lv0.pre, rand,
                        results, path)
    A64 = h2.A64
    x64 = x.double()
    A64_csr = dia_to_csr(A64)
    compare(check, f"dia_spmv.float64 [config2 host A64 nd={A64.ndiags} "
            f"n_pad={A64.n_pad}]", torch.float64,
            lambda: dia.dia_spmv(A64, x64), lambda: dia.dia_spmv_ref(A64, x64),
            results, *dia_cost(A64, 2),
            library_fn=lambda: torch.mv(A64_csr, x64), path=path)
    Xk, Bk = rand((LANES, A0.n_pad), f32), rand((LANES, A0.n_pad), f32)
    Xcols = Xk.T.contiguous()
    ktag = f"{tag} K={LANES}"
    compare(check, f"dia_jacobi_k.float32 [{ktag} colour 0]", f32,
            lambda: dia.dia_jacobi_k(A0, Xk, Bk, dinv_c, 1.0),
            lambda: dia.dia_jacobi_k_ref(A0, Xk, Bk, dinv_c, 1.0), results,
            *dia_cost(A0, 1, LANES, 3, extra_ops=4), path=lpath)
    compare(check, f"dia_spmm.float32 [{ktag}]", f32,
            lambda: dia.dia_spmm(A0, Xk), lambda: dia.dia_spmm_ref(A0, Xk),
            results, *dia_cost(A0, 0, LANES, 2),
            library_fn=lambda: torch.sparse.mm(A0_csr, Xcols), path=lpath)
    del Xk, Bk, Xcols, A0_csr, A64_csr
    T0 = lv0.P.ops[-1]
    assert (isinstance(lv0.P, ComposedOperator) and isinstance(T0, WindowedELL)
            and lv0.R.ops[0].base is T0)
    ops = [("level0 T", T0)] + [(f"level1 {name}", op) for name, op in (
        ("A", lv1.A), ("P", lv1.P)) if isinstance(op, WindowedELL)]
    check(isinstance(lv1.R, TransposedWindowed) and lv1.R.base is lv1.P,
          f"config 2 host-built level 1: A {type(lv1.A).__name__}, P "
          f"{type(lv1.P).__name__}, R {type(lv1.R).__name__} (P's arrays)")
    windowed_kernel_checks(check, "config2 host", (), ops,
                           tuple(label for label, _ in ops), f32, rand,
                           results, path, lanes=LANES, lane_path=lpath)

    b2 = np.random.default_rng(1).random(n3)
    normb = float(np.linalg.norm(b2))
    kw = dict(tol=1e-8, maxiter=30, cycle="W", accel=None, precision="mixed")
    dml2.solve(b2, **kw)                       # warm-up
    res = []
    x2, counts, wall = counted(lambda: dml2.solve(b2, residuals=res, **kw))
    launches[path] = counts
    times = [wall]
    for _ in range(4):
        t0 = time.perf_counter()
        dml2.solve(b2, **kw)
        times.append(time.perf_counter() - t0)
    iters = len(res) - 1
    true = float(np.linalg.norm(b2 - A3 @ x2)) / normb
    factor = (res[-1] / res[0]) ** (1.0 / iters)
    log(f"config 2 host-built (64^3, mixed, stationary W-cycle to 1e-8): "
        f"{iters} iterations, history relres {res[-1] / normb:.3e}, true "
        f"relres {true:.3e}, convergence factor {factor:.4f} (reference "
        f"{REF_FACTOR_C2_HOST}), solve {times[0]:.4f} s (repeats "
        f"{', '.join(f'{t:.4f}' for t in times[1:])} s, median "
        f"{float(np.median(times)):.4f} s)")
    log(f"  history: {' '.join(f'{r / normb:.3e}' for r in res)}")
    log(f"  launches in that solve: {json.dumps(counts, sort_keys=True)}")
    check(x2.shape == (n3,) and bool(np.isfinite(x2).all())
          and abs(iters - REF_ITERS_C2_HOST) <= 1 and true <= 1e-8
          and res[-1] <= 1e-8 * normb,
          f"config 2 host-built W-cycle: {iters} iterations within "
          f"{REF_ITERS_C2_HOST} +- 1 (reference), true relres {true:.3e} "
          "<= 1e-8")
    path_launches(check, path, counts)

    label = "config 2 host-built W-cycle CG native"
    res_n = []
    _, counts, wall = counted(lambda: dml2.solve(
        b2, tol=1e-5, maxiter=40, cycle="W", accel="cg", residuals=res_n))
    launches[label] = counts
    log(f"{label} to 1e-5: {len(res_n) - 1} iterations, history relres "
        f"{res_n[-1] / normb:.3e}, wall {wall:.4f} s")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    check(res_n[-1] <= 1e-5 * normb, f"{label}: relres <= 1e-5 in "
          f"{len(res_n) - 1} iterations")
    path_launches(check, label, counts)
    lane_solves_phase(check, lpath, dml2,
                      np.random.default_rng(3).random((n3, LANES)),
                      dict(tol=1e-5, maxiter=40, cycle="W", accel="cg"),
                      launches)

    r = rand(lv0.n_pad, f32)
    cyc = dml2.cycle_operator("W")
    sync_free_cycle(check, cyc, r, "64^3 host-built (multicolour GS and "
                    "Chebyshev)", "W")
    log(f"  one W-cycle at 64^3 host-built, f32: "
        f"{min(time_ms(lambda: cyc(r), 3), time_ms(lambda: cyc(r), 3)):.4f}"
        " ms (CUDA events, 3 cycles, min of 2)")
    profile_phase("config 2 host-built 64^3", (
        ("mixed stationary W-cycle to 1e-8", lambda: dml2.solve(b2, **kw)),
        ("one W-cycle", lambda: cyc(r))))

    # the device-built hierarchy with Chebyshev smoothers (poly_dyn)
    label = "config 2 device-built Chebyshev"
    t0 = time.perf_counter()
    dc = device_sa_setup(A3, grid=GRID3, dtype=f32, device=dev,
                         max_coarse=400, mixed_precision=True,
                         presmoother=C2_CHEBYSHEV, postsmoother=C2_CHEBYSHEV)
    torch.cuda.synchronize()
    log(f"{label}: device SA setup {time.perf_counter() - t0:.3f} s, "
        f"smoothers {[lvl.pre.config for lvl in dc.hierarchy.levels]}")
    lv = dc.hierarchy.levels[0]
    h_, c_r = rand(lv.A.n_pad, f32), rand(lv.A.n_pad, f32)
    Ac_csr = dia_to_csr(lv.A)
    compare(check, f"dia_spmv_add.float32 [config2 device level0 A nd="
            f"{lv.A.ndiags} n_pad={lv.A.n_pad}]", f32,
            lambda: dia.dia_spmv_add(lv.A, h_, c_r),
            lambda: dia.dia_spmv_add_ref(lv.A, h_, c_r), results,
            *dia_cost(lv.A, 3, extra_ops=1),
            library_fn=lambda: torch.addmv(c_r, Ac_csr, h_), path=label)
    del Ac_csr
    mixed = dict(tol=1e-8, maxiter=40, accel="cg", precision="mixed")
    dc.solve(b2, **mixed)                      # warm-up
    res_g, res_c = [], []
    xg, counts, wall = counted(lambda: dc.solve(b2, residuals=res_g, **mixed))
    launches[label] = counts
    cpu_copy_of(dc).solve(b2, residuals=res_c, **mixed)
    true = float(np.linalg.norm(b2 - A3 @ xg)) / normb
    log(f"{label} mixed CG to 1e-8: card {len(res_g) - 1} iterations (wall "
        f"{wall:.4f} s), its CPU copy {len(res_c) - 1}; true relres "
        f"{true:.3e}; launches {json.dumps(counts, sort_keys=True)}")
    check(len(res_g) == len(res_c) and true <= 1e-8,
          f"{label}: {len(res_g) - 1} iterations, the CPU copy's "
          f"{len(res_c) - 1}, true relres {true:.3e} <= 1e-8")
    path_launches(check, label, counts)
    sync_free_cycle(check, dc.cycle_operator("W"), rand(lv.n_pad, f32),
                    "64^3 device-built Chebyshev", "W")
    return dml2, b2


def sharded_config2_phase(check, dev, dml2, b2, rand, results, launches):
    """The host-built config 2 hierarchy row-sharded in a world of one NCCL
    rank (every level a ring of one, its DIA level through K16): the
    native float32 stationary W-cycle to 1e-4 (its float32 floor at 64^3
    is 2.1e-5 of ||b||) against the unsharded one, counters around the
    sharded solve; then K16 at that level's shape (7 diagonals, a reach of
    64^2 rows) against its plain twin and K1.  The process group is
    destroyed before returning."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from pyamg_tpu_torch import DeviceMultilevelSolver
    from pyamg_tpu_torch.parallel import (halo_width, initialize_distributed,
                                          make_solver_mesh, shard_hierarchy)

    label = "sharded config 2 host-built W-cycle"
    kw = dict(tol=1e-4, maxiter=30, cycle="W", accel=None)
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(init_method=f"file://{tmp}/rendezvous",
                               world_size=1, rank=0, device=dev)
        try:
            sharded = DeviceMultilevelSolver(shard_hierarchy(
                dml2.hierarchy, make_solver_mesh(device=dev)))
            res0, res1 = [], []
            dml2.solve(b2, residuals=res0, **kw)
            x, counts, wall = counted(lambda: sharded.solve(
                b2, residuals=res1, **kw))
            launches[label] = counts
        finally:
            dist.destroy_process_group()
    m = min(len(res0), len(res1))
    diff = float(np.max(np.abs(np.subtract(res1[:m], res0[:m]))
                        / np.asarray(res0[:m])))
    normb = float(np.linalg.norm(b2))
    log(f"{label} (world of one, native f32, stationary to 1e-4): "
        f"{len(res1) - 1} iterations (unsharded {len(res0) - 1}), history "
        f"relres {res1[-1] / normb:.3e}, vs unsharded max rel diff "
        f"{diff:.2e}, wall {wall:.4f} s")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    check(len(res1) == len(res0) and diff <= STATIONARY_RTOL
          and bool(np.isfinite(x).all()) and res1[-1] <= 1e-4 * normb,
          f"{label}: relres <= 1e-4 in the unsharded count, its history "
          f"to rtol {STATIONARY_RTOL:g}")
    path_launches(check, label, counts)
    A = dml2.hierarchy.levels[0].A
    tag = f"host config2 level0 nd={A.ndiags} n_pad={A.n_pad} " \
          f"halo={halo_width(A)}"
    x, k1, nbytes = halo_ring_check(check, A, rand, results, tag, label)
    halo_shards_check(check, A, x, k1, nbytes, tag, torch.cuda.Stream())


def smoother_kinds_phase(check, dev, rand, results, launches):
    """Every other smoother kind on a host-built float64 256^2 hierarchy:
    V-cycle CG to 1e-8 (maxiter 40) on the card, counters around it,
    against the same solve on the hierarchy's CPU copy (the plain twins):
    the same count, histories to rtol 1e-8; S1 in float64 at SOR's level
    0 (its multicolour form)."""
    import warnings

    import numpy as np
    import torch

    from pyamg_tpu_torch import (DeviceMultilevelSolver, compile_hierarchy,
                                 poisson, smoothed_aggregation_solver)
    from pyamg_tpu_torch.relaxation import chebyshev_polynomial_coefficients

    A = poisson(STATIONARY_GRID, format="csr")
    b = np.random.default_rng(5).random(A.shape[0])
    rho = 8.0                     # rho(A) of the 5-point Laplacian, < 8
    specs = {
        "richardson": ("richardson", {"omega": 1.0}),
        "sor": ("sor", {"omega": 1.0, "sweep": "symmetric"}),
        "jacobi_ne": ("jacobi_ne", {"omega": 0.5}),
        "gauss_seidel_nr": ("gauss_seidel_nr", {"sweep": "symmetric"}),
        "schwarz": ("schwarz", {}),
        "polynomial": [("polynomial", {"coefficients": list(
            chebyshev_polynomial_coefficients(rho / 30, 1.1 * rho, 3))}),
            C2_CHEBYSHEV],
        "chebyshev": C2_CHEBYSHEV}
    for kind in SMOOTHER_KINDS:
        label = f"256^2 float64 {kind}"
        ml = smoothed_aggregation_solver(A, presmoother=specs[kind],
                                         postsmoother=specs[kind])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the substitution notices
            h = compile_hierarchy(ml, dtype=torch.float64, device=dev)
        kw = dict(tol=1e-8, maxiter=40, accel="cg")
        res_g, res_c = [], []
        _, counts, wall = counted(lambda: DeviceMultilevelSolver(h).solve(
            b, residuals=res_g, **kw))
        launches[label] = counts
        DeviceMultilevelSolver(to_device(h, "cpu")).solve(
            b, residuals=res_c, **kw)
        m = min(len(res_g), len(res_c))
        err = float(np.max(np.abs(np.subtract(res_g[:m], res_c[:m]))
                           / np.asarray(res_c[:m])))
        check(len(res_g) == len(res_c) and err <= 1e-8,
              f"{label} ({h.levels[0].pre.config[0]} at level 0): card "
              f"{len(res_g) - 1} iterations, CPU copy {len(res_c) - 1}, "
              f"history rel diff {err:.2e} (tol 1e-8), last "
              f"{res_g[-1] / res_g[0]:.3e} of the first, wall {wall:.4f} s")
        path_launches(check, label, counts)
        if kind == "sor":
            scalar_sweep_checks(check, "256^2 float64 sor level0",
                                h.levels[0].A, h.levels[0].pre, rand,
                                results, label)


def classical_levels(solver):
    """(n, strides, ndiags) of each level of a device-built hierarchy, and
    the dense coarsest level's n."""
    return ([(i["n"], tuple(i["strides"]), i["ndiags"])
             for i in solver.setup_info["levels"]],
            solver.hierarchy.levels[-1].n)


def timed_setup(setup, A, kw):
    """A device setup called twice (the first warms the allocator and
    builds nothing else): (the second's solver, its seconds, the first's),
    CUDA-synchronised."""
    import torch

    t0 = time.perf_counter()
    setup(A, **kw)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = setup(A, **kw)
    torch.cuda.synchronize()
    return solver, time.perf_counter() - t0, t_first


def classical_level_checks(check, where, h, rand, results, path, lane_path,
                           A64=None):
    """The classical path's kernels at level 0 of ``h``: K1 plain on A and
    R_emb, K1 SPMV_ADD on P_emb, K3 and K2 with the level's Jacobi
    tensors, float32 (and K1 on the float64 ``A64``); with ``lane_path``
    K10, K9, K8 plain and K8 add at K = 8 instead."""
    import torch

    from pyamg_tpu_torch.sparse import dia

    lvl = h.levels[0]
    A, P, R = lvl.A, lvl.P.P_emb, lvl.R.R_emb
    dinv, omega = lvl.pre.arrays
    m = A.n_pad
    f32 = torch.float32
    tag = f"{where} level0 n_pad={m}"
    if lane_path is not None:
        Xk, Bk, Vk = (rand((LANES, m), f32) for _ in range(3))
        # library: torch.sparse.mm / torch.addmm on CSR, lanes as columns
        R_csr, P_csr = dia_to_csr(R), dia_to_csr(P)
        Xcols, Vcols = Xk.T.contiguous(), Vk.T.contiguous()
        ktag = f"{tag} K={LANES}"
        k10_checks(check, f"dia_jacobi_zero_res_k.float32 [{ktag} "
                   f"nd={A.ndiags}]", A, Bk, dinv, omega, results,
                   path=lane_path)
        for name, op, kern, plain, cost, lib in (
                ("dia_jacobi_k", A,
                 lambda: dia.dia_jacobi_k(A, Xk, Bk, dinv, omega),
                 lambda: dia.dia_jacobi_k_ref(A, Xk, Bk, dinv, omega),
                 dia_cost(A, 1, LANES, 3, extra_ops=4), None),
                ("dia_spmm", R, lambda: dia.dia_spmm(R, Xk),
                 lambda: dia.dia_spmm_ref(R, Xk), dia_cost(R, 0, LANES, 2),
                 lambda: torch.sparse.mm(R_csr, Xcols)),
                ("dia_spmm_add", P, lambda: dia.dia_spmm_add(P, Xk, Vk),
                 lambda: dia.dia_spmm_add_ref(P, Xk, Vk),
                 dia_cost(P, 0, LANES, 3, extra_ops=1),
                 lambda: torch.addmm(Vcols, P_csr, Xcols))):
            compare(check, f"{name}.float32 [{ktag} nd={op.ndiags}]", f32,
                    kern, plain, results, *cost, library_fn=lib,
                    path=lane_path)
        return
    x, b, t = (rand(m, f32) for _ in range(3))
    A_csr, P_csr, R_csr = dia_to_csr(A), dia_to_csr(P), dia_to_csr(R)
    # R_emb first: the kernels line reports a path's first check, and
    # every cycle restricts through K1 (a mixed outer loop applies A64)
    compare(check, f"dia_spmv.float32 [{tag} R_emb nd={R.ndiags}]", f32,
            lambda: dia.dia_spmv(R, x), lambda: dia.dia_spmv_ref(R, x),
            results, *dia_cost(R, 2), path=path,
            library_fn=lambda: torch.mv(R_csr, x))
    compare(check, f"dia_spmv.float32 [{tag} A nd={A.ndiags}]", f32,
            lambda: dia.dia_spmv(A, x), lambda: dia.dia_spmv_ref(A, x),
            results, *dia_cost(A, 2), path=path,
            library_fn=lambda: torch.mv(A_csr, x))
    compare(check, f"dia_spmv_add.float32 [{tag} P_emb nd={P.ndiags}]", f32,
            lambda: dia.dia_spmv_add(P, t, x),
            lambda: dia.dia_spmv_add_ref(P, t, x), results,
            *dia_cost(P, 3, extra_ops=1), path=path,
            library_fn=lambda: torch.addmv(x, P_csr, t))
    compare(check, f"dia_jacobi_zero_res.float32 [{tag} A nd={A.ndiags}]",
            f32, lambda: dia.dia_jacobi_zero_res(A, b, dinv, omega),
            lambda: dia.dia_jacobi_zero_res_ref(A, b, dinv, omega), results,
            *dia_cost(A, 4, extra_ops=3), path=path)
    compare(check, f"dia_jacobi.float32 [{tag} A nd={A.ndiags}]", f32,
            lambda: dia.dia_jacobi(A, x, b, dinv, omega),
            lambda: dia.dia_jacobi_ref(A, x, b, dinv, omega), results,
            *dia_cost(A, 4, extra_ops=4), path=path)
    if A64 is not None:
        x64 = rand(A64.n_pad, torch.float64)
        A64_csr = dia_to_csr(A64)
        compare(check, f"dia_spmv.float64 [{tag} A64 nd={A64.ndiags}]",
                torch.float64, lambda: dia.dia_spmv(A64, x64),
                lambda: dia.dia_spmv_ref(A64, x64), results,
                *dia_cost(A64, 2), path=path,
                library_fn=lambda: torch.mv(A64_csr, x64))


def primitive_checks(check, A):
    """The setup primitives (engine/setup.py) on the DIA ``A`` on the card
    against the same calls on a CPU copy: Luby MIS, JP colours and PMIS
    splitting from three seeds array for array, Bellman-Ford from three
    seed points to float32 rounding; each call's wall.  A round-based call
    that stops at a state no round changes (undecided neighbours whose
    hash weights tie: the reference's loop would not end there) must stop
    on the card at the CPU's round with the CPU's state."""
    import numpy as np
    import torch

    from pyamg_tpu_torch.engine import setup as dsetup
    from pyamg_tpu_torch.sparse import DIAMatrix

    Ac = DIAMatrix(data=A.data.cpu(), offsets=A.offsets, shape=A.shape,
                   nnz=A.nnz)
    seeds = torch.zeros(A.n_pad, dtype=torch.bool)
    seeds[[0, A.shape[0] // 2, A.shape[0] - 1]] = True
    calls = [(f"{name} seed {sd}", lambda M, f=fn, sd=sd: f(M, seed=sd))
             for name, fn in (("luby_mis", dsetup.device_luby_mis),
                              ("jp_coloring", dsetup.device_jp_coloring),
                              ("pmis_splitting",
                               dsetup.device_pmis_splitting))
             for sd in PRIMITIVE_SEEDS]
    calls.append(("bellman_ford 3 seed points",
                  lambda M: dsetup.device_bellman_ford(
                      M, seeds.to(M.device))))

    def run(fn, M):
        try:
            return fn(M), None
        except dsetup.UndecidedVertices as e:
            return e.state, e.rounds

    for label, fn in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, stop = run(fn, A)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want, stop_c = run(fn, Ac)
        got = got.cpu()
        if got.dtype.is_floating_point:
            fin = torch.isfinite(want)
            ok = (torch.equal(fin, torch.isfinite(got))
                  and bool(torch.allclose(got[fin], want[fin], rtol=1e-6)))
            what = (f"distances within float32 rounding of the CPU's, max "
                    f"{float(want[fin].max()):.4g}")
        else:
            ok = torch.equal(got, want) and stop == stop_c
            what = (f"equal to the CPU's array for array ("
                    f"{int(np.unique(want.numpy()).size)} distinct values)")
            if stop_c is not None:
                what += (f", both stopped after {stop_c} rounds with "
                         f"{int((want == -1).sum())} vertices undecided "
                         "(tied hash weights)")
        check(ok, f"setup primitive {label} on config 3's level 0 "
              f"(n_pad={A.n_pad}, nd={A.ndiags}): {what}, card wall "
              f"{wall:.4f} s")


def classical_phase(check, dev, rand, results, launches, card):
    """Phase 18: the classical device setups on the card.  Config 3
    (512^2 rotated anisotropic diffusion): device_rs_setup with the
    bench's arguments, its levels, levels 0 and 1 against the port's CPU
    copy of the same setup, the kernels at its level-0 shapes, CG to 1e-5
    (the reference's 13 iterations) and K = 8 lanes of it, then
    device_sa_setup with stride="auto" (its strides, 10 iterations) and
    the setup primitives on its level-0 DIA; config 5 (1024^2
    recirculating flow): device_rs_setup mixed, its levels, the kernels at
    its level 0, mixed FGMRES to 1e-8 (the reference's 43 +- 2
    iterations, true relres <= 1e-8); AIR (256^2 upwind advection): its
    levels, the masked K2 sweep against its twin and the composed form,
    the first stationary cycle's residual drop (>= 1e5).  Counters around
    every solve, and each solve profiled."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import (advection_2d, device_air_setup,
                                 device_rs_setup, device_sa_setup,
                                 diffusion_stencil_2d, recirc_flow,
                                 stencil_grid)
    from pyamg_tpu_torch.sparse import dia

    f32 = torch.float32
    # config 3: the classical column
    A3 = stencil_grid(diffusion_stencil_2d(epsilon=1e-3, theta=0.0,
                                           type="FD"), C3_GRID).tocsr()
    n3 = A3.shape[0]
    b3 = np.random.default_rng(2).random(n3)
    kw3 = dict(grid=C3_GRID, dtype=f32, max_coarse=400)
    drs3, t_setup, t_first = timed_setup(device_rs_setup, A3,
                                         dict(device=dev, **kw3))
    lv, nc = classical_levels(drs3)
    log(f"config 3 device RS setup, {C3_GRID} (n={n3}): {t_setup:.4f} s "
        f"(first call {t_first:.3f} s, CUDA-synchronised, host CSR -> DIA "
        f"included; {card}); {len(drs3.hierarchy.levels)} levels")
    levels_log(drs3)
    check(lv == C3_LEVELS and nc == C3_COARSE,
          f"config 3 classical levels {lv} + dense {nc} (the JAX "
          f"package's {C3_LEVELS} + {C3_COARSE})")
    t0 = time.perf_counter()
    crs3 = device_rs_setup(A3, device="cpu", **kw3)
    t_cpu = time.perf_counter() - t0
    worst = 0.0
    for i in (0, 1):
        lg, lc = drs3.hierarchy.levels[i], crs3.hierarchy.levels[i]
        for g, c in ((lg.A, lc.A), (lg.P.P_emb, lc.P.P_emb),
                     (lg.R.R_emb, lc.R.R_emb)):
            assert g.offsets == c.offsets
            worst = max(worst, float((g.data.cpu() - c.data).abs().max()
                                     / c.data.abs().max()))
        rg = float(drs3.setup_info["levels"][i]["rho_D_inv_A"])
        rc = float(crs3.setup_info["levels"][i]["rho_D_inv_A"])
        worst = max(worst, abs(rg - rc) / rc)
    check(worst <= 1e-5, f"config 3 classical levels 0-1 (A, P_emb, R_emb, "
          f"rho) on the card vs the port's CPU copy: max rel diff "
          f"{worst:.2e} (float32 rounding, tol 1e-5; CPU setup {t_cpu:.2f} s)")
    del crs3
    log("config 3 classical kernels at level 0 (kernel vs plain twin):")
    classical_level_checks(check, "config3 classical", drs3.hierarchy, rand,
                           results, "config 3 classical CG", None)
    classical_level_checks(check, "config3 classical", drs3.hierarchy, rand,
                           results, None, "config 3 classical batched CG")
    cg5 = dict(tol=1e-5, maxiter=60, accel="cg")
    drs3.solve(b3, **cg5)                           # warm-up
    res = []
    x, counts, wall = counted(lambda: drs3.solve(b3, residuals=res, **cg5))
    launches["config 3 classical CG"] = counts
    normb = float(np.linalg.norm(b3))
    true = float(np.linalg.norm(b3 - A3 @ x)) / normb
    log(f"config 3 classical (512^2, f32, CG to 1e-5): {len(res) - 1} "
        f"iterations, history relres {res[-1] / normb:.3e}, true relres "
        f"{true:.3e}, solve {wall:.4f} s ({card})")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    check(len(res) - 1 == REF_ITERS_C3_RS and res[-1] <= 1e-5 * normb,
          f"config 3 classical CG: {len(res) - 1} iterations to 1e-5 "
          f"(reference {REF_ITERS_C3_RS})")
    path_launches(check, "config 3 classical CG", counts)
    B3 = np.random.default_rng(5).random((n3, LANES))
    lane_solves_phase(check, "config 3 classical batched CG", drs3, B3, cg5,
                      launches)
    # the SA column with stride="auto"
    dsa3, t_sa, _ = timed_setup(device_sa_setup, A3,
                                dict(device=dev, stride="auto", **kw3))
    strides = [tuple(i["strides"]) for i in dsa3.setup_info["levels"]]
    res_sa = []
    _, counts, wall_sa = counted(lambda: dsa3.solve(b3, residuals=res_sa,
                                                    **cg5))
    launches["config 3 SA stride auto CG"] = counts
    log(f"config 3 device SA setup (stride='auto'): {t_sa:.4f} s, strides "
        f"{strides}; CG to 1e-5 {len(res_sa) - 1} iterations, solve "
        f"{wall_sa:.4f} s")
    check(strides == C3_SA_STRIDES and len(res_sa) - 1 == REF_ITERS_C3_SA,
          f"config 3 SA stride='auto': strides {strides} (reference "
          f"{C3_SA_STRIDES}), {len(res_sa) - 1} CG iterations (reference "
          f"{REF_ITERS_C3_SA})")
    path_launches(check, "config 3 SA stride auto CG", counts)
    primitive_checks(check, drs3.hierarchy.levels[0].A)
    Bt3 = torch.as_tensor(B3, device=dev)
    profile_phase("config 3 512^2", (
        ("classical CG to 1e-5", lambda: drs3.solve(b3, **cg5)),
        (f"classical CG to 1e-5, K={LANES}", lambda: drs3.solve(Bt3, **cg5)),
        ("SA stride='auto' CG to 1e-5", lambda: dsa3.solve(b3, **cg5))))
    del drs3, dsa3, Bt3

    # config 5: the device-built classical column, mixed FGMRES
    A5 = recirc_flow(C5_GRID, epsilon=1e-2)
    n5 = A5.shape[0]
    b5 = np.random.default_rng(4).random(n5)
    drs5, t_setup, t_first = timed_setup(device_rs_setup, A5, dict(
        grid=C5_GRID, dtype=f32, device=dev, max_coarse=400,
        mixed_precision=True))
    lv, nc = classical_levels(drs5)
    log(f"config 5 device RS setup, recirc_flow {C5_GRID} (n={n5}, mixed): "
        f"{t_setup:.4f} s (first call {t_first:.3f} s; {card}); "
        f"{len(drs5.hierarchy.levels)} levels")
    levels_log(drs5)
    check(lv == C5_LEVELS and nc == C5_COARSE,
          f"config 5 classical levels {lv} + dense {nc} (the JAX "
          f"package's {C5_LEVELS} + {C5_COARSE})")
    log("config 5 classical kernels at level 0 (kernel vs plain twin):")
    classical_level_checks(check, "config5 classical", drs5.hierarchy, rand,
                           results, "config 5 classical mixed FGMRES", None,
                           A64=drs5.hierarchy.A64)
    fg = dict(tol=1e-8, maxiter=150, accel="fgmres", precision="mixed")
    drs5.solve(b5, **fg)                            # warm-up
    res = []
    x, counts, wall = counted(lambda: drs5.solve(b5, residuals=res, **fg))
    launches["config 5 classical mixed FGMRES"] = counts
    normb = float(np.linalg.norm(b5))
    true = float(np.linalg.norm(b5 - A5 @ x)) / normb
    iters = len(res) - 1
    log(f"config 5 classical (1024^2, mixed FGMRES to 1e-8): {iters} "
        f"iterations, history relres {res[-1] / normb:.4e}, true relres "
        f"{true:.4e} (reference {REF_ITERS_C5} and {REF_RELRES_C5:g}), "
        f"solve {wall:.4f} s ({card})")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    check(abs(iters - REF_ITERS_C5) <= 2 and true <= 1e-8
          and res[-1] <= 1e-8 * normb,
          f"config 5 classical: {iters} FGMRES iterations within "
          f"{REF_ITERS_C5} +- 2, true relres {true:.3e} <= 1e-8")
    path_launches(check, "config 5 classical mixed FGMRES", counts)
    profile_phase("config 5 1024^2", (
        ("classical mixed FGMRES to 1e-8", lambda: drs5.solve(b5, **fg)),))
    del drs5

    # AIR on upwind advection 256^2
    Aa, ba = advection_2d(AIR_GRID, theta=np.pi / 4)
    dair, t_setup, t_first = timed_setup(device_air_setup, Aa, dict(
        grid=AIR_GRID, device=dev, max_coarse=400))
    lv, nc = classical_levels(dair)
    log(f"AIR device setup, advection {AIR_GRID}: {t_setup:.4f} s (first "
        f"call {t_first:.3f} s; {card}); levels {lv} + dense {nc}")
    levels_log(dair, rho=False)
    check([n for n, _, _ in lv] == AIR_LEVELS and nc == AIR_COARSE,
          f"AIR levels {[n for n, _, _ in lv]} + dense {nc} (the JAX "
          f"package's {AIR_LEVELS} + {AIR_COARSE})")
    lvl = dair.hierarchy.levels[0]
    post = lvl.post
    A0, mdinv = lvl.A, post.mask_dinv[0]
    dinv, fmask = post.arrays[0], post.arrays[1]
    omega = post.config[2]
    m = A0.n_pad
    x, b = rand(m, f32), rand(m, f32)
    tag = f"AIR level0 A nd={A0.ndiags} n_pad={m}, F-masked dinv"
    compare(check, f"dia_jacobi.float32 [{tag}]", f32,
            lambda: dia.dia_jacobi(A0, x, b, mdinv, omega),
            lambda: dia.dia_jacobi_ref(A0, x, b, mdinv, omega), results,
            *dia_cost(A0, 4, extra_ops=4), path="AIR stationary")
    got = dia.dia_jacobi(A0, x, b, mdinv, omega)
    composed = torch.where(fmask, x + omega * dinv * (b - A0 @ x), x)
    err = float((got - composed).abs().max() / composed.abs().max())
    check(err <= F32_REL_TOL and torch.equal(got[~fmask], x[~fmask]),
          f"AIR masked sweep: K2 with the masked dinv vs the composed "
          f"torch.where form on the card, max rel err {err:.2e} (tol "
          f"{F32_REL_TOL:g}), rows off the mask bit-identical")
    res = []
    _, counts, wall = counted(lambda: dair.solve(ba, tol=1e-8, maxiter=5,
                                                 residuals=res))
    launches["AIR stationary"] = counts
    drop = res[0] / res[1]
    log(f"AIR stationary (256^2, f32, 5 cycles): history "
        f"{' '.join(f'{r:.4e}' for r in res)}, first-cycle drop {drop:.4g} "
        f"(reference 6.09e5), solve {wall:.4f} s")
    log(f"  launches: {json.dumps(counts, sort_keys=True)}")
    check(drop >= AIR_MIN_DROP and bool(np.isfinite(res).all()),
          f"AIR: first stationary cycle drops the residual {drop:.4g}x "
          f"(>= {AIR_MIN_DROP:g})")
    path_launches(check, "AIR stationary", counts)
    profile_phase("AIR 256^2", (
        ("AIR stationary, 5 cycles", lambda: dair.solve(ba, tol=1e-8,
                                                        maxiter=5)),))


def launches_per_call(fn):
    """Device operations one ``fn()`` issues, counted exactly: a call
    after a warm one is captured in a CUDA graph, and the graph's kernel,
    memcpy and memset nodes are counted through the driver API (a
    profiler trace can drop events)."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    kind = ctypes.c_int()
    ops = 0
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                   ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
        ops += kind.value in (0, 1, 2)
    del graph
    return ops


def block_levels(solver):
    """(n, bs, ndiags) of each level of a block device setup, and the
    dense coarsest level's n."""
    return ([(i["n"], i["bs"], i["ndiags"])
             for i in solver.setup_info["levels"]],
            solver.hierarchy.levels[-1].n)


def bdia_to_csr(A, dev):
    """The same operator as a torch sparse CSR tensor on ``dev`` (the
    yardstick for torch.mv)."""
    import torch

    nd, nb, bs, _ = A.data.shape
    n = nb * bs
    rows = (torch.arange(nb, device=dev)[None, :, None, None] * bs
            + torch.arange(bs, device=dev)[None, None, :, None])
    offs = torch.tensor(A.offsets, device=dev)[:, None, None, None]
    cols = ((torch.arange(nb, device=dev)[None, :, None, None] + offs) % nb
            * bs + torch.arange(bs, device=dev)[None, None, None, :])
    rows = rows.expand(nd, nb, bs, bs)
    cols = cols.expand(nd, nb, bs, bs)
    keep = A.data != 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # sparse tensors are "beta"
        coo = torch.sparse_coo_tensor(
            torch.stack([rows[keep], cols[keep]]), A.data[keep], (n, n))
        return coo.coalesce().to_sparse_csr()


def block_cost(A, vectors, dinv=False, nodes=None, extra_ops=0):
    """(bytes, operations) of one block-DIA pass: the blocks of ``nodes``
    nodes (all by default) of every diagonal, their Dinv blocks where
    ``dinv``, and ``vectors`` full vectors, each read or written once."""
    nd, nb, bs = A.ndiags, A.nb_pad, A.bs
    nn = nb if nodes is None else nodes
    blocks = nd * nn * bs * bs + (nn * bs * bs if dinv else 0)
    nbytes = (blocks + vectors * nb * bs) * A.data.element_size()
    return nbytes, 2 * blocks + extra_ops * nn * bs


class TwinSpy:
    """Counts calls of the block-DIA twins and the multicolour sweeps'
    twins with a CUDA tensor among their arguments while active: on the
    card every wrapper must launch its kernel, so the count must stay 0
    through a solve."""

    NAMES = {"block_dia": ("block_dia_spmv_ref", "block_dia_resid_ref",
                           "block_jacobi_zero_ref",
                           "block_jacobi_zero_res_ref",
                           "block_jacobi_step_ref", "block_colour_step_ref",
                           "block_mcgs_sweep_ref"),
             "dia": ("dia_mcgs_sweep_ref",)}

    def __enter__(self):
        import importlib

        import torch

        self.saved, self.calls = [], 0

        def spying(fn):
            def spy(*args, **kw):
                if any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in args):
                    self.calls += 1
                return fn(*args, **kw)
            return spy

        for mod, names in self.NAMES.items():
            module = importlib.import_module(f"pyamg_tpu_torch.sparse.{mod}")
            for name in names:
                self.saved.append((module, name, getattr(module, name)))
                setattr(module, name, spying(getattr(module, name)))
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def counted_no_twin(check, label, fn):
    """``counted(fn)`` with the block and sweep twins watched: (result,
    counts, wall); checks that no twin ran on the card."""
    with TwinSpy() as spy:
        out = counted(fn)
    check(spy.calls == 0, f"{label}: no block-DIA or sweep twin ran on the "
          f"card ({spy.calls} calls on CUDA tensors)")
    return out


def sweep_forms(plan, x_bytes):
    """(label, plan) of each form of a multicolour sweep that is right
    for ``plan``'s colouring on an iterate of ``x_bytes``: the plan's own
    first, then the other barrier route (the one-CTA route only where the
    iterate fits its shared memory), then, where the plan runs in place,
    those routes staged (staging is right for any colouring)."""
    from pyamg_tpu_torch.sparse import dia

    threads = {"cta": dia._SWEEP_CTA_THREADS,
               "grid": dia._SWEEP_GRID_THREADS}
    other = "cta" if plan.route == "grid" else "grid"
    forms = [plan]
    if other == "grid" or x_bytes <= dia._SWEEP_CTA_X_BYTES:
        forms.append(dataclasses.replace(plan, route=other,
                                         threads=threads[other]))
    if not plan.staged:
        forms += [dataclasses.replace(p, staged=True) for p in forms]
    return [(f"{p.route} {p.threads}{' staged' if p.staged else ''}", p)
            for p in forms]


def sweep_cost(A, dirs):
    """(bytes, operations) of a multicolour sweep of ``dirs`` directions
    on A (DIA or block DIA): the operator's stored values, its inverse
    diagonal (blocks), b and x read once and the result written once; each
    direction's products, residuals and updates over every row."""
    if hasattr(A, "bs"):
        nbytes, ops = block_cost(A, 3, dinv=True, extra_ops=2)
        return nbytes, dirs * ops
    nbytes, ops = dia_cost(A, 4, extra_ops=3)
    return nbytes, dirs * ops


def sweep_checks(check, name, dtype, forms, chain_fn, twin_fn, results,
                 cost, path):
    """A one-launch multicolour sweep: its plan's form (the first of
    ``forms``, label -> fn) by ``compare`` against the colour-by-colour
    chain of the parent kernels (``chain_fn``) bit for bit, two launches
    bit-identical, the twin timed as the plain version; within tolerance
    of the twin; one launch a call; the chain's time beside it; and every
    other form the chain's bits, each timed."""
    import torch

    (label0, fn0), *others = forms.items()
    compare(check, f"{name} [{label0}]", dtype, fn0, twin_fn, results,
            *cost, path=path, exact=True, repeat_exact=True,
            want_fn=chain_fn)
    r = results[-1]
    k = launches_per_call(fn0)
    r["launches_per_call"] = k
    check(k == 1, f"{name} [{label0}]: {k} launch(es) a call (one)")
    got, twin, want = fn0(), twin_fn(), chain_fn()
    err = float((got - twin).abs().max() / twin.abs().max())
    tol = F32_REL_TOL if dtype == torch.float32 else F64_REL_TOL
    r["twin_rel_err"] = err
    check(err <= tol, f"{name}: within {tol:g} of its twin (max rel err "
          f"{err:.3e})")
    r["chain_ms"] = min(time_ms(chain_fn) for _ in range(2))
    r["forms"] = {label0: r["ms"]}
    for label, fn in others:
        same = torch.equal(fn(), want)
        t = time_ms(fn)
        r["forms"][label] = t
        check(same, f"{name} [{label}]: the chain's bits "
              f"({'equal' if same else 'DIFFER'}), {t:.4f} ms")
    log(f"    the parent's chain {r['chain_ms']:.4f} ms; forms "
        + ", ".join(f"{k} {v:.4f}" for k, v in r["forms"].items()) + " ms")


def scalar_sweep_checks(check, where, A, sm, rand, results, path,
                        sweep=None):
    """S1 on the DIA level A with the multicolour smoother ``sm`` (its
    colouring and plan; ``sweep`` in place of its direction where given)
    against the chain of K2 colour steps with each colour's inverse
    diagonal (the parent's path) and the twin, by ``sweep_checks``."""
    from pyamg_tpu_torch.engine import relaxation as rel
    from pyamg_tpu_torch.sparse import dia

    _, ncolors, own, iterations = sm.config
    sweep = sweep or own
    dinv = sm.arrays[0]
    plan, stack = sm.plan(A), sm.color_dinv
    order = rel._sweeps(ncolors, sweep) * iterations
    x, b = rand(A.n_pad, A.dtype), rand(A.n_pad, A.dtype)

    def chain():
        y = x
        for c in order:
            y = dia.dia_jacobi(A, y, b, stack[c], 1.0)
        return y

    dt = str(A.dtype).removeprefix("torch.")
    forms = {label: (lambda p=p: dia.dia_mcgs_sweep(A, x, b, dinv, p, order))
             for label, p in sweep_forms(plan, x.numel() * x.element_size())}
    sweep_checks(
        check, f"dia_mcgs_sweep.{dt} [{where} nd={A.ndiags} n_pad="
        f"{A.n_pad}, {ncolors} colours (largest {plan.max_rows} rows) "
        f"{sweep} x{iterations}, {'staged' if plan.staged else 'in place'}]",
        A.dtype, forms, chain,
        lambda: dia.dia_mcgs_sweep_ref(A, x, b, dinv, plan, order), results,
        sweep_cost(A, len(order) // ncolors), path)


def block_sweep_checks(check, tag, A, Dinv, colors, ncolors, sweep, x, b,
                       results, path):
    """B3 on the block-DIA operator A over ``ncolors`` node colours, one
    ``sweep``, against the chain of B2 COLOUR steps (the parent's path)
    and the twin, by ``sweep_checks``."""
    from pyamg_tpu_torch.engine import relaxation as rel
    from pyamg_tpu_torch.sparse import block_dia as bd

    plan = bd.block_mcgs_plan(A, colors, ncolors)
    order = rel._sweeps(ncolors, sweep)

    def chain():
        y = x
        for c in order:
            y = bd.block_colour_step(A, y, b, Dinv, colors, c)
        return y

    dt = str(A.dtype).removeprefix("torch.")
    forms = {label: (lambda p=p: bd.block_mcgs_sweep(A, x, b, Dinv, p,
                                                      order))
             for label, p in sweep_forms(plan, x.numel() * x.element_size())}
    sweep_checks(
        check, f"block_mcgs_sweep.{dt} [{tag}, {ncolors} colours (largest "
        f"{plan.max_rows} nodes) {sweep}, "
        f"{'staged' if plan.staged else 'in place'}]", A.dtype, forms, chain,
        lambda: bd.block_mcgs_sweep_ref(A, x, b, Dinv, plan, order),
        results, sweep_cost(A, len(order) // ncolors), path)


def sweep_route_times(where, h):
    """Both barrier routes of S1 (one CTA of 1024 threads, the iterate in
    its shared memory where it fits; a cooperative grid of 256 or
    128-thread CTAs) timed at every multicolour DIA level of the hierarchy
    ``h``, the smoother's own sweep: the crossover that
    ``sparse/dia.py::sweep_route`` encodes."""
    import torch

    from pyamg_tpu_torch.engine import relaxation as rel
    from pyamg_tpu_torch.sparse import DIAMatrix, dia

    log(f"{where}: S1's barrier routes at each multicolour level (ms a "
        f"symmetric sweep; the plan's route marked *):")
    rng = torch.Generator(device=h.levels[0].A.device).manual_seed(11)
    for i, lvl in enumerate(h.levels):
        sm, A = lvl.pre, lvl.A
        if sm.config[0] != "mcgs" or not isinstance(A, DIAMatrix):
            continue
        plan = sm.plan(A)
        order = rel._sweeps(sm.config[1], sm.config[2]) * sm.config[3]
        x = torch.rand(A.n_pad, generator=rng, device=A.device,
                       dtype=A.dtype)
        b = torch.rand(A.n_pad, generator=rng, device=A.device,
                       dtype=A.dtype)
        times = []
        fits = A.n_pad * A.data.element_size() <= dia._SWEEP_CTA_X_BYTES
        for route, threads in (("cta", 1024), ("grid", 256),
                               ("grid", 128)):
            if route == "cta" and not fits:
                continue
            p = dataclasses.replace(plan, route=route, threads=threads)
            t = time_ms(lambda: dia.dia_mcgs_sweep(A, x, b, sm.arrays[0], p,
                                                   order))
            mark = "*" if (route, threads) == (plan.route,
                                               plan.threads) else ""
            times.append(f"{route} {threads}{mark} {t:.4f}")
        log(f"  level {i}: n_pad {A.n_pad}, {sm.config[1]} colours, "
            f"largest {plan.max_rows} rows: {', '.join(times)}")


def block_level_checks(check, where, A, Dinv, omega, rand, results, path,
                       csr=None, lanes=0, colors=None, ncolors=0,
                       jacobi=True):
    """B1 (PLAIN, RESID, and PLAIN on a K = ``lanes`` stack) and B2 (ZERO,
    ZERO_RES and STEP where ``jacobi``, and with ``colors`` one COLOUR
    step and the forward sweep over ``ncolors`` colours as a chain of
    COLOUR steps) on the block-DIA level operator A against their twins
    on the same card tensors, two launches bit-identical, and B3 (the
    symmetric and forward sweeps in one launch each) bit for bit against
    that chain (``block_sweep_checks``); each with its launches per call,
    its bound, and torch.mv / torch.sparse.mm on ``csr`` (the same
    operator as CSR) for B1; ZERO_RES beside its composed alternative
    (ZERO, then RESID)."""
    import torch

    from pyamg_tpu_torch.sparse import block_dia as bd

    dt = str(A.dtype).removeprefix("torch.")
    nb, bs = A.nb_pad, A.bs
    tag = f"{where} nd={A.ndiags} nb_pad={nb} bs={bs}"
    x, b = rand(A.n_pad, A.dtype), rand(A.n_pad, A.dtype)

    def run(name, kernel, plain, cost, lib=None):
        compare(check, name, A.dtype, kernel, plain, results, *cost,
                library_fn=lib, path=path, repeat_exact=True)
        k = launches_per_call(kernel)
        results[-1]["launches_per_call"] = k
        log(f"    {k} launch(es) a call")

    spmv, jac = f"block_dia_spmv.{dt}", f"block_dia_jacobi.{dt}"
    run(f"{spmv} [{tag}]", lambda: bd.block_dia_apply(A, x),
        lambda: bd.block_dia_spmv_ref(A, x), block_cost(A, 2),
        None if csr is None else (lambda: torch.mv(csr, x)))
    run(f"{spmv} RESID [{tag}]", lambda: bd.block_dia_resid(A, x, b),
        lambda: bd.block_dia_resid_ref(A, x, b),
        block_cost(A, 3, extra_ops=1),
        None if csr is None else (lambda: torch.addmv(b, csr, x,
                                                      alpha=-1.0)))
    if lanes:
        X = rand((lanes, A.n_pad), A.dtype)
        Xc = X.T.contiguous()
        run(f"{spmv} [{tag} K={lanes}]", lambda: bd.block_dia_apply(A, X),
            lambda: bd.block_dia_spmv_ref(A, X),
            (block_cost(A, 2 * lanes)[0], lanes * block_cost(A, 0)[1]),
            None if csr is None else (lambda: torch.sparse.mm(csr, Xc)))
        del X, Xc
    if Dinv is None:
        return
    if jacobi:
        run(f"{jac} STEP [{tag}]",
            lambda: bd.block_jacobi_step(A, x, b, Dinv, omega),
            lambda: bd.block_jacobi_step_ref(A, x, b, Dinv, omega),
            block_cost(A, 3, dinv=True, extra_ops=3))
        run(f"{jac} ZERO [{tag}]",
            lambda: bd.block_jacobi_zero(Dinv, b, omega),
            lambda: bd.block_jacobi_zero_ref(Dinv, b, omega),
            (block_cost(A, 2, dinv=True)[0] - A.data.numel()
             * A.data.element_size(), 2 * nb * bs * bs + nb * bs))
        run(f"{jac} ZERO_RES [{tag}]",
            lambda: bd.block_jacobi_zero_res(A, b, Dinv, omega),
            lambda: bd.block_jacobi_zero_res_ref(A, b, Dinv, omega),
            block_cost(A, 3, dinv=True, extra_ops=2))

        def composed():
            x0 = bd.block_jacobi_zero(Dinv, b, omega)
            return x0, bd.block_dia_resid(A, x0, b)

        t_comp = min(time_ms(composed) for _ in range(2))
        results[-1]["composed_ms"] = t_comp
        log(f"    composed alternative (ZERO, then RESID: 2 launches) "
            f"{t_comp:.4f} ms against ZERO_RES {results[-1]['ms']:.4f} ms")
    if colors is None:
        return
    n0 = int((colors == 0).sum())
    run(f"{jac} COLOUR 0 of {ncolors} ({n0} nodes) [{tag}]",
        lambda: bd.block_colour_step(A, x, b, Dinv, colors, 0),
        lambda: bd.block_colour_step_ref(A, x, b, Dinv, colors, 0),
        block_cost(A, 2 + n0 / nb, dinv=True, nodes=n0, extra_ops=3))

    def chain():
        y = x
        for c in range(ncolors):
            y = bd.block_colour_step(A, y, b, Dinv, colors, c)
        return y

    def chain_plain():
        y = x
        for c in range(ncolors):
            y = bd.block_colour_step_ref(A, y, b, Dinv, colors, c)
        return y

    # the parent's form of a forward sweep, a chain of COLOUR steps; it
    # needs the blocks and Dinv once, b once, x and y each step
    run(f"{jac} COLOUR forward sweep, the chain ({ncolors} colours) [{tag}]",
        chain, chain_plain,
        block_cost(A, 1 + 2 * ncolors, dinv=True, extra_ops=3))
    # B3: the smoother's symmetric sweep, and the forward one, one launch
    # each
    for sweep in ("symmetric", "forward"):
        block_sweep_checks(check, tag, A, Dinv, colors, ncolors, sweep, x, b,
                           results, path)


def config4_phase(check, dev, card, rand, results, launches):
    """Phase 19: config 4's block device setup on the card (128^2 at the
    reference's size, 1024^2 at the card's), the block operations
    against scipy and the CPU, the block-DIA kernels (B1, B2) against
    their twins at the 1024^2 levels' and adaptive SA's shapes, and
    adaptive SA on Poisson 512^2."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import (DeviceMultilevelSolver,
                                 device_adaptive_sa_setup,
                                 device_sa_setup_block, linear_elasticity,
                                 poisson)
    from pyamg_tpu_torch.engine import relaxation as rel
    from pyamg_tpu_torch.engine.hierarchy import (_block_colors_for,
                                                  _device_block_dinv)
    from pyamg_tpu_torch.sparse import block_dia_from_scipy

    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(7)
    A4, B4 = linear_elasticity(C4_GRID)
    n4 = A4.shape[0]
    b4 = np.random.default_rng(3).random(n4)
    kw4 = dict(grid=C4_NODE_GRID, B=B4, max_coarse=400, dtype=f32,
               device=dev, mixed_precision=True)
    d4, t_setup, t_first = timed_setup(device_sa_setup_block, A4, kw4)
    lv, nc = block_levels(d4)
    log(f"config 4 block device setup, elasticity {C4_GRID} (n={n4}, "
        f"mixed): {t_setup:.4f} s (first call {t_first:.3f} s; {card}); "
        f"levels {lv} + dense {nc}")
    check(lv == C4_LEVELS and nc == C4_COARSE,
          f"config 4 levels {lv} + dense {nc} (the JAX package's "
          f"{C4_LEVELS} + {C4_COARSE})")
    mixed = dict(tol=1e-8, maxiter=100, accel="cg", precision="mixed")
    d4.solve(b4, **mixed)                           # warm-up
    res = []
    path = "config 4 block mixed CG"
    x, counts, wall = counted_no_twin(
        check, path, lambda: d4.solve(b4, residuals=res, **mixed))
    launches[path] = counts
    normb = float(np.linalg.norm(b4))
    true = float(np.linalg.norm(b4 - A4 @ x)) / normb
    iters = len(res) - 1
    log(f"config 4 (128^2, mixed CG to 1e-8): {iters} iterations, history "
        f"relres {res[-1] / normb:.4e}, true relres {true:.4e} (reference "
        f"{REF_ITERS_C4}, 4.241e-9), solve {wall:.4f} s ({card})")
    log(f"  launches of hand-written kernels: "
        f"{json.dumps(counts, sort_keys=True)}")
    path_launches(check, path, counts)
    check(abs(iters - REF_ITERS_C4) <= 1 and true <= 1e-8
          and bool(np.isfinite(x).all()),
          f"config 4: {iters} mixed CG iterations within {REF_ITERS_C4} +- "
          f"1, true relres {true:.3e} <= 1e-8")
    res = []
    d4.solve(b4, tol=1e-5, maxiter=100, accel="cg", residuals=res)
    check(abs(len(res) - 1 - REF_ITERS_C4_1E5) <= 1,
          f"config 4 native float32 CG to 1e-5: {len(res) - 1} iterations "
          f"(JAX on the CPU {REF_ITERS_C4_1E5} +- 1)")
    h4 = d4.hierarchy
    r0 = torch.as_tensor(rng.random(h4.levels[0].n_pad), dtype=f32,
                         device=dev)
    sync_free_cycle(check, DeviceMultilevelSolver(h4).cycle_operator("V"),
                    r0, "the config 4 block hierarchy (128^2)")
    profile_phase("config 4 128^2", (
        ("block mixed CG to 1e-8", lambda: d4.solve(b4, **mixed)),))

    # the block operations on the card against scipy (f64) and the CPU
    # (f32), on the operator as the host-built compile lays it out
    x4 = rng.standard_normal(n4)
    T64 = block_dia_from_scipy(A4, dtype=f64, device=dev)
    xt = torch.as_tensor(x4, dtype=f64, device=dev)
    for what, got, want in (
            ("A x", T64 @ xt, A4 @ x4), ("A^T x", T64.rmatvec(xt),
                                         A4.T @ x4)):
        err = float(np.abs(got.cpu().numpy() - want).max()
                    / np.abs(want).max())
        check(err <= 1e-13, f"BlockDIAMatrix {what} float64 on the card vs "
              f"scipy BSR: max rel err {err:.2e} (tol 1e-13)")
    T32 = block_dia_from_scipy(A4, dtype=f32, device=dev)
    Tc = block_dia_from_scipy(A4, dtype=f32, device="cpu")
    x32 = torch.as_tensor(x4, dtype=f32)
    X32 = torch.as_tensor(rng.standard_normal((4, n4)), dtype=f32)
    Dinv = _device_block_dinv(A4, 2, T32.nb_pad, f32, dev)
    colors, ncolors = _block_colors_for(A4, 2, T32.nb_pad, dev)
    b32 = torch.as_tensor(rng.standard_normal(n4), dtype=f32)
    bj = rel.block_jacobi(Dinv, 0.6, iterations=2)
    gs = rel.block_multicolor_gs(Dinv, colors, ncolors, sweep="symmetric")
    bj_c = rel.block_jacobi(Dinv.cpu(), 0.6, iterations=2)
    gs_c = rel.block_multicolor_gs(Dinv.cpu(), colors.cpu(), ncolors,
                                   sweep="symmetric")
    for what, got, want in (
            ("A x", T32 @ x32.to(dev), Tc @ x32),
            ("A X (K = 4)", T32 @ X32.to(dev), Tc @ X32),
            ("A^T x", T32.rmatvec(x32.to(dev)), Tc.rmatvec(x32)),
            ("block Jacobi, 2 sweeps", bj(T32, x32.to(dev), b32.to(dev)),
             bj_c(Tc, x32, b32)),
            (f"block multicolour GS ({ncolors} colours, symmetric)",
             gs(T32, x32.to(dev), b32.to(dev)), gs_c(Tc, x32, b32))):
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        check(err <= F32_REL_TOL, f"{what} float32 on the card vs the CPU: "
              f"max rel err {err:.2e} (tol {F32_REL_TOL:g})")
    del d4, h4

    # 1024^2: 2.1 M unknowns
    t0 = time.perf_counter()
    A8, B8 = linear_elasticity(C4_BIG)
    n8 = A8.shape[0]
    b8 = np.random.default_rng(3).random(n8)
    t_host = time.perf_counter() - t0
    kw8 = dict(kw4, grid=C4_BIG_NODE_GRID, B=B8)
    t0 = time.perf_counter()
    device_sa_setup_block(A8, **kw8)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    d8, counts, t_setup = counted(lambda: device_sa_setup_block(A8, **kw8))
    peak = torch.cuda.max_memory_allocated(dev)
    lv, nc = block_levels(d8)
    log(f"config 4 at {C4_BIG} (n={n8}; gallery {t_host:.1f} s on the "
        f"host): setup {t_setup:.4f} s (first call {t_first:.3f} s), peak "
        f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the "
        f"{base / 2**30:.2f} held before; {card}); levels {lv} + dense {nc}")
    check([n for n, _, _ in lv] == C4_BIG_LEVELS and nc == C4_COARSE,
          f"config 4 1024^2 levels {[n for n, _, _ in lv]} + dense {nc} "
          f"(the plan's {C4_BIG_LEVELS} + {C4_COARSE})")
    d8.solve(b8, **mixed)                           # warm-up
    walls = []
    res = []
    path = "config 4 1024^2 block mixed CG"
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    x, counts, _ = counted_no_twin(
        check, path, lambda: d8.solve(b8, residuals=res, **mixed))
    peak = torch.cuda.max_memory_allocated(dev)
    launches[path] = counts
    for _ in range(3):
        t0 = time.perf_counter()
        x2 = d8.solve(b8, **mixed)
        walls.append(time.perf_counter() - t0)
    normb = float(np.linalg.norm(b8))
    true = float(np.linalg.norm(b8 - A8 @ x)) / normb
    iters = len(res) - 1
    log(f"config 4 1024^2 mixed CG to 1e-8: {iters} iterations, history "
        f"relres {res[-1] / normb:.4e}, true relres {true:.4e}, solve walls "
        f"{', '.join(f'{t:.4f}' for t in walls)} s (median "
        f"{float(np.median(walls)):.4f}); solve peak {peak / 2**30:.2f} GiB "
        f"({(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} "
        f"held; {card})")
    log(f"  launches of hand-written kernels: "
        f"{json.dumps(counts, sort_keys=True)}")
    path_launches(check, path, counts)
    check(abs(iters - REF_ITERS_C4_BIG) <= 1 and true <= 1e-8
          and res[-1] <= 1e-8 * normb and bool(np.isfinite(x).all()),
          f"config 4 1024^2: {iters} mixed CG iterations within "
          f"{REF_ITERS_C4_BIG} +- 1, true relres {true:.3e} <= 1e-8")
    check(np.array_equal(x, x2), "config 4 1024^2: two solves give the "
          "same bits")
    profile_phase("config 4 1024^2", (
        ("block setup", lambda: device_sa_setup_block(A8, **kw8)),
        ("block mixed CG to 1e-8", lambda: d8.solve(b8, **mixed))))

    # the block-DIA kernels at the 1024^2 levels' shapes: level 0 (bs 2,
    # float32, K = 4, the 4-colour parity colouring of the padded node
    # grid: a valid colouring of the 9-point node stencil), A64
    # (float64), level 1 (bs 3)
    lvl = d8.hierarchy.levels[0]
    A0 = lvl.A
    Dinv0, omega0 = lvl.pre.arrays
    gy, gx = lvl.P.fine_grid_p
    node = torch.arange(A0.nb_pad, device=dev)
    parity = ((node // gx) % 2 * 2 + node % gx % 2).to(torch.int32)
    csr = bdia_to_csr(A0, dev)
    log(f"  block-DIA kernels at 1024^2 (torch.mv on the same operator as "
        f"CSR, {csr._nnz()} entries, the library yardstick; {card}):")
    block_level_checks(check, "1024^2 level0", A0, Dinv0, omega0, rand,
                       results, path, csr=csr, lanes=4, colors=parity,
                       ncolors=4)
    del csr
    A64 = d8.hierarchy.A64
    csr64 = bdia_to_csr(A64, dev)
    block_level_checks(check, "1024^2 level0 A64", A64, Dinv0.double(),
                       omega0.double(), rand, results, path, csr=csr64)
    del csr64
    lvl1 = d8.hierarchy.levels[1]
    Dinv1, omega1 = lvl1.pre.arrays
    block_level_checks(check, "1024^2 level1", lvl1.A, Dinv1, omega1, rand,
                       results, path, csr=bdia_to_csr(lvl1.A, dev))
    del d8, A0, lvl, lvl1, A64

    # adaptive SA on Poisson 512^2
    A2 = poisson(ADAPT_GRID, format="csr")
    b2 = np.random.default_rng(0).random(A2.shape[0])
    dad, t_setup, t_first = timed_setup(device_adaptive_sa_setup, A2, dict(
        grid=ADAPT_GRID, stages=2, max_coarse=400, device=dev))
    lv, nc = block_levels(dad)
    res = []
    path = "adaptive SA CG"
    _, counts, wall = counted_no_twin(
        check, path, lambda: dad.solve(b2, tol=1e-5, maxiter=100,
                                       accel="cg", residuals=res))
    launches[path] = counts
    path_launches(check, path, counts)
    log(f"adaptive SA stages=2, Poisson {ADAPT_GRID}: setup {t_setup:.4f} s "
        f"(first call {t_first:.3f} s), m={dad.setup_info['m']}, levels "
        f"{lv} + dense {nc}; native CG to 1e-5 {len(res) - 1} iterations in "
        f"{wall:.4f} s ({card})")
    check(lv == ADAPT_LEVELS and nc == ADAPT_COARSE
          and dad.setup_info["m"] == 2,
          f"adaptive SA levels {lv} + dense {nc} (the JAX package's "
          f"{ADAPT_LEVELS} + {ADAPT_COARSE})")
    check(abs(len(res) - 1 - REF_ITERS_ADAPT) <= 1,
          f"adaptive SA: {len(res) - 1} CG iterations to 1e-5 (JAX on the "
          f"CPU {REF_ITERS_ADAPT} +- 1)")
    # the block-DIA kernels at adaptive SA's level 0 (bs 1, nd 5)
    lvl = dad.hierarchy.levels[0]
    Dinv_a, omega_a = lvl.pre.arrays
    block_level_checks(check, "adaptive level0", lvl.A, Dinv_a, omega_a,
                       rand, results, path, csr=bdia_to_csr(lvl.A, dev))


def block_halo_checks(check, A, rand, results, tag, path, side, shards=4):
    """B1's halo mode on the block level A: the ring of one against its
    plain twin (the strip sum over [tail, x, head]) at the kernel
    tolerance, a second launch with the first one's bits, one launch a
    call, and bit for bit against B1 PLAIN (RESID too); then ``shards``
    in-process node-row blocks (halos copied on the side stream ``side``)
    against B1 bit for bit, and the interior alone, the halo copies alone
    and the overlapped total beside B1 on the whole operator, the plain
    twin, ``torch.mv`` on A as CSR and the bound."""
    import torch

    from pyamg_tpu_torch.parallel.dist_spmv import block_dia_halo_rows_ref
    from pyamg_tpu_torch.parallel.halo_spmv import (block_halo_plan,
                                                    block_halo_spmv,
                                                    block_halo_spmv_shards)
    from pyamg_tpu_torch.parallel.partition import SolverMesh
    from pyamg_tpu_torch.sparse import block_dia as bd

    one = SolverMesh(rank=0, world=1, device=A.device)
    dtype, n, nb = A.dtype, A.n_pad, A.nb_pad
    dt = str(dtype).removeprefix("torch.")
    halo = max(A.halo, 1)
    hw = halo * A.bs
    x, b = rand(n, dtype), rand(n, dtype)
    csr = bdia_to_csr(A, A.device)

    def ring():
        return block_halo_spmv(A.data, A.offsets, A.offsets_t, x, halo, one,
                               1)

    def plain():
        return block_dia_halo_rows_ref(A.data, A.offsets, x[n - hw:], x,
                                       x[:hw], halo, ((0, nb),),
                                       torch.empty_like(x))

    nbytes, ops = block_cost(A, 2)
    compare(check, f"block_dia_halo.{dt} [{tag} ring of one]", dtype, ring,
            plain, results, nbytes, ops,
            library_fn=lambda: torch.mv(csr, x), path=path,
            repeat_exact=True)
    k = launches_per_call(ring)
    results[-1]["launches_per_call"] = k
    plan = block_halo_plan(tuple(A.offsets), nb)
    b1, b1_r = bd.block_dia_apply(A, x), bd.block_dia_resid(A, x, b)
    ring_r = block_halo_spmv(A.data, A.offsets, A.offsets_t, x, halo, one,
                             1, b=b)
    torch.cuda.synchronize()
    check(torch.equal(ring(), b1) and torch.equal(ring_r, b1_r) and k == 1,
          f"block_dia_halo.{dt} [{tag}]: the ring of one ({plan.row_blocks} "
          f"row blocks of {plan.rows} nodes, interior [{plan.lo}, "
          f"{plan.hi})) equals B1 PLAIN and RESID bit for bit in {k} "
          f"launch(es) a call")
    split = block_halo_spmv_shards(A, x, shards, side)
    split_r = block_halo_spmv_shards(A, x, shards, side, b=b)
    torch.cuda.synchronize()
    check(torch.equal(split, b1) and torch.equal(split_r, b1_r),
          f"block_dia_halo.{dt} [{tag}]: {shards} in-process node-row "
          f"blocks (~{nb // shards} nodes each) equal B1 PLAIN and RESID "
          "bit for bit")
    t = {}
    for label, phases in (("interior", ("interior",)),
                          ("halo copies", ("halos",)),
                          ("overlapped", ("interior", "halos",
                                          "boundary"))):
        t[label] = min(time_ms(lambda: block_halo_spmv_shards(
            A, x, shards, side, phases=phases)) for _ in range(2))
    t_b1 = min(time_ms(lambda: bd.block_dia_apply(A, x)) for _ in range(2))
    t_plain = time_ms(lambda: bd.block_dia_spmv_ref(A, x))
    t_lib = time_ms(lambda: torch.mv(csr, x))
    log(f"  B1 halo mode, {shards} blocks in one process [{dt} {tag}]: "
        f"interior alone {t['interior']:.4f} ms, halo copies alone (side "
        f"stream, {2 * shards} copies) {t['halo copies']:.4f} ms, "
        f"overlapped total {t['overlapped']:.4f} ms; B1 on the whole "
        f"operator {t_b1:.4f} ms; plain {t_plain:.4f} ms; library "
        f"{t_lib:.4f} ms (torch.mv, CSR); bound "
        f"{nbytes / PEAK_BYTES * 1e3:.4f} ms (bytes)")


def remap_checks(check, label, what, solver, hs, rand, results, lanes=0):
    """K6 and K7 on the grid remap that the sharded level-0 transfers
    apply (``what``: the structured T, the embedding E or the block
    candidates' Q), at the block ``shard_hierarchy`` chose: P's last
    factor and R's first in the sharded hierarchy ``hs``, which must be
    one remap built once for the level (the transfers' shared
    ``remaps``, one entry); then, through ``windowed_kernel_checks``,
    each kernel against its twin (K7 twice, the same bits), its bound,
    ``torch.mv`` on the CSR, K6 equal to its per-row kernel and K7's
    column plan built with no host sync and equal to the CPU twin bit for
    bit; and each kernel's launches a call.  With ``lanes``, K12 and K13
    on a stack of that many lanes instead, as the sharded batched solve
    applies the remap (each against its twin with a repeat's bits, one
    launch a call, ``torch.sparse.mm`` on the CSR, K13 equal to the CPU
    twin bit for bit)."""
    import torch

    from pyamg_tpu_torch.sparse import window

    lv0, lvs = solver.hierarchy.levels[0], hs.levels[0]
    W, Wt = lvs.P.factors[-1].local, lvs.R.factors[0].local
    remaps = lv0.P.remaps
    check(remaps is lv0.R.remaps and len(remaps) == 1
          and W.block == Wt.block and W.block in remaps
          and all(torch.equal(getattr(W, f), getattr(Wt, f))
                  for f in ("data", "idx", "starts")),
          f"{label}: level 0's P and R shard one {what} (built once for "
          f"the level at block {W.block}; blocks kept {sorted(remaps)})")
    where = f"sharded {label.split('sharded ')[-1]}"
    if lanes:
        windowed_kernel_checks(check, where, (), ((f"level0 {what}", W),),
                               (f"level0 {what}",), W.dtype, rand, results,
                               label, lanes=lanes, vectors=False)
        return
    x, r = rand(W.m_chunks * W.w2, W.dtype), rand(W.n_pad, W.dtype)
    k6 = launches_per_call(lambda: window.windowed_matvec(W, x))
    k7 = launches_per_call(lambda: window.windowed_rmatvec(W, r))
    log(f"  {label} level0 {what}: {W.shape[0]}x{W.shape[1]}, k={W.k}, "
        f"block={W.block}, w2={W.w2}, {W.nnz} entries; K6 {k6} and K7 {k7} "
        f"device operation(s) a call")
    check(k6 == 1 and k7 == 1, f"{label} level0 {what}: K6 and K7 one "
          f"launch a call ({k6}, {k7})")
    windowed_kernel_checks(check, where, (), ((f"level0 {what}", W),), (),
                           W.dtype, rand, results, label)


def sharded_device_built_phase(check, dev, card, rand, results, launches,
                               dsa, A1, d2, A3):
    """Phase 20: the device-built hierarchies row-sharded in a world of one
    NCCL rank (file:// rendezvous), each solve against the unsharded solve
    of the same b in this run: the same iteration count, a true relres
    within 2x of the unsharded one, walls (numpy b and x, median of 3),
    the launches of the counted solve (zeroed just before, read just
    after).  Config 1 2048^2 (native f32 CG to 1e-5), config 2 64^3 (V-
    and W-cycle CG to 1e-5), config 3 RS 512^2 (CG to 1e-5, 13), config 5
    RS 1024^2 (native f32 FGMRES to 1e-5), AIR 256^2 structured and routed
    (the first stationary cycle's drop and FGMRES to 1e-6), config 4
    128^2 and 1024^2 (native CG to 1e-5); K16 at the device-built level-0
    S / S^T, the 64^3 S and config 5's P_emb / R_emb, and B1's halo mode
    at config 4's 1024^2 level 0, through ``compare``."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from pyamg_tpu_torch import (BlockStructuredDeviceSolver,
                                 DeviceMultilevelSolver,
                                 StructuredDeviceSolver, _build, advection_2d,
                                 device_air_setup, device_rs_setup,
                                 device_sa_setup_block, diffusion_stencil_2d,
                                 linear_elasticity, recirc_flow,
                                 stencil_grid)
    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh, shard_hierarchy)

    f32 = torch.float32

    def sharded_solver(solver, mesh):
        hs = shard_hierarchy(solver.hierarchy, mesh)
        if isinstance(solver, BlockStructuredDeviceSolver):
            return BlockStructuredDeviceSolver(
                hs, solver.grid, solver.grid_p, solver.bs, solver.setup_info)
        if isinstance(solver, StructuredDeviceSolver):
            return StructuredDeviceSolver(hs, solver.grid, solver.grid_p,
                                          solver.setup_info)
        assert type(solver) is DeviceMultilevelSolver, type(solver)
        return DeviceMultilevelSolver(hs)

    def c3():
        A = stencil_grid(diffusion_stencil_2d(epsilon=1e-3, theta=0.0,
                                              type="FD"), C3_GRID).tocsr()
        return A, device_rs_setup(A, grid=C3_GRID, dtype=f32, device=dev,
                                  max_coarse=400)

    def c5():
        A = recirc_flow(C5_GRID, epsilon=1e-2)
        return A, device_rs_setup(A, grid=C5_GRID, dtype=f32, device=dev,
                                  max_coarse=400)

    def air():
        A, b = advection_2d(AIR_GRID, theta=np.pi / 4)
        return A, device_air_setup(A, grid=AIR_GRID, device=dev,
                                   max_coarse=400), b

    def routed():
        A, b = advection_operator(UCL_AIR_NX)
        return A, device_air_setup(A, device=dev), b

    def c4(grid, node_grid):
        A, B = linear_elasticity(grid)
        return A, device_sa_setup_block(A, grid=node_grid, B=B,
                                        max_coarse=400, dtype=f32,
                                        device=dev)

    cg5 = dict(tol=1e-5, maxiter=100, accel="cg")
    fg = dict(tol=1e-6, maxiter=30, accel="fgmres")
    rng = np.random.default_rng(11)
    side = torch.cuda.Stream()
    cases = (
        ("sharded device-built config 1", lambda: (A1, dsa), cg5, None),
        ("sharded config 2 V-cycle", lambda: (A3, d2), cg5, None),
        ("sharded config 2 W-cycle", lambda: (A3, d2), dict(cg5, cycle="W"),
         None),
        ("sharded config 3 RS", c3, dict(cg5, maxiter=60), REF_ITERS_C3_RS),
        ("sharded config 5 RS", c5,
         dict(tol=1e-5, maxiter=150, accel="fgmres"), None),
        ("sharded structured AIR", air, fg, AIR_MIN_DROP),
        ("sharded routed AIR", routed, fg, UCL_AIR_MIN_DROP),
        ("sharded config 4 1024^2", lambda: c4(C4_BIG, C4_BIG_NODE_GRID),
         cg5, None),
        ("sharded config 4 128^2", lambda: c4(C4_GRID, C4_NODE_GRID), cg5,
         REF_ITERS_C4_1E5))
    with tempfile.TemporaryDirectory() as tmp:
        rank, world, _ = initialize_distributed(
            init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
            device=dev)
        try:
            mesh = make_solver_mesh(device=dev)
            log(f"sharded device-built solves: torch.distributed "
                f"{dist.get_backend()}, rank {rank} of {world}; {card}")
            for label, make, kw, ref in cases:
                t0 = time.perf_counter()
                made = make()
                M, solver = made[:2]
                b = made[2] if len(made) > 2 else rng.random(M.shape[0])
                torch.cuda.synchronize()
                t_setup = time.perf_counter() - t0
                t0 = time.perf_counter()
                sharded = sharded_solver(solver, mesh)
                torch.cuda.synchronize()
                t_shard = time.perf_counter() - t0
                res0 = []
                x0 = solver.solve(b, residuals=res0, **kw)
                sharded.solve(b, **kw)                 # warm-up
                torch.cuda.synchronize()
                _build.reset_launches()
                res1 = []
                x1 = sharded.solve(b, residuals=res1, **kw)
                torch.cuda.synchronize()
                counts = launches[label] = dict(_build.launches)
                times = {}
                for key, s in (("sharded", sharded), ("unsharded", solver)):
                    ts = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        s.solve(b, **kw)
                        ts.append(time.perf_counter() - t0)
                    times[key] = float(np.median(ts))
                normb = float(np.linalg.norm(b))
                true0, true1 = (float(np.linalg.norm(
                    b - M @ np.asarray(x, dtype=np.float64))) / normb
                    for x in (x0, x1))
                it0, it1 = len(res0) - 1, len(res1) - 1
                m = min(it0, it1) + 1
                hist_diff = float(np.max(np.abs(np.subtract(
                    res1[:m], res0[:m])) / np.asarray(res0[:m])))
                per_solve = sum(counts.values())
                halo = {k: c for k, c in counts.items()
                        if k.split(".")[0] in ("dia_halo_spmv",
                                               "block_dia_halo")}
                cyc = f", {kw['cycle']}-cycle" if "cycle" in kw else ""
                log(f"{label} (n={M.shape[0]}, {kw.get('accel')} to "
                    f"{kw['tol']:g}{cyc}): "
                    f"{it1} iterations (unsharded {it0}), true relres "
                    f"{true1:.3e} (unsharded {true0:.3e}), history vs "
                    f"unsharded max rel diff {hist_diff:.2e}; setup "
                    f"{t_setup:.3f} s, shard_hierarchy {t_shard:.3f} s; "
                    f"solve {times['sharded']:.4f} s sharded, "
                    f"{times['unsharded']:.4f} s unsharded (numpy b, median "
                    f"of 3); {per_solve} kernel launches a solve, K16 / B1 "
                    f"halo {json.dumps(halo, sort_keys=True)}")
                log(f"  launches in that solve: "
                    f"{json.dumps(counts, sort_keys=True)}")
                check(x1.shape == (M.shape[0],)
                      and bool(np.isfinite(x1).all())
                      and res1[-1] <= kw["tol"] * normb
                      and true1 <= 2 * true0,
                      f"{label}: finite, relres <= {kw['tol']:g}, true "
                      f"relres {true1:.3e} within 2x of the unsharded "
                      f"{true0:.3e}")
                check(it1 == it0, f"{label}: {it1} iterations, the "
                      f"unsharded solve's {it0}")
                check(hist_diff <= SHARDED_HIST_RTOL, f"{label}: history "
                      f"within rtol {SHARDED_HIST_RTOL:g} of the unsharded "
                      f"one ({hist_diff:.2e})")
                if label.endswith("AIR"):
                    drops = []
                    for s in (solver, sharded):
                        r = []
                        s.solve(b, tol=1e-12, maxiter=2, residuals=r)
                        drops.append(r[0] / r[1])
                    check(drops[1] >= ref, f"{label}: the first stationary "
                          f"cycle drops the residual {drops[1]:.4g}x "
                          f"(unsharded {drops[0]:.4g}x, bar {ref:g})")
                elif ref is not None:
                    check(it1 == ref, f"{label}: {it1} iterations, the "
                          f"unsharded phase's {ref}")
                path_launches(check, label, counts)
                # the kernels at this path's shapes
                lv0 = solver.hierarchy.levels[0]
                if label == "sharded device-built config 1":
                    for what, op in (("S^T", lv0.R.St), ("S", lv0.P.S)):
                        tag = (f"device level0 {what} nd={op.ndiags} "
                               f"n_pad={op.n_pad}")
                        ring = halo_ring_check(check, op, rand, results, tag,
                                               label)
                    halo_shards_check(check, lv0.P.S, *ring, tag, side)
                elif label == "sharded config 2 V-cycle":
                    op = lv0.P.S
                    halo_ring_check(check, op, rand, results,
                                    f"64^3 level0 S nd={op.ndiags} "
                                    f"n_pad={op.n_pad}", label)
                elif label == "sharded config 5 RS":
                    for what, op in (("P_emb", lv0.P.P_emb),
                                     ("R_emb", lv0.R.R_emb)):
                        halo_ring_check(check, op, rand, results,
                                        f"config5 level0 {what} "
                                        f"nd={op.ndiags} n_pad={op.n_pad}",
                                        label)
                elif label == "sharded config 4 1024^2":
                    A0 = lv0.A
                    block_halo_checks(check, A0, rand, results,
                                      f"config4 1024^2 level0 A bs={A0.bs} "
                                      f"nd={A0.ndiags} nb={A0.nb_pad}",
                                      label, side)
                if label in REMAPS:
                    remap_checks(check, label, REMAPS[label], solver,
                                 sharded.hierarchy, rand, results)
                del made, M, solver, sharded
        finally:
            dist.destroy_process_group()


def sharded_arrays(h):
    """name -> this rank's block of each array of a sharded structured or
    block hierarchy: every level's A and every factor of its P and R (a
    DIA or block-DIA factor's diagonals; a grid remap's rows, with w2,
    chunk count, nnz, block, shape and groups), the smoothers' arrays,
    the dense coarsest level, the coarse inverse."""
    import torch

    out = {}
    for i, lvl in enumerate(h.levels):
        out[f"L{i}.A"] = lvl.A.factors[0].data
        if lvl.P is not None:
            for tag, f in zip(("P0", "P1", "R0", "R1"),
                              lvl.P.factors + lvl.R.factors):
                W = getattr(f, "local", None)
                if W is None:
                    out[f"L{i}.{tag}"] = f.data
                    continue
                out.update({f"L{i}.{tag}.data": W.data,
                            f"L{i}.{tag}.idx": W.idx,
                            f"L{i}.{tag}.starts": W.starts,
                            f"L{i}.{tag}.meta": torch.tensor(
                                [W.w2, W.m_chunks, W.nnz, W.block,
                                 *W.shape, f.groups])})
        for side in ("pre", "post"):
            for j, a in enumerate(getattr(lvl, side).arrays):
                out[f"L{i}.{side}{j}"] = a
    out["coarse_inv"] = h.coarse_inv
    return out


def timed_setups(label, whole, part, launches):
    """Warm calls of both setups, then whole, partitioned, partitioned,
    whole, each CUDA-synchronised, with the peak device memory each adds
    above the allocation at its start; the launch counters zeroed just
    before each partitioned call and read just after (the last kept
    under ``label``).  Returns (the last solvers by key, seconds by key,
    GiB by key, the partitioned setup's launches)."""
    import torch

    from pyamg_tpu_torch import _build

    dev = torch.device("cuda")
    made = {"whole": whole(), "partitioned": part()}       # warm
    times = {"whole": [], "partitioned": []}
    added = {}
    for key in ("whole", "partitioned", "partitioned", "whole"):
        made[key] = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        if key == "partitioned":
            _build.reset_launches()
        t0 = time.perf_counter()
        made[key] = (part if key == "partitioned" else whole)()
        torch.cuda.synchronize()
        times[key].append(time.perf_counter() - t0)
        if key == "partitioned":
            counts = launches[label] = dict(_build.launches)
        added[key] = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    return made, times, added, counts


def same_arrays(check, label, dp, dw):
    """Every array of the partitioned hierarchy ``dp`` the whole route's
    ``dw`` bit for bit (shape, dtype and values); returns the count."""
    import torch

    got, want = sharded_arrays(dp.hierarchy), sharded_arrays(dw.hierarchy)
    diff = [k for k in want if k not in got or not (
        got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        and torch.equal(got[k], want[k]))]
    differ = f" (differ: {', '.join(diff[:8])})" if diff else ""
    nlev = len(dp.hierarchy.levels)
    check(not diff and len(got) == len(want),
          f"{label}: {len(want)} arrays of {nlev} levels equal to the whole "
          f"route's (setup + shard_hierarchy) bit for bit{differ}")
    return len(want)


def partitioned_route(check, card, mesh, rand, results, launches, name, A,
                      make, solve_kw, ref_iters, side):
    """One partitioned route of phase 22 beside its whole route (the
    setup + ``shard_hierarchy``): ``make(mesh)`` builds the setup of the
    host operator ``A`` with ``mesh``, or whole with None; the setups
    timed and their peak
    memory (:func:`timed_setups`), the partitioned setup's launches,
    every array and every level's rho bit for bit, the kernel of its
    power iterations at its level-0 A through ``compare`` (K16, or B1's
    halo mode on a block level), and its sharded solve (a warm call, then
    the counted one) with the whole route's history bit for bit."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import (BlockStructuredDeviceSolver,
                                 StructuredDeviceSolver, _build)
    from pyamg_tpu_torch.parallel import shard_hierarchy
    from pyamg_tpu_torch.sparse import BlockDIAMatrix, DIAMatrix

    label, solve_label = (f"partitioned setup {name}",
                          f"partitioned sharded {name}")

    def whole():
        ds = make(None)
        hs = shard_hierarchy(ds.hierarchy, mesh)
        if isinstance(ds, BlockStructuredDeviceSolver):
            return BlockStructuredDeviceSolver(hs, ds.grid, ds.grid_p, ds.bs,
                                               ds.setup_info)
        return StructuredDeviceSolver(hs, ds.grid, ds.grid_p, ds.setup_info)

    made, times, added, counts = timed_setups(label, whole,
                                              lambda: make(mesh), launches)
    dw, dp = made["whole"], made["partitioned"]
    hp = dp.hierarchy
    log(f"{label}: {len(hp.levels)} levels on groups {hp.groups}, n_pads "
        f"{hp.n_pads}; {card}")
    for key in ("whole", "partitioned"):
        log(f"  {key} setup{' + shard_hierarchy' * (key == 'whole')}: "
            f"{min(times[key]):.4f} s (second calls "
            f"{', '.join(f'{t:.4f}' for t in times[key])} s, "
            f"CUDA-synchronised, host CSR -> device included); peak device "
            f"memory {added[key]:.3f} GiB above the allocation at its "
            f"start; {card}")
    log(f"  launches in the partitioned setup: "
        f"{json.dumps(counts, sort_keys=True)}")
    same_arrays(check, label, dp, dw)
    rk = "rho" if "rho" in dp.setup_info["levels"][0] else "rho_D_inv_A"
    rho = [(float(a[rk]), float(b[rk])) for a, b in zip(
        dp.setup_info["levels"], dw.setup_info["levels"])]
    check(all(a == b for a, b in rho), f"{label}: rho of every level the "
          f"whole route's ({rho})")
    path_launches(check, label, counts)
    f0, lv0 = hp.levels[0].A.factors[0], hp.levels[0].A
    if isinstance(dp, BlockStructuredDeviceSolver):
        A0 = BlockDIAMatrix(data=f0.data, offsets=f0.offsets, shape=lv0.shape,
                            bs=dp.bs, nnz=lv0.nnz)
        block_halo_checks(check, A0, rand, results,
                          f"partitioned {name} level0 A bs={A0.bs} "
                          f"nd={A0.ndiags} nb={A0.nb_pad}", label, side)
    else:
        A0 = DIAMatrix(data=f0.data, offsets=f0.offsets, shape=lv0.shape,
                       nnz=lv0.nnz)
        halo_ring_check(check, A0, rand, results,
                        f"partitioned {name} level0 A nd={A0.ndiags} "
                        f"n_pad={A0.n_pad}", label)
    b = np.random.default_rng(0).random(A.shape[0])
    dp.solve(b, **solve_kw)                                # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    res = []
    t0 = time.perf_counter()
    x = dp.solve(b, residuals=res, **solve_kw)
    t_solve = time.perf_counter() - t0
    counts_solve = launches[solve_label] = dict(_build.launches)
    res_w = []
    dw.solve(b, residuals=res_w, **solve_kw)
    relres = float(np.linalg.norm(b - A @ np.asarray(x, dtype=np.float64))
                   / np.linalg.norm(b))
    its = len(res) - 1
    log(f"  {solve_label}: {solve_kw['accel']} to {solve_kw['tol']:g} in "
        f"{its} iterations (whole route {len(res_w) - 1}; true relres "
        f"{relres:.3e}), {t_solve:.4f} s (numpy b), "
        f"{sum(counts_solve.values())} launches")
    check((ref_iters is None or its == ref_iters)
          and bool(np.isfinite(x).all())
          and res[-1] <= solve_kw["tol"] * res[0],
          f"{solve_label}: {its} iterations to {solve_kw['tol']:g}"
          f"{'' if ref_iters is None else f' (want {ref_iters})'}, finite")
    check(res == res_w, f"{solve_label}: the whole route's sharded history "
          f"bit for bit")
    path_launches(check, solve_label, counts_solve)


def partitioned_setup_phase(check, dev, card, rand, results, launches, A1):
    """Phase 22: the partitioned device setups in a world of one NCCL rank,
    float32, full width: the SA setup (``device_sa_setup(..., mesh=mesh)``)
    at config 1's 2048^2, the RS setup (``device_rs_setup(...,
    mesh=mesh)``) at config 3's 512^2 (``stride="auto"``) and config 5's
    1024^2, and the block setup (``device_sa_setup_block(...,
    mesh=mesh)``) at config 4's 1024^2.  Every large level is a ring of
    one (its slab the whole level, its halos the slab's tail and head; K16
    gives K1's bits, B1's halo mode B1's), so each setup must give the
    whole route's bits: the setup + shard_hierarchy, array for array.
    Each pair timed (warm calls, then whole, partitioned, partitioned,
    whole, each CUDA-synchronised) with the peak device memory each adds;
    the partitioned setup's launches (counters zeroed just before, read
    just after: K16, or B1's halo mode, in its power iterations); that
    kernel at its level-0 A through ``compare``; the sharded solve with the
    whole route's history bit for bit (config 1 CG to 1e-5 in 13
    iterations, config 3 CG to 1e-5 in 13, config 5 FGMRES to 1e-5 as
    phase 20 runs it, config 4 CG to 1e-5 in 18)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from pyamg_tpu_torch import (StructuredDeviceSolver, _build,
                                 device_rs_setup, device_sa_setup,
                                 device_sa_setup_block, diffusion_stencil_2d,
                                 linear_elasticity, recirc_flow,
                                 stencil_grid)
    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh, shard_hierarchy)
    from pyamg_tpu_torch.sparse import DIAMatrix

    f32 = torch.float32
    label, solve_label = ("partitioned setup config 1",
                          "partitioned sharded config 1")
    with tempfile.TemporaryDirectory() as tmp:
        rank, world, _ = initialize_distributed(
            init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
            device=dev)
        try:
            mesh = make_solver_mesh(device=dev)
            kw = dict(grid=GRID, dtype=f32, device=dev, max_coarse=400)

            def whole():
                ds = device_sa_setup(A1, **kw)
                return StructuredDeviceSolver(
                    shard_hierarchy(ds.hierarchy, mesh), ds.grid, ds.grid_p,
                    ds.setup_info)

            def part():
                return device_sa_setup(A1, mesh=mesh, **kw)

            made, times, added, counts = timed_setups(label, whole, part,
                                                      launches)
            dw, dp = made["whole"], made["partitioned"]
            hp = dp.hierarchy
            log(f"partitioned setup: torch.distributed {dist.get_backend()},"
                f" rank {rank} of {world}; {card}; {len(hp.levels)} levels "
                f"on groups {hp.groups}, n_pads {hp.n_pads}")
            for key in ("whole", "partitioned"):
                log(f"  {key} setup{' + shard_hierarchy' * (key == 'whole')}"
                    f": {min(times[key]):.4f} s (second calls "
                    f"{', '.join(f'{t:.4f}' for t in times[key])} s, "
                    f"CUDA-synchronised, host CSR -> device included); peak "
                    f"device memory {added[key]:.3f} GiB above the "
                    f"allocation at its start; {card}")
            log(f"  launches in the partitioned setup: "
                f"{json.dumps(counts, sort_keys=True)}")
            same_arrays(check, label, dp, dw)
            rho = [(float(a["rho_D_inv_A"]), float(b["rho_D_inv_A"]))
                   for a, b in zip(dp.setup_info["levels"],
                                   dw.setup_info["levels"])]
            check(all(a == b for a, b in rho), f"{label}: rho(D^-1 A) of "
                  f"every level the whole route's ({rho})")
            path_launches(check, label, counts)
            A0 = hp.levels[0].A.factors[0]
            A_dia = DIAMatrix(data=A0.data, offsets=A0.offsets,
                              shape=hp.levels[0].A.shape,
                              nnz=hp.levels[0].A.nnz)
            halo_ring_check(check, A_dia, rand, results,
                            f"partitioned setup level0 A nd={A_dia.ndiags} "
                            f"n_pad={A_dia.n_pad}", label)
            b = np.random.default_rng(0).random(A1.shape[0])
            cg = dict(tol=1e-5, maxiter=100, accel="cg")
            dp.solve(b, **cg)                                  # warm-up
            torch.cuda.synchronize()
            _build.reset_launches()
            res = []
            t0 = time.perf_counter()
            x = dp.solve(b, residuals=res, **cg)
            t_solve = time.perf_counter() - t0
            counts_solve = launches[solve_label] = dict(_build.launches)
            res_w = []
            dw.solve(b, residuals=res_w, **cg)
            relres = float(np.linalg.norm(
                b - A1 @ np.asarray(x, dtype=np.float64))
                / np.linalg.norm(b))
            log(f"  {solve_label}: CG to 1e-5 in {len(res) - 1} iterations "
                f"(true relres {relres:.3e}), {t_solve:.4f} s (numpy b), "
                f"{sum(counts_solve.values())} launches")
            check(len(res) - 1 == REF_ITERS_PARTITIONED
                  and bool(np.isfinite(x).all())
                  and res[-1] <= 1e-5 * res[0],
                  f"{solve_label}: {len(res) - 1} iterations to 1e-5 (phase "
                  f"20's {REF_ITERS_PARTITIONED}), finite")
            check(res == res_w, f"{solve_label}: the whole route's sharded "
                  f"history bit for bit")
            path_launches(check, solve_label, counts_solve)
            del made, dw, dp, hp

            # the partitioned RS and block setups (each operator made once
            # on the host, outside the timed setups)
            def rs(A, grid):
                return A, lambda mesh_: device_rs_setup(
                    A, grid=grid, dtype=f32, device=dev, max_coarse=400,
                    mesh=mesh_)

            def c4():
                A, B = linear_elasticity(C4_BIG)
                return A, lambda mesh_: device_sa_setup_block(
                    A, grid=C4_BIG_NODE_GRID, B=B, max_coarse=400, dtype=f32,
                    device=dev, mesh=mesh_)

            side = torch.cuda.Stream()
            cg5 = dict(tol=1e-5, maxiter=100, accel="cg")
            for name, route, solve_kw, ref in (
                    ("config 3 RS", lambda: rs(stencil_grid(
                        diffusion_stencil_2d(epsilon=1e-3, theta=0.0,
                                             type="FD"), C3_GRID).tocsr(),
                        C3_GRID), dict(cg5, maxiter=60),
                     REF_ITERS_PARTITIONED_C3),
                    ("config 5 RS", lambda: rs(recirc_flow(
                        C5_GRID, epsilon=1e-2), C5_GRID),
                     dict(tol=1e-5, maxiter=150, accel="fgmres"), None),
                    ("config 4 1024^2", c4, cg5, REF_ITERS_PARTITIONED_C4)):
                t0 = time.perf_counter()
                A, make = route()
                partitioned_route(check, card, mesh, rand, results, launches,
                                  name, A, make, solve_kw, ref, side)
                log(f"  partitioned {name}: {time.perf_counter() - t0:.1f} s "
                    "in all")
        finally:
            dist.destroy_process_group()


def host_built_solve(check, label, solver, A, b, kw, ref_iters, launches,
                     card):
    """One host-built mixed solve on the card (after a warm one) with the
    counters zeroed just before and read just after, no block or sweep
    twin run on the card, every smoother call one launch of the path's
    sweep kernel and no launch of the colour-step kernel it replaced
    (``HOST_SWEEPS``); then three more for the median wall.  Returns (the
    sweep launches, the true relres)."""
    import numpy as np
    import torch

    solver.solve(b, **kw)                         # warm-up
    res = []
    x, counts, wall = counted_no_twin(
        check, label, lambda: solver.solve(b, residuals=res, **kw))
    launches[label] = counts
    sweep, step = HOST_SWEEPS[label]
    sweeps, steps = counts.get(sweep, 0), counts.get(step, 0)
    walls = [wall]
    for _ in range(3):
        t0 = time.perf_counter()
        solver.solve(b, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    normb = float(np.linalg.norm(b))
    iters = len(res) - 1
    hist = res[-1] / res[0]
    true = float(np.linalg.norm(b - A @ x)) / normb
    log(f"{label}: {iters} iterations, history relres {hist:.4e}, true "
        f"relres {true:.4e}, solve walls "
        f"{', '.join(f'{t:.4f}' for t in walls)} s (median of the last 3 "
        f"{float(np.median(walls[1:])):.4f} s; {card})")
    log(f"  history: {' '.join(f'{r / res[0]:.3e}' for r in res)}")
    log(f"  launches of hand-written kernels: "
        f"{json.dumps(counts, sort_keys=True)}; sweeps ({sweep}) {sweeps}, "
        f"colour steps ({step}) {steps}")
    check(sweeps > 0 and steps == 0,
          f"{label}: {sweeps} one-launch sweeps ({sweep}), {steps} colour "
          f"steps ({step}, none expected)")
    check(abs(iters - ref_iters) <= 1 and hist <= 1e-8
          and x.shape == b.shape and bool(np.isfinite(x).all()),
          f"{label}: {iters} iterations within {ref_iters} +- 1 (the "
          f"reference's), history relres {hist:.3e} <= 1e-8, x finite")
    path_launches(check, label, counts)
    return sweeps, true


def host_level_checks(check, where, lvl, rand, results, path):
    """K1 on a DIA level's A, K2 with its first colour's inverse diagonal
    (the parent's multicolour step), S1 (the smoother's sweep in one
    launch) against the chain of those steps, and K6 / K7 on its windowed
    P and R = P^T, each against its twin at the path's shapes."""
    import torch

    from pyamg_tpu_torch.sparse import DIAMatrix, dia

    A = lvl.A
    assert isinstance(A, DIAMatrix)
    f32 = torch.float32
    x, b = rand(A.n_pad, f32), rand(A.n_pad, f32)
    tag = f"{where} nd={A.ndiags} n_pad={A.n_pad}"
    A_csr = dia_to_csr(A)
    compare(check, f"dia_spmv.float32 [{tag}]", f32,
            lambda: dia.dia_spmv(A, x), lambda: dia.dia_spmv_ref(A, x),
            results, *dia_cost(A, 2), path=path,
            library_fn=lambda: torch.mv(A_csr, x))
    if lvl.pre.config[0] == "mcgs":
        ncolors = lvl.pre.config[1]
        dinv0 = lvl.pre.color_dinv[0]
        compare(check, f"dia_jacobi.float32 [{tag}, colour 0 of {ncolors}]",
                f32, lambda: dia.dia_jacobi(A, x, b, dinv0, 1.0),
                lambda: dia.dia_jacobi_ref(A, x, b, dinv0, 1.0), results,
                *dia_cost(A, 4, extra_ops=4), path=path)
        scalar_sweep_checks(check, where, A, lvl.pre, rand, results, path)
    transfer_checks(check, where, lvl, rand, results, path)


def transfer_checks(check, where, lvl, rand, results, path):
    """K6 / K7 on a level's windowed P (R = P^T shares its arrays) by
    ``windowed_kernel_checks``."""
    import torch

    from pyamg_tpu_torch.sparse import WindowedELL

    P = lvl.P
    ok = isinstance(P, WindowedELL) and getattr(lvl.R, "base", None) is P
    check(ok, f"{where}: P a WindowedELL and R its transpose (P "
          f"{type(P).__name__}, R {type(lvl.R).__name__})")
    if ok:
        windowed_kernel_checks(check, where, (), [("P", P)], (),
                               torch.float32, rand, results, path)


def host_setup_phase(check, dev, card, rand, results, launches):
    """Phase 23: the host-built columns of configs 3 and 4 on the card.
    The port's own ruge_stuben_solver on config 3's 512^2 stencil and
    rootnode_solver on config 4's 128^2 elasticity (host seconds, the
    reference's level sizes), compile_hierarchy f32 with the f64 A64 and
    cut at 1024 rows (each level's forms and smoother), mixed GMRES / CG
    to 1e-8 at the reference's counts with the launches of every kernel
    (one sweep launch a smoother call: S1 on config 3's DIA levels, B3 on
    config 4's block levels), and each of those kernels against its twin
    at the paths' shapes, the sweeps bit for bit against the parent's
    colour-step chains, both barrier routes timed at config 3's
    multicolour levels."""
    import numpy as np
    import torch

    from pyamg_tpu_torch import (DeviceMultilevelSolver, compile_hierarchy,
                                 diffusion_stencil_2d, linear_elasticity,
                                 rootnode_solver, ruge_stuben_solver,
                                 stencil_grid)
    from pyamg_tpu_torch.sparse import BlockDIAMatrix, DIAMatrix, dia

    f32, f64 = torch.float32, torch.float64
    parts, last = {}, [time.perf_counter()]

    def lap(part):
        """Adds the seconds since the last lap to ``parts[part]``."""
        now = time.perf_counter()
        parts[part] = parts.get(part, 0.0) + now - last[0]
        last[0] = now

    def setup_and_compile(label, build, want_sizes):
        t0 = time.perf_counter()
        ml = build()
        t_setup = time.perf_counter() - t0
        sizes = [lvl.A.shape[0] for lvl in ml.levels]
        t0 = time.perf_counter()
        h = compile_hierarchy(ml, f32, device=dev, mixed_precision=True,
                              coarse_cutoff=COARSE_CUTOFF)
        torch.cuda.synchronize()
        t_compile = time.perf_counter() - t0
        log(f"{label}: the port's host setup {t_setup:.3f} s, levels "
            f"{sizes}; compile to the card {t_compile:.3f} s, "
            f"{len(h.levels)} device levels")
        for i, lvl in enumerate(h.levels):
            log(f"  level {i}: n={lvl.n} n_pad={lvl.n_pad} {forms(lvl)}; "
                f"smoother {lvl.pre.config[:2]}")
        check(sizes == want_sizes, f"{label}: levels {sizes} (the "
              f"reference's {want_sizes})")
        return ml, h

    # config 3: Ruge-Stuben, the reference's defaults, mixed GMRES
    A3 = stencil_grid(diffusion_stencil_2d(epsilon=1e-3, theta=0.0,
                                           type="FD"), C3_GRID).tocsr()
    b3 = np.random.default_rng(2).random(A3.shape[0])
    _, h3 = setup_and_compile("config 3 host-built RS 512^2",
                              lambda: ruge_stuben_solver(A3), C3_HOST_LEVELS)
    big = h3.levels[:-1]
    check(len(big) == 7 and all(
        isinstance(lvl.A, DIAMatrix) and lvl.pre.config[0] == "mcgs"
        for lvl in big),
        f"config 3 host-built: levels 0-6 DIA with multicolour GS, as the "
        f"reference's compile gives at 512^2: "
        f"{[lvl.pre.config[:2] for lvl in big]}")
    lap("setups and compiles")
    d3 = DeviceMultilevelSolver(h3)
    kw3 = dict(tol=1e-8, maxiter=60, accel="gmres", precision="mixed")
    path3 = "host-built config 3 mixed GMRES"
    sweeps3, true3 = host_built_solve(check, path3, d3, A3, b3, kw3,
                                      REF_ITERS_C3_HOST, launches, card)
    log(f"  config 3 mixed GMRES is left preconditioned: its true relres "
        f"{true3:.3e} is printed, not held to 1e-8 (reference history "
        f"relres 7.27e-9)")
    lap("solves")
    log("config 3 host-built kernels (kernel vs plain twin):")
    for i in (0, 1):
        host_level_checks(check, f"host-built config3 level{i}",
                          h3.levels[i], rand, results, path3)
    sweep_route_times("config 3 host-built", h3)
    x, A64 = rand(h3.A64.n_pad, f64), h3.A64
    A64_csr = dia_to_csr(A64)
    compare(check, f"dia_spmv.float64 [host-built config3 A64 "
            f"nd={A64.ndiags} n_pad={A64.n_pad}]", f64,
            lambda: dia.dia_spmv(A64, x), lambda: dia.dia_spmv_ref(A64, x),
            results, *dia_cost(A64, 2), path=path3,
            library_fn=lambda: torch.mv(A64_csr, x))

    lap("kernel checks")

    # config 4: rootnode, 2x2 blocks, mixed CG
    A4, B4 = linear_elasticity(C4_GRID)
    b4 = np.random.default_rng(3).random(A4.shape[0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # B truncated to 2 columns
        _, h4 = setup_and_compile(
            "config 4 host-built rootnode 128^2",
            lambda: rootnode_solver(A4, B=B4, strength="symmetric"),
            C4_HOST_LEVELS)
    blocks = h4.levels[:2]
    check(len(h4.levels) == 3 and all(
        isinstance(lvl.A, BlockDIAMatrix) and lvl.pre.config[0]
        == "block_mcgs" for lvl in blocks),
        f"config 4 host-built: levels 0 and 1 BlockDIAMatrix with block "
        f"multicolour GS ({[lvl.pre.config[:2] for lvl in blocks]})")
    lap("setups and compiles")
    d4 = DeviceMultilevelSolver(h4)
    kw4 = dict(tol=1e-8, maxiter=60, accel="cg", precision="mixed")
    path4 = "host-built config 4 mixed CG"
    sweeps4, true4 = host_built_solve(check, path4, d4, A4, b4, kw4,
                                      REF_ITERS_C4_HOST, launches, card)
    check(true4 <= 1e-8, f"{path4}: true relres {true4:.3e} <= 1e-8 "
          f"(reference history 4.64e-9)")
    log(f"  one-launch sweeps: config 3 {sweeps3} (S1), config 4 {sweeps4} "
        f"(B3)")
    lap("solves")
    log("config 4 host-built kernels (kernel vs plain twin):")
    for i, lvl in enumerate(blocks):
        if not isinstance(lvl.A, BlockDIAMatrix):
            continue
        Dinv, colors = lvl.pre.arrays
        block_level_checks(check, f"host-built config4 level{i}", lvl.A,
                           Dinv, None, rand, results, path4,
                           csr=bdia_to_csr(lvl.A, dev), colors=colors,
                           ncolors=lvl.pre.config[1], jacobi=False)
        transfer_checks(check, f"host-built config4 level{i}", lvl, rand,
                        results, path4)
    x, A64 = rand(h4.A64.n_pad, f64), h4.A64
    A64_csr = dia_to_csr(A64)
    compare(check, f"dia_spmv.float64 [host-built config4 A64 "
            f"nd={A64.ndiags} n_pad={A64.n_pad}]", f64,
            lambda: dia.dia_spmv(A64, x), lambda: dia.dia_spmv_ref(A64, x),
            results, *dia_cost(A64, 2), path=path4,
            library_fn=lambda: torch.mv(A64_csr, x))
    lap("kernel checks")
    profile_phase("host-built configs 3 and 4", (
        ("config 3 RS 512^2 mixed GMRES to 1e-8",
         lambda: d3.solve(b3, **kw3)),
        ("config 4 rootnode 128^2 mixed CG to 1e-8",
         lambda: d4.solve(b4, **kw4))))
    lap("profile")
    log("  phase 23 seconds: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in parts.items()))


def halo_lane_checks(check, A, rand, results, tag, path, side, shards=4):
    """K16's lane mode on the DIA operator A at K = LANES: the ring of one
    against its plain twin (the rolled sum over every lane's [tail, x,
    head]) at the kernel tolerance, a second launch with the first one's
    bits, one launch a call, bit for bit against K8 (``dia_spmm``) with
    K8's own time beside it; then ``shards`` in-process row blocks (each
    block's columns of the stack, (K, halo) halos copied on the side
    stream) against K8 bit for bit, and the interior alone, the halo
    copies alone and the overlapped total.  Library: ``torch.sparse.mm``
    of A as CSR against the (n, K) columns."""
    import torch

    from pyamg_tpu_torch.parallel import halo_width
    from pyamg_tpu_torch.parallel.dist_spmv import dia_halo_rows_ref
    from pyamg_tpu_torch.parallel.halo_spmv import (halo_plan, halo_spmv,
                                                    halo_spmv_shards)
    from pyamg_tpu_torch.parallel.partition import SolverMesh
    from pyamg_tpu_torch.sparse import dia

    one = SolverMesh(rank=0, world=1, device=A.device)
    dtype, n, halo = A.dtype, A.n_pad, halo_width(A)
    dt = str(dtype).removeprefix("torch.")
    X = rand((LANES, n), dtype)
    Xcols = X.T.contiguous()
    A_csr = dia_to_csr(A)

    def ring():
        return halo_spmv(A.data, A.offsets, A.offsets_t, X, halo, one, 1)

    def plain():
        return dia_halo_rows_ref(A.data, A.offsets, X[:, n - halo:], X,
                                 X[:, :halo], halo, ((0, n),),
                                 torch.empty_like(X))

    nbytes, ops = dia_cost(A, 0, LANES, 2)
    name = f"dia_halo_spmm.{dt} [{tag} K={LANES} ring of one]"
    compare(check, name, dtype, ring, plain, results, nbytes, ops,
            library_fn=lambda: torch.sparse.mm(A_csr, Xcols), path=path,
            repeat_exact=True)
    row = results[-1]
    k = row["launches_per_call"] = launches_per_call(ring)
    k8 = dia.dia_spmm(A, X)
    row["k8_ms"] = min(time_ms(lambda: dia.dia_spmm(A, X)) for _ in range(2))
    plan = halo_plan(tuple(A.offsets), n, dtype)
    torch.cuda.synchronize()
    check(torch.equal(ring(), k8) and k == 1,
          f"dia_halo_spmm.{dt} [{tag}]: the lane mode's ring of one "
          f"({plan.row_blocks} row blocks of {plan.rows} rows x {LANES} "
          f"lanes) equals K8 (dia_spmm) bit for bit in {k} launch(es) a "
          f"call; K16 lanes {row['ms']:.4f} ms, K8 {row['k8_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms")
    split = halo_spmv_shards(A, X, shards, side)
    torch.cuda.synchronize()
    check(torch.equal(split, k8),
          f"dia_halo_spmm.{dt} [{tag}]: {shards} in-process row blocks of "
          f"the K={LANES} stack equal K8 bit for bit")
    t = {}
    for label, phases in (("interior", ("interior",)),
                          ("halo copies", ("halos",)),
                          ("overlapped", ("interior", "halos",
                                          "boundary"))):
        t[label] = min(time_ms(lambda: halo_spmv_shards(
            A, X, shards, side, phases=phases)) for _ in range(2))
    log(f"  K16 lanes, {shards} blocks in one process [{dt} {tag} "
        f"K={LANES}]: interior alone {t['interior']:.4f} ms, halo copies "
        f"alone ({2 * shards} (K, halo) copies) {t['halo copies']:.4f} ms, "
        f"overlapped total {t['overlapped']:.4f} ms; K8 on the whole "
        f"operator {row['k8_ms']:.4f} ms")


def block_halo_lane_checks(check, A, rand, results, tag, path, side,
                           shards=4):
    """B1's halo mode on K = LANES lanes of the block level A: the ring of
    one against its plain twin at the kernel tolerance, two launches with
    the same bits, launches a call, and PLAIN and RESID bit for bit
    against B1 on the lanes (``block_dia_apply``, B1's own time beside
    it); ``shards`` in-process node-row blocks of the stack against B1
    bit for bit; ``RESID`` on the ring of one timed too.  Library:
    ``torch.sparse.mm`` (``torch.addmm`` for RESID) of A as CSR against
    the (n, K) columns."""
    import torch

    from pyamg_tpu_torch.parallel.dist_spmv import block_dia_halo_rows_ref
    from pyamg_tpu_torch.parallel.halo_spmv import (block_halo_spmv,
                                                    block_halo_spmv_shards)
    from pyamg_tpu_torch.parallel.partition import SolverMesh
    from pyamg_tpu_torch.sparse import block_dia as bd

    one = SolverMesh(rank=0, world=1, device=A.device)
    dtype, n, nb = A.dtype, A.n_pad, A.nb_pad
    dt = str(dtype).removeprefix("torch.")
    halo = max(A.halo, 1)
    hw = halo * A.bs
    X, Bv = rand((LANES, n), dtype), rand((LANES, n), dtype)
    Xcols, Bcols = X.T.contiguous(), Bv.T.contiguous()
    csr = bdia_to_csr(A, A.device)

    def ring():
        return block_halo_spmv(A.data, A.offsets, A.offsets_t, X, halo, one,
                               1)

    def plain():
        return block_dia_halo_rows_ref(A.data, A.offsets, X[:, n - hw:], X,
                                       X[:, :hw], halo, ((0, nb),),
                                       torch.empty_like(X))

    # the blocks once, every lane's x and y; 2 operations a block entry a
    # lane
    nbytes, ops = block_cost(A, 2 * LANES)
    compare(check, f"block_dia_halo_spmm.{dt} [{tag} K={LANES} ring of "
            "one]", dtype, ring, plain, results, nbytes, ops * LANES,
            library_fn=lambda: torch.sparse.mm(csr, Xcols), path=path,
            repeat_exact=True)
    row = results[-1]
    k = row["launches_per_call"] = launches_per_call(ring)
    b1, b1_r = bd.block_dia_apply(A, X), bd.block_dia_resid(A, X, Bv)
    row["b1_lanes_ms"] = min(time_ms(lambda: bd.block_dia_apply(A, X))
                             for _ in range(2))

    def ring_resid():
        return block_halo_spmv(A.data, A.offsets, A.offsets_t, X, halo, one,
                               1, b=Bv)

    # RESID: b read besides; one more operation a row
    compare(check, f"block_dia_halo_spmm.{dt} RESID [{tag} K={LANES} ring "
            "of one]", dtype, ring_resid,
            lambda: block_dia_halo_rows_ref(
                A.data, A.offsets, X[:, n - hw:], X, X[:, :hw], halo,
                ((0, nb),), torch.empty_like(X), Bv), results,
            block_cost(A, 3 * LANES)[0],
            LANES * block_cost(A, 0, extra_ops=1)[1],
            library_fn=lambda: torch.addmm(Bcols, csr, Xcols, alpha=-1.0),
            path=path, repeat_exact=True)
    results[-1]["launches_per_call"] = launches_per_call(ring_resid)
    ring_r = ring_resid()
    split = block_halo_spmv_shards(A, X, shards, side)
    split_r = block_halo_spmv_shards(A, X, shards, side, b=Bv)
    torch.cuda.synchronize()
    check(torch.equal(ring(), b1) and torch.equal(ring_r, b1_r) and k == 1
          and torch.equal(split, b1) and torch.equal(split_r, b1_r),
          f"block_dia_halo_spmm.{dt} [{tag}]: the ring of one and {shards} "
          f"in-process blocks of the K={LANES} stack equal B1's lanes "
          f"(PLAIN and RESID) bit for bit, {k} launch(es) a call; halo "
          f"lanes {row['ms']:.4f} ms, B1 lanes {row['b1_lanes_ms']:.4f} "
          f"ms, bound {row['bound_ms']:.4f} ms")


def block_lane_checks(check, A, Dinv, omega, colors, rand, results, tag,
                      path, zero_path):
    """B1 (PLAIN, RESID) and B2 (ZERO, ZERO_RES, STEP, COLOUR on colour 0
    of ``colors``) on K = LANES stacks of the block level A, the unsharded
    batched V-cycle's kernels (ZERO, the local update of the sharded block
    sweep too, on ``zero_path``): each against its twin at the kernel
    tolerance, a second launch with the first one's bits, launches a
    call, and every lane equal to the one-vector kernel on that lane alone
    bit for bit.  Each row's bound counts the blocks (and Dinv) once and
    every lane's vectors; the library call: ``torch.sparse.mm`` of A as
    CSR against the (n, K) columns (``torch.addmm`` for RESID) and
    ``torch.baddbmm`` of Dinv against the stack's (nb, bs, K) view for
    ZERO; none for ZERO_RES, STEP and COLOUR."""
    import torch

    from pyamg_tpu_torch.sparse import block_dia as bd

    dtype, n, nb, bs = A.dtype, A.n_pad, A.nb_pad, A.bs
    dt = str(dtype).removeprefix("torch.")
    X, B = rand((LANES, n), dtype), rand((LANES, n), dtype)
    Xcols, Bcols = X.T.contiguous(), B.T.contiguous()
    Bv = B.view(LANES, nb, bs).permute(1, 2, 0)
    out = torch.empty((nb, bs, LANES), dtype=dtype, device=B.device)
    csr = bdia_to_csr(A, A.device)
    w = float(omega)
    n0 = int((colors == 0).sum())

    def lanes_cost(vectors, **kw):
        """block_cost with every lane's vectors and operations."""
        return (block_cost(A, LANES * vectors, **kw)[0],
                LANES * block_cost(A, vectors, **kw)[1])

    zero_bytes = (Dinv.numel() + 2 * LANES * n) * B.element_size()
    modes = (
        ("block_dia_spmv", "", lambda X, B: bd.block_dia_apply(A, X),
         lambda: bd.block_dia_spmv_ref(A, X), lanes_cost(2),
         lambda: torch.sparse.mm(csr, Xcols)),
        ("block_dia_spmv", " RESID", lambda X, B: bd.block_dia_resid(A, X, B),
         lambda: bd.block_dia_resid_ref(A, X, B), lanes_cost(3, extra_ops=1),
         lambda: torch.addmm(Bcols, csr, Xcols, alpha=-1.0)),
        ("block_dia_jacobi", " ZERO",
         lambda X, B: bd.block_jacobi_zero(Dinv, B, omega),
         lambda: bd.block_jacobi_zero_ref(Dinv, B, omega),
         (zero_bytes, LANES * (2 * nb * bs * bs + nb * bs)),
         lambda: torch.baddbmm(out, Dinv, Bv, beta=0, alpha=w)),
        ("block_dia_jacobi", " ZERO_RES",
         lambda X, B: bd.block_jacobi_zero_res(A, B, Dinv, omega),
         lambda: bd.block_jacobi_zero_res_ref(A, B, Dinv, omega),
         lanes_cost(3, dinv=True, extra_ops=2), None),
        ("block_dia_jacobi", " STEP",
         lambda X, B: bd.block_jacobi_step(A, X, B, Dinv, omega),
         lambda: bd.block_jacobi_step_ref(A, X, B, Dinv, omega),
         lanes_cost(3, dinv=True, extra_ops=3), None),
        ("block_dia_jacobi", f" COLOUR 0 ({n0} nodes)",
         lambda X, B: bd.block_colour_step(A, X, B, Dinv, colors, 0),
         lambda: bd.block_colour_step_ref(A, X, B, Dinv, colors, 0),
         (block_cost(A, LANES * (2 + n0 / nb), dinv=True, nodes=n0)[0],
          LANES * block_cost(A, 2 + n0 / nb, dinv=True, nodes=n0,
                             extra_ops=3)[1]), None))
    for kernel, mode, fn, plain, cost, lib in modes:
        name = f"{kernel}.{dt}{mode} [{tag} K={LANES}]"
        compare(check, name, dtype, lambda: fn(X, B), plain, results, *cost,
                library_fn=lib, repeat_exact=True,
                path=zero_path if mode == " ZERO" else path)
        row = results[-1]
        k = row["launches_per_call"] = launches_per_call(lambda: fn(X, B))
        got = fn(X, B)
        got = got if isinstance(got, tuple) else (got,)
        same = True
        for i in range(LANES):
            one = fn(X[i].clone(), B[i].clone())
            one = one if isinstance(one, tuple) else (one,)
            same &= all(torch.equal(g[i], o) for g, o in zip(got, one))
        check(same and k == 1, f"{name}: every lane equals the one-vector "
              f"kernel on that lane alone bit for bit, {k} launch(es) a "
              f"call; {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")


def transposed_level_checks(check, A, Ab, rand):
    """A^T of a sharded level in a world of one: the DIA level A's
    transposed diagonals (built at the first transpose) through K16,
    against ``DIAMatrix.rmatvec``'s rolls on a vector and a K = LANES
    stack (the kernel tolerance: the rolls round each product apart from
    its sum), one launch a call after the build; the block level Ab's
    through B1's halo mode against ``BlockDIAMatrix.rmatvec`` (B1 on its
    transposed blocks) bit for bit; times of both forms, and of the library
    call on A^T as CSR (``torch.mv`` on a vector, ``torch.sparse.mm`` on
    the stack's (n, K) columns)."""
    import torch

    from pyamg_tpu_torch.parallel.partition import (ShardedOperator,
                                                    SolverMesh)
    from pyamg_tpu_torch.sparse import block_dia as bd

    one = SolverMesh(rank=0, world=1, device=A.device)
    for M, kind in ((A, "DIA"), (Ab, "block")):
        sh = ShardedOperator(M, one, (1, M.n_pad), (1, M.n_pad), 1)
        csr_t = (dia_to_csr(M, transpose=True) if kind == "DIA"
                 else bdia_to_csr(M.T, M.device))
        dt = str(M.dtype).removeprefix("torch.")
        y0 = rand(M.n_pad, M.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sh.rmatvec(y0)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        for y in (rand(M.n_pad, M.dtype), rand((LANES, M.n_pad), M.dtype)):
            got = sh.rmatvec(y)
            want = (M.rmatvec(y) if kind == "DIA"
                    else bd.block_dia_apply(M.T, y))
            torch.cuda.synchronize()
            err = float((got - want).abs().max() / want.abs().max())
            k = launches_per_call(lambda: sh.rmatvec(y))
            t_sh = time_ms(lambda: sh.rmatvec(y))
            t_un = time_ms(lambda: M.rmatvec(y))
            if y.ndim == 1:
                lib = "torch.mv"
                t_lib = time_ms(lambda: torch.mv(csr_t, y))
            else:
                lib, cols = "torch.sparse.mm", y.T.contiguous()
                t_lib = time_ms(lambda: torch.sparse.mm(csr_t, cols))
            lanes = "one vector" if y.ndim == 1 else f"K={LANES}"
            tol = F32_REL_TOL if M.dtype == torch.float32 else F64_REL_TOL
            ok = (torch.equal(got, want) if kind == "block"
                  else err <= tol)
            how = ("bit for bit" if kind == "block"
                   else f"rel err {err:.2e}")
            check(ok and k == 1,
                  f"sharded A^T [{kind} {dt} n_pad={M.n_pad}, {lanes}]: "
                  f"{how} against the unsharded transpose, {k} launch(es) a call,"
                  f" {t_sh:.4f} ms (unsharded {t_un:.4f} ms; library "
                  f"{t_lib:.4f} ms, {lib} on A^T as CSR); the first "
                  f"transpose, the diagonals' build included, "
                  f"{t_build * 1e3:.1f} ms")


def sharded_lanes_phase(check, dev, card, rand, results, launches, dsa, dml,
                        A1, d2, dla, dus, A_un):
    """Phase 21: sharded batched (n, K) solves, A^T of sharded levels and
    the cross-shard sweeps, in a world of one NCCL rank (file://
    rendezvous).  Kernels: K16's lane mode at config 1's device-built
    2048^2 level-0 S and S^T (float32 and float64) and the 64^3 level-0 S,
    B1's halo mode on lanes and B1 / B2 in every mode on lanes (the
    unsharded batched V-cycle's kernels) at config 4's 1024^2 level 0,
    the transposed DIA and block DIA.  Solves at K = LANES, each against its unsharded
    batched solve in this run (every lane's count, its history within
    SHARDED_HIST_RTOL, its true relres, walls median of 3, launches a
    solve): config 1 device-built and host-built (CG to 1e-5), config 3
    RS 512^2, config 4 1024^2 (block, its columns grid-encoded; then the
    unsharded solve's launches and a torch.profiler trace of both), the 640k
    unstructured SA (CG to 1e-6); CGNR and CGNE on config 5's RS 1024^2
    and on AIR 256^2 (20 iterations); the Cimmino sweep and windowed
    Schwarz on a host-built 256^2 float64 hierarchy (CG)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from pyamg_tpu_torch import (DeviceMultilevelSolver,
                                 StructuredDeviceSolver, advection_2d,
                                 compile_hierarchy, device_air_setup,
                                 device_rs_setup, device_sa_setup_block,
                                 diffusion_stencil_2d, linear_elasticity,
                                 poisson, recirc_flow,
                                 smoothed_aggregation_solver, stencil_grid)
    from pyamg_tpu_torch.engine.batched_cycle import supports_interleaved
    from pyamg_tpu_torch.parallel import (initialize_distributed,
                                          make_solver_mesh, shard_hierarchy)
    from pyamg_tpu_torch.sparse import DIAMatrix

    f32 = torch.float32
    side = torch.cuda.Stream()
    rng = np.random.default_rng(21)

    def walls(fn):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def lane_case(label, unsharded, sharded, B, true_relres, kw, ref=None):
        """``unsharded`` / ``sharded``: (B, **kw) -> X; B (n, K)."""
        res0 = []
        unsharded(B, residuals=res0, **kw)
        sharded(B, **kw)                           # warm-up
        res1 = []
        X1, counts, _ = counted(lambda: sharded(B, residuals=res1, **kw))
        launches[label] = counts
        t1, t0 = walls(lambda: sharded(B, **kw)), walls(
            lambda: unsharded(B, **kw))
        its0 = [len(r) - 1 for r in res0]
        its1 = [len(r) - 1 for r in res1]
        true1 = true_relres(X1)
        normb = np.linalg.norm(B, axis=0)
        diff = max(float(np.max(np.abs(r1[:m] - r0[:m]) / r0[:m]))
                   for r0, r1 in zip(res0, res1)
                   for m in (min(len(r0), len(r1)),))
        per_solve = sum(counts.values())
        lane_k = {k: c for k, c in counts.items()
                  if k.split(".")[0] in ("dia_halo_spmm",
                                         "block_dia_halo_spmm")}
        log(f"{label} (world of one, K={B.shape[1]}, {kw['accel']} to "
            f"{kw['tol']:g}): iterations per lane {its1} (unsharded "
            f"{its0}); history relres max "
            f"{max(r[-1] for r in res1) / normb.min():.3e}, true relres "
            f"per lane {[f'{v:.3e}' for v in true1]}; history vs unsharded "
            f"max rel diff {diff:.2e}; solve {t1:.4f} s sharded, {t0:.4f} "
            f"s unsharded (numpy B, median of 3); {per_solve} kernel "
            f"launches a solve, lane halo {json.dumps(lane_k)}")
        log(f"  launches in that solve: {json.dumps(counts, sort_keys=True)}")
        check(X1.shape == B.shape and bool(np.isfinite(X1).all())
              and all(r[-1] <= kw["tol"] * nb for r, nb in zip(res1, normb)),
              f"{label}: finite, every lane's relres <= {kw['tol']:g}")
        check(its1 == its0, f"{label}: iterations per lane {its1}, the "
              f"unsharded batched solve's {its0}")
        if ref is not None:
            check(all(i == ref for i in its1), f"{label}: {ref} iterations "
                  f"every lane ({its1})")
        check(diff <= SHARDED_HIST_RTOL, f"{label}: every lane's history "
              f"within rtol {SHARDED_HIST_RTOL:g} of the unsharded one "
              f"({diff:.2e})")
        check(not any(k.startswith("int_") for k in counts),
              f"{label}: the K-major lane route (no interleaved kernel)")
        path_launches(check, label, counts)

    def one_case(label, unsharded, sharded, b, kw, rtol):
        """A one-vector solve: the unsharded count, history within
        ``rtol``."""
        res0, res1 = [], []
        unsharded(b, residuals=res0, **kw)
        sharded(b, **kw)
        _, counts, wall = counted(lambda: sharded(b, residuals=res1, **kw))
        launches[label] = counts
        m = min(len(res0), len(res1))
        diff = float(np.max(np.abs(np.subtract(res1[:m], res0[:m]))
                            / np.asarray(res0[:m])))
        log(f"{label} (world of one, {kw['accel']}, maxiter "
            f"{kw['maxiter']}): {len(res1) - 1} iterations (unsharded "
            f"{len(res0) - 1}), last {res1[-1] / res1[0]:.3e} of the first,"
            f" history vs unsharded max rel diff {diff:.2e}; solve "
            f"{wall:.4f} s; {sum(counts.values())} kernel launches")
        check(len(res1) == len(res0) and diff <= rtol,
              f"{label}: {len(res1) - 1} iterations, the unsharded "
              f"{len(res0) - 1}, history within rtol {rtol:g} ({diff:.2e})")
        path_launches(check, label, counts)

    def grid_pair(solver, mesh):
        """(unsharded, sharded) solves of a grid solver, and the sharded
        hierarchy."""
        hs = shard_hierarchy(solver.hierarchy, mesh)
        return solver.solve, StructuredDeviceSolver(
            hs, solver.grid, solver.grid_p, solver.setup_info).solve, hs

    def lane_remap(label, solver, hs):
        """K12 / K13 on the remap ``label``'s level-0 transfers apply."""
        remap_checks(check, label, LANE_REMAPS[label], solver, hs, rand,
                     results, lanes=LANES)

    def true_of(M, B):
        """Each lane's true relres of an (n, K) solution of M X = B."""
        return lambda X: np.linalg.norm(
            B - M @ X.astype(np.float64), axis=0) / np.linalg.norm(B, axis=0)

    with tempfile.TemporaryDirectory() as tmp:
        rank, world, _ = initialize_distributed(
            init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
            device=dev)
        try:
            mesh = make_solver_mesh(device=dev)
            log(f"sharded lanes, A^T and cross-shard sweeps: "
                f"torch.distributed {dist.get_backend()}, rank {rank} of "
                f"{world}; {card}")
            # kernels: K16's lane mode at the device-built 2048^2 level 0
            lv0 = dsa.hierarchy.levels[0]
            for what, op in (("S", lv0.P.S), ("S^T", lv0.R.St)):
                for dtype in (f32, torch.float64):
                    M = op if dtype == f32 else DIAMatrix(
                        data=op.data.double(), offsets=op.offsets,
                        shape=op.shape, nnz=op.nnz)
                    halo_lane_checks(
                        check, M, rand, results,
                        f"device level0 {what} nd={M.ndiags} "
                        f"n_pad={M.n_pad}",
                        "sharded batched device-built config 1"
                        if dtype == f32 and what == "S" else None, side)
                    del M
            op = d2.hierarchy.levels[0].P.S
            halo_lane_checks(check, op, rand, results,
                             f"64^3 level0 S nd={op.ndiags} n_pad={op.n_pad}",
                             None, side)
            # config 1: the device-built hierarchy (and the lane-aligned
            # one's sharded copy, which the interleaved route refuses)
            hs_la = shard_hierarchy(dla.hierarchy, mesh)
            check(supports_interleaved(dla.hierarchy)
                  and not supports_interleaved(hs_la),
                  "the lane-aligned hierarchy takes the interleaved route "
                  "unsharded and not sharded (the reference's rule)")
            del hs_la
            n1 = A1.shape[0]
            B1 = rng.random((n1, LANES))
            cg5 = dict(tol=1e-5, maxiter=100, accel="cg")
            un, sh, hs = grid_pair(dsa, mesh)
            lane_case("sharded batched device-built config 1", un, sh, B1,
                      true_of(A1, B1), cg5, REF_ITERS_BATCHED_1E5)
            lane_remap("sharded batched device-built config 1", dsa, hs)
            del un, sh, hs
            hsm = shard_hierarchy(dml.hierarchy, mesh)
            lane_case("sharded batched host-built config 1", dml.solve,
                      DeviceMultilevelSolver(hsm).solve, B1,
                      true_of(A1, B1), cg5)
            del hsm, B1
            # config 3 RS 512^2
            A3 = stencil_grid(diffusion_stencil_2d(
                epsilon=1e-3, theta=0.0, type="FD"), C3_GRID).tocsr()
            d3 = device_rs_setup(A3, grid=C3_GRID, dtype=f32, device=dev,
                                 max_coarse=400)
            B3 = rng.random((A3.shape[0], LANES))
            un, sh, hs = grid_pair(d3, mesh)
            lane_case("sharded batched config 3 RS", un, sh, B3,
                      true_of(A3, B3), dict(cg5, maxiter=60),
                      REF_ITERS_C3_RS)
            lane_remap("sharded batched config 3 RS", d3, hs)
            del d3, un, sh, hs, B3
            # config 4 1024^2: block levels, columns grid-encoded
            A4, Bm = linear_elasticity(C4_BIG)
            d4 = device_sa_setup_block(A4, grid=C4_BIG_NODE_GRID, B=Bm,
                                       max_coarse=400, dtype=f32, device=dev)
            lv4 = d4.hierarchy.levels[0]
            tag4 = (f"config4 1024^2 level0 A bs={lv4.A.bs} "
                    f"nd={lv4.A.ndiags} nb={lv4.A.nb_pad}")
            block_halo_lane_checks(
                check, lv4.A, rand, results, tag4,
                "sharded batched config 4 1024^2", side)
            # the 4-colour parity colouring of the padded node grid
            gx = lv4.P.fine_grid_p[1]
            node = torch.arange(lv4.A.nb_pad, device=dev)
            parity = ((node // gx) % 2 * 2 + node % gx % 2).to(torch.int32)
            block_lane_checks(check, lv4.A, *lv4.pre.arrays, parity, rand,
                              results, tag4, "batched config 4 1024^2",
                              "sharded batched config 4 1024^2")
            del parity, node
            transposed_level_checks(check, lv0.A, lv4.A, rand)
            B4 = rng.random((A4.shape[0], LANES))
            E4 = np.stack([d4._encode(c) for c in B4.T], axis=1)
            true4 = true_of(A4, B4)
            hs4 = shard_hierarchy(d4.hierarchy, mesh)
            un4 = DeviceMultilevelSolver(d4.hierarchy).solve
            sh4 = DeviceMultilevelSolver(hs4).solve
            lane_case("sharded batched config 4 1024^2", un4, sh4, E4,
                      lambda X: true4(np.stack(
                          [d4._decode(c) for c in X.T], axis=1)), cg5)
            lane_remap("sharded batched config 4 1024^2", d4, hs4)
            label = "batched config 4 1024^2"
            _, counts, wall = counted(lambda: un4(E4, **cg5))
            launches[label] = counts
            log(f"{label} (unsharded, K={LANES}, cg to 1e-5): solve "
                f"{wall:.4f} s; launches in that solve: "
                f"{json.dumps(counts, sort_keys=True)}")
            path_launches(check, label, counts)
            profile_phase(f"config 4 1024^2 batched CG, K={LANES}", (
                ("unsharded batched CG to 1e-5", lambda: un4(E4, **cg5)),
                ("sharded batched CG to 1e-5 (world of one)",
                 lambda: sh4(E4, **cg5))), top=14)
            del d4, hs4, lv4, E4, B4, un4, sh4
            # the 640k unstructured SA hierarchy, CG to 1e-6
            Bu = rng.standard_normal((A_un.shape[0], LANES))
            hsu = shard_hierarchy(dus.hierarchy, mesh)
            lane_case("sharded batched unstructured",
                      DeviceMultilevelSolver(dus.hierarchy).solve,
                      DeviceMultilevelSolver(hsu).solve, Bu,
                      true_of(A_un, Bu), dict(tol=1e-6, maxiter=100,
                                              accel="cg"))
            del hsu, Bu
            # CGNR / CGNE: config 5's RS 1024^2 and AIR 256^2
            A5 = recirc_flow(C5_GRID, epsilon=1e-2)
            d5 = device_rs_setup(A5, grid=C5_GRID, dtype=f32, device=dev,
                                 max_coarse=400)
            Aa, ba = advection_2d(AIR_GRID, theta=np.pi / 4)
            da = device_air_setup(Aa, grid=AIR_GRID, device=dev,
                                  max_coarse=400)
            for what, solver, b in (
                    ("config 5 RS", d5,
                     np.random.default_rng(4).random(A5.shape[0])),
                    ("structured AIR", da, np.asarray(ba))):
                un, sh, _ = grid_pair(solver, mesh)
                for accel in ("cgnr", "cgne"):
                    one_case(f"sharded {accel.upper()} {what}", un, sh, b,
                             dict(tol=1e-8, maxiter=20, accel=accel),
                             SHARDED_HIST_RTOL)
                del un, sh
            del d5, da
            # the Cimmino sweep and windowed Schwarz, host-built 256^2
            A2 = poisson(STATIONARY_GRID, format="csr")
            b2 = np.random.default_rng(5).random(A2.shape[0])
            for label, spec in (("sharded Cimmino 256^2 float64",
                                 ("gauss_seidel_nr", {"sweep":
                                                      "symmetric"})),
                                ("sharded Schwarz 256^2 float64",
                                 ("schwarz", {}))):
                ml = smoothed_aggregation_solver(A2, presmoother=spec,
                                                 postsmoother=spec)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    h = compile_hierarchy(ml, dtype=torch.float64,
                                          device=dev)
                one_case(label, DeviceMultilevelSolver(h).solve,
                         DeviceMultilevelSolver(
                             shard_hierarchy(h, mesh)).solve, b2,
                         dict(tol=1e-8, maxiter=40, accel="cg"), 1e-8)
        finally:
            dist.destroy_process_group()


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from pyamg_tpu_torch import (_build, as_device_solver, device_sa_setup,
                                 DeviceMultilevelSolver, poisson,
                                 smoothed_aggregation_solver)
    from pyamg_tpu_torch.engine.batched_cycle import (_jacobi_wd,
                                                      supports_interleaved)
    from pyamg_tpu_torch.sparse import DIAMatrix, WindowedELL, dia, window
    from pyamg_tpu_torch.sparse import interleaved as il

    t_start = time.perf_counter()
    check = Checks()
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)

    # 1. toolchain
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    card = nvidia_smi_line()
    log(f"card: {card}; torch.cuda.device_count() = "
        f"{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(cached={_build.build_info.get('cached')}) -> "
        f"{_build.build_info.get('path')}")
    for line in _build.build_info.get("log", "").splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. the port's host setup and its compile at 2048^2
    config1 = dict(presmoother=("jacobi", {"omega": 4.0 / 3.0}),
                   postsmoother=("jacobi", {"omega": 4.0 / 3.0}))
    A = poisson(GRID, format="csr")
    n = A.shape[0]
    t0 = time.perf_counter()
    ml = smoothed_aggregation_solver(A, **config1)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    dml = as_device_solver(ml, device=dev, mixed_precision=True,
                           coarse_cutoff=COARSE_CUTOFF)
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    h = dml.hierarchy
    log(f"host SA setup (the port's own, g++ build of its native subset "
        f"included) {t_setup:.2f} s; {len(ml.levels)} host levels; compile "
        f"to the card {t_compile:.2f} s; {len(h.levels)} device levels")
    for i, lvl in enumerate(h.levels):
        log(f"  level {i}: n={lvl.n} n_pad={lvl.n_pad} {forms(lvl)}")

    # 4. device-built setup at 2048^2 (warm call, then the timed one)
    setup_kw = dict(grid=GRID, dtype=torch.float32, device=dev,
                    max_coarse=400, mixed_precision=True)
    t0 = time.perf_counter()
    dsa = device_sa_setup(A, **setup_kw)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    del dsa
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dsa = device_sa_setup(A, **setup_kw)
    torch.cuda.synchronize()
    t_dsetup = time.perf_counter() - t0
    hd = dsa.hierarchy
    log(f"device SA setup on the card: {t_dsetup:.3f} s (first call "
        f"{t_first:.3f} s, CUDA-synchronised, host CSR -> DIA included); "
        f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
        f" GiB; {len(hd.levels)} levels")
    levels_log(dsa)
    # ... and lane-aligned, the interleaved route's layout
    t0 = time.perf_counter()
    dla = device_sa_setup(A, lane_align=True, **setup_kw)
    torch.cuda.synchronize()
    log(f"lane-aligned device SA setup on the card: "
        f"{time.perf_counter() - t0:.3f} s; grid_p {dla.grid_p}; "
        f"supports_interleaved {supports_interleaved(dla.hierarchy)}")
    levels_log(dla, rho=False)
    check(dla.grid_p == LANE_GRID_P
          and dla.hierarchy.levels[0].n_pad == LANE_N_PAD
          and supports_interleaved(dla.hierarchy),
          f"lane-aligned hierarchy: grid_p {dla.grid_p}, n_pad "
          f"{dla.hierarchy.levels[0].n_pad} (the reference's {LANE_GRID_P}, "
          f"{LANE_N_PAD}), interleaved route admitted")

    # 5. kernels against their plain twins at the paths' shapes
    log("kernel checks (kernel vs plain twin, same inputs; library calls "
        "are yardsticks only):")
    rng = np.random.default_rng(0)

    def rand(shape, dtype):
        return torch.as_tensor(rng.random(shape), dtype=dtype, device=dev)

    def as_dtype(M, dtype):
        return DIAMatrix(data=M.data.to(dtype), offsets=M.offsets,
                         shape=M.shape, nnz=M.nnz)

    results = []
    lv0, lv1 = h.levels[0], h.levels[1]
    dia_cases = [("level0", lv0.A, lv0.pre.arrays[0]),
                 ("level1", lv1.A, lv1.pre.arrays[0])]
    omega0 = lv0.pre.config[1]
    for label, Af, dinvf in dia_cases:
        for dtype in (torch.float32, torch.float64):
            if dtype == torch.float32:
                Ad, dinv = Af, dinvf
            elif label == "level0":
                Ad, dinv = h.A64, dinvf.double()
            else:
                Ad, dinv = as_dtype(Af, dtype), dinvf.double()
            assert isinstance(Ad, DIAMatrix) and Ad.n_pad == dinv.shape[0]
            x = rand(Ad.n_pad, dtype)
            b = rand(Ad.n_pad, dtype)
            tag = f"host {label} nd={Ad.ndiags} n_pad={Ad.n_pad}"
            dt = str(dtype).removeprefix("torch.")
            lib = None
            if label == "level0":
                A_csr = dia_to_csr(Ad)
                lib = lambda: torch.mv(A_csr, x)   # noqa: E731
            compare(check, f"dia_spmv.{dt} [{tag}]", dtype,
                    lambda: dia.dia_spmv(Ad, x),
                    lambda: dia.dia_spmv_ref(Ad, x), results,
                    *dia_cost(Ad, 2), library_fn=lib)
            compare(check, f"dia_jacobi.{dt} [{tag}]", dtype,
                    lambda: dia.dia_jacobi(Ad, x, b, dinv, omega0),
                    lambda: dia.dia_jacobi_ref(Ad, x, b, dinv, omega0),
                    results, *dia_cost(Ad, 4, extra_ops=4))
            compare(check, f"dia_jacobi_zero_res.{dt} [{tag}]", dtype,
                    lambda: dia.dia_jacobi_zero_res(Ad, b, dinv, omega0),
                    lambda: dia.dia_jacobi_zero_res_ref(Ad, b, dinv, omega0),
                    results, *dia_cost(Ad, 4, extra_ops=3))
            # K10, the host-built batched cycle's zero-entry front-end
            Bk = rand((LANES, Ad.n_pad), dtype)
            k10_checks(check, f"dia_jacobi_zero_res_k.{dt} [{tag} "
                       f"K={LANES}]", Ad, Bk, dinv, omega0, results)
            if label != "level0" or dtype != torch.float32:
                continue
            # ... and on 19 lanes: still one launch (the thread-per-row
            # form took two)
            B19 = rand((19, Ad.n_pad), dtype)
            k10_checks(check, f"dia_jacobi_zero_res_k.{dt} [{tag} K=19]",
                       Ad, B19, dinv, omega0, results)
            del B19
            # K9 and K8 plain at the host-built level 0 (the host-built
            # batched path's sweeps and residuals); X from a generator of
            # its own, so the later checks keep their inputs
            Xk = torch.as_tensor(np.random.default_rng(9).random(
                (LANES, Ad.n_pad)), dtype=dtype, device=dev)
            Xcols = Xk.T.contiguous()
            ktag = f"{tag} K={LANES}"
            path = "host-built batched config 1"
            compare(check, f"dia_jacobi_k.{dt} [{ktag}]", dtype,
                    lambda: dia.dia_jacobi_k(Ad, Xk, Bk, dinv, omega0),
                    lambda: dia.dia_jacobi_k_ref(Ad, Xk, Bk, dinv, omega0),
                    results, *dia_cost(Ad, 1, LANES, 3, extra_ops=4),
                    path=path)
            k8_rows_check(check, f"dia_jacobi_k.{dt} [{ktag}]",
                          "dia_jacobi_k", dia._JACOBI_K, Ad, Xk, Bk, dinv,
                          omega0, lambda: dia.dia_jacobi_k(Ad, Xk, Bk, dinv,
                                                           omega0))
            compare(check, f"dia_spmm.{dt} [{ktag}]", dtype,
                    lambda: dia.dia_spmm(Ad, Xk),
                    lambda: dia.dia_spmm_ref(Ad, Xk), results,
                    *dia_cost(Ad, 0, LANES, 2), path=path,
                    library_fn=lambda: torch.sparse.mm(A_csr, Xcols))
            k8_rows_check(check, f"dia_spmm.{dt} [{ktag}]", "dia_spmm",
                          dia._SPMM, Ad, Xk, None, None, 0.0,
                          lambda: dia.dia_spmm(Ad, Xk))
            del Xk, Xcols
    for label, hlvl, host_lvl in (("level0", lv0, ml.levels[0]),
                                  ("level1", lv1, ml.levels[1])):
        Tf = hlvl.P.ops[-1]
        assert isinstance(Tf, WindowedELL) and hlvl.R.ops[0].base is Tf
        T_host = host_lvl.P._sa_factor["T"]
        for dtype in (torch.float32, torch.float64):
            T = Tf if dtype == torch.float32 else WindowedELL(
                data=Tf.data.double(), idx=Tf.idx, starts=Tf.starts,
                shape=Tf.shape, block=Tf.block, w2=Tf.w2,
                m_chunks=Tf.m_chunks, nnz=Tf.nnz)
            x = rand(T.m_chunks * T.w2, dtype)
            r = rand(T.n_pad, dtype)
            tag = (f"host {label} T {T.shape[0]}x{T.shape[1]} k={T.k} "
                   f"block={T.block} w2={T.w2}")
            dt = str(dtype).removeprefix("torch.")
            sz = T.data.element_size()
            meta = T.data.numel() * sz + (T.idx.numel()
                                          + T.starts.numel()) * 4
            ops = 2 * T.data.numel()
            lib_mv = lib_rmv = None
            if label == "level0":
                T_csr = scipy_to_csr(T_host, dtype, dev)
                Tt_csr = scipy_to_csr(T_host.T, dtype, dev)
                xm = x[: T.shape[1]].contiguous()
                rn = r[: T.shape[0]].contiguous()
                lib_mv = lambda: torch.mv(T_csr, xm)     # noqa: E731
                lib_rmv = lambda: torch.mv(Tt_csr, rn)   # noqa: E731
            compare(check, f"windowed_matvec.{dt} [{tag}]", dtype,
                    lambda: window.windowed_matvec(T, x),
                    lambda: window.windowed_matvec_ref(T, x), results,
                    meta + (x.numel() + T.n_pad) * sz, ops,
                    library_fn=lib_mv)
            k6_rows_check(check, f"windowed_matvec.{dt} [{tag}]", T, x)
            compare(check, f"windowed_rmatvec.{dt} [{tag}]", dtype,
                    lambda: window.windowed_rmatvec(T, r),
                    lambda: window.windowed_rmatvec_ref(T, r), results,
                    meta + (r.numel() + T.m_chunks * T.w2) * sz, ops,
                    library_fn=lib_rmv,
                    repeat_exact=True)
            # K12 and K13 at K = 8 (library: torch.sparse.mm of T and T^T
            # in CSR against (n, 8) column stacks)
            Xk = rand((LANES, T.m_chunks * T.w2), dtype)
            Rk = rand((LANES, T.n_pad), dtype)
            lib_mm = lib_rmm = None
            if label == "level0":
                Xc = Xk[:, : T.shape[1]].T.contiguous()
                Rc = Rk[:, : T.shape[0]].T.contiguous()
                lib_mm = lambda: torch.sparse.mm(T_csr, Xc)     # noqa: E731
                lib_rmm = lambda: torch.sparse.mm(Tt_csr, Rc)   # noqa: E731
            ktag = f"{tag} K={LANES}"
            compare(check, f"windowed_matmat_k.{dt} [{ktag}]", dtype,
                    lambda: window.windowed_matmat_k(T, Xk),
                    lambda: window.windowed_matmat_k_ref(T, Xk), results,
                    meta + (Xk.numel() + LANES * T.n_pad) * sz,
                    ops * LANES, library_fn=lib_mm, repeat_exact=True)
            compare(check, f"windowed_rmatmat_k.{dt} [{ktag}]", dtype,
                    lambda: window.windowed_rmatmat_k(T, Rk),
                    lambda: window.windowed_rmatmat_k_ref(T, Rk), results,
                    meta + (Rk.numel() + LANES * T.m_chunks * T.w2) * sz,
                    ops * LANES, library_fn=lib_rmm,
                    repeat_exact=True)
            for kind, fn in (
                    ("matmat_k", lambda: window.windowed_matmat_k(T, Xk)),
                    ("rmatmat_k", lambda: window.windowed_rmatmat_k(T, Rk))):
                lane_launches(check, f"windowed_{kind}.{dt} [{ktag}]",
                              f"windowed_{kind}.{dt}", fn)
            transpose_checks(check, f"host {label} T {dt}", T, r, Rk)
    # the device-built path's kernels: K5 on levels 0 and 1, K4 and the
    # two K1 epilogues on level 0; the K-lane kernels (K8 in three modes,
    # K9, K11) at K = 8 on levels 0 and 1; each in float32 and float64
    device_level_checks(check, "device", hd, rand, results,
                        {"lanes": "device-built batched config 1",
                         "scale": "device-built batched stationary"})

    # K11's per-row branch: a 3-D 7-point pattern whose +-n^2 offset is
    # too far for one lane's ring (100 x 180 x 180, reach 32 400 rows)
    k11_per_row_checks(check, rand, results)
    # K7 on columns longer than a warp and than its tile budget
    k7_long_column_checks(check, rand, results)

    # K15's five modes on the lane-aligned level-0 operators, K = 8, f32
    # (library: torch.sparse.mm of A and torch.addmm of S in CSR against
    # (n, 8) column stacks)
    la0 = dla.hierarchy.levels[0]
    A_la, S_la, St_la, tv_la = la0.A, la0.P.S, la0.R.St, la0.R.tv
    wd_la = _jacobi_wd(la0.pre)
    f32 = torch.float32
    Bi, Xi = (rand((A_la.n_pad // 128, LANES, 128), f32) for _ in range(2))
    Tcols = il.from_interleaved(Bi).T.contiguous()
    Xcols = il.from_interleaved(Xi).T.contiguous()
    A_la_csr, S_la_csr = dia_to_csr(A_la), dia_to_csr(S_la)
    itag = f"lane-aligned level0 n_pad={A_la.n_pad} K={LANES}"
    for name, op, kern, plain, cost, lib in (
            ("int_jacobi_zero_res", A_la,
             lambda: il.int_jacobi_zero_res(A_la, wd_la, Bi),
             lambda: il.int_jacobi_zero_res_ref(A_la, wd_la, Bi),
             dia_cost(A_la, 1, LANES, 3, extra_ops=2), None),
            ("int_spmv_scaled", St_la,
             lambda: il.int_spmv_scaled(St_la, Bi, tv_la),
             lambda: il.int_spmv_scaled_ref(St_la, Bi, tv_la),
             dia_cost(St_la, 1, LANES, 2, extra_ops=1), None),
            ("int_spmv", A_la, lambda: il.int_spmv(A_la, Bi),
             lambda: il.int_spmv_ref(A_la, Bi), dia_cost(A_la, 0, LANES, 2),
             lambda: torch.sparse.mm(A_la_csr, Tcols)),
            ("int_spmv_add", S_la, lambda: il.int_spmv_add(S_la, Bi, Xi),
             lambda: il.int_spmv_add_ref(S_la, Bi, Xi),
             dia_cost(S_la, 0, LANES, 3, extra_ops=1),
             lambda: torch.addmm(Xcols, S_la_csr, Tcols)),
            ("int_jacobi_step", A_la,
             lambda: il.int_jacobi_step(A_la, wd_la, Bi, Xi),
             lambda: il.int_jacobi_step_ref(A_la, wd_la, Bi, Xi),
             dia_cost(A_la, 1, LANES, 3, extra_ops=3), None)):
        compare(check, f"{name}.float32 [{itag} nd={op.ndiags}]", f32, kern,
                plain, results, *cost, library_fn=lib)

    # 5b. K16 at host level 0: ring of one and in-process shards vs K1
    halo_phase(check, h, rand, results)

    # 6. small input: the float64 host-built solve on the card against the
    # same hierarchy copied to the CPU (the plain twins), every level kept
    A_s = poisson((128, 128), format="csr")
    ml_s = smoothed_aggregation_solver(A_s, **config1)
    b_s = np.random.default_rng(6).random(A_s.shape[0])
    d_s = as_device_solver(ml_s, dtype=torch.float64, device=dev)
    c_s = DeviceMultilevelSolver(to_device(d_s.hierarchy, "cpu"))
    res_d, res_h = [], []
    d_s.solve(b_s, tol=1e-10, maxiter=25, accel="cg", residuals=res_d)
    c_s.solve(b_s, tol=1e-10, maxiter=25, accel="cg", residuals=res_h)
    m = min(len(res_d), len(res_h))
    hist_err = float(np.max(np.abs(np.subtract(res_d[:m], res_h[:m]))
                            / np.asarray(res_h[:m])))
    check(len(res_d) == len(res_h) and hist_err <= 1e-8,
          f"128^2 float64 CG on the card vs its CPU copy (twins): "
          f"{len(res_d) - 1} vs {len(res_h) - 1} iterations, history rel "
          f"diff {hist_err:.2e} (tol 1e-8)")

    # 7. and 8. config 1, host-built and device-built, with counters
    launches = {}
    solve_phase(check, "host-built config 1", dml, A,
                np.random.default_rng(1).random(n), REF_ITERS, launches)
    solve_phase(check, "device-built config 1", dsa, A,
                np.random.default_rng(0).random(n), REF_ITERS_DEVICE,
                launches)

    # 9. batched device-built config 1 (K8, K9, K11)
    batched_phase(check, "device-built batched config 1", dsa, A, launches,
                  REF_ITERS_BATCHED_1E5, REF_ITERS_DEVICE)
    # host-built (K10, K12, K13): the reference times no batched host-built
    # native solve; its mixed count is the 1-D host-built one
    batched_phase(check, "host-built batched config 1", dml, A, launches,
                  None, REF_ITERS)
    # the lane-aligned device-built hierarchy: the interleaved route (K15)
    # and the K-major mixed solve
    interleaved_phase(check, dla, A, launches)

    # 10. stationary V-cycles from a nonzero iterate, one right-hand side
    # (K4, K1 SPMV_SCALED) and K = 4 lanes (K9 + K8, K8 scale)
    A_st = poisson(STATIONARY_GRID, format="csr")
    d_st = device_sa_setup(A_st, grid=STATIONARY_GRID, dtype=torch.float32,
                           device=dev, max_coarse=400)
    rng_st = np.random.default_rng(2)
    stationary_phase(check, "device-built stationary", d_st,
                     rng_st.random(A_st.shape[0]), launches)
    stationary_phase(check, "device-built batched stationary", d_st,
                     rng_st.random((A_st.shape[0], STATIONARY_LANES)),
                     launches)

    # 11. one device-built V-cycle, on a vector and on a K = 8 stack, with
    # every host sync an error; then the batched solve's profile
    cycle = DeviceMultilevelSolver(hd).cycle_operator("V")
    sync_free_cycle(check, cycle, rand(hd.levels[0].n_pad, torch.float32),
                    "one vector (device-built)")
    sync_free_cycle(check, cycle, rand((LANES, hd.levels[0].n_pad),
                                       torch.float32),
                    f"a K={LANES} stack (device-built)")
    lane_cycle_times(check, dla, rand)
    Bp = torch.as_tensor(np.random.default_rng(3).random((n, LANES)),
                         device=dev)
    b0 = Bp[:, 0].contiguous()
    native, mixed = (dict(tol=1e-5, accel="cg"),
                     dict(tol=1e-8, accel="cg", precision="mixed"))
    profile_phase(f"2048^2, K={LANES}", (
        ("device-built batched native", lambda: dsa.solve(Bp, **native)),
        ("device-built batched mixed", lambda: dsa.solve(Bp, **mixed)),
        ("device-built 1-D native", lambda: dsa.solve(b0, **native)),
        ("host-built batched native", lambda: dml.solve(Bp, **native)),
        ("host-built batched mixed", lambda: dml.solve(Bp, **mixed)),
        ("interleaved batched native (lane-aligned)",
         lambda: dla.solve(Bp, **native))))

    # 12. the unstructured device setup and solve
    t_u = time.perf_counter()
    dus, A_un = unstructured_phase(check, dev, rand, results, launches)
    log(f"unstructured phases: {time.perf_counter() - t_u:.1f} s")

    # 12b. the unstructured classical setups and solves
    t_u = time.perf_counter()
    drs = unstructured_classical_phase(check, dev, rand, results, launches,
                                       A_un, card)
    log(f"unstructured classical phase: {time.perf_counter() - t_u:.1f} s")

    # 13. row-sharded solves in a world of one NCCL rank
    t_s = time.perf_counter()
    sharded_phase(check, dev, dml, A, dus, A_un, drs, launches)
    del drs
    log(f"sharded phase: {time.perf_counter() - t_s:.1f} s")

    # 14. config 2: the device-built 64^3 hierarchy, its kernels, and the
    # W, F and AMLI cycles
    t_c = time.perf_counter()
    d2, A3 = config2_phase(check, dev, rand, results, launches)
    log(f"config 2 phase: {time.perf_counter() - t_c:.1f} s")

    # 15. the Krylov methods: BiCGStab, GMRES and FGMRES at 2048^2 on both
    # hierarchies, GMRES in float64, every accel and cycle at 256^2
    t_k = time.perf_counter()
    krylov_phase(check, "device-built", dsa, A,
                 np.random.default_rng(0).random(n), launches)
    krylov_phase(check, "host-built", dml, A,
                 np.random.default_rng(1).random(n), launches)
    gmres_float64_phase(check, dev, A, launches)
    accel_parity_phase(check, dev, A_st)
    log(f"Krylov phase: {time.perf_counter() - t_k:.1f} s")

    # 16. lanes: the 64^3 W-cycle CG at K = 8, GMRES (restart 4) at K = 4
    # on 256^2
    lane_solves_phase(check, "config 2 batched W-cycle", d2,
                      np.random.default_rng(3).random((A3.shape[0], LANES)),
                      dict(tol=1e-5, maxiter=40, cycle="W", accel="cg"),
                      launches)
    lane_solves_phase(check, "device-built batched GMRES", d_st,
                      np.random.default_rng(4).random(
                          (A_st.shape[0], GMRES_LANES)),
                      dict(tol=1e-5, maxiter=40, accel="gmres", restart=4),
                      launches, need_info=False)

    # 17. the other smoothers: config 2's host-built column (multicolour
    # GS and the Chebyshev fallback), its lanes and its sharded W-cycle;
    # the device-built Chebyshev 64^3 solve; every other kind at 256^2
    t_m = time.perf_counter()
    dml2, b2 = config2_host_phase(check, dev, rand, results, launches)
    sharded_config2_phase(check, dev, dml2, b2, rand, results, launches)
    smoother_kinds_phase(check, dev, rand, results, launches)
    log(f"smoother phase: {time.perf_counter() - t_m:.1f} s")

    # 18. the classical device setups: configs 3 and 5, AIR
    t_cl = time.perf_counter()
    classical_phase(check, dev, rand, results, launches, card)
    log(f"classical phase: {time.perf_counter() - t_cl:.1f} s")

    # 19. config 4: the block device setup, its block operations and
    # kernels, and adaptive SA
    t_c4 = time.perf_counter()
    config4_phase(check, dev, card, rand, results, launches)
    log(f"config 4 phase: {time.perf_counter() - t_c4:.1f} s")

    # 20. the device-built hierarchies row-sharded (a world of one)
    t_sd = time.perf_counter()
    sharded_device_built_phase(check, dev, card, rand, results, launches,
                               dsa, A, d2, A3)
    log(f"sharded device-built phase: {time.perf_counter() - t_sd:.1f} s")

    # 21. sharded batched solves, A^T of sharded levels (CGNR / CGNE) and
    # the cross-shard sweeps (a world of one)
    t_sl = time.perf_counter()
    sharded_lanes_phase(check, dev, card, rand, results, launches, dsa, dml,
                        A, d2, dla, dus, A_un)
    log(f"sharded lanes phase: {time.perf_counter() - t_sl:.1f} s")

    # 22. the partitioned device SA setup (a world of one)
    t_ps = time.perf_counter()
    partitioned_setup_phase(check, dev, card, rand, results, launches, A)
    log(f"partitioned setup phase: {time.perf_counter() - t_ps:.1f} s")

    # 23. the host-built columns of configs 3 and 4 (the port's own
    # Ruge-Stuben and rootnode setups)
    t_hs = time.perf_counter()
    host_setup_phase(check, dev, card, rand, results, launches)
    log(f"host-built configs 3 and 4 phase: "
        f"{time.perf_counter() - t_hs:.1f} s")

    if check.failures:
        print(f"chip_smoke: {len(check.failures)} check(s) failed:",
              file=sys.stderr)
        for f in check.failures:
            print(f"  {f}", file=sys.stderr)
        return 1

    # 24. result lines: each path kernel instance, with its launches on
    # the paths that run it (``launches``: the first of them) and, where a
    # later path's shapes were checked too (config 2's 64^3), those
    # numbers under ``at_paths``
    rows = []
    for key in dict.fromkeys(k for ks in PATHS.values() for k in ks):
        base, dt = key.split(".")
        src, replaces = KERNELS[base]
        by_path = {p: launches[p][key] for p, ks in PATHS.items()
                   if key in ks}
        # the check at the shapes of the first path that launches it,
        # else the first check of this instance
        mine = [r for r in results if r["name"].startswith(key + " ")]
        r0 = next((r for r in mine if r["path"] == next(iter(by_path))),
                  mine[0])
        at_paths = {}
        for p in list(by_path)[1:]:
            r = next((r for r in mine if r["path"] == p), None)
            if r is not None and r is not r0:
                at_paths[p] = {k: r[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")} | {"shape": r["name"],
                                      "launches": by_path[p]}
        rows.append({"name": key, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": next(iter(by_path.values())),
                     "launches_by_path": by_path,
                     "max_abs_err": r0["max_abs_err"], "ms": r0["ms"],
                     "plain_ms": r0["plain_ms"], "bound_ms": r0["bound_ms"],
                     "bound_by": r0["bound_by"],
                     "library_ms": r0["library_ms"], "shape": r0["name"],
                     **({"at_paths": at_paths} if at_paths else {}),
                     **({"checks": [{k: r[k] for k in (
                         "name", "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "max_abs_err", "launches_per_call",
                         "composed_ms", "chain_ms", "twin_rel_err",
                         "forms") if k in r} for r in mine]}
                        if base in BLOCK_KERNELS + SWEEP_KERNELS
                        else {})})
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
