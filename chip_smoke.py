"""Smoke run of the torch port on one NVIDIA card: build, check, measure.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``tmhpvsim_torch/csrc`` (nvcc, one process
   per source, all at once) and print the card's name and power limit;
2. K1 (threefry) against its plain torch version: bit for bit at every
   launch ``init_state`` makes (on its own keys), then on 2**20 keys for
   split, fold_in, bits and uniform bit for bit and normal to 2 float32
   ULP;
3. K2 (sampler windows) against its plain version at 65536 chains, every
   table and the carry bit for bit: the two launches ``init_state``
   makes, a block after which the carry advances, then two consecutive
   blocks (the Markov carry crosses a block); and the block from 23:45
   across midnight at 65536 - 37 chains (a partial last CTA) under
   threefry2x32 (also the next block), rbg and unsafe_rbg keys and with
   K7's regimes (``K2_EDGE``);
4. the block step against its plain versions at the main paths' shape,
   65536 chains x 1080 s, on 2 daylight blocks, on the same K2 tables:
   K3 (acc epilogue: 7 statistics and the renewal carry); K4 series (the
   per-second sums to rtol 1e-6, a second run bit-identical, the
   cross-CTA sum ``series_sum`` bit for bit against its plain version,
   which holds within 1e-6 of the float64 sum); K4 trace (meter bit-identical, pv and
   residual to the K3 tolerance, and each chain's sums over the trace
   against the acc kernel's); K3 and K4 trace bit for bit on a
   redraw-heavy edge block (``edge_block``), and the lean step's acc,
   series and trace under the table set, rbg, unsafe_rbg and bf16 keys
   and from a start off a whole minute on the edge block's last half hour
   (its sunset seconds) at 8192 - 37 chains (``phase_lean_edges``); K6 (the site-geometry mode through the acc
   epilogue at 65536 sites, and the geometry fields on their own);
   then the fleet kernels on 2 blocks of path F's fleet: K7 (the regime
   gather of K2 at init_state's launch and two blocks, bit for bit; the
   transforms through acc, trace and series), K8 (telemetry full), K9
   (analytics full, with 3 cohorts in shared memory, with 64 through
   global atomics, and with 30000 bins, where the residual histogram and
   the exceedance slots count through global atomics too; with ten
   exceedance thresholds, past the eight that count in registers, with
   telemetry full and shared histograms and at 30000 bins, each past the
   first on the second block; K9 is two launches, the acc producer and
   the observer fold) and K8+K9 (both at
   level full with the fleet's cohorts, path F's two launches) on path
   F's night and noon blocks: the acc producer against its plain version
   (statistics, carry, meter, csi and covered flags bit for bit, pv bit
   for bit or to the engine tolerance) and the acc kernel's statistics,
   the observer fold on the producer's own arrays against its plain
   version (per-chain leaves, counts, histograms and extrema bit for
   bit, sums over chains within 1e-6 of the float64 plain sums, a rerun
   bit-identical), the path's entry equal to the two launches; then the
   collapse on the fold's own per-group partial rows, bit for bit
   against an index-order float64 fold on the host and within 1e-12 (of
   the rows' absolute sum) of its plain version; then K10 (the
   scenario producer and fold) on the main path's noon block, 65536
   chains x 1080 s x 16 scenario rows (neutral, padding, a horizon ending
   mid-block, demand scale / shift, DC scale x weather bias, a binding
   curtailment cap and seeded mixtures) against its plain version, each
   row against a batch-of-1 launch of it and the neutral row against K3's
   launch; its two launches on their own (the producer's meter and carry
   bit for bit and pv to the engine tolerance; the fold on the producer's
   meter and pv bit for bit, with and without the producer's flags that
   let a masked tail skip its loads, and for 6 of the rows with a
   30000-bin sketch, still in shared memory, and a 60000-bin one,
   through global atomics, and with ten exceedance thresholds, counted
   with atomics where seven count in registers, at the default and the
   60000-bin sketch), timed at 1, 4 and 16 rows; and
   on 2 blocks of path F's fleet with the site and cohort selectors; then the precision levers' kernels: K11
   (the table transcendentals) on its own, each function on 2**20 seeded
   arguments over its ``ARG_RANGES`` bit for bit against its plain
   version (and the site geometry with the table set on path B's grid),
   and K6s (the strided site geometry, stride 60) through the acc
   epilogue at 65536 sites x 2 daylight blocks with the exact and the
   table set (statistics and the renewal carry bit-identical, a rerun
   bit-identical), and with both levers on 2 blocks of path F's fleet:
   the trace (every value bit-identical), K10 at 16 rows, and K8+K9
   (path F-L's producer and the fold, checked as K8+K9 above); and the port with both
   levers at the JAX suite's ``small_config`` shape (shared site, a
   4-site grid, a 12-site fleet) bit-identical to the host's plain run;
   then the K4 merges on the K4 trace of 2 daylight blocks x 65536
   chains: the wide fold (acc only; acc with telemetry; acc with
   telemetry and analytics on path F's fleet with its 3 cohorts; analytics
   with 64 cohorts and with 30000 bins, the global-memory branches, and
   with ten exceedance thresholds in shared and in global memory, each
   past F-W's launch on the second block)
   against its plain version (statistics, per-chain leaves, counts,
   histograms and extrema bit for bit, observer sums within 1e-6 of the
   float64 plain sums, a rerun bit-identical; the acc-only fold's seven
   statistics bit for bit) and against K3's acc on the same blocks (bit
   for bit), the wide series against its plain version (rtol 1e-6, a
   rerun bit-identical) and the scan's series kernel; and the wide fused
   topology (the acc launch) on 2 blocks against path R's; then K12 (the
   block step under ``compute_dtype='bf16'``) against its plain bf16
   version at 65536 chains x 2 daylight blocks, bit for bit: acc on a
   shared site, on path B's grid and, strided with the table set, on path
   B's grid (the grid's two on the first block); the series (sums rtol
   1e-6) and the trace on a shared site, the trace on path B's grid (the
   first block);
   K8 + K9 on path F's fleet (path F-H's producer and the fold, checked
   as K8+K9 above);
   a difference prints its size in bf16 ULP and the bf16 step it starts
   at, and fails; then K13 (``prng_impl='rbg'``, Philox4x32-10): the bits
   launch on 2**26 words from a key whose 128-bit counter carries,
   per-key bits, batched uniform and normal and init_state's rbg launches
   bit for bit; K2's rbg instantiation (init_state's launches, two
   blocks) bit for bit; the rbg block step on 2 daylight blocks x 65536
   chains (acc in the scan, scan2 and trace layouts, series, trace, the
   site grid, bf16 acc with telemetry light; the strided table set in
   float32 and bf16 on the first block; path F's fleet: its regime windows and K8+K9 at
   level full, the rbg producer and the fold checked as K8+K9 above on the noon
   block; the
   scenario epilogue at 16 rows); then K14
   (``prng_impl='unsafe_rbg'``: Philox key derivations, batched as jax's
   vmap batches them) bit for bit: K14 in K1 (init_state's unbatched and
   batched splits at 65536 chains, per-key splits, batched and scalar
   fold_in, init_state's keys with and without a chain slab); K2's
   unsafe_rbg instantiation (init_state's launches, two blocks, a block
   of path B's grid); the unsafe_rbg block step as K13's above, with the
   bf16 acc in every layout (scan2 and trace on the first block), and the scenario epilogue at 1, 4 and 16
   rows; then K12 in K10 (the bf16 scenario producer and the fold)
   against its plain bf16 version at 1, 4 and 16 rows, its two launches
   on their own as K10's; then K15 (metersim's block producer) bit for
   bit against its plain version on the card and on the host under
   threefry2x32, rbg and unsafe_rbg, at sec0 0, 600 and 85800 and a
   60-second block, then a day's 144 launches block for block, and the
   first three blocks at seed 7 against the JAX producer's (their SHA-256
   in ``tests/data/torch_port_reference.json``).  The plain scenario fold
   folds all
   of a block's rows at once over a leading row axis; then NaNs and
   signed zeros (``phase_nan``), each result NaN where its plain version
   has one and every zero of the plain version's sign: the NaN-keeping
   minimum, maximum and clamp on their own, K3 with fleet leaves that
   carry NaNs and signed zeros in float32 and bf16 (K12), K8 + K9 (the
   producer and the fold) on path F's fleet with such leaves, the
   scenario fold with NaN and signed-zero
   knobs, and the wide fold with both observers on a trace with NaN and
   signed-zero values;
5. the paths, every launch counter set to 0 just before each and read
   just after; each must launch every kernel it needs:
   R. reduce, shared site: ``run_reduced`` at 65536 chains x 86400 s,
      1080 s blocks (the main path of the first slice), then timed in 10
      pairs of alternating order against the first slice's loop;
   A. ensemble, shared site: ``run_ensemble``, 65536 chains x 86400 s;
   B. site-grid reduce: ``run_reduced`` over the 256 x 256 grid of
      ``--site-grid 47:55:256,6:15:256`` (65536 sites) x 86400 s;
   C. trace: ``run_blocks``, 65536 chains x 4320 s from 10:00, every
      chain's (65536, 1080) arrays gathered to the host;
   D. the CLI: ``pvsim OUT.csv --no-realtime --duration 86400 --start
      "2019-09-05 00:00:00"`` (1 chain, trace), 86400 rows plus a header;
   F. the fleet: ``run_reduced`` of ``FleetParams.synthetic(65536,
      seed=0)`` x 86400 s in 1080 s blocks with telemetry and analytics
      at level full (each block the acc producer, the observer fold and
      the collapses);
   G. the fleet CLI: ``pvsim OUT.csv --output reduce --fleet-synth 4096
      --analytics risk --duration 3600 --no-realtime --start "2019-09-05
      11:00:00" --run-report R.json`` (reduce mode needs --no-realtime);
   H. path F's fleet over 3 blocks from 11:00 with one observer
      instantiation each: none (H0, the fleet transforms alone),
      telemetry full (H8), analytics full (H9); the observers leave the
      statistics bit-identical;
   S. scenario serving with window batching: an in-process
      ``ScenarioServer`` on ``local://`` answering 16 ``ScenarioClient``s
      x 2 requests (reduce, fleet and quantiles modes, horizons 3600 s to
      86400 s) from a 65536-chain x 86400 s simulation in 1080 s blocks;
   S-c. the same requests with continuous batching: every reply
      byte-equal (as JSON) to path S's;
   R-T. path R with ``kernel_impl='table'`` (K11 in the per-chain
      physics only: the shared geometry is the host's, exact);
   B-L. path B with ``geom_stride=60, kernel_impl='table'`` (the levers'
      main path);
   F-L. path F with both levers;
   G-L. the CLI: ``pvsim OUT.csv --output reduce --site-grid
      47:55:64,6:15:64 --geom-stride 60 --kernel-impl table --duration
      3600 --no-realtime --start "2019-09-05 11:00:00" --run-report R``,
      whose precision section must name both levers;
   R-W. path R with ``block_impl='wide', stats_fusion='split'`` (the K4
      trace, then the wide fold): its statistics against path R's;
   A-W. path A with ``block_impl='wide'`` (the trace, then the wide
      series): its means against path A's;
   F-W. path F with ``block_impl='wide'``: the trace, then the wide fold
      with both observers; its statistics against path F's;
   R-K. path R with ``blocks_per_dispatch=8, block_impl='scan2',
      rng_batch='block'``: bit-identical to path R;
   G-W. the CLI: ``pvsim OUT.csv --output reduce --block-impl wide
      --blocks-per-dispatch 4 --chains 4096 --duration 3600 --no-realtime
      --start "2019-09-05 11:00:00" --run-report R``, whose report must
      pass the port's ``validate_report`` and whose plan must name the
      three knobs;
   R-H. path R with ``compute_dtype='bf16', telemetry_strict=True``:
      telemetry raised to light, the drift sentinel strict over all 80
      blocks (verdict ok);
   A-H. path A on the bf16 path; B-H path B, B-HL path B-L on it; F-H
      path F on it; C-H path C on it (the per-second paths' block means
      through a strict sentinel, as the reference checks reduce mode only);
   R-HW. path R-H with ``block_impl='wide'``: the K4 trace under bf16,
      then the wide fold with telemetry;
   G-H. the CLI: ``pvsim OUT.csv --output reduce --compute-dtype bf16
      --telemetry light --telemetry-strict --chains 4096 --duration 3600
      --no-realtime --start "2019-09-05 11:00:00" --run-report R``, whose
      report must validate and name bf16 and the sentinel's verdict;
   R-P. path R through the CLI with ``--prng-impl rbg``, its CSV's
      statistics checked as path R's; ``run_reduced`` under rbg timed
      against path R's in alternating pairs;
   R-U. path R under ``prng_impl='unsafe_rbg'`` through the Python API
      (``Simulation(SimConfig(prng_impl='unsafe_rbg')).run_reduced()``;
      the CLI offers no unsafe_rbg, as the JAX one), checked as path R's
      and timed against it in alternating pairs;
   S-H. path S's 32 requests served under ``compute_dtype='bf16'``, each
      reply's sums within 1 % of the field's scale of path S's; then the
      same requests at 4096 chains x two blocks against the plain bf16
      scenario, every reply within the engine tolerance;
   M. ``metersim_main`` over ``local://`` without realtime for a day
      (86400 s, seed 1) on the device producer, a subscriber counting:
      86400 messages in [0, 9000), equal to K15's plain stream, 144
      launches;
   SP. the streaming pair in one process over ``local://``: ``pvsim
      --backend asyncio``'s ``pvsim_main`` (seed 1) and ``metersim_main``
      (seed 2, device producer) from 2019-09-05 10:00 for 3600 s: at
      least 95 % of the seconds joined, every residual meter - pv, the
      meter column K15's plain stream (6 launches);
   SP-T. path SP over ``tcp://`` through a ``TcpFanoutBroker`` started
      in-process on port 0, for 600 s;
   the sharded phase (``tmhpvsim_torch.parallel``, after path H): (a)
      NCCL in a group of one, joined through the package's
      ``distributed.initialize``: R-N1 (path R's config through
      ``ShardedSimulation``: rows bit for bit and ``ensemble_stats``
      equal to path R's), A-N1 (path A's config over 4 blocks: means bit
      for bit against A's first 4 blocks), F-N1 (path F's fleet with both
      observers full over 4 blocks from 11:00) and F-NaN-N1 (2 blocks,
      NaN fleet leaves in chains past 32768) bit for bit against their
      unsharded runs; (b) the same four over two ranks on the one card
      (this script re-invoked as ``--sharded-rank R DIR``; gloo on CUDA
      tensors, as NCCL refuses two ranks on one device): R-2's rows bit
      for bit and its ``ensemble_stats`` within 1e-12 of path R's, A-2's
      means within rtol 1e-5 / atol 1e-3 of path A's, F-2's rows bit for
      bit, the observers' integers and extrema exact and their sums
      within 1e-5, the fleet summary's counts exact, F-NaN-2's NaN rows
      where the unsharded run's are and NaN winning MIN and MAX in
      ``ensemble_stats``; every rank must launch its path's kernels, and
      every all_reduce wrapper is timed per call in both topologies
      (CUDA events and the host's clock) with its bytes and its calls per
      block (the ``{"collectives": [...]}`` line before the kernels line);
   R-SL. path R under a plan with ``slab_chains=16384`` (four slabs run
      one after another): rows bit for bit against path R's, its wall
      against R's in 3 alternating pairs; path A under the same plan: the
      per-second means bit for bit against path A's (the slabs' per-CTA
      partials folded on the host in the order of one launch);
   R-CK. a checkpoint's host copy at path R's shape, waited for and
      enqueued; path R's loop in process with nothing, a synchronous save
      or the async writer after every block, 3 rounds in turns (the
      loop's added ms a block against the copy's); path R's config
      through the CLI with ``--checkpoint``: without checkpoints, with
      synchronous and with async saves (each CSV byte-equal to the first;
      the run reports' save counts and seconds); then per save mode the
      CLI as a process of its own with ``--preempt-grace 30``, sent
      SIGTERM once a generation past block 20 exists (async: the process
      held 4 ms in every 5 from its first write on, so that a writer
      stalled on the disk cannot let the loop end first): rc 0, the resume
      line and no CSV; the same command rerun writes the
      uninterrupted run's bytes;
   D-CK. path D as a process with ``--checkpoint``, SIGKILLed once its
      first checkpoint exists, then the same command rerun: path D's
      bytes, each row once;
   R-2CK. path R-2's two gloo ranks through ``pvsim(sharded=True,
      checkpoint=...)`` (this script re-invoked as ``--ck-rank R DIR``),
      stopped by SIGTERM once both have a generation past block 20; this
      process reassembles their files (``checkpoint.load_elastic``) and
      finishes the run: path R's rows bit for bit;
6. each kernel and its plain version timed with CUDA events at the main
   paths' shapes (the fleet kernels on path F's noon block; K11 and K6s
   on paths R-T's and B-L's noon blocks, the K10 row reset of
   continuous batching at 16 rows, the wide fold on paths R's and F's
   noon blocks (the acc-only fold with the library's ``sum`` / ``amax``
   / ``amin`` over the same arrays beside it, ``fold_library``) and the
   wide series on R's, with ``torch.sum(dim=1)`` beside it and
   ``part.sum(1)`` beside ``series_sum``, in turns; K12's
   instantiations that the bf16 paths launch on their noon blocks; K13's
   bits and the rbg windows and step that path R-P launches, with
   ``torch.rand`` beside the bits as a yardstick; K14's derivations, the
   unsafe_rbg windows and step that path R-U launches; K15 per launch,
   per synchronised launch and from a CUDA graph, ``torch.rand(600)``
   beside it as a yardstick; the acc producer
   and the observer fold of paths F, F-L and F-H each on its own, the
   fold's bound its 13 bytes a chain-second); every timed
   kernel's issue bound beside its bound (``bound``'s third value:
   int32 and float32 instructions on one issue rate); the site geometry
   modes' launches (K6, K7 with site geometry, K8 + K9, K6s, K12 site and
   fleet) beside their issue bounds (``print_geometry_timing``;
   ab_kernels.py times them against the parent tree in one call); every
   block-step row's registers, CTAs per SM and waves at 65536 chains
   (``add_shapes``; the observer fold's with its chain groups per CTA);
7. the port on the card at the JAX suite's ``small_config`` shape against
   the JAX package's results in ``tests/data/torch_port_reference.json``:
   reduce statistics, every per-second ensemble mean, chain 0's trace
   over the first hour and the site-grid reduce statistics (n_seconds
   exact, the rest rtol 2e-5 / atol 1e-2), and the fleet run's reduce
   statistics and fleet summary (counts within a few samples, quantiles
   within one sketch bin, other floats rtol 1e-4); and the same in the
   wide formulation: reduce statistics, the first half hour's ensemble
   means and the fleet run; and under bf16 (paths R-H's and F-H's
   configurations) the reduce statistics and the fleet run against the
   JAX package's bf16 runs; and under rbg and unsafe_rbg each
   formulation's reduce statistics and chain 0's trace against the JAX
   package's runs.

Each phase prints its seconds on a line of its own (``phase NAME: S
s``), and all of them once more as ``{"phase_s": {...}}`` after the
run's total.  Then the ``{"collectives": [...]}`` record (the library's
all_reduce, not a hand-written kernel: route ``library``); the line
before the card line is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

try:
    import torch

    from tmhpvsim_torch import kernels, rng
    from tmhpvsim_torch.config import SimConfig, SiteGrid
    from tmhpvsim_torch.engine.simulation import BlockInputs, Simulation
    from tmhpvsim_torch.fleet import FleetParams
    from tmhpvsim_torch.models import renewal
    from tmhpvsim_torch.models import tables as mtables
    from tmhpvsim_torch.kernels import block_step as k3
    from tmhpvsim_torch.kernels import build
    from tmhpvsim_torch.kernels import tables as k11
    from tmhpvsim_torch.kernels import threefry as k1
    from tmhpvsim_torch.kernels import wide as k4m
    from tmhpvsim_torch.kernels import windows as k2
    from tmhpvsim_torch.obs.report import validate_report
    from tmhpvsim_torch.serve import schema
    from tmhpvsim_torch.serve.schema import Scenario
except ImportError as _e:
    print(f"chip_smoke: FAIL: cannot import the port ({_e}); run it from a "
          "checkout of the repository", file=sys.stderr)
    sys.exit(1)

HERE = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3
#: bandwidth, float32 outside the tensor cores (an FMA counts 2), and
#: int32 (64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_I32 = 132 * 64 * 1.98e9

#: operation counts per item, read off the kernel sources: one threefry
#: hash (20 rounds of add/rotate/xor, 5 key injections) is 80 int32 ops;
#: one accurate libm transcendental (expf, logf, log1pf, acosf, cosf,
#: sinf, tanf, asinf, atan2f, fmodf) is counted as 16 float32 ops and
#: powf as 32
HASH_I = 80
TRANS_F = 16
POW_F = 32
#: XLA's erfinv + the normal's uniform: 30 float ops and XLA's log1p
#: (counted as one transcendental)
NORMAL_F = 30 + TRANS_F
UNIFORM_F = 4
#: K3 per chain-second outside the random draws: 5 table lerps, the second
#: noise, csi, the DISC / Hay-Davies / SAPM / Sandia chain (one expf, one
#: logf, ~110 float ops) and the statistics fold
K3_SECOND_F = 15 + 4 + 2 + 110 + 2 * TRANS_F + 12
K3_SECOND_I = 2 * HASH_I + 10
#: K3 per chain-minute: the four fold_in key derivations
K3_MINUTE_I = 4 * HASH_I
#: the series epilogue per chain-second: two 5-step butterflies (10 adds)
#: in place of the 12-op fold
SERIES_SECOND_F = K3_SECOND_F - 12 + 10
#: the trace epilogue per chain-second: no fold
TRACE_SECOND_F = K3_SECOND_F - 12
#: K6 on top of K3, split as the JAX function's work is: ``device_geometry``
#: maps over the site scalars only, so the site-independent half of the PSA
#: ephemeris (sinf/cosf of omega, the mean anomaly and the ecliptic
#: longitude, the obliquity terms, atan2f and fmodf for the right ascension,
#: asinf for the declination, fmodf for the sidereal time, cosf/sinf/tanf of
#: the declination: 15 transcendentals and ~35 float ops) is work per second
#: (the kernel's ``sun_time``, once per second and CTA; counted once per
#: second here, its least).  Per chain-second: the
#: site's hour angle, zenith, azimuth, refraction, Kasten-Young, Ineichen,
#: the csi cap and AOI (15 transcendentals, one powf, ~60 float ops) and the
#: physics terms the shared mode computes once per second (cosf, acosf, powf
#: and ~35 float ops)
K6_TIME_F = 15 * TRANS_F + 35
K6_SITE_SECOND_F = 17 * TRANS_F + 2 * POW_F + 95
#: K7 per chain-second: pv scale and clip, the demand multiply-add (2)
K7_SECOND_F = 4
#: K8 per chain-second: per field isfinite, the NaN test, 2 extrema, 2
#: selects, the sum and the sum of squares (an FMA, 2): 10 float32 ops x 4
#: fields, plus the csi bin (divide, 2 clamps, convert) and 3 int32 ops
#: per field for the counters, the covered count and the shared atomic
TEL_SECOND_F = 4 * 10 + 4
TEL_SECOND_I = 4 * 3 + 3
#: K9 per chain-second: the bin (subtract, multiply, 2 clamps, floor), 7
#: threshold compares, 2 extrema, the capacity compare, 3 ramp grids (a
#: select, |difference|, a max, 2 selects), 6 masked sums (select + add):
#: ~45 float32 ops; int32: the slot index, 3 shared atomics, the run
#: length and its 2 tests, 3 modulos, the use count: ~20
FLT_SECOND_F = 5 + 7 + 2 + 1 + 3 * 5 + 6 * 2 + 3
FLT_SECOND_I = 20

HEADLINE = dict(start="2019-09-05 00:00:00", duration_s=86400,
                n_chains=65536, seed=0, block_s=1080, output="reduce")
#: path B's grid: the JAX CLI's --site-grid "47:55:256,6:15:256" (Germany's
#: extent, tilt = latitude, azimuth 180, altitude 100 m, Europe/Berlin)
GRID_B = ((47, 55), (6, 15), 256, 256)
#: path C: shared-site trace, 4 blocks from 10:00
PATH_C = dict(HEADLINE, start="2019-09-05 10:00:00", duration_s=4320,
              output="trace")
#: path D: BASELINE config 1 through the CLI
PATH_D_ARGS = ["--no-realtime", "--duration", "86400", "--start",
               "2019-09-05 00:00:00"]
#: path G: the fleet CLI in reduce mode with analytics and a run report
PATH_G_SITES = 4096
PATH_G_ARGS = ["--output", "reduce", "--fleet-synth", str(PATH_G_SITES),
               "--analytics", "risk", "--duration", "3600", "--no-realtime",
               "--start", "2019-09-05 11:00:00"]
#: same-call pairs of path R's two loops (the first slice's, the lookahead)
LOOP_PAIRS = 10
#: the check blocks: two daylight blocks from 11:00
CHECK_START = "2019-09-05 11:00:00"
#: path F's fleet: FleetParams.synthetic(65536, seed=FLEET_SEED), the JAX
#: CLI's --fleet-synth 65536 (a Germany-like national fleet: 3 weather
#: regimes, 3 cohorts, ~30% inverter-clipped, per-site demand)
FLEET_SEED = 0
#: K9's check blocks use a lower capacity and a shorter run length than
#: the defaults (7200 W, 60 s), so that loss-of-load runs occur in them
K9_CAPACITY = 4000.0
K9_LOLP_K = 5
#: a cohort count whose histogram (64 x 2050 int32) exceeds the shared
#: memory budget: K9's global-atomics path
K9_MANY_COHORTS = 64
#: past ~24500 bins the residual histogram leaves shared memory
K9_WIDE_BINS = 30000
#: ten ascending exceedance thresholds [W]: past MAX_THR (8) the observer
#: and wide folds count the exceedance with atomics, not in registers
K9_MANY_THR = tuple(float(x) for x in range(-4000, 6000, 1000))
PATH_H_BLOCKS = 3
#: K10's check: the main path's noon block, one bucket of 16 rows
K10_BLOCK = 40
K10_B = 16
#: the fleet check's site selector (a chain of path F's fleet)
K10_FLEET_SITE = 12345
#: K10 after K3's step, read off the kernel, counting what the scenario
#: fold needs.  Per second: the duration compare and the tests of the two
#: ramp grids wider than 1 s (a modulo and a compare each), 5 int32 ops;
#: per (row, second) the horizon compare; per (row, chain) the site and
#: cohort selectors.  Per valid (row, chain, second) sample: the transform
#: (a multiply-add, a multiply, a min, the residual: 4), 3 sums and 3
#: extrema, the finite test, the bin (subtract, multiply, 2 clamps,
#: floor: 5), 7 threshold compares, 2 extrema and the capacity compare,
#: 26 float32 ops; int32: n_seconds, n_use, the bin index, 2 atomics, the
#: run length and its 2 tests, 8.  Per valid sample on a second of a ramp
#: grid (every second of the 1 s grid, one in w of the w-second grid):
#: |difference| (2) and a max, 3 float32 ops, and the seen flag
K10_SECOND_I, K10_ROW_SECOND_I, K10_ROW_CHAIN_I = 5, 1, 2
K10_VALID_F, K10_VALID_I = 26, 8
K10_GRID_F, K10_GRID_I = 3, 1
#: K10's wide sketches: 30000 bins still fit in the fold's shared memory
#: (one row per thread), 60000 leave it for global atomics; each check
#: runs the first K10_WIDE_ROWS check rows through the fold
K10_WIDE_BINS = 30000
K10_GLOBAL_BINS = 60000
K10_WIDE_ROWS = 6
#: ten ascending exceedance thresholds [W] (the default grid has seven)
K10_MANY_THR = range(-4000, 6000, 1000)
#: path S: the served simulation (the main path's), 16 clients x 2
#: requests, at most 16 per dispatch (the JAX CLI's serve default)
PATH_S = dict(HEADLINE)
PATH_S_CLIENTS = 16
PATH_S_PER_CLIENT = 2
PATH_S_WINDOW = 0.02
#: K11's check: seeded arguments per function over ARG_RANGES
K11_N = 1 << 20
#: the constant exponents powc takes on the path (Kasten-Young, Kasten 1966)
POWC_EXPONENTS = (-1.6364, -1.253)
#: the two precision levers, as their paths run them
LEVERS = dict(geom_stride=60, kernel_impl="table")
#: path G-L: the site-grid CLI with both levers and a run report
PATH_GL_SITES = 64 * 64
PATH_GL_ARGS = ["--output", "reduce", "--site-grid", "47:55:64,6:15:64",
                "--geom-stride", "60", "--kernel-impl", "table",
                "--duration", "3600", "--no-realtime", "--start",
                "2019-09-05 11:00:00"]
#: the strided mode's lerp per chain-second: 1 - f, then per field a
#: multiply and a multiply-add (8 fields)
LERP_SECOND_F = 1 + 8 * 3
#: path R-K: path R with the knobs that give its bits
KNOBS = dict(blocks_per_dispatch=8, block_impl="scan2", rng_batch="block")
#: path G-W: the CLI in the wide formulation, 4 blocks per dispatch
PATH_GW_CHAINS = 4096
PATH_GW_ARGS = ["--output", "reduce", "--block-impl", "wide",
                "--blocks-per-dispatch", "4", "--chains",
                str(PATH_GW_CHAINS), "--duration", "3600", "--no-realtime",
                "--start", "2019-09-05 11:00:00"]
#: the wide fold per chain-second, read off csrc/wide_fold.cu: the seven
#: statistics (the residual, the valid select, 3 multiplies and 3 adds, 3
#: extrema with their selects: 12 float32 ops; the duration compare and
#: n_seconds: 2 int32); with TEL K8's 10 float32 and 3 int32 ops per field
#: for meter, pv and residual; with FLT K9's, less the level-full
#: regime sums (3 masked sums: 6 float32 ops)
WIDE_SECOND_F, WIDE_SECOND_I = 12, 2
WIDE_TEL_SECOND_F, WIDE_TEL_SECOND_I = 3 * 10, 3 * 3
WIDE_FLT_SECOND_F, WIDE_FLT_SECOND_I = FLT_SECOND_F - 6, FLT_SECOND_I


def trans_f(name, ks):
    """Float32 ops of one call of a transcendental of the kernel set: the
    libm estimate (16, powf 32) for the exact set, the polynomial's own
    count (kernels/tables.py OPS, from csrc/tables.cuh) for the table
    set."""
    if ks == "table":
        return k11.OPS[name]
    return POW_F if name == "powc" else TRANS_F


def k3_second_f(ks):
    """K3 per chain-second outside the draws (one exp, one log)."""
    return K3_SECOND_F - 2 * TRANS_F + trans_f("exp", ks) + \
        trans_f("log", ks)


def phys_f(ks):
    """The physics terms per chain-second from a chain's geometry: cos of
    the zenith and of the apparent zenith, Kasten 1966 (cos, powc), acos
    of the AOI and ~35 float ops."""
    return 3 * trans_f("cos", ks) + trans_f("powc", ks) + \
        trans_f("arccos", ks) + 35


def geo_site_f(ks):
    """The site half of the geometry per chain and time point: the hour
    angle's cos and sin, acos and the parallax sin of the zenith, its cos,
    atan2 and fmod of the azimuth, the refraction's tan, Kasten-Young (cos,
    powc), Ineichen (cos, exp), the cap's 2 exp, the AOI's sin and cos;
    ~60 float ops."""
    return (5 * trans_f("cos", ks) + 3 * trans_f("sin", ks)
            + trans_f("arccos", ks) + trans_f("arctan2", ks) + TRANS_F
            + trans_f("tan", ks) + 3 * trans_f("exp", ks)
            + trans_f("powc", ks) + 60)


def geo_time_f(ks):
    """The time half of the geometry per time point: 5 sin, 4 cos, atan2,
    asin, tan and 2 fmod of the PSA ephemeris, ~35 float ops."""
    return (5 * trans_f("sin", ks) + 4 * trans_f("cos", ks)
            + trans_f("arctan2", ks) + trans_f("arcsin", ks)
            + trans_f("tan", ks) + 2 * TRANS_F + 35)


#: the JAX suite's small_config (tests/test_engine.py)
SMALL = dict(start="2019-09-05 10:00:00", duration_s=7200, n_chains=3,
             seed=7, block_s=3600)
#: the engine tolerance (tests/test_engine.py): rtol, atol
TOL = (2e-5, 1e-2)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def ulp_diff(a, b) -> int:
    ai = a.contiguous().view(torch.int32).to(torch.int64)
    bi = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ai - bi).abs().max()) if a.numel() else 0


def max_abs(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def close(a, b, rtol=TOL[0], atol=TOL[1]) -> bool:
    return bool(torch.allclose(a.double(), b.double(), rtol=rtol, atol=atol))


def time_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events), after one
    call to warm up; a single-rep timing (a plain version's, seconds long,
    whose functions the checks before it have run) is its one call."""
    if reps > 1:
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


def time_graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Mean device milliseconds of one ``fn()`` with ``reps`` of them
    launched back to back from one CUDA graph: no host work between the
    launches, so a launch of a few microseconds is timed, not its
    wrapper's Python."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * reps)


#: the issue bound's rate: int32 and float32 instructions charged to the
#: same 4 x 32 lanes per SM per clock (132 SMs, 1.98 GHz boost), an FMA
#: at its count of 2, as the operation bound counts it
PEAK_ISSUE = 132 * 4 * 32 * 1.98e9


def bound(int_ops: float, f32_ops: float, nbytes: float):
    """(least milliseconds, what bounds it, issue bound in milliseconds).

    The bound prices the int32 and float32 work each against its own peak
    and takes the larger, which hides the float work of a kernel whose
    int32 time is larger; the issue bound charges both to one issue rate
    (``PEAK_ISSUE``)."""
    times = {"operations": max(int_ops / PEAK_I32, f32_ops / PEAK_F32),
             "bytes": nbytes / PEAK_BYTES}
    by = max(times, key=times.get)
    return times[by] * 1e3, by, (int_ops + f32_ops) / PEAK_ISSUE * 1e3


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def clone(tree):
    return {k: v.clone() for k, v in tree.items()}


# ---------------------------------------------------------------------------


#: each phase's seconds in this run, in the order run
PHASE_S = {}


def timed(name, fn, *args, **kw):
    """Run one phase, print its seconds on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_S[name] = round(time.perf_counter() - t0, 1)
    print(f"phase {name}: {PHASE_S[name]:.1f} s", flush=True)
    return out


def phase_build():
    t0 = time.perf_counter()
    paths = build.build_all()
    for src in paths:
        build.library(src)
    print(f"build: {len(paths)} libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, path in paths.items():
        log = path[:-3] + ".log"
        if os.path.exists(log):
            for line in open(log):
                if ("registers" in line or "spill" in line
                        or "entry function" in line):
                    print(f"  {src}: {line.strip()}")


def phase_k1(dev):
    # the launches init_state makes, on the very keys it makes them on:
    # split(root, n_chains), the per-chain 5-way and 2-way splits and the
    # two scalar uniforms
    n = HEADLINE["n_chains"]
    root = rng.split(rng.key(HEADLINE["seed"]), 2)[0].to(dev)
    chains = k1.split(root, n)
    init = [("split(root, n)", chains, rng.split(root, n))]
    s5 = k1.split(chains, 5)
    init.append(("split(chains, 5)", s5, rng.split(chains, 5)))
    k_renew = s5[:, 2, :].contiguous()
    kr = k1.split(k_renew, 2)
    init.append(("split(k_renew, 2)", kr, rng.split(k_renew, 2)))
    for j in (0, 1):
        k = kr[:, j, :].contiguous()
        init.append((f"uniform(kr[{j}])", k1.uniform(k), rng.uniform(k, ())))
    torch.cuda.synchronize()
    for what, a, b in init:
        if not torch.equal(a, b):
            fail(f"K1 {what} at init_state's shape differs from the plain "
                 "version")
    print(f"K1 vs plain at init_state's launches ({n} chains): "
          f"{len(init)} launches bit-identical")

    keys = rng.split(rng.key(1234, device=dev), 1 << 20)
    idx = torch.arange(1 << 20, device=dev) * 7919
    errs = {}
    for op, kern, plain, exact in (
            ("split", lambda: k1.split(keys, 4), lambda: rng.split(keys, 4),
             True),
            ("fold_in", lambda: k1.fold_in(keys, idx),
             lambda: rng.fold_in(keys, idx), True),
            ("bits", lambda: k1.bits(keys, 60),
             lambda: rng.random_bits(keys, (60,)), True),
            ("uniform", lambda: k1.uniform(keys, 60),
             lambda: rng.uniform(keys, (60,)), True),
            ("normal", lambda: k1.normal(keys, 60),
             lambda: rng.normal(keys, (60,)), False)):
        a, b = kern(), plain()
        torch.cuda.synchronize()
        if exact:
            if not torch.equal(a, b):
                fail(f"K1 {op} differs from the plain version")
            errs[op] = 0.0
        else:
            u = ulp_diff(a, b)
            if u > 2:
                fail(f"K1 {op} differs from the plain version by {u} ULP")
            errs[op] = max_abs(a, b)
    print(f"K1 vs plain on 2^20 keys: split/fold_in/bits/uniform exact; "
          f"normal max abs {errs['normal']:.3g}")
    return max(errs.values())


def k2_held(label, args, regime=None, impl="threefry2x32"):
    """One K2 launch against its plain version on the same inputs: every
    table and the Markov carry bit for bit.  Returns the carry."""
    tk, ck = k2.sampler_windows(*args, regime=regime, impl=impl)
    tp, cp = k2.windows_plain(*args, regime=regime, impl=impl)
    torch.cuda.synchronize()
    for name in tk:
        if not torch.equal(tk[name], tp[name]):
            fail(f"{label}: table {name} differs from the plain version: "
                 f"max abs {max_abs(tk[name], tp[name])}")
    if not torch.equal(ck, cp):
        fail(f"{label}: the Markov carry differs from the plain version")
    return ck


#: K2's edge blocks: the first two 1080 s blocks from 23:45 (the first
#: across midnight: clear-day and windspeed values of two days; the
#: second's day windows start a day later), at 65536 - 37 chains (a
#: partial last CTA)
K2_EDGE = dict(HEADLINE, start="2019-09-05 23:45:00", n_chains=65536 - 37)


def phase_k2(dev):
    sim = Simulation(SimConfig(**HEADLINE), device=dev)
    state = sim.init_state()
    k_arr, k_min = state["k_arr"], state["k_min"]
    ones = torch.ones(sim.config.n_chains, dtype=torch.float32, device=dev)
    no_min = (torch.zeros(0, dtype=torch.int32, device=dev),
              torch.zeros(0, dtype=torch.float32, device=dev))

    # init_state's two launches (cc at hours 0-1 with ws0; the cloudy
    # pair), block 6 (the hour window moves on after it: the carry
    # advances), then two consecutive blocks so the Markov carry crosses
    # one
    k2_held("K2 init cc01/ws0", (k_arr, k_min, ones, ones,
                                 k2.Bounds(0, 2, 0, 0, 0, 0, 0, 1),
                                 *no_min))
    k2_held("K2 init cloudy pair", (k_arr, k_min, ones, state["cc0"],
                                    k2.Bounds(0, 0, 2, 0, 0, 0, 0, 0),
                                    *no_min))
    cc_carry = state["cc_carry"]
    b6 = sim.host_inputs(6).bounds
    if b6.hour_next_lo == b6.hour_lo:
        fail("K2: block 6 does not advance the Markov carry")
    for bi in (6, 40, 41):
        ins = sim.host_inputs(bi)
        cc_carry = k2_held(f"K2 block {bi}", (
            k_arr, k_min, cc_carry, state["cc0"], ins.bounds, ins.mh_idx,
            ins.mh_frac))
    # the edge blocks (the second under threefry only), under each key
    # implementation and with K7's regimes (path F's fleet: 65536 sites)
    n = K2_EDGE["n_chains"]
    edges = []
    for label, kw in (("K2", {}), ("K13 in K2", RBG), ("K14 in K2", URBG),
                      ("K7 regime", dict(fleet=fleet_f(),
                                         n_chains=HEADLINE["n_chains"]))):
        esim = rbg_sim(SimConfig(**dict(K2_EDGE, **kw)), dev)
        est = esim.init_state()
        regime = est["fleet"]["regime"] if esim._het_regime else None
        cc = est["cc_carry"]
        bounds = []
        for bi in ((0, 1) if not kw else (0,)):
            ins = esim.host_inputs(bi)
            cc = k2_held(f"{label} edge block {bi}", (
                est["k_arr"], est["k_min"], cc, est["cc0"], ins.bounds,
                ins.mh_idx, ins.mh_frac), regime, esim.plan.prng_impl)
            bounds.append(ins.bounds)
        edges.append(label)
        if not kw:
            b0, b1 = bounds
    if not (b0.n_cd and b0.n_days and b1.day_lo > b0.day_lo):
        fail(f"K2's edge blocks miss an edge case: {b0}, {b1}")
    shapes = {impl: k2.windows_attrs(impl, b0.n_hours)
              for impl in ("threefry2x32", "rbg", "unsafe_rbg")}
    print(f"K2 vs plain at {sim.config.n_chains} chains, init_state's 2 "
          f"launches and blocks 6, 40-41, and ({', '.join(edges)}) the "
          f"block from 23:45 across midnight (threefry also the next) at "
          f"{n} chains (the regimes at path F's 65536 sites): every table "
          f"and the carry bit-identical; launch shapes {shapes}")
    return 0.0


#: the lean step's edge block: the last hour of daylight, sunset in
#: its last minutes (seconds with and without clear-sky GHI), 65536 - 37
#: chains (a partial last CTA), the duration ending mid-tile and the wind
#: speeds x16, so that cycles last a few seconds: redraws in consecutive
#: seconds and in a tile's first and last second
EDGE = dict(HEADLINE, start="2019-09-05 18:50:00", n_chains=65536 - 37,
            block_s=3600)
EDGE_WS = 16.0
EDGE_DURATION = 3600 - 30


_EDGE = {}


def edge_block(dev):
    """``(cfg, sim, state, head, tilt, albedo, reached)`` of the edge
    block, its wind-speed table scaled by EDGE_WS (made once a run);
    ``reached`` counts its edge cases (``edge_reached``)."""
    if dev not in _EDGE:
        cfg = SimConfig(**EDGE)
        sim = Simulation(cfg, device=dev)
        state = sim.init_state()
        ins = sim.host_inputs(0)
        tables, _ = sim._windows(state, ins)
        tables = dict(tables, ws=tables["ws"] * EDGE_WS)
        tilt, alb, _ = sim.geometry_args(state)
        head = head_of(state, ins, tables)
        _EDGE[dev] = (cfg, sim, state, head, tilt, alb,
                      edge_reached(head, state["carry"]))
    return _EDGE[dev]


def edge_reached(head, carry):
    """Fail unless the edge block has redraws in tiles' first and last
    seconds and in consecutive seconds, and seconds with and without
    clear-sky GHI; returns the counts."""
    tables, rows_i, rows_f, k_scan, _ = head
    red = k3.redraws_plain(tables, rows_i, rows_f, k_scan, carry)
    ghi = rows_f[k3.ROWS_F.index("ghi_clear")]
    got = {"redraws": int(red.sum()), "first": int(red[0::60].sum()),
           "last": int(red[59::60].sum()),
           "consecutive": int((red[1:] & red[:-1]).sum()),
           "dark_s": int((ghi == 0).sum()), "T": int(ghi.numel())}
    if not (got["first"] and got["last"] and got["consecutive"]
            and 0 < got["dark_s"] < got["T"]):
        fail(f"the edge block misses an edge case: {got}")
    return got


def bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32) if a.dtype == torch.float32 else a,
        b.contiguous().view(torch.int32) if b.dtype == torch.float32 else b)


def phase_k3(dev):
    # the main path's shape (65536 chains x 1080 s), two daylight blocks
    cfg = SimConfig(**dict(HEADLINE, start="2019-09-05 11:00:00"))
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    acc_k = sim.init_reduce_acc()
    acc_p = {k: v.clone() for k, v in acc_k.items()}
    carry_k = {k: v.clone() for k, v in state["carry"].items()}
    carry_p = {k: v.clone() for k, v in state["carry"].items()}
    cc_carry = state["cc_carry"]
    site = cfg.site
    for bi in (0, 1):
        ins = sim.host_inputs(bi)
        tables, cc_carry = k2.sampler_windows(
            state["k_arr"], state["k_min"], cc_carry, state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac)
        common = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
                  state["k_meter"])
        tail = (cfg.duration_s, cfg.meter_max_w, site.surface_tilt,
                site.albedo)
        carry_k, acc_k = k3.block_step_acc(*common, carry_k, acc_k, *tail)
        carry_p, acc_p = k3.block_step_plain(*common, carry_p, acc_p, *tail)
    torch.cuda.synchronize()
    err = 0.0
    for name in acc_k:
        a, b = acc_k[name], acc_p[name]
        if name == "n_seconds":
            if not torch.equal(a, b):
                fail("K3 n_seconds differs from the plain version")
            continue
        if not torch.allclose(a, b, rtol=2e-5, atol=1e-2):
            fail(f"K3 {name} differs from the plain version: max abs "
                 f"{max_abs(a, b)}")
        err = max(err, max_abs(a, b))
    for name in carry_k:
        if not torch.allclose(carry_k[name], carry_p[name], rtol=1e-5,
                              atol=1e-3):
            fail(f"K3 renewal carry {name} differs from the plain version")
    same = int(sum(torch.equal(acc_k[k], acc_p[k]) for k in acc_k))
    print(f"K3 vs plain on 2 blocks x {cfg.n_chains} chains: max abs "
          f"{err:.3g} "
          f"({same}/7 statistics bit-identical)")
    if float(acc_k["pv_max"].max()) <= 10.0:
        fail("K3 check blocks saw no daylight")
    # the lean step's edges, bit for bit
    cfg, sim, state, head, tilt, alb, got = edge_block(dev)
    tail = (EDGE_DURATION, cfg.meter_max_w, tilt, alb)
    carry_k, acc_k = k3.block_step_acc(*head, clone(state["carry"]),
                                       sim.init_reduce_acc(), *tail)
    carry_p, acc_p = k3.block_step_plain(*head, clone(state["carry"]),
                                         sim.init_reduce_acc(), *tail)
    torch.cuda.synchronize()
    for what, a, b in (("statistics", acc_k, acc_p),
                       ("renewal carry", carry_k, carry_p)):
        for k in a:
            if not bits_equal(a[k], b[k]):
                fail(f"K3 edge block: {what} {k} differs from the plain "
                     f"version: max abs {max_abs(a[k], b[k])}")
    print(f"K3 vs plain on the edge block ({cfg.n_chains} chains, duration "
          f"ending mid-tile, wind x{EDGE_WS:g}: {got}): bit for bit")
    return err


def check_blocks(cfg, dev):
    """The two check blocks of ``cfg`` (from 11:00) with their K2 tables:
    ``(sim, state, [(inputs, tables), ...])``."""
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    cc_carry = state["cc_carry"]
    out = []
    for bi in (0, 1):
        ins = sim.host_inputs(bi)
        tables, cc_carry = k2.sampler_windows(
            state["k_arr"], state["k_min"], cc_carry, state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac, impl=sim.plan.prng_impl)
        out.append((ins, tables))
    return sim, state, out


def head_of(state, ins, tables):
    return (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"])


def phase_k4_series(dev):
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, output="ensemble"))
    sim, state, blocks = check_blocks(cfg, dev)
    tilt, alb, _ = sim.geometry_args(state)
    mw = cfg.meter_max_w
    carry_k, carry_p = clone(state["carry"]), clone(state["carry"])
    err = sum_err = f64_err = 0.0
    for ins, tables in blocks:
        head = head_of(state, ins, tables)
        again = clone(carry_k)
        carry_k, part = k3.series_partials_cuda(*head, carry_k, mw, tilt,
                                                alb)
        out = k3.series_sum(part)
        again, part2 = k3.series_partials_cuda(*head, again, mw, tilt, alb)
        out2 = k3.series_sum(part2)
        carry_p, m_p, p_p = k3.series_plain(*head, carry_p, mw, tilt, alb)
        torch.cuda.synchronize()
        if not (torch.equal(part, part2) and torch.equal(out, out2)
                and all(torch.equal(again[k], carry_k[k]) for k in again)):
            fail("K4 series: a second run on the same inputs is not "
                 "bit-identical")
        want = k3.series_sum_plain(part)
        if not torch.equal(out, want):
            fail(f"K4 series_sum differs from its plain version: max abs "
                 f"{max_abs(out, want)}")
        sum_err = max(sum_err, max_abs(out, want))
        # the plain version's strand order against a float64 sum
        ref = part.double().sum(1)
        if not close(want, ref, rtol=1e-6, atol=0.0):
            fail(f"K4 series_sum_plain is not within 1e-6 of the float64 "
                 f"sum: max abs {max_abs(want, ref)}")
        f64_err = max(f64_err, max_abs(want, ref))
        for what, a, b in (("meter", out[0], m_p), ("pv", out[1], p_p)):
            if not close(a, b, rtol=1e-6, atol=0.0):
                fail(f"K4 series {what} sums differ from the plain version: "
                     f"max abs {max_abs(a, b)}")
            err = max(err, max_abs(a, b))
        if float(out[1].max()) <= 10.0 * cfg.n_chains:
            fail("K4 series check blocks saw no daylight")
    for k in carry_k:
        if not torch.equal(carry_k[k], carry_p[k]):
            fail(f"K4 series renewal carry {k} differs from the plain "
                 "version")
    print(f"K4 series vs plain on 2 blocks x {cfg.n_chains} chains: per-"
          f"second sums within rtol 1e-6 (max abs {err:.3g} W), a second "
          f"run bit-identical; series_sum bit-identical to its plain "
          f"version (max abs {sum_err:.3g}), which is within max abs "
          f"{f64_err:.3g} W of the float64 sum")
    return err, sum_err


def phase_k4_trace(dev):
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, output="trace"))
    sim, state, blocks = check_blocks(cfg, dev)
    tilt, alb, _ = sim.geometry_args(state)
    mw = cfg.meter_max_w
    carry_k, carry_p = clone(state["carry"]), clone(state["carry"])
    carry_a, acc = clone(state["carry"]), sim.init_reduce_acc()
    sums = {"pv": 0.0, "meter": 0.0}
    err, same, total = 0.0, 0, 0
    for ins, tables in blocks:
        head = head_of(state, ins, tables)
        carry_k, mk, pk = k3.block_step_trace(*head, carry_k, mw, tilt, alb)
        carry_p, mp, pp = k3.trace_plain(*head, carry_p, mw, tilt, alb)
        carry_a, acc = k3.block_step_acc(*head, carry_a, acc,
                                         cfg.duration_s, mw, tilt, alb)
        torch.cuda.synchronize()
        if not torch.equal(mk, mp):
            fail(f"K4 trace meter differs from the plain version: max abs "
                 f"{max_abs(mk, mp)}")
        for what, a, b in (("pv", pk, pp), ("residual", mk - pk, mp - pp)):
            if not close(a, b):
                fail(f"K4 trace {what} differs from the plain version: max "
                     f"abs {max_abs(a, b)}")
            err = max(err, max_abs(a, b))
        same += int((pk == pp).sum())
        total += pk.numel()
        sums["pv"] = sums["pv"] + pk.double().sum(0)
        sums["meter"] = sums["meter"] + mk.double().sum(0)
        del mk, pk, mp, pp
    for k in carry_k:
        if not close(carry_k[k], carry_p[k], rtol=1e-5, atol=1e-3):
            fail(f"K4 trace renewal carry {k} differs from the plain version")
    for what in ("pv", "meter"):
        a, b = sums[what], acc[f"{what}_sum"]
        if not close(a, b, rtol=2e-5, atol=0.0):
            fail(f"K4 trace: per-chain sum of {what} over the trace differs "
                 f"from the acc kernel's {what}_sum: max abs {max_abs(a, b)}")
    print(f"K4 trace vs plain on 2 blocks x {cfg.n_chains} chains: meter "
          f"bit-identical, pv/residual max abs {err:.3g}; {same}/{total} pv "
          "values bit-identical; per-chain sums over the trace match the "
          "acc kernel's pv_sum/meter_sum to rtol 2e-5")
    # the lean step's edges, bit for bit
    cfg, sim, state, head, tilt, alb, got = edge_block(dev)
    carry_k, mk, pk = k3.block_step_trace(*head, clone(state["carry"]), mw,
                                          tilt, alb)
    carry_p, mp, pp = k3.trace_plain(*head, clone(state["carry"]), mw, tilt,
                                     alb)
    torch.cuda.synchronize()
    for what, a, b in (("meter", mk, mp), ("pv", pk, pp),
                       *((f"carry {k}", carry_k[k], carry_p[k])
                         for k in carry_k)):
        if not bits_equal(a, b):
            fail(f"K4 trace edge block: {what} differs from the plain "
                 f"version: max abs {max_abs(a, b)}")
    print(f"K4 trace vs plain on the edge block ({cfg.n_chains} chains, "
          f"wind x{EDGE_WS:g}: {got}): bit for bit")
    return err


#: the lean step's plain checks' edge block: the edge block's last half
#: hour (the same sunset seconds, with and without clear-sky GHI, at half
#: the depth the plain versions' time follows), at 8192 - 37 chains, the
#: duration ending mid-tile
LEAN_EDGE = dict(EDGE, start="2019-09-05 19:20:00", n_chains=8192 - 37,
                 block_s=1800)
LEAN_DURATION = 1800 - 30

#: the lean step's other instantiations on LEAN_EDGE, and LEAN_EDGE from a
#: start off a whole minute (the minute index then changes inside every
#: tile): (label, SimConfig fields)
LEAN_EDGES = (("off the minute", dict(start="2019-09-05 19:20:30")),
              ("table set", dict(kernel_impl="table")),
              ("rbg", dict(prng_impl="rbg")),
              ("unsafe_rbg", dict(prng_impl="unsafe_rbg")),
              ("bf16", dict(compute_dtype="bf16")),
              ("bf16 rbg", dict(compute_dtype="bf16", prng_impl="rbg")),
              ("bf16 unsafe_rbg", dict(compute_dtype="bf16",
                                       prng_impl="unsafe_rbg")))


#: the lean step's telemetry instantiations (shared site, acc with the
#: telemetry observer) checked on both edge blocks: float32 light and full
#: (one plain run at level full holds both: level light folds the same
#: leaves but the csi histogram and the occupancy), bf16 light (path
#: R-H's launch); (label, config fields, the levels the kernel runs)
LEAN_TEL = (("f32", dict(telemetry="full"), ("full", "light")),
            ("bf16", dict(compute_dtype="bf16", telemetry="light"),
             ("light",)))
#: the edge block on and off a whole minute
EDGE_STARTS = (("on the minute", LEAN_EDGE["start"]),
               ("off the minute", "2019-09-05 19:20:30"))


def lean_tel_edges(dev):
    """The acc launch with the telemetry observer (each LEAN_TEL case and
    level) on the edge block on and off the minute, against its plain
    version: the statistics, the renewal carry and every per-chain
    telemetry leaf bit for bit, the collapsed counts, extrema, csi
    histogram and occupancy bit for bit, the sums within 1e-6 of the
    float64 plain sums (a level-light launch against the level-full plain
    run on the leaves level light has)."""
    rel = 0.0
    for edge, start in EDGE_STARTS:
        runs = []
        for label, fields, levels in LEAN_TEL:
            cfg = SimConfig(**{**LEAN_EDGE, "start": start, **fields})
            sim = Simulation(cfg, device=dev)
            state = sim.init_state()
            ins = sim.host_inputs(0)
            tables, _ = sim._windows(state, ins)
            tables = dict(tables, ws=tables["ws"] * EDGE_WS)
            tilt, alb, _ = sim.geometry_args(state)
            head = head_of(state, ins, tables)
            obs = dataclasses.replace(sim.observers(state), per_chain=True)
            args = (LEAN_DURATION, cfg.meter_max_w, tilt, alb)
            cd = sim.plan.compute_dtype
            cp, ap, op = k3.block_step_obs_plain(
                *head, clone(state["carry"]), sim.init_reduce_acc(), *args,
                obs=obs, compute_dtype=cd)
            for level in levels:
                what = f"lean edge ({edge}, {label}, telemetry {level})"
                ck, ak, ok = k3.block_step_obs(
                    *head, clone(state["carry"]), sim.init_reduce_acc(),
                    *args, obs=dataclasses.replace(obs, telemetry=level),
                    compute_dtype=cd)
                torch.cuda.synchronize()
                check_same(f"{what} acc", ak, ap)
                check_same(f"{what} carry", ck, cp)
                # level light counts no occupancy
                chain = {k: v for k, v in op["telemetry_chain"].items()
                         if level == "full" or k != "occ_cov"}
                n_leaves = check_chain(what, ok["telemetry_chain"], chain)
                delta = {k: v for k, v in op["telemetry"].items()
                         if k in ok["telemetry"]}
                r, _ = check_sketch(f"{what} telemetry", ok["telemetry"],
                                    delta, _plain_sums(chain, TEL_SUMS))
                rel = max(rel, r)
                runs.append(f"{label} {level} ({n_leaves} per-chain leaves)")
        print(f"lean step with telemetry vs plain on the edge block ({edge},"
              f" {cfg.n_chains} chains from {start}, wind x{EDGE_WS:g}; "
              + ", ".join(runs) + "): statistics, carry, per-chain "
              "telemetry leaves, counts, extrema, csi histogram and "
              f"occupancy bit for bit; sums within {rel:.3g} of the float64 "
              "plain sums")


def phase_lean_edges(dev):
    """The acc, series and trace launches of each LEAN_EDGES case on its
    edge block against their plain versions: bit for bit (the series'
    per-CTA partials against ``series_partials_plain``), but for rbg
    keys, whose float32 values the card's K13 checks hold within the
    engine tolerance (``phase_k13_k3``): there the meter trace bit for
    bit, the rest within that tolerance and the series' sums within rtol
    1e-6 of the float64 plain sums; then the telemetry instantiations
    (``lean_tel_edges``)."""
    for label, fields in LEAN_EDGES:
        cfg = SimConfig(**dict(LEAN_EDGE, **fields))
        sim = Simulation(cfg, device=dev)
        state = sim.init_state()
        ins = sim.host_inputs(0)
        tables, _ = sim._windows(state, ins)
        tables = dict(tables, ws=tables["ws"] * EDGE_WS)
        tilt, alb, _ = sim.geometry_args(state)
        head = head_of(state, ins, tables)
        impl = sim.plan.prng_impl
        kw = dict(kernels=sim.plan.kernel_impl,
                  compute_dtype=sim.plan.compute_dtype, impl=impl)
        strict = impl != "rbg"
        mw, start = cfg.meter_max_w, state["carry"]
        red = k3.redraws_plain(tables, ins.rows_i, ins.rows_f,
                               state["k_scan"], start, impl=impl)
        m = ins.rows_i[3]
        got = {"first": int(red[0::60].sum()), "last": int(red[59::60].sum()),
               "consecutive": int((red[1:] & red[:-1]).sum()),
               "tiles with a minute change": int((m[0::60] != m[59::60])
                                                 .sum())}
        if not (got["first"] and got["last"] and got["consecutive"]):
            fail(f"the lean step's edge block ({label}) misses an edge "
                 f"case: {got}")
        if cfg.start.endswith(":30") and \
                got["tiles with a minute change"] != m.numel() // 60:
            fail(f"the edge block ({label}) has a tile within one minute")

        def carry_held(what, ck, cp):
            if strict:
                check_same(what, ck, cp)
            elif not all(close(ck[k], cp[k], rtol=1e-5, atol=1e-3)
                         for k in cp):
                fail(f"{what} differs from the plain version")

        ck, ak = k3.block_step_acc(*head, clone(start), sim.init_reduce_acc(),
                                   LEAN_DURATION, mw, tilt, alb, **kw)
        cp, ap = k3.block_step_plain(*head, clone(start),
                                     sim.init_reduce_acc(), LEAN_DURATION,
                                     mw, tilt, alb, **kw)
        torch.cuda.synchronize()
        if strict:
            check_same(f"lean edge ({label}) acc", ak, ap)
        else:
            rbg_acc_held(f"lean edge ({label}) acc", ak, ap)
        carry_held(f"lean edge ({label}) acc carry", ck, cp)
        ck, mk, pk = k3.block_step_trace(*head, clone(start), mw, tilt, alb,
                                         **kw)
        cp, mp, pp = k3.trace_plain(*head, clone(start), mw, tilt, alb, **kw)
        torch.cuda.synchronize()
        check_same(f"lean edge ({label}) trace meter", {"m": mk}, {"m": mp})
        if strict:
            check_same(f"lean edge ({label}) trace pv", {"p": pk}, {"p": pp})
        elif not close(pk, pp):
            fail(f"lean edge ({label}) trace pv differs from the plain "
                 f"version: max abs {max_abs(pk, pp)}")
        carry_held(f"lean edge ({label}) trace carry", ck, cp)
        ck, part = k3.series_partials_cuda(*head, clone(start), mw, tilt,
                                           alb, **kw)
        if strict:
            cp, want = k3.series_partials_plain(*head, clone(start), mw,
                                                tilt, alb, **kw)
            torch.cuda.synchronize()
            check_same(f"lean edge ({label}) series partials", {"p": part},
                       {"p": want})
        else:
            cp, m_p, p_p = k3.series_plain(*head, clone(start), mw, tilt,
                                           alb, **kw)
            out = k3.series_sum(part)
            torch.cuda.synchronize()
            for what, a, b in (("meter", out[0], m_p), ("pv", out[1], p_p)):
                if not close(a, b, rtol=1e-6, atol=0.0):
                    fail(f"lean edge ({label}) series {what} sums differ "
                         f"from the plain version: max abs {max_abs(a, b)}")
        carry_held(f"lean edge ({label}) series carry", ck, cp)
        print(f"lean step vs plain on the edge block ({label}, "
              f"{cfg.n_chains} chains from {cfg.start}, wind x{EDGE_WS:g}: "
              f"{got}): acc, trace and series "
              + ("bit for bit" if strict else
                 "within the rbg tolerance (series sums rtol 1e-6), the "
                 "meter bit for bit"))
    lean_tel_edges(dev)


def grid_b():
    return SiteGrid.regular(*GRID_B)


def phase_k6(dev):
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, site_grid=grid_b()))
    sim, state, blocks = check_blocks(cfg, dev)
    _, _, site = sim.geometry_args(state)
    mw = cfg.meter_max_w
    acc_k, acc_p = sim.init_reduce_acc(), sim.init_reduce_acc()
    carry_k, carry_p = clone(state["carry"]), clone(state["carry"])
    for ins, tables in blocks:
        head = head_of(state, ins, tables)
        carry_k, acc_k = k3.block_step_acc(*head, carry_k, acc_k,
                                           cfg.duration_s, mw, None, None,
                                           site=site)
        carry_p, acc_p = k3.block_step_plain(*head, carry_p, acc_p,
                                             cfg.duration_s, mw, None, None,
                                             site=site)
    torch.cuda.synchronize()
    err = 0.0
    for name in acc_k:
        a, b = acc_k[name], acc_p[name]
        if name == "n_seconds":
            if not torch.equal(a, b):
                fail("K6 n_seconds differs from the plain version")
            continue
        if not close(a, b):
            fail(f"K6 {name} differs from the plain version: max abs "
                 f"{max_abs(a, b)}")
        err = max(err, max_abs(a, b))
    for name in carry_k:
        if not close(carry_k[name], carry_p[name], rtol=1e-5, atol=1e-3):
            fail(f"K6 renewal carry {name} differs from the plain version")
    same = int(sum(torch.equal(acc_k[k], acc_p[k]) for k in acc_k))
    if float(acc_k["pv_max"].max()) <= 10.0:
        fail("K6 check blocks saw no daylight")
    # the geometry device function on its own, on the first 240 s
    rows = blocks[0][0].rows_f[:, :240].contiguous()
    got = k3.device_geometry_fields(rows, site)
    want = k3.geometry_fields_plain(rows, site)
    torch.cuda.synchronize()
    geo = {}
    for i, k in enumerate(k3.GEOM_FIELDS):
        w = want[i]
        d = (got[i].double() - w.double()).abs()
        if k == "azimuth":  # an angle: compare across the 2 pi seam
            d = torch.minimum(d, 2 * np.pi - d)
        rel = d / w.double().abs().clamp_min(1.0)
        if float(rel.max()) > 1e-5:
            fail(f"K6 geometry field {k} differs from the plain version: "
                 f"max abs {float(d.max())}")
        geo[k] = (float(d.max()), float((got[i] == w).double().mean()))
    print(f"K6 vs plain on 2 blocks x {cfg.n_chains} sites: max abs "
          f"{err:.3g} ({same}/7 statistics bit-identical); geometry fields "
          f"on 240 s x {cfg.n_chains} sites (max abs, share identical): "
          + ", ".join(f"{k} {a:.3g} {b:.3f}" for k, (a, b) in geo.items()))
    return err


# ---------------------------------------------------------------------------
# the fleet slice: K7 (regime gather, fleet transforms), K8, K9


_FLEET = {}


def fleet_f():
    """Path F's fleet, ``FleetParams.synthetic(65536, seed=0)`` (built once:
    the host sampler and its range checks take a few seconds)."""
    if "f" not in _FLEET:
        _FLEET["f"] = FleetParams.synthetic(HEADLINE["n_chains"],
                                            seed=FLEET_SEED)
    return _FLEET["f"]


def fleet_blocks(cfg, dev):
    """``check_blocks`` for a fleet: the two check blocks with their K2
    tables drawn from each chain's regime table."""
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    out = []
    for bi in (0, 1):
        ins = sim.host_inputs(bi)
        tables, cc_carry = sim._windows(state, ins)
        state = dict(state, cc_carry=cc_carry)
        out.append((ins, tables))
    return sim, state, out


def check_sketch(what, k, p, p64, tol=1e-6):
    """A collapsed delta ``k`` against the plain one ``p``: integer leaves
    and extrema bit-identical, float sums within ``tol`` (relative) of the
    plain float64 sums ``p64``.  Returns the largest (relative, absolute)
    error of the sums."""
    rel = err = 0.0
    for name, v in p.items():
        a, b = k[name], v
        if name in p64:
            want = p64[name]
            d = (a.double() - want).abs()
            e = float((d / want.abs().clamp_min(1e-30)).max())
            if e > tol:
                fail(f"{what} {name}: {e:.3g} from the float64 plain sum")
            rel, err = max(rel, e), max(err, float(d.max()))
        elif not torch.equal(a, b):
            fail(f"{what} {name} differs from the plain version")
    return rel, err


def check_chain(what, k, p):
    """Per-chain leaves of the kernel against the plain fold's, bit for
    bit, wherever both have the leaf."""
    shared = [n for n in k if n in p]
    for name in shared:
        if not torch.equal(k[name], p[name]):
            bad = int((k[name] != p[name]).sum())
            fail(f"{what} per-chain {name} differs from the plain fold at "
                 f"{bad} chains")
    return len(shared)


def same_out(a, b):
    return all(torch.equal(a[d][k], b[d][k]) for d in a if a[d] is not None
               for k in a[d])


def phase_k7(dev):
    fp = fleet_f()
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, fleet=fp))
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    regime = state["fleet"]["regime"]
    n = sim.config.n_chains
    counts = torch.bincount(regime.long(), minlength=3).tolist()
    if min(counts) == 0:
        fail(f"K7: the check fleet misses a regime ({counts})")
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    no_min = (torch.zeros(0, dtype=torch.int32, device=dev),
              torch.zeros(0, dtype=torch.float32, device=dev))
    err = 0.0
    cc_same = 0

    def check(what, *args):
        nonlocal err, cc_same
        tk, ck = k2.sampler_windows(*args, regime=regime)
        tp, cp = k2.windows_plain(*args, regime=regime)
        torch.cuda.synchronize()
        if not (torch.equal(tk["cc"], tp["cc"]) and torch.equal(ck, cp)):
            fail(f"K7 regime gather: the Markov window or carry differs "
                 f"from the plain version in {what}")
        cc_same += tk["cc"].numel()
        for name in tk:
            if not torch.equal(tk[name], tp[name]):
                fail(f"K7 regime gather: table {name} differs from the "
                     f"plain version in {what}: max abs "
                     f"{max_abs(tk[name], tp[name])}")
            err = max(err, max_abs(tk[name], tp[name]))
        return ck

    check("init cc01/ws0", state["k_arr"], state["k_min"], ones, ones,
          k2.Bounds(0, 2, 0, 0, 0, 0, 0, 1), *no_min)
    cc = state["cc_carry"]
    for bi in (0, 1):
        ins = sim.host_inputs(bi)
        cc = check(f"block {bi}", state["k_arr"], state["k_min"], cc,
                   state["cc0"], ins.bounds, ins.mh_idx, ins.mh_frac)
    # the regimes change the draws of every chain outside regime 0
    ins = sim.host_inputs(0)
    t0, _ = k2.sampler_windows(state["k_arr"], state["k_min"],
                               state["cc_carry"], state["cc0"], ins.bounds,
                               ins.mh_idx, ins.mh_frac)
    tr, _ = k2.sampler_windows(state["k_arr"], state["k_min"],
                               state["cc_carry"], state["cc0"], ins.bounds,
                               ins.mh_idx, ins.mh_frac, regime=regime)
    moved = (t0["cc"] != tr["cc"]).any(0)
    if bool(moved[regime == 0].any()) or \
            float(moved[regime != 0].double().mean()) < 0.9:
        fail("K7 regime gather: the regimes do not select the tables")
    print(f"K7 regime gather vs plain at {n} chains (regimes {counts}), "
          f"init_state's launch and 2 blocks: {cc_same} Markov values, "
          f"every other table and the carry bit-identical")
    # the transforms: acc (site geometry, the fleet's grid) and trace
    sim, state, blocks = fleet_blocks(cfg, dev)
    _, _, site = sim.geometry_args(state)
    fleet = sim.fleet_leaves(state)
    mw = cfg.meter_max_w
    acc_k, acc_p = sim.init_reduce_acc(), sim.init_reduce_acc()
    carry_k, carry_p = clone(state["carry"]), clone(state["carry"])
    for ins, tables in blocks:
        head = head_of(state, ins, tables)
        carry_k, acc_k = k3.block_step_acc(
            *head, carry_k, acc_k, cfg.duration_s, mw, None, None,
            site=site, fleet=fleet)
        carry_p, acc_p = k3.block_step_plain(
            *head, carry_p, acc_p, cfg.duration_s, mw, None, None,
            site=site, fleet=fleet)
    torch.cuda.synchronize()
    terr = 0.0
    for name in acc_k:
        a, b = acc_k[name], acc_p[name]
        if name == "n_seconds":
            if not torch.equal(a, b):
                fail("K7 n_seconds differs from the plain version")
            continue
        if not close(a, b):
            fail(f"K7 {name} differs from the plain version: max abs "
                 f"{max_abs(a, b)}")
        terr = max(terr, max_abs(a, b))
    same = int(sum(torch.equal(acc_k[k], acc_p[k]) for k in acc_k))
    ins, tables = blocks[0]
    head = head_of(state, ins, tables)
    _, mk, pk = k3.block_step_trace(*head, clone(state["carry"]), mw, None,
                                    None, site=site, fleet=fleet)
    _, mp, pp = k3.trace_plain(*head, clone(state["carry"]), mw, None, None,
                               site=site, fleet=fleet)
    torch.cuda.synchronize()
    if not torch.equal(mk, mp):
        fail(f"K7 trace meter differs from the plain version: max abs "
             f"{max_abs(mk, mp)}")
    if not close(pk, pp):
        fail(f"K7 trace pv differs from the plain version: max abs "
             f"{max_abs(pk, pp)}")
    limited = fleet.ac_limit_w < float("inf")
    if not bool((pk[:, limited] <= fleet.ac_limit_w[limited]).all()):
        fail("K7 trace: pv above an inverter limit")
    _, sk, qk = k3.block_step_series(*head, clone(state["carry"]), mw, None,
                                     None, site=site, fleet=fleet)
    _, sp, qp = k3.series_plain(*head, clone(state["carry"]), mw, None, None,
                                site=site, fleet=fleet)
    torch.cuda.synchronize()
    for what, a, b in (("meter", sk, sp), ("pv", qk, qp)):
        if not close(a, b, rtol=1e-6, atol=0.0):
            fail(f"K7 series {what} sums differ from the plain version: "
                 f"max abs {max_abs(a, b)}")
    print(f"K7 transforms vs plain on 2 blocks x {n} fleet sites (site "
          f"geometry): max abs {terr:.3g} ({same}/7 statistics "
          f"bit-identical); trace block: meter bit-identical, pv max abs "
          f"{max_abs(pk, pp):.3g}, every limited site within its limit; "
          f"series sums within rtol 1e-6 (max abs {max_abs(sk, sp):.3g} W)")
    return err, terr


def _plain_sums(chain, names, cohort=None, n_cohorts=0):
    """The float64 sums over chains of per-chain float leaves (grouped by
    cohort for ``cohort_sum_*``)."""
    out = {}
    for collapsed, leaf in names:
        v = chain[leaf].double()
        if collapsed.startswith("cohort_sum_"):
            out[collapsed] = torch.zeros(
                n_cohorts, dtype=torch.float64,
                device=v.device).index_add_(0, cohort.long(), v)
        else:
            out[collapsed] = v.sum()
    return out


def phase_k8(dev):
    fp = fleet_f()
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, fleet=fp,
                           telemetry="full"))
    sim, state, blocks = fleet_blocks(cfg, dev)
    _, _, site = sim.geometry_args(state)
    fleet = sim.fleet_leaves(state)
    mw, dur = cfg.meter_max_w, cfg.duration_s
    obs = k3.Observers(telemetry="full", per_chain=True)
    sums = [(f"{k}_{f}", f"{k}_{f}") for f in ("meter", "csi", "pv",
                                              "residual")
            for k in ("sum", "sumsq")]
    rel = err = 0.0
    n_leaves = 0
    for ins, tables in blocks:
        head = head_of(state, ins, tables)
        common = (cfg.duration_s, mw, None, None)
        _, acc_k, out_k = k3.block_step_obs(
            *head, clone(state["carry"]), sim.init_reduce_acc(), *common,
            site=site, fleet=fleet, obs=obs)
        _, _, out_2 = k3.block_step_obs(
            *head, clone(state["carry"]), sim.init_reduce_acc(), *common,
            site=site, fleet=fleet, obs=obs)
        _, acc_a = k3.block_step_acc(
            *head, clone(state["carry"]), sim.init_reduce_acc(), *common,
            site=site, fleet=fleet)
        _, _, out_p = k3.block_step_obs_plain(
            *head, clone(state["carry"]), sim.init_reduce_acc(), *common,
            site=site, fleet=fleet, obs=obs)
        torch.cuda.synchronize()
        if not same_out(out_k, out_2):
            fail("K8: a second run on the same inputs is not bit-identical")
        if not all(torch.equal(acc_k[k], acc_a[k]) for k in acc_k):
            fail("K8: the statistics differ from the acc kernel's")
        n_leaves = check_chain("K8", out_k["telemetry_chain"],
                               out_p["telemetry_chain"])
        p64 = _plain_sums(out_p["telemetry_chain"], sums)
        r, e = check_sketch("K8", out_k["telemetry"], out_p["telemetry"],
                            p64)
        rel, err = max(rel, r), max(err, e)
        if int(out_k["telemetry"]["csi_hist"].sum()) != \
                int((ins.rows_i[0] < dur).sum()) * cfg.n_chains:
            fail("K8: the csi histogram does not hold every chain-second")
    print(f"K8 vs plain on 2 blocks x {cfg.n_chains} fleet sites (site "
          f"geometry, level full): {n_leaves} per-chain leaves, counts, "
          f"extrema and the csi histogram bit-identical; float sums within "
          f"{rel:.3g} (relative; {err:.3g} absolute) of the float64 plain "
          "sums; a rerun bit-identical; the statistics equal the acc "
          "kernel's")
    return rel, err


def phase_k9(dev):
    fp = fleet_f()
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, fleet=fp,
                           analytics="full"))
    sim, state, blocks = fleet_blocks(cfg, dev)
    _, _, site = sim.geometry_args(state)
    fleet = sim.fleet_leaves(state)
    mw, n = cfg.meter_max_w, cfg.n_chains
    params = dataclasses.replace(sim._fleet_params, capacity_w=K9_CAPACITY,
                                 lolp_k=K9_LOLP_K)
    many = torch.arange(n, device=dev, dtype=torch.int32) % K9_MANY_COHORTS
    wide = dataclasses.replace(params, bins=K9_WIDE_BINS)
    many_thr = dataclasses.replace(params, thresholds=K9_MANY_THR)
    wide_thr = dataclasses.replace(wide, thresholds=K9_MANY_THR)
    own = state["fleet"]["cohort"], sim._n_cohorts
    nt = len(K9_MANY_THR)
    runs = (("3 cohorts, shared-memory histograms", *own, params,
             (True, True), "off"),
            (f"{K9_MANY_COHORTS} cohorts, global-atomics cohort histogram",
             many, K9_MANY_COHORTS, params, (True, False), "off"),
            (f"{K9_WIDE_BINS} bins, global-atomics residual, exceedance "
             "and cohort histograms", *own, wide, (False, False), "off"),
            (f"{nt} thresholds (exceedance by shared atomics) with "
             "telemetry full", *own, many_thr, (True, True), "full"),
            (f"{K9_WIDE_BINS} bins and {nt} thresholds (exceedance by "
             "global atomics)", *own, wide_thr, (False, False), "off"))
    if nt <= k3.MAX_THR:
        fail(f"K9: {nt} thresholds would count in registers")
    rel = err = 0.0
    report = []
    for j, (label, cohort, C, prm, paths, tel_level) in enumerate(runs):
        obs = k3.Observers(telemetry=tel_level, analytics="full", params=prm,
                           cohort=cohort, n_cohorts=C, per_chain=True)
        hist_bytes = 4 * (prm.bins + len(prm.thresholds) + 3)
        coh_bytes = 4 * C * (prm.bins + 2)
        if (hist_bytes <= k3.SMEM_MAX,
                hist_bytes + coh_bytes <= k3.SMEM_MAX) != paths:
            fail(f"K9: the {label} run would not take that path")
        sums = [(f"{k}_{f}", f"{k}_{f}") for f in ("meter", "pv", "residual")
                for k in ("sum", "cov_sum", "cohort_sum")]
        events = 0
        # the first run on both blocks, the other branches on the second
        for ins, tables in (blocks if j == 0 else blocks[-1:]):
            head = head_of(state, ins, tables)
            common = (cfg.duration_s, mw, None, None)
            _, _, out_k = k3.block_step_obs(
                *head, clone(state["carry"]), sim.init_reduce_acc(), *common,
                site=site, fleet=fleet, obs=obs)
            _, _, out_2 = k3.block_step_obs(
                *head, clone(state["carry"]), sim.init_reduce_acc(), *common,
                site=site, fleet=fleet, obs=obs)
            _, _, out_p = k3.block_step_obs_plain(
                *head, clone(state["carry"]), sim.init_reduce_acc(), *common,
                site=site, fleet=fleet, obs=obs)
            torch.cuda.synchronize()
            if not same_out(out_k, out_2):
                fail(f"K9 ({label}): a second run is not bit-identical")
            nl = check_chain(f"K9 ({label})", out_k["fleet_chain"],
                             out_p["fleet_chain"])
            if tel_level != "off":
                nl += check_chain(f"K9 ({label}) telemetry",
                                  out_k["telemetry_chain"],
                                  out_p["telemetry_chain"])
            p64 = _plain_sums(out_p["fleet_chain"], sums, cohort, C)
            r, e = check_sketch(f"K9 ({label})", out_k["fleet"],
                                out_p["fleet"], p64)
            rel, err = max(rel, r), max(err, e)
            d = out_k["fleet"]
            total = int(d["count"])
            for leaf in ("res_hist", "exceed", "cohort_count", "cohort_hist"):
                if int(d[leaf].sum()) != total:
                    fail(f"K9 ({label}): {leaf} does not hold every sample")
            if len(prm.thresholds) > k3.MAX_THR and \
                    int((d["exceed"] > 0).sum()) < 3:
                fail(f"K9 ({label}): the samples fill fewer than 3 "
                     "exceedance slots")
            events += int(d["lol_events"])
        if events == 0:
            fail(f"K9 ({label}): the check blocks saw no loss-of-load run")
        report.append(f"{label}: {nl} per-chain leaves, every count, "
                      f"histogram and extremum bit-identical, {events} LOLP "
                      "events")
    print(f"K9 vs plain on 2 blocks x {n} fleet sites (the runs past the "
          f"first on the second; site geometry, level full, capacity "
          f"{K9_CAPACITY} W, lolp_k {K9_LOLP_K}): "
          + "; ".join(report) + f"; float sums within {rel:.3g} "
          f"(relative; {err:.3g} absolute) of the float64 plain sums; "
          "reruns bit-identical")
    return rel, err


def index_order(part, kinds):
    """The collapse's plain fold on the host: the per-CTA rows combined in
    index order, sums in float64 (python floats), by kind."""
    rows = part.cpu().tolist()
    out = list(rows[0])
    for row in rows[1:]:
        out = [x + y if k == 0 else (min(x, y) if k == 1 else max(x, y))
               for x, y, k in zip(out, row, kinds)]
    return torch.tensor(out, dtype=torch.float64)


def check_collapse(sets):
    """The grouped collapse on row sets ``{name: (part, kinds)}`` (kinds:
    one period that repeats over the leaves), all of them in one
    ``collapse_group`` launch: each set bit for bit against the host's
    index-order fold, and within 1e-12 of the rows' absolute sum from
    collapse_plain.  Returns the largest (absolute, relative) difference
    from collapse_plain."""
    err = rel = 0.0
    names = list(sets)
    launches = k3.COLLAPSE.launches
    outs = k3.collapse_group([sets[k] for k in names])
    torch.cuda.synchronize()
    if k3.COLLAPSE.launches != launches + 1:
        fail(f"collapse of {', '.join(names)}: not one launch")
    for name, got in zip(names, outs):
        part, kinds = sets[name]
        kinds = tuple(kinds) * (part.shape[1] // len(kinds))
        plain = k3.collapse_plain(part, kinds)
        if not torch.equal(got.cpu(), index_order(part, kinds)):
            fail(f"collapse of {name}: not the index-order fold")
        d = (got - plain).abs()
        scale = part.abs().sum(0)
        if bool((d > 1e-12 * scale).any()):
            fail(f"collapse of {name}: {float(d.max()):.3g} from the plain "
                 "version")
        err = max(err, float(d.max()))
        rel = max(rel, float((d / scale.clamp_min(1e-300)).max()))
    return err, rel


def obs_row_sets(partials):
    """The observers' per-CTA row sets (``out["partials"]``) with their
    kinds, as ``check_collapse`` takes them."""
    return {k: (v, k3.PART_KINDS[k]) for k, v in partials.items()}


def collapse_inputs(fn):
    """``(fn(), sets)``: ``fn``'s result and the row sets its collapses
    were given (``k3.collapse_group`` recorded while ``fn`` runs)."""
    seen = []
    grouped = k3.collapse_group

    def spy(sets):
        sets = [(part, tuple(kinds)) for part, kinds in sets]
        seen.append({f"set {i}": s for i, s in enumerate(sets)})
        return grouped(sets)

    k3.collapse_group = spy
    try:
        out = fn()
    finally:
        k3.collapse_group = grouped
    return out, seen


#: the observer checks' blocks of path F's day: the night block (00:00)
#: and the noon block (12:00), 1080 s each
OBS_BLOCKS = (("night", 0), ("noon", 40))


def phase_k89(dev, levers=None, label="K8+K9", path=None,
              blocks=OBS_BLOCKS):
    """K8 and K9 on path F's config (both observers at level full with the
    fleet's own cohorts), on its night and noon blocks (``blocks``): the
    acc producer
    (``obs_producer``) against its plain version (statistics, carry,
    meter, csi and covered bit for bit, pv bit for bit or to the engine
    tolerance) and the acc kernel's statistics; the observer fold
    (``obs_fold``) on the producer's own arrays against its plain version
    (per-chain leaves, counts, extrema and histograms bit for bit, sums
    within 1e-6 of the float64 plain sums, a rerun bit-identical); the
    path's entry (``block_step_obs``: both launches) equal to the two on
    their own; then the collapse on the fold's partial rows.  ``levers``:
    the precision levers, the compute dtype or the key implementation
    (paths F-L's, F-H's, R-P's and R-U's instantiations), ``path``: the
    path named."""
    fp = fleet_f()
    cfg = SimConfig(**dict(HEADLINE, fleet=fp, telemetry="full",
                           analytics="full", **(levers or {})))
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    ks, cd = sim.plan.kernel_impl, sim.plan.compute_dtype
    impl = sim.plan.prng_impl
    _, _, site = sim.geometry_args(state)
    fleet = sim.fleet_leaves(state)
    obs = dataclasses.replace(sim.observers(state), per_chain=True)
    C = obs.n_cohorts
    tel_sums = [(f"{k}_{f}", f"{k}_{f}") for f in ("meter", "csi", "pv",
                                                  "residual")
                for k in ("sum", "sumsq")]
    flt_sums = [(f"{k}_{f}", f"{k}_{f}") for f in ("meter", "pv",
                                                  "residual")
                for k in ("sum", "cov_sum", "cohort_sum")]
    rel = err = c_err = c_rel = pv_err = 0.0
    n_leaves = pv_same = pv_all = 0
    dur, mw = cfg.duration_s, cfg.meter_max_w
    for bname, bi in blocks:
        ins = sim.host_inputs(bi)
        tables, _ = sim._windows(state, ins)
        head = head_of(state, ins, tables)
        t = ins.rows_i[0]
        kw = dict(site=site, fleet=fleet, kernels=ks, compute_dtype=cd,
                  impl=impl)
        what = f"{label} ({bname} block)"
        ck, ak, pk = k3.obs_producer(*head, clone(state["carry"]),
                                     sim.init_reduce_acc(), dur, mw, None,
                                     None, obs=obs, **kw)
        cp, ap, pp = k3.obs_producer_plain(*head, clone(state["carry"]),
                                           sim.init_reduce_acc(), dur, mw,
                                           None, None, **kw)
        _, aa = k3.block_step_acc(*head, clone(state["carry"]),
                                  sim.init_reduce_acc(), dur, mw, None, None,
                                  **kw)
        torch.cuda.synchronize()
        for name in ck:
            if not torch.equal(ck[name], cp[name]):
                fail(f"{what}: the producer's carry {name} differs from "
                     "the plain version")
        for name in ak:
            if not torch.equal(ak[name], aa[name]):
                fail(f"{what}: the producer's {name} differs from the acc "
                     "kernel's")
            if not close(ak[name], ap[name]):
                fail(f"{what}: the producer's {name} differs from the "
                     f"plain version: max abs {max_abs(ak[name], ap[name])}")
        if not torch.equal(pk["meter"], pp["meter"]):
            fail(f"{what}: the producer's meter differs from the plain "
                 "version")
        if not torch.equal(pk["csi"], pp["csi"]):
            fail(f"{what}: the producer's csi differs from the plain "
                 "version")
        if not torch.equal(pk["covered"], pp["covered"].to(torch.uint8)):
            fail(f"{what}: the producer's covered flags differ from the "
                 "plain version")
        if not close(pk["pv"], pp["pv"]):
            fail(f"{what}: the producer's pv differs from the plain "
                 f"version: max abs {max_abs(pk['pv'], pp['pv'])}")
        pv_same += int((pk["pv"] == pp["pv"]).sum())
        pv_all += pk["pv"].numel()
        pv_err = max(pv_err, max_abs(pk["pv"], pp["pv"]))
        # the fold, on the producer's own arrays
        out_k = k3.obs_fold(pk, t, dur, obs)
        out_2 = k3.obs_fold(pk, t, dur, obs)
        out_p = k3.obs_fold_plain(dict(pk, covered=pk["covered"].bool()),
                                  t, dur, obs)
        _, ae, out_e = k3.block_step_obs(*head, clone(state["carry"]),
                                         sim.init_reduce_acc(), dur, mw,
                                         None, None, obs=obs, **kw)
        torch.cuda.synchronize()
        if not same_out(out_k, out_2):
            fail(f"{what}: a second fold of the same arrays is not "
                 "bit-identical")
        if not same_out(out_e, out_k) or \
                not all(torch.equal(ae[k], ak[k]) for k in ak):
            fail(f"{what}: block_step_obs differs from the producer and "
                 "the fold on their own")
        n_leaves = check_chain(what, out_k["telemetry_chain"],
                               out_p["telemetry_chain"]) + \
            check_chain(what, out_k["fleet_chain"], out_p["fleet_chain"])
        for d, sums in (("telemetry", tel_sums), ("fleet", flt_sums)):
            p64 = _plain_sums(out_p[f"{d}_chain"], sums, obs.cohort, C)
            r, e = check_sketch(f"{what} {d}", out_k[d], out_p[d], p64)
            rel, err = max(rel, r), max(err, e)
        total = int(out_k["fleet"]["count"])
        if int(out_k["telemetry"]["csi_hist"].sum()) != total or total != \
                int((t < dur).sum()) * cfg.n_chains:
            fail(f"{what}: the csi histogram or the sketch misses samples")
        for leaf in ("res_hist", "exceed", "cohort_count", "cohort_hist"):
            if int(out_k["fleet"][leaf].sum()) != total:
                fail(f"{what}: {leaf} does not hold every sample")
        e, r = check_collapse(obs_row_sets(out_k["partials"]))
        c_err, c_rel = max(c_err, e), max(c_rel, r)
    mode = "site" if site.stride <= 1 else "strided"
    names = " and ".join(b for b, _ in blocks)
    print(f"{label} vs plain on path {path or ('F-L' if levers else 'F')}'s "
          f"{names} block(s) x {cfg.n_chains} fleet sites ({mode} "
          f"geometry, {ks} set, {cd}, {impl}, both level full, {C} "
          "cohorts): the producer's statistics (the acc kernel's), carry, "
          f"meter, csi and covered flags bit-identical, pv {pv_same}/"
          f"{pv_all} bit-identical (max abs {pv_err:.3g}); the fold on its "
          f"arrays: {n_leaves} per-chain leaves, counts, extrema and "
          f"histograms bit-identical, float sums within {rel:.3g} "
          f"(relative; {err:.3g} absolute) of the float64 plain sums, a "
          "rerun bit-identical; block_step_obs equal to the two launches")
    print(f"collapse on {label}'s per-group rows "
          f"({', '.join(out_k['partials'])} in one launch; {len(blocks)} "
          "block(s)): bit-identical to the "
          f"host's index-order float64 fold; max abs {c_err:.3g} (relative "
          f"{c_rel:.3g}) from collapse_plain")
    return (rel, err), (c_rel, c_err)


def run_path(name, need, fn):
    """Drive one path with every counter at 0 before; returns
    ``(result, wall seconds, launches)``."""
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    for k in need:
        if launches[k] == 0:
            fail(f"path {name} never launched {k}")
    return out, wall, {k: v for k, v in launches.items() if v}


def check_reduced(name, reduced, duration_s):
    if not (reduced["n_seconds"] == duration_s).all():
        fail(f"path {name}: n_seconds != duration for some chain")
    for k, v in reduced.items():
        if not np.isfinite(v).all():
            fail(f"path {name}: non-finite {k}")
    pv_max = float(reduced["pv_max"].max())
    if pv_max <= 10.0:
        fail(f"path {name}: fleet pv_max {pv_max} W: no daylight generation")
    return pv_max


def phase_path_r(dev):
    cfg = SimConfig(**HEADLINE)
    sim = Simulation(cfg, device=dev)
    reduced, wall, launches = run_path(
        "R", ("threefry_fill", "sampler_windows", "block_step"),
        sim.run_reduced)
    pv_max = check_reduced("R", reduced, cfg.duration_s)
    rate = cfg.n_chains * cfg.duration_s / wall
    print(f"path R (reduce, shared site): {cfg.n_chains} chains x "
          f"{cfg.duration_s} s in {sim.n_blocks} blocks: {wall:.3f} s wall "
          f"(the first slice's loop: 0.256 s on an H100 80GB HBM3 at 700 W), "
          f"{rate:.6g} site-s/s (incl. init and host inputs); fleet pv_max "
          f"{pv_max:.2f} W; all chains n_seconds={cfg.duration_s}; launches "
          f"{launches}")
    print(f"ensemble: {json.dumps(sim.ensemble_stats())}")
    # the same run through the first slice's loop (each block's inputs
    # computed at the top of the loop and copied from pageable memory)
    # against run_reduced's lookahead loop, in 10 pairs whose order
    # alternates: first/lookahead, lookahead/first, ...
    kinds = ("first slice's loop", "lookahead")
    walls = {k: [] for k in kinds}
    for pair in range(LOOP_PAIRS):
        for kind in (kinds if pair % 2 == 0 else kinds[::-1]):
            s = Simulation(cfg, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "lookahead":
                s.run_reduced()
            else:
                first_slice_loop(s, dev)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
    print(f"path R loops, same card, {LOOP_PAIRS} alternating pairs: " +
          "; ".join(f"{k} median {np.median(v):.4f} s, min {min(v):.4f}, "
                    f"max {max(v):.4f} ("
                    + ", ".join(f"{w:.4f}" for w in v) + ")"
                    for k, v in walls.items()))
    return sim, launches, reduced, wall


def first_slice_loop(sim, dev):
    """``run_reduced`` as the first slice ran it: inputs computed inline,
    copied synchronously from pageable memory."""
    state, acc = sim.init_state(), sim.init_reduce_acc()
    for bi in range(sim.n_blocks):
        h = sim.host_arrays(bi)
        ins = BlockInputs(h.bounds, *(torch.from_numpy(a).to(dev) for a in (
            h.mh_idx, h.mh_frac, h.rows_i, h.rows_f)), h.epoch)
        state, acc = sim.step_acc(state, ins, acc)
    return acc


def phase_path_a(dev):
    cfg = SimConfig(**dict(HEADLINE, output="ensemble"))
    sim = Simulation(cfg, device=dev)

    means = ([], [])

    def run():
        rows, pv_max, n_blocks = 0, 0.0, 0
        for blk in sim.run_ensemble():
            if blk.pv.shape != (1, cfg.block_s) or \
                    blk.meter.dtype != np.float32:
                fail(f"path A: block of shape {blk.pv.shape}")
            for k in ("meter", "pv", "residual"):
                if not np.isfinite(getattr(blk, k)).all():
                    fail(f"path A: non-finite {k}")
            rows += blk.pv.shape[1]
            n_blocks += 1
            pv_max = max(pv_max, float(blk.pv.max()))
            means[0].append(blk.meter[0])
            means[1].append(blk.pv[0])
        return rows, pv_max, n_blocks

    (rows, pv_max, n_blocks), wall, launches = run_path(
        "A", ("threefry_fill", "sampler_windows", "block_step_series",
              "series_sum"), run)
    if rows != cfg.duration_s or n_blocks != sim.n_blocks:
        fail(f"path A: {rows} rows in {n_blocks} blocks")
    if pv_max <= 10.0:
        fail(f"path A: fleet-mean pv max {pv_max} W: no daylight")
    print(f"path A (ensemble, shared site): {cfg.n_chains} chains x "
          f"{cfg.duration_s} s in {n_blocks} blocks: {wall:.3f} s wall, "
          f"{cfg.n_chains * cfg.duration_s / wall:.6g} site-s/s; "
          f"{rows} fleet-mean rows; fleet-mean pv max {pv_max:.3f} W; "
          f"launches {launches}")
    return launches, tuple(np.concatenate(m) for m in means)


def phase_path_b(dev):
    grid = grid_b()
    cfg = SimConfig(**dict(HEADLINE, site_grid=grid))
    sim = Simulation(cfg, device=dev)
    reduced, wall, launches = run_path(
        "B", ("threefry_fill", "sampler_windows", "block_step_site"),
        sim.run_reduced)
    n = sim.config.n_chains
    if n != GRID_B[2] * GRID_B[3] or len(reduced["pv_sum"]) != n:
        fail(f"path B ran {n} sites")
    pv_max = check_reduced("B", reduced, cfg.duration_s)
    # the grid spans 8 degrees of longitude: the east sees noon earlier
    print(f"path B (site-grid reduce, {GRID_B[2]}x{GRID_B[3]} sites over "
          f"{GRID_B[0]} N x {GRID_B[1]} E): {n} sites x {cfg.duration_s} s "
          f"in {sim.n_blocks} blocks: {wall:.3f} s wall, "
          f"{n * cfg.duration_s / wall:.6g} site-s/s; fleet pv_max "
          f"{pv_max:.2f} W; all sites n_seconds={cfg.duration_s}; "
          f"pv_sum over sites min/max {float(reduced['pv_sum'].min()):.4g}/"
          f"{float(reduced['pv_sum'].max()):.4g} Ws; launches {launches}")
    return launches


def phase_path_c(dev):
    cfg = SimConfig(**PATH_C)
    sim = Simulation(cfg, device=dev)

    def run():
        secs, pv_max = 0, 0.0
        for blk in sim.run_blocks():
            shape = (cfg.n_chains, cfg.block_s)
            for k in ("meter", "pv", "residual"):
                a = getattr(blk, k)
                if a.shape != shape or not np.isfinite(a).all():
                    fail(f"path C: {k} of shape {a.shape} or not finite")
            if (blk.pv < 0).any():
                fail("path C: negative pv")
            secs += blk.pv.shape[1]
            pv_max = max(pv_max, float(blk.pv.max()))
        return secs, pv_max

    (secs, pv_max), wall, launches = run_path(
        "C", ("threefry_fill", "sampler_windows", "block_step_trace"), run)
    if secs != cfg.duration_s:
        fail(f"path C: {secs} seconds of trace")
    if pv_max <= 10.0:
        fail(f"path C: pv max {pv_max} W: no daylight")
    gb = 2 * cfg.n_chains * cfg.duration_s * 4 / 1e9
    print(f"path C (trace, shared site): {cfg.n_chains} chains x "
          f"{cfg.duration_s} s in {sim.n_blocks} blocks gathered to the host "
          f"({gb:.2f} GB of meter and pv): {wall:.3f} s wall incl. the "
          f"host's residual and checks, "
          f"{cfg.n_chains * cfg.duration_s / wall:.6g} site-s/s; pv max "
          f"{pv_max:.2f} W; launches {launches}")
    return launches


def phase_path_d():
    from tmhpvsim_torch.cli import main as cli

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "path_d_trace.csv")
    try:
        rc, wall, launches = run_path(
            "D", ("threefry_fill", "sampler_windows", "block_step_trace"),
            lambda: cli(["pvsim", out] + PATH_D_ARGS))
        if rc != 0:
            fail(f"path D: the CLI returned {rc}")
        with open(out, "rb") as f:
            data = f.read()
        lines = data.decode().splitlines()
    finally:
        if os.path.exists(out):
            os.remove(out)
    if lines[0] != "time,meter,pv,residual load" or len(lines) != 86401:
        fail(f"path D: {len(lines)} lines, header {lines[0]!r}")
    first, last = lines[1].split(","), lines[-1].split(",")
    if first[0] != "2019-09-05 00:00:00" or last[0] != "2019-09-05 23:59:59":
        fail(f"path D: time column runs {first[0]} .. {last[0]}")
    pv = np.asarray([float(x.split(",")[2]) for x in lines[1:]])
    if not np.isfinite(pv).all() or pv.max() <= 10.0:
        fail("path D: pv column not finite or no daylight")
    print(f"path D (CLI trace, 1 chain x 86400 s): {wall:.3f} s wall incl. "
          f"writing the CSV; {len(lines) - 1} rows plus the header, "
          f"{first[0]} .. {last[0]}; pv max {pv.max():.2f} W; launches "
          f"{launches}")
    return launches, data


def phase_path_f(dev):
    fp = fleet_f()
    cfg = SimConfig(**dict(HEADLINE, fleet=fp, telemetry="full",
                           analytics="full"))
    sim = Simulation(cfg, device=dev)
    # the wall ends with the run total on the host, as a user reads it
    (reduced, summary), wall, launches = run_path(
        "F", ("threefry_fill", "sampler_windows", "sampler_windows_regime",
              "block_step_prod_site", "block_step_fleet",
              "block_step_tel_analytics", "obs_fold", "chainwise_collapse"),
        lambda: (sim.run_reduced(), sim.fleet_summary()))
    n = sim.config.n_chains
    pv_max = check_reduced("F", reduced, cfg.duration_s)
    total = n * cfg.duration_s
    if summary["count"] != total or \
            sum(c["count"] for c in summary["cohorts"]) != total or \
            summary["regimes"]["covered"]["seconds"] + \
            summary["regimes"]["clear"]["seconds"] != total:
        fail(f"path F: the fleet sketch holds {summary['count']} of "
             f"{total} site-seconds")
    hist = sim._fleet_total["res_hist"]
    if int(hist.sum()) != total or int(sim._fleet_total["exceed"].sum()) \
            != total:
        fail("path F: the residual histogram or exceedance slots lose "
             "samples")
    tel_s = sim.tel_summary
    if tel_s["count"] != n * cfg.block_s or any(
            f["nan"] or f["inf"] for f in tel_s["fields"].values()):
        fail(f"path F: the last block's telemetry: {tel_s}")
    limited = np.isfinite(np.asarray(fp.ac_limit_w))
    over = reduced["pv_max"][limited] > np.asarray(
        fp.ac_limit_w, np.float32)[limited]
    if over.any():
        fail(f"path F: {int(over.sum())} clipped sites above their limit")
    q = summary["residual"]["quantiles"]
    print(f"path F (fleet reduce, synthetic({n}, seed={FLEET_SEED}), "
          f"analytics and telemetry full): {n} sites x {cfg.duration_s} s "
          f"in {sim.n_blocks} blocks: {wall:.3f} s wall, "
          f"{total / wall:.6g} site-s/s; fleet pv_max {pv_max:.2f} W, every "
          f"clipped site within its limit; residual p1/p50/p99 "
          f"{q['p1']:.1f}/{q['p50']:.1f}/{q['p99']:.1f} W, LOLP "
          f"{summary['lolp']['prob']:.3g} ({summary['lolp']['events']} "
          f"events), ramps {summary['ramp']}; last block's telemetry: csi "
          f"mean {tel_s['fields']['csi']['mean']:.4f}, covered "
          f"{tel_s['cloud_occupancy']['covered']:.0f} of {tel_s['count']:.0f}"
          f"; launches {launches}")
    return launches, reduced


def phase_path_g():
    from tmhpvsim_torch.cli import main as cli

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "path_g_reduce.csv")
    rep = os.path.join(build.BUILD_DIR, "path_g_report.json")
    try:
        rc, wall, launches = run_path(
            "G", ("sampler_windows_regime", "block_step_prod_site",
                  "block_step_fleet", "block_step_analytics", "obs_fold",
                  "chainwise_collapse"),
            lambda: cli(["pvsim", out] + PATH_G_ARGS + ["--run-report", rep]))
        if rc != 0:
            fail(f"path G: the CLI returned {rc}")
        with open(out) as f:
            rows = f.read().splitlines()
        with open(rep) as f:
            report = json.load(f)
    finally:
        for path in (out, rep):
            if os.path.exists(path):
                os.remove(path)
    n = PATH_G_SITES
    if len(rows) != n + 2 or rows[-1].split(",")[0] != "ensemble":
        fail(f"path G: {len(rows)} CSV lines")
    fleet = report.get("fleet")
    if fleet is None or fleet["level"] != "risk" or \
            fleet["count"] != n * 3600 or len(fleet["cohorts"]) != 3:
        fail(f"path G: run report fleet section {fleet}")
    print(f"path G (CLI pvsim --output reduce --fleet-synth {n} --analytics "
          f"risk --duration 3600 --run-report): {wall:.3f} s wall incl. "
          f"the CSV and the report; {n} chain rows plus the ensemble row; "
          f"report fleet count {fleet['count']}, p50 "
          f"{fleet['residual']['quantiles']['p50']:.1f} W; launches "
          f"{launches}")
    return launches


def phase_path_h(dev):
    """Path F's fleet over 3 blocks with each observer instantiation on
    its own: none, telemetry only, analytics only.  Returns each run's
    launches."""
    fp = fleet_f()
    base = dict(HEADLINE, start=CHECK_START, duration_s=PATH_H_BLOCKS *
                HEADLINE["block_s"], fleet=fp)
    runs = (("H0", {}, ("sampler_windows_regime", "block_step_site",
                        "block_step_fleet")),
            ("H8", dict(telemetry="full"), ("block_step_tel",)),
            ("H9", dict(analytics="full"), ("block_step_prod_site",
                                            "block_step_analytics",
                                            "obs_fold",
                                            "chainwise_collapse")))
    out, first, walls = {}, None, []
    for name, obs, need in runs:
        sim = Simulation(SimConfig(**dict(base, **obs)), device=dev)
        reduced, wall, out[name] = run_path(name, need, sim.run_reduced)
        check_reduced(name, reduced, base["duration_s"])
        if first is None:
            first = reduced
        elif any(not np.array_equal(reduced[k], first[k]) for k in first):
            fail(f"path {name}: the observers change the statistics")
        n = sim.config.n_chains
        if name == "H8" and sim.tel_summary["count"] != n * base["block_s"]:
            fail(f"path H8: the last block's telemetry {sim.tel_summary}")
        if name == "H9" and sim.fleet_summary()["count"] != \
                n * base["duration_s"]:
            fail("path H9: the fleet sketch misses site-seconds")
        walls.append(f"{name} {wall:.3f} s")
    print(f"path H (path F's fleet, {PATH_H_BLOCKS} blocks from "
          f"{CHECK_START}, one observer instantiation each): "
          f"{', '.join(walls)} wall; the statistics bit-identical across "
          f"the three; launches "
          f"{ {k: {c: v for c, v in d.items() if v} for k, d in out.items()} }")
    return out


def phase_timing(dev):
    """Each kernel and its plain version at the main paths' shapes."""
    cfg = SimConfig(**HEADLINE)
    sim = Simulation(cfg, device=dev)
    n = cfg.n_chains
    T = cfg.block_s
    state = sim.init_state()
    out = {}
    # K1: the main path's largest launch, the per-chain 5-way split
    keys = state["k_arr"]
    ms = time_ms(lambda: k1.split(keys, 5), reps=20)
    plain = time_ms(lambda: rng.split(keys, 5), reps=5)
    # a key is two 32-bit words (8 B) read or written, although the port
    # holds each word in an int64
    n_h = n * 5
    out["K1"] = (ms, plain, *bound(
        n_h * HASH_I, 0, n * 8 + n_h * 8))
    # K2 and the block step on a daylight block (block 40 = 12:00 local)
    ins = sim.host_inputs(40)
    args = (state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac)
    b = ins.bounds
    n_min = int(ins.mh_idx.shape[0])
    ms = time_ms(lambda: k2.sampler_windows(*args))
    plain = time_ms(lambda: k2.windows_plain(*args), reps=1)
    # K2 work per chain: 4 key splits; per hour a fold_in, a split and a
    # draw (AL: 1 hash + 2 logf, or t: ~8 hashes with gamma); cloudy,
    # clear-day and windspeed draws (normal: 2 hashes; gamma: ~8); two
    # minute noises (3 hashes + a normal each)
    hashes = 4 + b.n_hours * 6 + b.n_cloudy * 6 + b.n_cd * 2 + \
        b.n_days * 8 + n_min * 5
    f32 = (b.n_hours * 30 + b.n_cloudy * 40 + b.n_cd * NORMAL_F
           + b.n_days * 60 + n_min * (2 * NORMAL_F + 12))
    nbytes = n * (8 * 2 + 8) + 4 * n * (2 * b.n_hours + b.n_cd + b.n_days
                                         + 2 * n_min + 1)
    out["K2"] = (ms, plain, *bound(
        n * hashes * HASH_I, n * f32, nbytes))
    tables, _ = k2.sampler_windows(*args)
    carry = clone(state["carry"])
    acc = sim.init_reduce_acc()
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"], carry)
    tail = (cfg.meter_max_w, cfg.site.surface_tilt, cfg.site.albedo)
    k3_args = head + (acc, cfg.duration_s) + tail
    int_ops = n * (T * K3_SECOND_I + (T // 60) * K3_MINUTE_I)
    draws_f = NORMAL_F + UNIFORM_F + 1
    table_bytes = sum(t.numel() * 4 for t in tables.values())
    in_bytes = (table_bytes + n * 8 * 2 + n * 4 * 3 * 2
                + ins.rows_i.numel() * 4 + ins.rows_f.numel() * 4)
    ms = time_ms(lambda: k3.block_step_acc(*k3_args))
    plain = time_ms(lambda: k3.block_step_plain(*k3_args), reps=1)
    out["K3"] = (ms, plain, *bound(
        int_ops, n * T * (K3_SECOND_F + draws_f),
        in_bytes + n * 4 * 7 * 2))
    # K4 series: the first pass, then the cross-CTA sum on its partials
    ms = time_ms(lambda: k3.series_partials_cuda(*head, *tail))
    plain = time_ms(lambda: k3.series_plain(*head, *tail), reps=1)
    out["K4S"] = (ms, plain, *bound(
        int_ops, n * T * (SERIES_SECOND_F + draws_f),
        in_bytes + 2 * T * 4))
    _, part = k3.series_partials_cuda(*head, *tail)
    n_parts = part.shape[1]
    # series_sum and part.sum(1), its library yardstick, in turns: per
    # call (CUDA events around 20 calls, the measure of every other row
    # and of the earlier PRs), and device time from CUDA graphs of 20
    # launches beside it (no host work between the launches)
    ms_k, ms_l, call_k, call_l = [], [], [], []
    for kernel_first in (True, False, False, True):
        for fn, to, call in ((lambda: k3.series_sum(part), ms_k, call_k),
                             (lambda: part.sum(1), ms_l, call_l)
                             )[::1 if kernel_first else -1]:
            to.append(time_graph_ms(fn))
            call.append(time_ms(fn, reps=20))
    ms, lib_sum = float(np.mean(call_k)), float(np.mean(call_l))
    plain = time_ms(lambda: k3.series_sum_plain(part), reps=5)
    out["K4R"] = (ms, plain, *bound(
        0, 2 * n_parts * T, part.numel() * 4 + 2 * T * 4))
    # K4 trace: 8 bytes per chain-second written
    ms = time_ms(lambda: k3.block_step_trace(*head, *tail))
    plain = time_ms(lambda: k3.trace_plain(*head, *tail), reps=1)
    out["K4T"] = (ms, plain, *bound(
        int_ops, n * T * (TRACE_SECOND_F + draws_f),
        in_bytes + 2 * n * T * 4))
    # K6: path B's grid on its noon block
    gsim = Simulation(SimConfig(**dict(HEADLINE, site_grid=grid_b())),
                      device=dev)
    gstate = gsim.init_state()
    gins = gsim.host_inputs(40)
    gtables, _ = k2.sampler_windows(
        gstate["k_arr"], gstate["k_min"], gstate["cc_carry"], gstate["cc0"],
        gins.bounds, gins.mh_idx, gins.mh_frac)
    _, _, site = gsim.geometry_args(gstate)
    k6_args = (gtables, gins.rows_i, gins.rows_f, gstate["k_scan"],
               gstate["k_meter"], clone(gstate["carry"]),
               gsim.init_reduce_acc(), cfg.duration_s, cfg.meter_max_w, None,
               None)
    ms = time_ms(lambda: k3.block_step_acc(*k6_args, site=site))
    plain = time_ms(lambda: k3.block_step_plain(*k6_args, site=site), reps=1)
    g_table_bytes = sum(t.numel() * 4 for t in gtables.values())
    g_in = (g_table_bytes + n * 8 * 2 + n * 4 * 3 * 2 + n * 4 * 6 + 12 * 4
            + gins.rows_i.numel() * 4 + gins.rows_f.numel() * 4)
    out["K6"] = (ms, plain, *bound(
        int_ops,
        n * T * (K3_SECOND_F + K6_SITE_SECOND_F + draws_f) + T * K6_TIME_F,
        g_in + n * 4 * 7 * 2))
    for name, (ms, plain, bms, by, ibms) in out.items():
        print(f"timing {name}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
              f"bound {bms:.4f} ms ({by}), issue bound "
              f"{ibms:.4f} ms")
    print(f"timing series_sum beside part.sum(1) on its (2, {n_parts}, {T}) "
          f"partials, in turns: per call {call_k} ms against {call_l} ms; "
          f"device time from CUDA graphs {ms_k} ms against {ms_l} ms")
    out["K4R_library"] = lib_sum
    out["K4R_device"] = (float(np.mean(ms_k)), float(np.mean(ms_l)))
    for label, s in (("shared site", sim), ("site grid", gsim)):
        t0 = time.perf_counter()
        for bi in range(s.n_blocks):
            s.host_arrays(bi)
        host_ms = (time.perf_counter() - t0) * 1e3 / s.n_blocks
        print(f"timing host_arrays ({label}): {host_ms:.3f} ms per block "
              f"(host clock, mean of {s.n_blocks}; overlapped with the card "
              "by the loops' one-block lookahead)")
    return out


def k5_plain(sim):
    """init_state's keys and primers from the plain versions on the
    card: the K1 / K13 / K14 draws and derivations and K2's windows as
    their plain torch functions compute them."""
    cfg, dev, impl = sim.config, sim.device, sim.plan.prng_impl
    total = cfg.n_chains_total or cfg.n_chains
    keys = rng.split(sim._k_chains.to(dev), total, impl)[
        cfg.chain_offset:cfg.chain_offset + cfg.n_chains]
    s5 = rng.split(keys, 5, impl)
    k_arr, k_min, k_renew = (s5[:, i, :].contiguous() for i in range(3))
    ones = torch.ones(cfg.n_chains, dtype=torch.float32, device=dev)
    no_min = (torch.zeros(0, dtype=torch.int32, device=dev),
              torch.zeros(0, dtype=torch.float32, device=dev))
    t1, _ = k2.windows_plain(k_arr, k_min, ones, ones,
                             k2.Bounds(0, 2, 0, 0, 0, 0, 0, 1), *no_min,
                             impl=impl)
    f0 = sim._f0_hour
    cc0 = t1["cc"][0] * (1 - f0) + t1["cc"][1] * f0
    t2, _ = k2.windows_plain(k_arr, k_min, ones, cc0,
                             k2.Bounds(0, 0, 2, 0, 0, 0, 0, 0), *no_min,
                             impl=impl)
    kr = rng.split(k_renew, 2, impl)
    carry = renewal.init_from_u(rng.uniform(kr[:, 0, :], impl=impl),
                                rng.uniform(kr[:, 1, :], impl=impl),
                                t1["cc"][0], t1["ws"][0])
    return {"cc0": cc0, "cloudy_pair": t2["cloudy"].T, "carry": carry,
            "k_arr": k_arr, "k_min": k_min, "k_scan": s5[:, 3, :],
            "k_meter": s5[:, 4, :]}


def phase_timing_k5(dev):
    """K5, ``init_state`` (engine/simulation.py:509-536 ``one`` vmapped
    over the chains, and :546's split), on the main path at 65536 chains:
    the state bit-identical to its plain composition on the card, its
    launches counted, timed beside the plain composition.  Its work: per
    chain the 5-way split and the root split's hash, K2's two primer
    launches (a 4-way split, two Markov hours, the first windspeed's
    gamma, two cloudy draws) and the renewal split and two uniforms."""
    cfg = SimConfig(**HEADLINE)
    sim = Simulation(cfg, device=dev)
    n = cfg.n_chains
    torch.cuda.synchronize()
    kernels.reset_counts()
    state = sim.init_state()
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.counts().items() if v}
    plain = k5_plain(sim)
    torch.cuda.synchronize()
    for k, v in plain.items():
        if k == "carry":
            check_same("K5 renewal carry", state[k], v)
        elif not torch.equal(state[k], v):
            fail(f"K5 {k} differs from its plain composition: max abs "
                 f"{max_abs(state[k].double(), v.double())}")
    ms = time_ms(sim.init_state)
    plain_ms = time_ms(lambda: k5_plain(sim), reps=1)
    hashes = 1 + 5 + (4 + 2 * 6 + 8) + (4 + 2 * 6) + 4
    f32 = 2 * 30 + 60 + 2 * 40 + 2 * UNIFORM_F + 2 * POW_F + 12
    nbytes = n * (4 * 8 + 7 * 4)
    bms, by, ibms = bound(n * hashes * HASH_I, n * f32, nbytes)
    print(f"K5 (init_state) vs its plain composition at {n} chains: every "
          f"key and primer bit-identical; launches {launches}")
    print(f"timing K5: init_state {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bms:.4f} ms ({by}), issue bound {ibms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "issue_bound_ms": ibms, "launches": launches}


#: the observer fold's bytes per chain-second: float32 meter, pv and csi,
#: uint8 covered flags (both observers, telemetry full)
OBS_FOLD_BYTES = 13


def obs_parts_ms(args, kw, obs):
    """The acc producer and the observer fold of one block, each timed on
    its own (CUDA events; the producer into the engine's reused buffers,
    the fold without its collapses), and their plain versions: ``(producer
    ms, fold ms, plain producer ms, plain fold ms)``."""
    held, bufs = {}, {}

    def producer():
        held["p"] = k3._obs_producer_cuda(*args, obs=obs, **kw,
                                          held=bufs)[2]

    ms_p = time_ms(producer)
    t, dur = args[1][0], args[7]
    ms_f = time_ms(lambda: k3._obs_fold_launch(held["p"], t, dur, obs))
    prod = dict(held["p"])
    if "covered" in prod:
        prod["covered"] = prod["covered"].bool()
    plain_p = time_ms(lambda: k3.obs_producer_plain(*args, **kw), reps=1)
    plain_f = time_ms(lambda: k3.obs_fold_plain(prod, t, dur, obs), reps=1)
    return ms_p, ms_f, plain_p, plain_f


def obs_fold_bound(n, T, obs):
    """The observer fold's bound: its inputs read once (13 bytes a
    chain-second with both observers at full) and its partial rows and
    histograms written once; operations: the fused epilogue's per-sample
    folds."""
    n_ctas = (n + k3.THREADS - 1) // k3.THREADS
    tel_on = obs.telemetry != "off"
    per_s = 8 + 4 * tel_on + int(obs.telemetry == "full"
                                 or obs.analytics == "full")
    nb = obs.params.bins + 2
    C = obs.n_cohorts if obs.cohort is not None else 0
    out_b = n_ctas * ((25 * tel_on + 15 + 6 * C) * 8) + 4 * (
        nb + 8 + C * nb + 8 * tel_on) + n * 4 * C
    i_ops = n * T * (FLT_SECOND_I + TEL_SECOND_I * tel_on)
    f_ops = n * T * (FLT_SECOND_F + TEL_SECOND_F * tel_on)
    return bound(i_ops, f_ops, n * T * per_s + out_b + T * 4)


def phase_timing_fleet(dev):
    """K7, K8, K9 and the collapse, and their plain versions, on path F's
    noon block (65536 fleet sites x 1080 s)."""
    fp = fleet_f()
    cfg = SimConfig(**dict(HEADLINE, fleet=fp, telemetry="full",
                           analytics="full"))
    sim = Simulation(cfg, device=dev)
    n, T = sim.config.n_chains, cfg.block_s
    state = sim.init_state()
    ins = sim.host_inputs(40)
    regime = state["fleet"]["regime"]
    args = (state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac)
    b = ins.bounds
    n_min = int(ins.mh_idx.shape[0])
    out = {}
    ms = time_ms(lambda: k2.sampler_windows(*args, regime=regime))
    plain = time_ms(lambda: k2.windows_plain(*args, regime=regime), reps=1)
    # K2's work (the regime adds one int32 load and an index per chain)
    hashes = 4 + b.n_hours * 6 + b.n_cloudy * 6 + b.n_cd * 2 + \
        b.n_days * 8 + n_min * 5
    f32 = (b.n_hours * 30 + b.n_cloudy * 40 + b.n_cd * NORMAL_F
           + b.n_days * 60 + n_min * (2 * NORMAL_F + 12))
    nbytes = n * (8 * 2 + 8 + 4) + 4 * n * (2 * b.n_hours + b.n_cd +
                                             b.n_days + 2 * n_min + 1)
    out["K7R"] = (ms, plain, *bound(
        n * hashes * HASH_I, n * f32, nbytes))
    tables, _ = k2.sampler_windows(*args, regime=regime)
    _, _, site = sim.geometry_args(state)
    fleet = sim.fleet_leaves(state)
    head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"], clone(state["carry"]))
    tail = (cfg.duration_s, cfg.meter_max_w, None, None)
    int_ops = n * (T * K3_SECOND_I + (T // 60) * K3_MINUTE_I)
    table_bytes = sum(t.numel() * 4 for t in tables.values())
    in_bytes = (table_bytes + n * 8 * 2 + n * 4 * 3 * 2 + n * 4 * 6 + 12 * 4
                + ins.rows_i.numel() * 4 + ins.rows_f.numel() * 4
                + n * 4 * 4)
    f_k7 = n * T * (K3_SECOND_F + K6_SITE_SECOND_F + NORMAL_F + UNIFORM_F
                    + 1 + K7_SECOND_F) + T * K6_TIME_F
    acc = sim.init_reduce_acc()
    ms = time_ms(lambda: k3.block_step_acc(*head, acc, *tail, site=site,
                                           fleet=fleet))
    plain = time_ms(lambda: k3.block_step_plain(*head, acc, *tail, site=site,
                                                fleet=fleet), reps=1)
    out["K7T"] = (ms, plain, *bound(
        int_ops, f_k7, in_bytes + n * 4 * 7 * 2))
    n_ctas = (n + k3.THREADS - 1) // k3.THREADS
    obs_t = k3.Observers(telemetry="full")
    obs_f = sim.observers(state)
    obs_f = dataclasses.replace(obs_f, telemetry="off")
    obs_tf = sim.observers(state)
    nb = sim._fleet_params.bins + 2
    C = sim._n_cohorts
    tel_b = n_ctas * 25 * 8 + 9 * 4
    flt_b = (n_ctas * (15 + 6 * C) * 8 + n * 4 + 4 * (nb + 8 + C * nb))
    for key, obs, f_extra, i_extra, b_extra in (
            ("K8", obs_t, TEL_SECOND_F, TEL_SECOND_I, tel_b),
            ("K9", obs_f, FLT_SECOND_F, FLT_SECOND_I, flt_b),
            ("K89", obs_tf, TEL_SECOND_F + FLT_SECOND_F,
             TEL_SECOND_I + FLT_SECOND_I, tel_b + flt_b)):
        ms = time_ms(lambda: k3.block_step_obs(*head, acc, *tail, site=site,
                                               fleet=fleet, obs=obs))
        plain = time_ms(lambda: k3.block_step_obs_plain(
            *head, acc, *tail, site=site, fleet=fleet, obs=obs), reps=1)
        out[key] = (ms, plain, *bound(
            int_ops + n * T * i_extra, f_k7 + n * T * f_extra,
            in_bytes + n * 4 * 7 * 2 + b_extra))
    # path F's two launches on their own: the producer (its bound: K7T's
    # work, its arrays written once) and the observer fold
    ms_p, ms_f, plain_p, plain_f = obs_parts_ms(
        (*head, acc, *tail), dict(site=site, fleet=fleet), obs_tf)
    out["K89P"] = (ms_p, plain_p, *bound(
        int_ops, f_k7, in_bytes + n * 4 * 7 * 2 + n * T * OBS_FOLD_BYTES))
    out["KF"] = (ms_f, plain_f, *obs_fold_bound(n, T, obs_tf))
    # the collapse on its own: the three per-CTA row sets of this block's
    # K8+K9 launch in one launch, as path F collapses them per block; the
    # library's yardstick a sum, a minimum and a maximum over each set's
    # rows
    _, _, o = k3.block_step_obs(*head, acc, *tail, site=site, fleet=fleet,
                                obs=dataclasses.replace(obs_tf,
                                                        per_chain=True))
    parts = list(obs_row_sets(o["partials"]).values())
    ms = time_ms(lambda: k3.collapse_group(parts), reps=20)
    plain = time_ms(lambda: [k3.collapse_plain(
        v, kinds * (v.shape[1] // len(kinds))) for v, kinds in parts],
        reps=5)

    def library():
        return [(v.sum(0), v.amin(0), v.amax(0)) for v, _ in parts]

    out["KC_library"] = time_ms(library, reps=20)
    out["KC_device"] = (time_graph_ms(lambda: k3.collapse_group(parts)),
                        time_graph_ms(library))
    numel = sum(v.numel() for v, _ in parts)
    out["KC"] = (ms, plain, *bound(
        0, numel, numel * 8 + sum(v.shape[1] * 8 for v, _ in parts)))
    for name, v in out.items():
        if name.startswith("KC_"):
            continue
        ms, plain, bms, by, ibms = v
        print(f"timing {name}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
              f"bound {bms:.4f} ms ({by}), issue bound "
              f"{ibms:.4f} ms")
    dev_ms, dev_lib = out["KC_device"]
    print(f"timing KC: path F's block ({len(parts)} row sets, one launch) "
          f"{out['KC'][0]:.4f} ms per call, device {dev_ms:.4f} ms from a "
          f"CUDA graph; the library's sum, amin and amax per set "
          f"{out['KC_library']:.4f} ms per call, device {dev_lib:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# scenario serving: K10, paths S and S-c


def k10_rows(t0, duration_s):
    """K10's 16 check rows: neutral, padding, a horizon ending 500 s into
    the block starting at ``t0``, demand scale / shift, DC scale x
    weather bias, a binding curtailment cap, then seeded mixtures."""
    gen = np.random.default_rng(0)
    rows = [Scenario(horizon_s=duration_s), Scenario(horizon_s=0),
            Scenario(horizon_s=t0 + 500),
            Scenario(demand_scale=1.3, demand_shift_w=-400.0,
                     horizon_s=duration_s),
            Scenario(dc_capacity_scale=1.5, weather_bias=0.7,
                     horizon_s=duration_s),
            Scenario(curtail_w=120.0, horizon_s=duration_s)]
    while len(rows) < K10_B:
        rows.append(Scenario(
            demand_scale=float(gen.uniform(0.2, 3.0)),
            demand_shift_w=float(gen.uniform(-2000.0, 2000.0)),
            dc_capacity_scale=float(gen.uniform(0.0, 4.0)),
            weather_bias=float(gen.uniform(0.25, 4.0)),
            curtail_w=float(gen.uniform(50.0, 400.0)),
            horizon_s=int(gen.integers(t0 + 1, duration_s + 1))))
    return rows


def check_scenario(what, ak, dk, ap, dp):
    """K10's outputs against the plain version's: n_seconds, extrema and
    every FleetAcc count, histogram, extremum and per-chain leaf bit for
    bit; the float sums bit-identical or (printed) within the engine
    tolerance.  Returns (max abs of the sums, statistics bit-identical)."""
    err, same = 0.0, 0
    for k, b in ap.items():
        a = ak[k]
        if torch.equal(a, b):
            same += 1
            continue
        if k in ("n_seconds", "pv_max", "residual_min", "residual_max"):
            fail(f"K10 ({what}) {k} differs from the plain version")
        if not close(a, b):
            fail(f"K10 ({what}) {k} differs from the plain version: max "
                 f"abs {max_abs(a, b)}")
        err = max(err, max_abs(a, b))
        print(f"K10 ({what}): {k} not bit-identical to the plain version: "
              f"{int((a != b).sum())} of {a.numel()} (row, chain) sums "
              f"differ, max abs {max_abs(a, b):.4g}")
    for k, v in dp.items():
        if k == "chain":
            for c in v:
                if not torch.equal(dk["chain"][c], v[c]):
                    fail(f"K10 ({what}) per-chain {c} differs from the "
                         "plain fold")
        elif not torch.equal(dk[k], v):
            fail(f"K10 ({what}) FleetAcc {k} differs from the plain fold")
    return err, same


def k10_parts(label, sim, head, tail, rows, params, ms_rows, cd="f32",
              sketches=True):
    """K10's two launches on their own on one block: the producer against
    its plain version (meter and the renewal carry bit for bit, pv to the
    engine tolerance, as the K4 trace), then the fold against its plain
    version on the producer's own meter and pv, with and without the
    producer's flags that let a masked tail skip its loads (every
    statistic, count, histogram, extremum and per-chain leaf bit for bit:
    the same inputs, the same arithmetic), also with a sketch
    that still fits in shared memory (K10_WIDE_BINS) and one that does not
    (K10_GLOBAL_BINS), and with K10_MANY_THR thresholds at the default and
    the global sketch, when ``sketches``.  ``ms_rows``: the whole wrapper's
    times by rows, for the record.  Returns the times and bounds of both
    launches and the largest difference the fold's checks saw."""
    cfg = sim.config
    dev = sim.device
    n, T = cfg.n_chains, cfg.block_s
    dur, mw, tilt, alb = tail
    state_carry = head[5]
    ck, mk, pk, tk = k3._scenario_producer_cuda(
        *head[:5], clone(state_carry), mw, tilt, alb, compute_dtype=cd)
    cp, mp, pp = k3.scenario_producer_plain(*head[:5], clone(state_carry),
                                            mw, tilt, alb, compute_dtype=cd)
    torch.cuda.synchronize()
    if not torch.equal(mk, mp):
        fail(f"{label} producer: meter differs from the plain version: max "
             f"abs {max_abs(mk, mp)}")
    if not close(pk, pp):
        fail(f"{label} producer: pv differs from the plain version: max abs "
             f"{max_abs(pk, pp)}")
    for k in ck:
        if not torch.equal(ck[k], cp[k]):
            fail(f"{label} producer: renewal carry {k} differs from the "
                 "plain version")
    perr, psame = max_abs(pk, pp), int((pk == pp).sum())
    del mp, pp, cp
    t = head[1][0]
    B = len(rows)

    def fold_pair(scs, prm, tame=None):
        scen = schema.encode_batch(scs, len(scs), device=dev)
        got = k3.scenario_fold(mk, pk, t, sim.init_scenario_acc(len(scs)),
                               dur, scen=scen, params=prm, per_chain=True,
                               tame=tame)
        return scen, got

    (scen, want), row_sets = collapse_inputs(lambda: fold_pair(rows,
                                                                params))
    # the fold's per-(CTA, row) partial rows through the grouped collapse
    c_err, _ = check_collapse(row_sets[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = k3.scenario_fold_plain(mk, pk, t, sim.init_scenario_acc(B), dur,
                                   scen, params, per_chain=True)
    end.record()
    torch.cuda.synchronize()
    fold_plain_ms = start.elapsed_time(end)

    fold_err = 0.0

    def same(what, got, ref):
        nonlocal fold_err
        pairs = [(k, got[0][k], v) for k, v in ref[0].items()]
        for k, v in ref[1].items():
            pairs += ([(f"per-chain {c}", got[1]["chain"][c], v[c])
                       for c in v] if k == "chain" else [(k, got[1][k], v)])
        for k, a, b in pairs:
            err = max_abs(a, b)
            fold_err = max(fold_err, err)
            if not torch.equal(a, b):
                fail(f"{label} fold ({what}): {k} differs from the plain "
                     f"fold: max abs {err}")

    same(f"{B} rows", want, plain)
    if int(tk.sum()) != n:
        fail(f"{label} producer: a chain's values are not all finite")
    same(f"{B} rows, the masked tails skipped", fold_pair(rows, params,
                                                          tk)[1], plain)
    del plain, want
    many = tuple(float(x) for x in K10_MANY_THR)
    for bins, shared, thr in ((K10_WIDE_BINS, True, params.thresholds),
                              (K10_GLOBAL_BINS, False, params.thresholds),
                              (params.bins, True, many),
                              (K10_GLOBAL_BINS, False, many)
                              ) if sketches else ():
        prm = dataclasses.replace(params, bins=bins, thresholds=thr)
        sketch = bins + 2 + (len(thr) + 1) * (len(thr) > k3.MAX_THR)
        if k3.scenario_fold_layout(T, prm) != (shared,
                                               4 * sketch * shared + T):
            fail(f"{label} fold: the {bins}-bin sketch is not where the "
                 "check expects it")
        scs = rows[:K10_WIDE_ROWS]
        sc, got = fold_pair(scs, prm)
        same(f"{bins} bins, {len(thr)} thresholds, "
             f"{'shared' if shared else 'global'} memory", got,
             k3.scenario_fold_plain(mk, pk, t,
                                    sim.init_scenario_acc(len(scs)), dur,
                                    sc, prm, per_chain=True))
        del got
    # the times of each launch at the rows of ms_rows
    ms_prod = time_ms(lambda: k3.scenario_producer(
        *head[:5], clone(state_carry), mw, tilt, alb, compute_dtype=cd))
    ms_fold = {}
    for b in ms_rows:
        sc = schema.encode_batch(rows[:b], b, device=dev)
        acc_b = sim.init_scenario_acc(b)
        ms_fold[b] = time_ms(lambda: k3.scenario_fold(
            mk, pk, t, acc_b, dur, scen=sc, params=params, tame=tk))
    # bounds: the producer is K3's step writing 8 bytes per chain-second;
    # the fold's operations are this block's valid samples' and its bytes
    # the meter and pv read once with the statistics read and written
    acc_b = sim.init_scenario_acc(B)
    k3.scenario_fold(mk, pk, t, acc_b, dur, scen=scen, params=params,
                     tame=tk)
    ns = acc_b["n_seconds"]
    valid = int(ns.sum())
    t0 = int(t[0])
    nsl = ns.long()
    grid = sum(int(((t0 + nsl) // w - t0 // w).sum())
               for w in params.ramp_windows)
    bf = cd == "bf16"
    tables = head[0]
    table_bytes = sum(v.numel() * 4 for v in tables.values())
    in_bytes = (table_bytes + n * 8 * 2 + n * 4 * 3 * 2
                + head[1].numel() * 4 + head[2].numel() * 4)
    prod_int = n * (T * (K3_SECOND_I + (K12_DRAWS_I if bf else 0))
                    + (T // 60) * K3_MINUTE_I)
    prod_f = n * T * (TRACE_SECOND_F + (K12_DRAWS_F if bf else
                                        NORMAL_F + UNIFORM_F + 1))
    b_prod, by_prod, ib_prod = bound(prod_int, prod_f,
                                     in_bytes + 2 * n * T * 4)
    nb, ne = params.bins + 2, len(params.thresholds) + 1
    fold_int = T * (K10_SECOND_I + B * K10_ROW_SECOND_I) + \
        B * n * K10_ROW_CHAIN_I + valid * K10_VALID_I + grid * K10_GRID_I
    fold_f = valid * K10_VALID_F + grid * K10_GRID_F
    b_fold, by_fold, ib_fold = bound(
        fold_int, fold_f, 2 * n * T * 4 + T * 4
        + B * (n * 4 * 7 * 2 + 4 * (nb + ne) + 8 * 4))
    print(f"{label} producer vs plain on the noon block x {n} chains: meter "
          f"and the renewal carry bit-identical, {psame}/{n * T} pv values "
          f"bit-identical (max abs {perr:.3g}); the fold vs its plain "
          f"version on the producer's meter and pv at {B} rows (with and "
          "without the masked tails' skip)"
          + (f", at {K10_WIDE_BINS} bins (shared "
                                 f"memory) and {K10_GLOBAL_BINS} bins "
                                 "(global atomics), and with "
                                 f"{len(K10_MANY_THR)} thresholds at "
                                 f"{params.bins} and {K10_GLOBAL_BINS} bins"
                                 if sketches else "")
          + ": every statistic, count, histogram, extremum and per-chain "
          f"leaf bit-identical (max abs {fold_err}); the {B} rows' per-CTA "
          "partial rows through the grouped collapse bit-identical to the "
          f"host's index-order float64 fold (max abs {c_err:.3g} from "
          "collapse_plain)")
    print(f"timing {label}: producer {ms_prod:.4f} ms (bound {b_prod:.4f} "
          f"ms, {by_prod}); fold " + ", ".join(
              f"{ms_fold[b]:.4f} ms ({b} rows)" for b in ms_rows)
          + f" (bound at {B} rows {b_fold:.4f} ms, {by_fold}; plain "
          f"{fold_plain_ms:.1f} ms); the whole wrapper " + ", ".join(
              f"{ms_rows[b]:.4f} ms ({b} rows)" for b in ms_rows))
    return {"ms_producer": ms_prod, "bound_ms_producer": b_prod,
            "bound_by_producer": by_prod,
            "issue_bound_ms_producer": ib_prod, "ms_fold": ms_fold,
            "bound_ms_fold": b_fold, "bound_by_fold": by_fold,
            "issue_bound_ms_fold": ib_fold, "plain_ms_fold": fold_plain_ms,
            "producer_max_abs_err": perr, "fold_max_abs_err": fold_err}


def phase_k10(dev):
    """K10 on the main path's noon block: the whole wrapper against
    scenario_plain, batch-of-1 identity, the neutral row against K3, its
    two launches on their own (k10_parts), and the times at 1, 4 and 16
    rows.  Returns the kernels-line figures."""
    cfg = SimConfig(**HEADLINE)
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    ins = sim.host_inputs(K10_BLOCK)
    tables, _ = sim._windows(state, ins)
    head = head_of(state, ins, tables)
    tail = (cfg.duration_s, cfg.meter_max_w, cfg.site.surface_tilt,
            cfg.site.albedo)
    n, T = cfg.n_chains, cfg.block_s
    t0 = K10_BLOCK * T
    rows = k10_rows(t0, cfg.duration_s)
    params = sim.scenario_fleet_params()

    def launch(fn, scs, per_chain=True, prm=params):
        scen = schema.encode_batch(scs, len(scs), device=dev)
        return fn(*head, clone(state["carry"]),
                  sim.init_scenario_acc(len(scs)), *tail, scen=scen,
                  params=prm, per_chain=per_chain)

    _, ak, dk = launch(k3.block_step_scenario, rows)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, ap, dp = launch(k3.scenario_plain, rows)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err, same = check_scenario(f"{n} chains x {K10_B} rows", ak, dk, ap, dp)
    del ap, dp
    # row i of the batch-of-16 launch is a batch-of-1 launch of row i
    for i, row in enumerate(rows):
        _, a1, d1 = launch(k3.block_step_scenario, [row], per_chain=False)
        torch.cuda.synchronize()
        if not all(torch.equal(a1[k][0], ak[k][i]) for k in a1) or \
                not all(torch.equal(d1[k][0], dk[k][i]) for k in d1):
            fail(f"K10 row {i} of the batch-of-{K10_B} launch differs from "
                 "its batch-of-1 launch")
    _, acc = k3.block_step_acc(*head, clone(state["carry"]),
                               sim.init_reduce_acc(), *tail)
    torch.cuda.synchronize()
    if not all(torch.equal(ak[k][0], acc[k]) for k in acc):
        fail("K10's neutral row differs from K3's launch")
    acc0 = sim.init_scenario_acc(1)
    ns = ak["n_seconds"]
    if not all(torch.equal(ak[k][1], acc0[k][0]) for k in acc0) or \
            int(dk["count"][1]) != 0:
        fail("K10's padding row folded something")
    if not bool((ns[2] == 500).all()) or int(dk["count"][2]) != 500 * n:
        fail("K10's mid-block horizon row folded the wrong seconds")
    if float(ak["pv_max"][5].max()) > 120.0 or \
            float(ak["pv_max"][0].max()) <= 120.0:
        fail("K10's curtailment cap does not bind")
    # the times at 1, 4 and 16 rows, and the bound at 16 from this
    # block's valid samples
    ms = {}
    for b in (1, 4, K10_B):
        scen = schema.encode_batch(rows[:b], b, device=dev)
        acc_b = sim.init_scenario_acc(b)
        ms[b] = time_ms(lambda: k3.block_step_scenario(
            *head, clone(state["carry"]), acc_b, *tail, scen=scen,
            params=params))
    parts = k10_parts("K10", sim, head + (state["carry"],), tail, rows,
                      params, ms)
    # the valid seconds of a (row, chain) are the first ns of the block,
    # so the ramp grids' valid samples are counted exactly
    valid = int(ns.sum())
    nsl = ns.long()
    grid = sum(int(((t0 + nsl) // w - t0 // w).sum())
               for w in params.ramp_windows)
    int_ops = n * (T * K3_SECOND_I + (T // 60) * K3_MINUTE_I) + \
        T * (K10_SECOND_I + K10_B * K10_ROW_SECOND_I) + \
        K10_B * n * K10_ROW_CHAIN_I + valid * K10_VALID_I + \
        grid * K10_GRID_I
    f32_ops = n * T * (K3_SECOND_F + NORMAL_F + UNIFORM_F + 1) + \
        valid * K10_VALID_F + grid * K10_GRID_F
    table_bytes = sum(t.numel() * 4 for t in tables.values())
    nb, ne = params.bins + 2, len(params.thresholds) + 1
    nbytes = (table_bytes + n * 8 * 2 + n * 4 * 3 * 2
              + ins.rows_i.numel() * 4 + ins.rows_f.numel() * 4
              + K10_B * (n * 4 * 7 * 2 + 4 * (nb + ne) + 8 * 4))
    bms, by, ibms = bound(int_ops, f32_ops, nbytes)
    print(f"K10 vs plain on the noon block x {n} chains x {K10_B} rows: "
          f"{same}/7 statistics bit-identical (float sums max abs "
          f"{err:.3g}), every FleetAcc count, histogram, extremum and "
          f"per-chain leaf bit-identical; each row equals its batch-of-1 "
          f"launch; the neutral row equals K3's launch; the padding row "
          f"folded nothing; {valid} valid (row, chain)-seconds of "
          f"{K10_B * n * T}")
    print(f"timing K10: kernel {ms[1]:.4f} ms (1 row), {ms[4]:.4f} ms "
          f"(4 rows), {ms[K10_B]:.4f} ms ({K10_B} rows); plain "
          f"{plain_ms:.1f} ms ({K10_B} rows); bound {bms:.4f} ms ({by})")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "issue_bound_ms": ibms, **parts}


def phase_k10_fleet(dev):
    """K10 on 2 blocks of path F's fleet (site geometry, the fleet
    transforms) with the site and cohort selectors."""
    fp = fleet_f()
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, fleet=fp))
    sim, state, blocks = fleet_blocks(cfg, dev)
    _, _, site = sim.geometry_args(state)
    fleet = sim.fleet_leaves(state)
    cohort = sim.scenario_cohort()
    dur = cfg.duration_s
    rows = [Scenario(horizon_s=dur),
            Scenario(site_index=K10_FLEET_SITE, horizon_s=dur),
            Scenario(cohort=1, demand_scale=1.2, horizon_s=dur),
            Scenario(cohort=2, curtail_w=100.0, dc_capacity_scale=2.0,
                     horizon_s=dur),
            Scenario(demand_shift_w=-600.0, weather_bias=0.5,
                     horizon_s=1800),
            Scenario(horizon_s=0)]
    scen = schema.encode_batch(rows, len(rows), device=dev)
    params = sim.scenario_fleet_params()
    acc_k = sim.init_scenario_acc(len(rows))
    acc_p = sim.init_scenario_acc(len(rows))
    carry_k, carry_p = clone(state["carry"]), clone(state["carry"])
    err, n_same = 0.0, 0
    for bi, (ins, tables) in enumerate(blocks):
        head = head_of(state, ins, tables)
        tail = (dur, cfg.meter_max_w, None, None)
        kw = dict(site=site, fleet=fleet, scen=scen, params=params,
                  cohort=cohort, per_chain=True)
        carry_k, acc_k, dk = k3.block_step_scenario(*head, carry_k, acc_k,
                                                    *tail, **kw)
        carry_p, acc_p, dp = k3.scenario_plain(*head, carry_p, acc_p,
                                               *tail, **kw)
        torch.cuda.synchronize()
        e, n_same = check_scenario(f"fleet block {bi}", acc_k, dk, acc_p,
                                   dp)
        err = max(err, e)
        # the next block's plain fold continues from the kernel's
        # statistics, so each block is held on its own
        acc_p = {k: v.clone() for k, v in acc_k.items()}
    for k in carry_k:
        if not torch.equal(carry_k[k], carry_p[k]):
            fail(f"K10 (fleet) renewal carry {k} differs from the plain "
                 "version")
    ns = acc_k["n_seconds"]
    t2 = 2 * cfg.block_s
    c1 = int((cohort == 1).sum())
    if int(ns[1].sum()) != t2 or int(ns[1][K10_FLEET_SITE]) != t2 or \
            int(ns[2].sum()) != t2 * c1 or int(ns[4][0]) != 1800:
        fail("K10 (fleet): a selector or horizon folded the wrong samples")
    print(f"K10 vs plain on 2 blocks x {sim.config.n_chains} fleet sites "
          f"(site geometry, fleet transforms, {len(rows)} rows with a site "
          f"selector, 2 cohort selectors, a short horizon and padding): "
          f"{n_same}/7 statistics bit-identical in the last block (float "
          f"sums max abs {err:.3g}), every FleetAcc count, histogram, "
          f"extremum and per-chain leaf bit-identical, the renewal carry "
          f"bit-identical")
    return err


def path_s_requests():
    """Path S's 32 requests: (rid, scenario, mode), horizons from 1/24 of
    the served duration to all of it (3600 s to 86400 s) in mixed order,
    the three modes, knobs varied."""
    hour = PATH_S["duration_s"] // 24
    out = []
    for j in range(PATH_S_CLIENTS * PATH_S_PER_CLIENT):
        doc = {"horizon_s": hour * (1 + (j * 7) % 24),
               "demand_scale": round(0.8 + 0.05 * (j % 9), 2),
               "demand_shift_w": 25.0 * (j % 5) - 50.0}
        if j % 3 == 1:
            doc.update(dc_capacity_scale=1.5, weather_bias=0.8)
        if j % 4 == 2:
            doc["curtail_w"] = 200.0
        out.append((f"s{j:02d}", doc,
                    ("reduce", "fleet", "quantiles")[j % 3]))
    return out


def phase_path_s(name, batching, dev, extra=None,
                 need=("threefry_fill", "sampler_windows",
                       "block_step_scenario", "scenario_fold")):
    """Serve path S's requests through an in-process server with the
    given batching (``extra``: SimConfig overrides); returns ({rid:
    result as JSON}, launches)."""
    from tmhpvsim_torch.obs.metrics import MetricsRegistry
    from tmhpvsim_torch.serve.server import (ScenarioClient, ScenarioServer,
                                             ServeConfig)

    cfg = ServeConfig(sim=SimConfig(**dict(PATH_S, **(extra or {}))),
                      url="local://smoke-serve",
                      max_batch=16, window_s=PATH_S_WINDOW,
                      batching=batching, timeout_s=900.0, device=dev)
    reqs = path_s_requests()
    reg = MetricsRegistry()

    async def serve():
        t0 = time.perf_counter()
        server = ScenarioServer(cfg, registry=reg)
        await server.start()
        warm = time.perf_counter() - t0
        clients = [ScenarioClient(cfg.url) for _ in range(PATH_S_CLIENTS)]
        try:
            for c in clients:
                await c.__aenter__()
            k = PATH_S_PER_CLIENT

            async def client(ci):
                return await asyncio.gather(*[
                    clients[ci].request(doc, mode=mode, rid=rid,
                                        timeout=900.0)
                    for rid, doc, mode in reqs[ci * k:(ci + 1) * k]])

            t1 = time.perf_counter()
            got = await asyncio.gather(*[client(ci)
                                         for ci in range(len(clients))])
            wall = time.perf_counter() - t1
        finally:
            for c in clients:
                await c.__aexit__(None, None, None)
            await server.stop()
        return warm, wall, [r for g in got for r in g]

    (warm, wall, replies), _, launches = run_path(
        name, need, lambda: asyncio.run(serve()))
    n = PATH_S["n_chains"]
    results = {}
    for (rid, doc, mode), r in zip(reqs, replies):
        if not r.get("ok") or r["id"] != rid:
            fail(f"path {name}: request {rid} answered {r}")
        res = r["result"]
        h = doc["horizon_s"]
        count = (res["stats"]["n_seconds"] if mode == "reduce" else
                 res["fleet"]["count"] if mode == "fleet" else res["count"])
        if count != h * n or res["horizon_s"] != h:
            fail(f"path {name}: request {rid} folded {count} site-seconds, "
                 f"not {h * n}")
        text = json.dumps(res, sort_keys=True)
        if "NaN" in text or "Infinity" in text:
            fail(f"path {name}: request {rid} has a non-finite value")
        results[rid] = text
    lat = np.asarray([r["t"]["reply_latency_s"] for r in replies])
    snap = reg.snapshot()
    batches = snap["counters"]["serve.batches_total"]
    rows = snap["histograms"]["serve.batch_occupancy"]["mean"]
    folded = sum(doc["horizon_s"] for _, doc, _ in reqs) * n
    print(f"path {name} ({batching} batching, {PATH_S_CLIENTS} clients x "
          f"{PATH_S_PER_CLIENT} requests, {n} chains x "
          f"{PATH_S['duration_s']} s in {PATH_S['block_s']} s blocks): "
          f"{wall:.3f} s wall for {len(reqs)} requests after a {warm:.3f} s "
          f"start, {len(reqs) / wall:.4g} requests/s, reply latency p50 "
          f"{np.percentile(lat, 50):.3f} s p99 {np.percentile(lat, 99):.3f}"
          f" s, {len(reqs) / batches:.3g} requests per dispatch "
          f"({batches:.0f} dispatches of {rows:.3g} scheduled rows on "
          f"average), {folded / wall:.6g} "
          f"scenario-site-seconds folded per second; launches {launches}")
    return results, launches


def phase_reference(dev):
    path = os.path.join(HERE, "tests", "data", "torch_port_reference.json")
    with open(path) as f:
        ref = json.load(f)
    if ref["config"] != SMALL:
        fail(f"reference file config {ref['config']} != {SMALL}")
    worst = {}

    def held(what, have, want):
        have, want = np.asarray(have, np.float64), np.asarray(want,
                                                              np.float64)
        if have.shape != want.shape or \
                not np.allclose(have, want, rtol=TOL[0], atol=TOL[1]):
            fail(f"reference: {what} differs from the JAX package "
                 f"(shapes {have.shape} {want.shape})")
        worst[what] = float(np.max(np.abs(have - want)
                                   / np.maximum(np.abs(want), 1.0)))

    def stats(what, got, want):
        for name, w in want.items():
            if name == "n_seconds":
                if not np.array_equal(got[name], np.asarray(w)):
                    fail(f"reference: {what} n_seconds differs")
                continue
            held(f"{what} {name}", got[name], w)

    stats("reduce", Simulation(SimConfig(**SMALL), device=dev).run_reduced(),
          ref["reduced"])
    blocks = list(Simulation(SimConfig(**SMALL), device=dev).run_ensemble())
    for k in ("meter", "pv"):
        held(f"ensemble {k}", np.concatenate([getattr(b, k)[0]
                                              for b in blocks]),
             ref["ensemble"][k])
    blocks = list(Simulation(SimConfig(**SMALL), device=dev).run_blocks())
    tr = ref["trace"]
    for k in ("meter", "pv"):
        held(f"trace {k}", getattr(blocks[0], k)[tr["chain"], :len(tr[k])],
             tr[k])
    grid = SiteGrid.regular(*ref["site_grid"]["regular"])
    stats("site-grid", Simulation(SimConfig(**dict(SMALL, site_grid=grid)),
                                  device=dev).run_reduced(),
          ref["site_grid"]["reduced"])
    fr = ref["fleet"]
    n_f, seed_f = fr["synthetic"]
    sim = Simulation(SimConfig(**dict(
        SMALL, fleet=FleetParams.synthetic(n_f, seed=seed_f),
        **fr["config"])), device=dev)
    stats("fleet", sim.run_reduced(), fr["reduced"])
    summary = sim.fleet_summary()
    slack = max(2, int(1e-4 * fr["summary"]["count"]))
    width = fr["summary"]["sketch"]["width_w"]
    worst_int = held_summary("fleet summary", summary, fr["summary"], slack,
                             width)
    # the wide formulation (K4 trace, then the K4 merges)
    wr = ref["wide"]
    stats("wide reduce", Simulation(SimConfig(**dict(
        SMALL, block_impl="wide", stats_fusion="split")),
        device=dev).run_reduced(), wr["reduced"])
    blocks = list(Simulation(SimConfig(**dict(SMALL, block_impl="wide")),
                             device=dev).run_ensemble())
    for k in ("meter", "pv"):
        want = wr["ensemble"][k]
        held(f"wide ensemble {k}", np.concatenate(
            [getattr(b, k)[0] for b in blocks])[:len(want)], want)
    sim = Simulation(SimConfig(**dict(
        SMALL, fleet=FleetParams.synthetic(n_f, seed=seed_f),
        block_impl="wide", **fr["config"])), device=dev)
    stats("wide fleet", sim.run_reduced(), wr["fleet"]["reduced"])
    worst_int = max(worst_int, held_summary(
        "wide fleet summary", sim.fleet_summary(), wr["fleet"]["summary"],
        slack, width))
    print("reference: small_config on the card matches the JAX package, "
          "scan and wide formulations "
          "(max relative error, relative to max(|JAX|, 1)): "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f"; fleet summary (synthetic({n_f}, seed={seed_f}), analytics "
          f"full): floats within rtol 1e-4 (quantiles within one sketch bin,"
          f" {width:.3g} W), counts within {slack} (largest difference "
          f"{worst_int})")


def held_summary(what, have, want, slack, width):
    """A fleet summary against the JAX package's: the same keys and
    Nones; integer counts within ``slack`` (``count`` exact; a residual a
    few float32 ULP off on the card can cross a sketch bin edge); quantiles
    within one sketch bin ``width``; other floats rtol 1e-4 / atol 1e-2.
    Returns the largest integer difference."""
    worst = 0
    if isinstance(want, dict):
        if set(have) != set(want):
            fail(f"reference: {what} keys {sorted(have)} != {sorted(want)}")
        for k in want:
            sub = f"{what}.{k}"
            if k == "count" and isinstance(want[k], int):
                if have[k] != want[k]:
                    fail(f"reference: {sub} {have[k]} != {want[k]}")
                continue
            w = width if k.startswith("p") and k[1:].isdigit() else None
            if w is not None:
                if abs(have[k] - want[k]) > w:
                    fail(f"reference: {sub} {have[k]} vs {want[k]}")
                continue
            worst = max(worst, held_summary(sub, have[k], want[k], slack,
                                            width))
        return worst
    if isinstance(want, list):
        if len(have) != len(want):
            fail(f"reference: {what} has {len(have)} entries")
        for i, (h, w) in enumerate(zip(have, want)):
            worst = max(worst, held_summary(f"{what}[{i}]", h, w, slack,
                                            width))
        return worst
    if want is None or isinstance(want, str):
        if have != want:
            fail(f"reference: {what} {have!r} != {want!r}")
        return 0
    if isinstance(want, int) and not isinstance(want, bool):
        d = abs(int(have) - want)
        if d > slack:
            fail(f"reference: {what} {have} != {want}")
        return d
    if not np.isclose(float(have), float(want), rtol=1e-4, atol=1e-2):
        fail(f"reference: {what} {have} vs {want}")
    return 0


# ---------------------------------------------------------------------------
# the precision levers: K11 (the table transcendentals) and K6s (strided site
# geometry), behind kernel_impl='table' and geom_stride


def levers_cfg(**kw):
    """The main paths' shape with both precision levers on."""
    return SimConfig(**{**HEADLINE, **LEVERS, **kw})


def k11_args(name, gen, dev, n=K11_N):
    """``n`` seeded arguments of ``name`` over its ``ARG_RANGES`` (log
    log-uniform; atan2 both arguments in [-1e3, 1e3]): ``(x, y)``."""
    if name == "arctan2":
        x, y = (gen.uniform(-1e3, 1e3, n) for _ in range(2))
        return (torch.from_numpy(x.astype(np.float32)).to(dev),
                torch.from_numpy(y.astype(np.float32)).to(dev))
    lo, hi = mtables.ARG_RANGES[name]
    x = (np.exp(gen.uniform(np.log(lo), np.log(hi), n)) if name == "log"
         else gen.uniform(lo, hi, n))
    return torch.from_numpy(x.astype(np.float32)).to(dev), None


def phase_k11(dev):
    """Each table function on the card against its plain version on the
    same 2**20 arguments, bit for bit, and timed (with torch's own libm
    call of the function beside it); then the site geometry with the
    table set on its own, bit for bit.  Returns ``({function: figures},
    the largest abs difference seen)``."""
    gen = np.random.default_rng(0)
    lib = {"sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
           "arcsin": torch.asin, "arccos": torch.acos,
           "arctan2": torch.atan2, "exp": torch.exp, "log": torch.log,
           "powc": torch.pow}
    out, err = {}, 0.0
    for name in k11.FUNCS:
        x, y = k11_args(name, gen, dev)
        for p in (POWC_EXPONENTS if name == "powc" else (None,)):
            got = k11.table_eval(name, x, y, p)
            want = k11.table_eval_plain(name, x, y, p)
            torch.cuda.synchronize()
            err = max(err, max_abs(got, want))
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                bad = int((got.view(torch.int32) !=
                           want.view(torch.int32)).sum())
                fail(f"K11 {name}: {bad} of {K11_N} values differ from the "
                     f"plain version (max ULP {ulp_diff(got, want)})")
            ms = time_ms(lambda: k11.table_eval(name, x, y, p), reps=20)
            plain = time_ms(lambda: k11.table_eval_plain(name, x, y, p),
                            reps=5)
            if name == "spencer_factor":
                lib_ms = None
            else:
                args = (x, y) if name == "arctan2" else \
                    (x, p) if name == "powc" else (x,)
                lib_ms = time_ms(lambda: lib[name](*args), reps=20)
            n_in = 2 if y is not None else 1
            bms, by, _ = bound(0, K11_N * k11.OPS[name],
                               K11_N * 4 * (n_in + 1))
            key = name if p is None else f"{name}({p})"
            out[key] = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                        "bound_by": by, "library_ms": lib_ms}
    # the geometry device function with the table set on its own
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, site_grid=grid_b(),
                           kernel_impl="table"))
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    _, _, site = sim.geometry_args(state)
    rows = sim.host_inputs(0).rows_f[:, :240].contiguous()
    got = k3.device_geometry_fields(rows, site, kernels="table")
    want = k3.geometry_fields_plain(rows, site, kernels="table")
    torch.cuda.synchronize()
    err = max(err, max_abs(got, want))
    if not torch.equal(got, want):
        fail(f"K11 geometry fields differ from the plain version: max abs "
             f"{max_abs(got, want)}")
    print(f"K11 vs plain on {K11_N} arguments per function over ARG_RANGES "
          f"(powc at exponents {POWC_EXPONENTS}): every value bit-identical;"
          f" the site geometry with the table set on 240 s x "
          f"{cfg.n_chains} sites bit-identical")
    for key, f in out.items():
        lib_ms = "-" if f["library_ms"] is None else \
            f"{f['library_ms']:.4f} ms"
        print(f"timing K11 {key}: kernel {f['ms']:.4f} ms, plain "
              f"{f['plain_ms']:.3f} ms, torch's libm call {lib_ms}, bound "
              f"{f['bound_ms']:.4f} ms ({f['bound_by']})")
    return out, err


def check_same(what, k, p):
    """Every tensor of ``k`` equal to ``p``'s bit for bit."""
    for name in p:
        if not torch.equal(k[name], p[name]):
            fail(f"{what} {name} differs from the plain version: "
                 f"{int((k[name] != p[name]).sum())} of {k[name].numel()} "
                 f"values, max abs {max_abs(k[name], p[name])}")


def phase_k6s(dev):
    """K6s: the strided block step (stride 60) against its plain version,
    the exact and the table set, at the main paths' shape on path B's
    grid and on path F's fleet, 2 daylight blocks each: acc (statistics
    and the renewal carry bit-identical, a rerun bit-identical), trace
    (every meter and pv bit-identical) and K10 at 16 rows (check_scenario);
    first the same acc check of the shared step with the table set (path
    R-T's launch); the observers of path F-L's launch in phase_k89.
    Returns the largest abs difference of the K10 float sums (0 where
    bit-identical)."""
    for ks, grid, stride in (("table", None, 0), ("exact", grid_b(), 60),
                             ("table", grid_b(), 60)):
        cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, site_grid=grid,
                               geom_stride=stride, kernel_impl=ks))
        sim, state, blocks = check_blocks(cfg, dev)
        tilt, alb, site = sim.geometry_args(state)
        mw = cfg.meter_max_w
        acc_k, acc_p = sim.init_reduce_acc(), sim.init_reduce_acc()
        carry_k, carry_p = clone(state["carry"]), clone(state["carry"])
        what = f"{'K11' if site is None else 'K6s'} ({ks})"
        for ins, tables in blocks:
            head = head_of(state, ins, tables)
            tail = (cfg.duration_s, mw, tilt, alb)
            c2, a2 = clone(carry_k), clone(acc_k)
            carry_k, acc_k = k3.block_step_acc(*head, carry_k, acc_k, *tail,
                                               site=site, kernels=ks)
            c2, a2 = k3.block_step_acc(*head, c2, a2, *tail, site=site,
                                       kernels=ks)
            carry_p, acc_p = k3.block_step_plain(*head, carry_p, acc_p,
                                                 *tail, site=site,
                                                 kernels=ks)
            torch.cuda.synchronize()
            check_same(f"{what} rerun", a2, acc_k)
            check_same(f"{what} rerun carry", c2, carry_k)
            check_same(what, acc_k, acc_p)
            check_same(f"{what} renewal carry", carry_k, carry_p)
        if float(acc_k["pv_max"].max()) <= 10.0:
            fail(f"{what} check blocks saw no daylight")
        print(f"{what} vs plain on 2 blocks x {cfg.n_chains} "
              f"{'chains (shared site)' if site is None else 'sites'}"
              f"{'' if site is None else ', stride 60'}: 7/7 statistics and "
              "the renewal carry bit-identical; a rerun bit-identical")
    # path F-L's fleet: trace and K10
    fp = fleet_f()
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, fleet=fp, **LEVERS))
    sim, state, blocks = fleet_blocks(cfg, dev)
    _, _, site = sim.geometry_args(state)
    fleet = sim.fleet_leaves(state)
    ks = sim.plan.kernel_impl
    mw = cfg.meter_max_w
    carry_k, carry_p = clone(state["carry"]), clone(state["carry"])
    for ins, tables in blocks:
        head = head_of(state, ins, tables)
        carry_k, mk, pk = k3.block_step_trace(*head, carry_k, mw, None, None,
                                              site=site, fleet=fleet,
                                              kernels=ks)
        carry_p, mp, pp = k3.trace_plain(*head, carry_p, mw, None, None,
                                         site=site, fleet=fleet, kernels=ks)
        torch.cuda.synchronize()
        check_same("K6s trace (fleet, table set)", {"meter": mk, "pv": pk},
                   {"meter": mp, "pv": pp})
        del mk, pk, mp, pp
    check_same("K6s trace renewal carry", carry_k, carry_p)
    rows = k10_rows(0, cfg.duration_s)
    scen = schema.encode_batch(rows, len(rows), device=dev)
    params = sim.scenario_fleet_params()
    cohort = sim.scenario_cohort()
    acc_k = sim.init_scenario_acc(len(rows))
    carry_k, carry_p = clone(state["carry"]), clone(state["carry"])
    err, n_same = 0.0, 0
    for bi, (ins, tables) in enumerate(blocks):
        head = head_of(state, ins, tables)
        tail = (cfg.duration_s, mw, None, None)
        kw = dict(site=site, fleet=fleet, scen=scen, params=params,
                  cohort=cohort, per_chain=True, kernels=ks)
        acc_p = {k: v.clone() for k, v in acc_k.items()}
        carry_k, acc_k, dk = k3.block_step_scenario(*head, carry_k, acc_k,
                                                    *tail, **kw)
        carry_p, acc_p, dp = k3.scenario_plain(*head, carry_p, acc_p,
                                               *tail, **kw)
        torch.cuda.synchronize()
        e, n_same = check_scenario(f"strided fleet block {bi}", acc_k, dk,
                                   acc_p, dp)
        err = max(err, e)
    check_same("K10 (strided fleet) renewal carry", carry_k, carry_p)
    print(f"K6s trace (table set, stride 60) vs plain on 2 blocks x "
          f"{sim.config.n_chains} fleet sites: every meter and pv value "
          f"bit-identical; K10 there at {len(rows)} rows: {n_same}/7 "
          f"statistics bit-identical in the last block (float sums max abs "
          f"{err:.3g}), every FleetAcc count, histogram, extremum and "
          "per-chain leaf bit-identical")
    return err


def phase_reference_levers(dev):
    """The port with both levers at the JAX suite's ``small_config`` shape
    for a shared site, the 4-site grid of tests/test_geom_stride.py and a
    12-site synthetic fleet, on the card and through the plain versions
    on the host CPU (which tests/test_torch_stride.py holds against the
    JAX package): every reduce statistic bit-identical."""
    grid = SiteGrid(latitude=(0.0, 48.12, 52.5, 70.0),
                    longitude=(11.6, 11.6, 13.4, 20.0),
                    altitude=(10.0, 520.0, 34.0, 5.0),
                    surface_tilt=(10.0, 30.0, 35.0, 60.0),
                    surface_azimuth=(180.0, 180.0, 175.0, 180.0))
    for what, kw in (("shared site", {}), ("grid", {"site_grid": grid}),
                     ("fleet", {"fleet": FleetParams.synthetic(12, seed=3)})):
        cfg = SimConfig(**dict(SMALL, output="reduce", **LEVERS, **kw))
        got = Simulation(cfg, device=dev).run_reduced()
        want = Simulation(cfg, device="cpu").run_reduced()
        for k in want:
            if not np.array_equal(got[k], want[k]):
                fail(f"levers at small_config ({what}): {k} on the card "
                     "differs from the host's plain run")
        if float(want["pv_max"].max()) <= 10.0:
            fail(f"levers at small_config ({what}): no daylight")
    print("levers at small_config (shared site, 4-site grid, 12-site fleet; "
          "geom_stride=60, kernel_impl=table): every reduce statistic on the "
          "card bit-identical to the host's plain run")


def phase_path_rt(dev):
    cfg = levers_cfg(geom_stride=0)
    sim = Simulation(cfg, device=dev)
    reduced, wall, launches = run_path(
        "R-T", ("threefry_fill", "sampler_windows", "block_step_table"),
        sim.run_reduced)
    pv_max = check_reduced("R-T", reduced, cfg.duration_s)
    print(f"path R-T (reduce, shared site, kernel_impl=table): "
          f"{cfg.n_chains} chains x {cfg.duration_s} s in {sim.n_blocks} "
          f"blocks: {wall:.3f} s wall, "
          f"{cfg.n_chains * cfg.duration_s / wall:.6g} site-s/s; fleet "
          f"pv_max {pv_max:.2f} W; launches {launches}")
    return launches, sim.ensemble_stats()


def phase_path_bl(dev):
    cfg = levers_cfg(site_grid=grid_b())
    sim = Simulation(cfg, device=dev)
    reduced, wall, launches = run_path(
        "B-L", ("threefry_fill", "sampler_windows",
                "block_step_strided_table"), sim.run_reduced)
    n = sim.config.n_chains
    pv_max = check_reduced("B-L", reduced, cfg.duration_s)
    print(f"path B-L (site-grid reduce, geom_stride=60, kernel_impl=table; "
          f"the levers' main path): {n} sites x {cfg.duration_s} s in "
          f"{sim.n_blocks} blocks: {wall:.3f} s wall, "
          f"{n * cfg.duration_s / wall:.6g} site-s/s; fleet pv_max "
          f"{pv_max:.2f} W; pv_sum over sites min/max "
          f"{float(reduced['pv_sum'].min()):.4g}/"
          f"{float(reduced['pv_sum'].max()):.4g} Ws; launches {launches}")
    return launches, sim.ensemble_stats()


def phase_path_fl(dev):
    fp = fleet_f()
    cfg = levers_cfg(fleet=fp, telemetry="full", analytics="full")
    sim = Simulation(cfg, device=dev)
    (reduced, summary), wall, launches = run_path(
        "F-L", ("threefry_fill", "sampler_windows_regime",
                "block_step_prod_strided_table", "block_step_fleet",
                "block_step_tel_analytics", "obs_fold",
                "chainwise_collapse"),
        lambda: (sim.run_reduced(), sim.fleet_summary()))
    n = sim.config.n_chains
    pv_max = check_reduced("F-L", reduced, cfg.duration_s)
    total = n * cfg.duration_s
    if summary["count"] != total:
        fail(f"path F-L: the fleet sketch holds {summary['count']} of "
             f"{total} site-seconds")
    q = summary["residual"]["quantiles"]
    print(f"path F-L (path F's fleet reduce with geom_stride=60, "
          f"kernel_impl=table): {n} sites x {cfg.duration_s} s in "
          f"{sim.n_blocks} blocks: {wall:.3f} s wall, {total / wall:.6g} "
          f"site-s/s; fleet pv_max {pv_max:.2f} W; residual p1/p50/p99 "
          f"{q['p1']:.1f}/{q['p50']:.1f}/{q['p99']:.1f} W, LOLP "
          f"{summary['lolp']['prob']:.3g}; launches {launches}")
    return launches, sim.ensemble_stats()


def phase_path_gl():
    from tmhpvsim_torch.cli import main as cli

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "path_gl_reduce.csv")
    rep = os.path.join(build.BUILD_DIR, "path_gl_report.json")
    try:
        rc, wall, launches = run_path(
            "G-L", ("sampler_windows", "block_step_strided_table"),
            lambda: cli(["pvsim", out] + PATH_GL_ARGS + ["--run-report",
                                                        rep]))
        if rc != 0:
            fail(f"path G-L: the CLI returned {rc}")
        with open(out) as f:
            rows = f.read().splitlines()
        with open(rep) as f:
            report = json.load(f)
    finally:
        for path in (out, rep):
            if os.path.exists(path):
                os.remove(path)
    n = PATH_GL_SITES
    if len(rows) != n + 2 or rows[-1].split(",")[0] != "ensemble":
        fail(f"path G-L: {len(rows)} CSV lines")
    prec = report.get("precision")
    if prec is None or prec["kernel_impl"] != "table" or \
            prec["geom_stride"] != 60:
        fail(f"path G-L: run report precision section {prec}")
    print(f"path G-L (CLI pvsim --output reduce --site-grid "
          f"47:55:64,6:15:64 --geom-stride 60 --kernel-impl table "
          f"--duration 3600 --run-report): {wall:.3f} s wall incl. the CSV "
          f"and the report; {n} site rows plus the ensemble row; report "
          f"precision {json.dumps(prec)}; launches {launches}")
    return launches


def strided_f32(ks, n, T, stride):
    """Float32 operations of one strided acc block: per chain-second K3's
    (with the set's exp and log), the lerp and the physics terms from the
    lerped geometry; per chain and stride sample the site half of the
    geometry; per sample its time half."""
    S = T // stride + 1
    return (n * T * (k3_second_f(ks) + NORMAL_F + UNIFORM_F + 1
                     + LERP_SECOND_F + phys_f(ks))
            + n * S * geo_site_f(ks) + S * geo_time_f(ks))


def phase_timing_levers(dev):
    """K11 through the shared acc step (path R-T's launch) and K6s (path
    B-L's launch, and the same with the exact set) on the noon block, with
    their plain versions; then the K10 row reset of continuous batching.
    Bounds as phase_timing's, with the table set's own operation counts."""
    from tmhpvsim_torch.serve.schema import Request
    from tmhpvsim_torch.serve.server import RollingSession, ScenarioEngine

    out = {}
    n, T = HEADLINE["n_chains"], HEADLINE["block_s"]
    int_ops = n * (T * K3_SECOND_I + (T // 60) * K3_MINUTE_I)
    draws_f = NORMAL_F + UNIFORM_F + 1
    # K11: the shared acc step with the table set (path R-T)
    sim = Simulation(levers_cfg(geom_stride=0), device=dev)
    state = sim.init_state()
    ins = sim.host_inputs(40)
    tables, _ = sim._windows(state, ins)
    site = sim.config.site
    args = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
            state["k_meter"], clone(state["carry"]), sim.init_reduce_acc(),
            sim.config.duration_s, sim.config.meter_max_w, site.surface_tilt,
            site.albedo)
    table_bytes = sum(t.numel() * 4 for t in tables.values())
    in_bytes = (table_bytes + n * 8 * 2 + n * 4 * 3 * 2
                + ins.rows_i.numel() * 4 + ins.rows_f.numel() * 4)
    ms = time_ms(lambda: k3.block_step_acc(*args, kernels="table"))
    plain = time_ms(lambda: k3.block_step_plain(*args, kernels="table"),
                    reps=1)
    out["K11"] = (ms, plain, *bound(
        int_ops, n * T * (k3_second_f("table") + draws_f),
        in_bytes + n * 4 * 7 * 2))
    # K6s: path B-L's grid on its noon block, both kernel sets
    for key, ks in (("K6s", "table"), ("K6sX", "exact")):
        gsim = Simulation(levers_cfg(site_grid=grid_b(), kernel_impl=ks),
                          device=dev)
        gstate = gsim.init_state()
        gins = gsim.host_inputs(40)
        gtables, _ = gsim._windows(gstate, gins)
        _, _, gsite = gsim.geometry_args(gstate)
        gargs = (gtables, gins.rows_i, gins.rows_f, gstate["k_scan"],
                 gstate["k_meter"], clone(gstate["carry"]),
                 gsim.init_reduce_acc(), gsim.config.duration_s,
                 gsim.config.meter_max_w, None, None)
        ms = time_ms(lambda: k3.block_step_acc(*gargs, site=gsite,
                                               kernels=ks))
        plain = time_ms(lambda: k3.block_step_plain(*gargs, site=gsite,
                                                    kernels=ks), reps=1)
        g_table_bytes = sum(t.numel() * 4 for t in gtables.values())
        g_in = (g_table_bytes + n * 8 * 2 + n * 4 * 3 * 2 + n * 4 * 6
                + 12 * 4 + gins.rows_i.numel() * 4
                + gins.rows_f.numel() * 4)
        out[key] = (ms, plain, *bound(
            int_ops, strided_f32(ks, n, T, 60), g_in + n * 4 * 7 * 2))
    # path F-L's launch: K8+K9 in the strided table-set step of the fleet
    fsim = Simulation(levers_cfg(fleet=fleet_f(), telemetry="full",
                                 analytics="full"), device=dev)
    fstate = fsim.init_state()
    fins = fsim.host_inputs(40)
    ftables, _ = fsim._windows(fstate, fins)
    _, _, fsite = fsim.geometry_args(fstate)
    obs = fsim.observers(fstate)
    fargs = (ftables, fins.rows_i, fins.rows_f, fstate["k_scan"],
             fstate["k_meter"], clone(fstate["carry"]),
             fsim.init_reduce_acc(), fsim.config.duration_s,
             fsim.config.meter_max_w, None, None)
    fkw = dict(site=fsite, fleet=fsim.fleet_leaves(fstate), obs=obs,
               kernels="table")
    ms = time_ms(lambda: k3.block_step_obs(*fargs, **fkw))
    plain = time_ms(lambda: k3.block_step_obs_plain(*fargs, **fkw), reps=1)
    ms_p, ms_f, plain_p, plain_f = obs_parts_ms(
        fargs, {k: v for k, v in fkw.items() if k != "obs"}, obs)
    n_ctas = (n + k3.THREADS - 1) // k3.THREADS
    nb, C = fsim._fleet_params.bins + 2, fsim._n_cohorts
    f_bytes = (sum(t.numel() * 4 for t in ftables.values()) + n * 8 * 2
               + n * 4 * 3 * 2 + n * 4 * 6 + 12 * 4
               + fins.rows_i.numel() * 4 + fins.rows_f.numel() * 4
               + n * 4 * 4 + n * 4 * 7 * 2 + n_ctas * 25 * 8 + 9 * 4
               + n_ctas * (15 + 6 * C) * 8 + n * 4 + 4 * (nb + 8 + C * nb))
    out["K89L"] = (ms, plain, *bound(
        int_ops + n * T * (TEL_SECOND_I + FLT_SECOND_I),
        strided_f32("table", n, T, 60) + n * T * (K7_SECOND_F + TEL_SECOND_F +
        FLT_SECOND_F), f_bytes))
    # its two launches on their own: the producer (K6s with K7, its arrays
    # written once) and the observer fold
    out["K89LP"] = (ms_p, plain_p, *bound(
        int_ops, strided_f32("table", n, T, 60) + n * T * K7_SECOND_F,
        f_bytes + n * T * OBS_FOLD_BYTES))
    out["K89LF"] = (ms_f, plain_f, *obs_fold_bound(n, T, obs))
    for name, (ms, plain, bms, by, ibms) in out.items():
        print(f"timing {name}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
              f"bound {bms:.4f} ms ({by}), issue bound "
              f"{ibms:.4f} ms")
    # the K10 row reset: every slot of a 16-row session admitted at once
    engine = ScenarioEngine(SimConfig(**HEADLINE), (K10_B,), device=dev)
    sess = RollingSession(engine, K10_B)
    items = [(i, Request(id=f"r{i}", reply_to="x", mode="reduce",
                         scenario=sc))
             for i, sc in enumerate(k10_rows(0, HEADLINE["duration_s"]))]
    ms = time_ms(lambda: sess.admit_rows(items), reps=20)
    nbytes = sum(3 * v.numel() * v.element_size()
                 for tree in (sess.acc, sess.total) for v in tree.values())
    bms, by, ibms = bound(0, 0, nbytes)
    out["K10R"] = (ms, None, bms, by, ibms)
    print(f"timing K10 row reset (RollingSession.admit_rows, {K10_B} rows "
          f"x {n} chains, plain torch.where): {ms:.4f} ms per admission; "
          f"bound {bms:.4f} ms ({by}: {nbytes} bytes, pristine and current "
          "read, the new rows written)")
    return out


# ---------------------------------------------------------------------------
# the wide formulation: K4 merges (wide_fold, wide_series) and the plan
# knobs that give the scan's bits


def wide_traces(cfg, dev):
    """The K4 trace of ``cfg``'s two check blocks, with each block's
    carry before it: ``(sim, state, [(inputs, tables, carry, meter, pv),
    ...])``."""
    sim, state, blocks = (fleet_blocks if cfg.fleet is not None
                          else check_blocks)(cfg, dev)
    tilt, alb, site = sim.geometry_args(state)
    fleet = sim.fleet_leaves(state)
    carry = clone(state["carry"])
    out = []
    for ins, tables in blocks:
        head = head_of(state, ins, tables)
        before = clone(carry)
        carry, meter, pv = k3.block_step_trace(
            *head, carry, cfg.meter_max_w, tilt, alb, site=site, fleet=fleet)
        out.append((ins, tables, before, meter, pv))
    return sim, state, out


def check_wide_fold(label, sim, traces, obs, dur):
    """K4m fold against its plain version on each trace block: the seven
    statistics (n_seconds and extrema bit for bit, sums to rtol 1e-6),
    with ``obs`` the per-chain leaves, counts, histograms and extrema bit
    for bit and the sums within 1e-6 of the float64 plain sums, and a
    rerun bit-identical.  Returns ``(rel, err, stat_err, events, same)``:
    the observers' largest sum errors, the statistics' largest absolute
    error, the LOLP events and the statistics bit-identical to the plain
    fold (of 7 per block)."""
    rel = err = stat_err = 0.0
    events = same = 0
    tel_sums = [(f"{k}_{f}", f"{k}_{f}") for f in ("meter", "pv",
                                                  "residual")
                for k in ("sum", "sumsq")]
    flt_sums = [(f"cohort_sum_{f}", f"cohort_sum_{f}")
                for f in ("meter", "pv", "residual")]
    for ins, _, _, meter, pv in traces:
        t = ins.rows_i[0]
        acc_k, out_k = k4m.wide_fold(meter, pv, t, dur, sim.init_reduce_acc(),
                                     obs)
        acc_2, out_2 = k4m.wide_fold(meter, pv, t, dur, sim.init_reduce_acc(),
                                     obs)
        acc_p, out_p = k4m.wide_fold_plain(meter, pv, t, dur,
                                           sim.init_reduce_acc(), obs)
        torch.cuda.synchronize()
        if not (all(torch.equal(acc_k[k], acc_2[k]) for k in acc_k)
                and same_out(out_k, out_2)):
            fail(f"K4m fold ({label}): a second run is not bit-identical")
        for k in acc_p:
            a, b = acc_k[k], acc_p[k]
            if k.endswith("_sum"):
                if not close(a, b, rtol=1e-6, atol=0.0):
                    fail(f"K4m fold ({label}) {k} differs from the plain "
                         f"version: max abs {max_abs(a, b)}")
                stat_err = max(stat_err, max_abs(a, b))
            elif not torch.equal(a, b):
                fail(f"K4m fold ({label}) {k} differs from the plain version")
            same += int(torch.equal(a, b))
        if obs is None:
            continue
        C = obs.n_cohorts if obs.cohort is not None else 0
        for d, sums in (("telemetry", tel_sums), ("fleet", flt_sums)):
            if out_p[d] is None:
                continue
            check_chain(f"K4m fold ({label}) {d}", out_k[f"{d}_chain"],
                        out_p[f"{d}_chain"])
            p64 = _plain_sums(out_p[f"{d}_chain"],
                              [x for x in sums if x[1] in out_p[f"{d}_chain"]],
                              obs.cohort, C)
            r, e = check_sketch(f"K4m fold ({label}) {d}", out_k[d],
                                out_p[d], p64)
            rel, err = max(rel, r), max(err, e)
        if out_k["fleet"] is not None:
            f = out_k["fleet"]
            total = int(f["count"])
            for leaf in ("res_hist", "exceed", "cohort_count",
                         "cohort_hist"):
                if leaf in f and int(f[leaf].sum()) != total:
                    fail(f"K4m fold ({label}): {leaf} does not hold every "
                         "sample")
            if len(obs.params.thresholds) > k3.MAX_THR and \
                    int((f["exceed"] > 0).sum()) < 3:
                fail(f"K4m fold ({label}): the samples fill fewer than 3 "
                     "exceedance slots")
            events += int(f["lol_events"])
    return rel, err, stat_err, events, same


def phase_k4m(dev):
    """K4m fold and series against their plain versions on the K4 trace
    of 2 daylight blocks x 65536 chains: acc only (and against K3's acc on
    the same blocks), acc with TEL, acc with TEL + FLT on path F's fleet
    (level full, 3 cohorts), FLT with 64 cohorts and with 30000 bins (the
    global-memory branches); the series against its plain version and
    against the scan's series kernel on the same blocks."""
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START))
    sim, state, traces = wide_traces(cfg, dev)
    dur, mw = cfg.duration_s, cfg.meter_max_w
    tilt, alb, _ = sim.geometry_args(state)
    report = []
    rel = err = stat_err = 0.0
    for label, obs in (("acc", None),
                       ("acc + TEL full", k3.Observers(telemetry="full",
                                                       per_chain=True))):
        r, e, se, _, same = check_wide_fold(label, sim, traces, obs, dur)
        rel, err, stat_err = max(rel, r), max(err, e), max(stat_err, se)
        if obs is None and same != 7 * len(traces):
            fail(f"K4m fold (acc): {same}/{7 * len(traces)} statistics "
                 "bit-identical to the plain fold")
        report.append(f"{label}: {same}/{7 * len(traces)} statistics "
                      "bit-identical to the plain fold")
    # the fold on the trace against K3's acc on the same blocks
    k3_same = k3_chains = 0
    for ins, tables, before, meter, pv in traces:
        head = head_of(state, ins, tables)
        _, acc3 = k3.block_step_acc(*head, clone(before),
                                    sim.init_reduce_acc(), dur, mw, tilt,
                                    alb)
        accw, _ = k4m.wide_fold(meter, pv, ins.rows_i[0], dur,
                                sim.init_reduce_acc())
        torch.cuda.synchronize()
        k3_same += int(sum(torch.equal(acc3[k], accw[k]) for k in acc3))
        k3_chains += int(torch.stack([acc3[k] == accw[k]
                                      for k in k3.ACC_F]).all(0).sum())
        for k in acc3:
            if not close(acc3[k], accw[k]):
                fail(f"K4m fold: {k} on the trace differs from K3's acc "
                     f"beyond the engine tolerance: max abs "
                     f"{max_abs(acc3[k], accw[k])}")
    if k3_same != 7 * len(traces):
        fail(f"K4m fold: {k3_same}/{7 * len(traces)} statistics on the "
             "trace bit-identical to K3's acc on the same blocks")
    # the series: against its plain version and the scan's series kernel
    s_err = 0.0
    s_same = 0
    for ins, tables, before, meter, pv in traces:
        head = head_of(state, ins, tables)
        ms, ps = k4m.wide_series(meter, pv)
        ms2, ps2 = k4m.wide_series(meter, pv)
        mp, pp = k4m.wide_series_plain(meter, pv)
        _, part = k3.series_partials_cuda(*head, clone(before), mw, tilt,
                                          alb)
        scan = k3.series_sum(part)
        torch.cuda.synchronize()
        if not (torch.equal(ms, ms2) and torch.equal(ps, ps2)):
            fail("K4m series: a second run is not bit-identical")
        for what, a, b in (("meter", ms, mp), ("pv", ps, pp)):
            if not close(a, b, rtol=1e-6, atol=0.0):
                fail(f"K4m series {what} sums differ from the plain "
                     f"version: max abs {max_abs(a, b)}")
            s_err = max(s_err, max_abs(a, b))
        s_same += int(torch.equal(ms, scan[0])) + int(torch.equal(ps,
                                                                  scan[1]))
    del traces
    # path F's fleet: TEL + FLT (F-W's launch), many cohorts, wide bins
    fp = fleet_f()
    fcfg = SimConfig(**dict(HEADLINE, start=CHECK_START, fleet=fp,
                            telemetry="full", analytics="full"))
    fsim, fstate, ftraces = wide_traces(fcfg, dev)
    n = fsim.config.n_chains
    params = dataclasses.replace(fsim._fleet_params, capacity_w=K9_CAPACITY,
                                 lolp_k=K9_LOLP_K)
    own = fstate["fleet"]["cohort"], fsim._n_cohorts
    many = torch.arange(n, device=dev, dtype=torch.int32) % K9_MANY_COHORTS
    wide_bins = dataclasses.replace(params, bins=K9_WIDE_BINS)
    nt = len(K9_MANY_THR)
    for label, obs, paths in (
            ("TEL + FLT full, 3 cohorts (path F-W's launch)",
             k3.Observers(telemetry="full", analytics="full", params=params,
                          cohort=own[0], n_cohorts=own[1], per_chain=True),
             (True, True)),
            (f"FLT, {K9_MANY_COHORTS} cohorts, global cohort histogram",
             k3.Observers(analytics="full", params=params, cohort=many,
                          n_cohorts=K9_MANY_COHORTS, per_chain=True),
             (True, False)),
            (f"FLT, {K9_WIDE_BINS} bins, global residual, exceedance and "
             "cohort histograms",
             k3.Observers(analytics="full", params=wide_bins, cohort=own[0],
                          n_cohorts=own[1], per_chain=True), (False, False)),
            (f"TEL + FLT full, {nt} thresholds (exceedance by shared "
             "atomics)",
             k3.Observers(telemetry="full", analytics="full",
                          params=dataclasses.replace(
                              params, thresholds=K9_MANY_THR),
                          cohort=own[0], n_cohorts=own[1], per_chain=True),
             (True, True)),
            (f"FLT, {K9_WIDE_BINS} bins and {nt} thresholds (exceedance by "
             "global atomics)",
             k3.Observers(analytics="full", params=dataclasses.replace(
                 wide_bins, thresholds=K9_MANY_THR), cohort=own[0],
                 n_cohorts=own[1], per_chain=True), (False, False))):
        # F-W's launch on both blocks, the other branches on the second
        traces = ftraces if label.endswith("(path F-W's launch)") \
            else ftraces[-1:]
        prm, C = obs.params, obs.n_cohorts
        hist_bytes = 4 * (prm.bins + len(prm.thresholds) + 3)
        coh_bytes = 4 * C * (prm.bins + 2)
        if (hist_bytes <= k3.SMEM_MAX,
                hist_bytes + coh_bytes <= k3.SMEM_MAX) != paths:
            fail(f"K4m fold: the {label} run would not take that path")
        r, e, se, events, same = check_wide_fold(label, fsim, traces, obs,
                                                 fcfg.duration_s)
        if events == 0:
            fail(f"K4m fold ({label}): no loss-of-load run in the blocks")
        rel, err, stat_err = max(rel, r), max(err, e), max(stat_err, se)
        report.append(f"{label}: {same}/{7 * len(traces)} statistics "
                      f"bit-identical, {events} LOLP events")
    print(f"K4m fold vs plain on the K4 trace of 2 blocks x {n} chains "
          f"(the fleet's branches past F-W's launch on the second; "
          f"capacity {K9_CAPACITY} W, lolp_k {K9_LOLP_K} for FLT): "
          + "; ".join(report) + f"; statistics' sums within rtol 1e-6 (max "
          f"abs {stat_err:.3g}), every per-chain leaf, count, histogram and "
          f"extremum bit-identical, observer sums within {rel:.3g} "
          f"(relative; {err:.3g} absolute) of the float64 plain sums; "
          "reruns bit-identical")
    print(f"K4m fold on the trace vs K3's acc on the same 2 blocks: "
          f"{k3_same}/14 statistics bit-identical, {k3_chains}/"
          f"{2 * cfg.n_chains} chains with every float statistic "
          "bit-identical")
    print(f"K4m series vs plain on 2 blocks: per-second sums within rtol "
          f"1e-6 (max abs {s_err:.3g} W), a rerun bit-identical; "
          f"{s_same}/4 per-second series bit-identical to the scan's "
          "series kernel on the same blocks")
    return stat_err, (rel, err), s_err


def phase_wide_fused(dev):
    """The wide formulation's fused topology launches the acc epilogue
    (producer, statistics and merge in one): 2 blocks against path R's
    launch on the same blocks, bit for bit."""
    base = dict(HEADLINE, start=CHECK_START,
                duration_s=2 * HEADLINE["block_s"])
    want = Simulation(SimConfig(**base), device=dev).run_reduced()
    sim = Simulation(SimConfig(**dict(base, block_impl="wide",
                                      stats_fusion="fused")), device=dev)
    got, _, launches = run_path("wide fused", ("block_step",),
                                sim.run_reduced)
    if launches.get("wide_fold") or launches.get("block_step_trace"):
        fail(f"wide fused launched the split topology: {launches}")
    for k in want:
        if not np.array_equal(got[k], want[k]):
            fail(f"wide fused: {k} differs from path R's launch")
    print(f"wide fused topology: 2 blocks x {sim.config.n_chains} chains "
          f"bit-identical to path R's launch; launches {launches}")


def phase_path_rw(dev, reduced_r):
    cfg = SimConfig(**dict(HEADLINE, block_impl="wide",
                           stats_fusion="split"))
    sim = Simulation(cfg, device=dev)
    reduced, wall, launches = run_path(
        "R-W", ("threefry_fill", "sampler_windows", "block_step_trace",
                "wide_fold"), sim.run_reduced)
    if launches.get("block_step"):
        fail("path R-W launched the acc epilogue")
    pv_max = check_reduced("R-W", reduced, cfg.duration_s)
    same = held_reduced("R-W", reduced, reduced_r)
    print(f"path R-W (reduce, shared site, block_impl=wide, "
          f"stats_fusion=split): {cfg.n_chains} chains x {cfg.duration_s} s "
          f"in {sim.n_blocks} blocks: {wall:.3f} s wall, "
          f"{cfg.n_chains * cfg.duration_s / wall:.6g} site-s/s; fleet "
          f"pv_max {pv_max:.2f} W; {same}/7 statistics bit-identical to "
          f"path R's (the rest within the engine tolerance); launches "
          f"{launches}")
    return launches


def held_reduced(name, got, want):
    """Reduce statistics against another path's: n_seconds exact, the
    rest at the engine tolerance.  Returns how many are bit-identical."""
    for k in want:
        if k == "n_seconds":
            if not np.array_equal(got[k], want[k]):
                fail(f"path {name}: n_seconds differs")
        elif not np.allclose(got[k], want[k], rtol=TOL[0], atol=TOL[1]):
            fail(f"path {name}: {k} differs beyond the engine tolerance: "
                 f"max abs {np.max(np.abs(got[k] - want[k]))}")
    return sum(int(np.array_equal(got[k], want[k])) for k in want)


def phase_path_aw(dev, means_a):
    cfg = SimConfig(**dict(HEADLINE, output="ensemble", block_impl="wide"))
    sim = Simulation(cfg, device=dev)

    def run():
        return [(blk.meter[0], blk.pv[0]) for blk in sim.run_ensemble()]

    blocks, wall, launches = run_path(
        "A-W", ("sampler_windows", "block_step_trace", "wide_series",
                "series_sum"), run)
    if launches.get("block_step_series"):
        fail("path A-W launched the series epilogue")
    same = 0
    for i, (k, want) in enumerate(zip(("meter", "pv"), means_a)):
        got = np.concatenate([b[i] for b in blocks])
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"path A-W: {k} means of shape {got.shape}")
        if not np.allclose(got, want, rtol=TOL[0], atol=TOL[1]):
            fail(f"path A-W: {k} means differ from path A's beyond the "
                 "engine tolerance")
        same += int((got == want).sum())
    print(f"path A-W (ensemble, shared site, block_impl=wide): "
          f"{cfg.n_chains} chains x {cfg.duration_s} s in {sim.n_blocks} "
          f"blocks: {wall:.3f} s wall, "
          f"{cfg.n_chains * cfg.duration_s / wall:.6g} site-s/s; "
          f"{same}/{2 * cfg.duration_s} per-second means bit-identical to "
          f"path A's; launches {launches}")
    return launches


def phase_path_fw(dev, reduced_f):
    fp = fleet_f()
    cfg = SimConfig(**dict(HEADLINE, fleet=fp, telemetry="full",
                           analytics="full", block_impl="wide"))
    sim = Simulation(cfg, device=dev)
    (reduced, summary), wall, launches = run_path(
        "F-W", ("sampler_windows_regime", "block_step_trace_site",
                "block_step_fleet", "wide_fold", "wide_fold_tel",
                "wide_fold_analytics", "chainwise_collapse"),
        lambda: (sim.run_reduced(), sim.fleet_summary()))
    n = sim.config.n_chains
    check_reduced("F-W", reduced, cfg.duration_s)
    same = held_reduced("F-W", reduced, reduced_f)
    total = n * cfg.duration_s
    if summary["count"] != total or \
            sum(c["count"] for c in summary["cohorts"]) != total or \
            summary["regimes"] is not None:
        fail(f"path F-W: fleet summary count {summary['count']} of {total}"
             f", regimes {summary['regimes']}")
    tel_s = sim.tel_summary
    if tel_s["count"] != n * cfg.block_s or \
            tel_s["fields"]["csi"]["observed"]:
        fail(f"path F-W: the last block's telemetry {tel_s}")
    q = summary["residual"]["quantiles"]
    print(f"path F-W (path F with block_impl=wide): {n} sites x "
          f"{cfg.duration_s} s in {sim.n_blocks} blocks: {wall:.3f} s wall, "
          f"{total / wall:.6g} site-s/s; {same}/7 statistics bit-identical "
          f"to path F's (the rest within the engine tolerance); residual "
          f"p1/p50/p99 {q['p1']:.1f}/{q['p50']:.1f}/{q['p99']:.1f} W, LOLP "
          f"{summary['lolp']['prob']:.3g}, regimes and csi unobserved; "
          f"launches {launches}")
    return launches


def phase_path_rk(dev, reduced_r, wall_r):
    cfg = SimConfig(**dict(HEADLINE, **KNOBS))
    sim = Simulation(cfg, device=dev)
    reduced, wall, launches = run_path(
        "R-K", ("threefry_fill", "sampler_windows", "block_step"),
        sim.run_reduced)
    for k in reduced_r:
        if not np.array_equal(reduced[k], reduced_r[k]):
            fail(f"path R-K: {k} differs from path R's")
    print(f"path R-K (path R with blocks_per_dispatch=8, block_impl=scan2, "
          f"rng_batch=block): {wall:.3f} s wall (path R {wall_r:.3f} s in "
          f"this call), {cfg.n_chains * cfg.duration_s / wall:.6g} "
          f"site-s/s; every statistic bit-identical to path R's; launches "
          f"{launches}")
    return launches


def phase_path_gw():
    from tmhpvsim_torch.cli import main as cli

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "path_gw_reduce.csv")
    rep = os.path.join(build.BUILD_DIR, "path_gw_report.json")
    try:
        # no observer and the fused topology (the JAX CLI's default on an
        # accelerator): the acc launch
        rc, wall, launches = run_path(
            "G-W", ("sampler_windows", "block_step"),
            lambda: cli(["pvsim", out] + PATH_GW_ARGS + ["--run-report",
                                                        rep]))
        if rc != 0:
            fail(f"path G-W: the CLI returned {rc}")
        with open(out) as f:
            rows = f.read().splitlines()
        with open(rep) as f:
            report = json.load(f)
    finally:
        for path in (out, rep):
            if os.path.exists(path):
                os.remove(path)
    n = PATH_GW_CHAINS
    if len(rows) != n + 2 or rows[-1].split(",")[0] != "ensemble":
        fail(f"path G-W: {len(rows)} CSV lines")
    try:
        validate_report(report)
    except ValueError as e:
        fail(f"path G-W: the run report fails validation: {e}")
    plan = report["plan"]
    knobs = {k: plan[k] for k in ("block_impl", "stats_fusion",
                                  "blocks_per_dispatch", "rng_batch")}
    if knobs != {"block_impl": "wide", "stats_fusion": "fused",
                 "blocks_per_dispatch": 4, "rng_batch": "scan"} or \
            report["device"]["platform"] != "gpu":
        fail(f"path G-W: run report plan {plan}, device {report['device']}")
    print(f"path G-W (CLI pvsim --output reduce --block-impl wide "
          f"--blocks-per-dispatch 4 --chains {n} --duration 3600 "
          f"--run-report): {wall:.3f} s wall incl. the CSV and the report; "
          f"{n} chain rows plus the ensemble row; the report validates, "
          f"plan {json.dumps(knobs)}, device "
          f"{report['device']['device_kind']}; launches {launches}")
    return launches


def fold_library(meter, pv):
    """The wide fold's statistics by the library's reductions over the
    block's (T, n) arrays (no mask: a block whose seconds are all valid);
    a yardstick that the port never calls."""
    residual = meter - pv
    return (pv.sum(0), pv.amax(0), meter.sum(0), residual.sum(0),
            residual.amin(0), residual.amax(0))


def phase_timing_wide(dev):
    """K4m fold (acc only on path R's noon block; TEL + FLT, path F-W's
    launch, on path F's) and K4m series on path R's noon block, with their
    plain versions, bounds and, for the series, ``torch.sum(x, dim=1)`` on
    each array; and ``part.sum(1)`` beside ``series_sum``."""
    out = {}
    n, T = HEADLINE["n_chains"], HEADLINE["block_s"]
    sim = Simulation(SimConfig(**HEADLINE), device=dev)
    state = sim.init_state()
    ins = sim.host_inputs(40)
    tables, _ = sim._windows(state, ins)
    tilt, alb, _ = sim.geometry_args(state)
    _, meter, pv = k3.block_step_trace(
        tables, ins.rows_i, ins.rows_f, state["k_scan"], state["k_meter"],
        clone(state["carry"]), sim.config.meter_max_w, tilt, alb)
    t, dur = ins.rows_i[0], sim.config.duration_s
    acc = sim.init_reduce_acc()
    trace_bytes = 2 * n * T * 4
    ms = time_ms(lambda: k4m.wide_fold(meter, pv, t, dur, acc), reps=20)
    plain = time_ms(lambda: k4m.wide_fold_plain(meter, pv, t, dur, acc),
                    reps=1)
    # the library's yardstick: the seven statistics' reductions over the
    # same (T, n) arrays (every second of the noon block is valid)
    lib = time_ms(lambda: fold_library(meter, pv), reps=20)
    out["K4MF"] = (ms, plain, *bound(
        n * T * WIDE_SECOND_I, n * T * WIDE_SECOND_F,
        trace_bytes + T * 4 + n * 4 * 7 * 2), lib)
    part = k4m.wide_series_partials_cuda(meter, pv)
    ms = time_ms(lambda: k4m.wide_series_partials_cuda(meter, pv), reps=20)
    plain = time_ms(lambda: k4m.wide_series_plain(meter, pv), reps=5)
    lib = time_ms(lambda: (torch.sum(meter, dim=1), torch.sum(pv, dim=1)),
                  reps=20)
    out["K4MS"] = (ms, plain, *bound(
        0, 2 * n * T, trace_bytes + part.numel() * 4), lib)
    whole = time_ms(lambda: k4m.wide_series(meter, pv), reps=20)
    lib_sum = time_ms(lambda: part.sum(1), reps=20)
    del meter, pv
    # path F-W's launch: TEL + FLT on the fleet's noon block
    fsim = Simulation(SimConfig(**dict(HEADLINE, fleet=fleet_f(),
                                       telemetry="full", analytics="full")),
                      device=dev)
    fstate = fsim.init_state()
    fins = fsim.host_inputs(40)
    ftables, _ = fsim._windows(fstate, fins)
    _, _, fsite = fsim.geometry_args(fstate)
    _, meter, pv = k3.block_step_trace(
        ftables, fins.rows_i, fins.rows_f, fstate["k_scan"],
        fstate["k_meter"], clone(fstate["carry"]), fsim.config.meter_max_w,
        None, None, site=fsite, fleet=fsim.fleet_leaves(fstate))
    obs = fsim.observers(fstate)
    ft = fins.rows_i[0]
    ms = time_ms(lambda: k4m.wide_fold(meter, pv, ft, dur, acc, obs),
                 reps=20)
    plain = time_ms(lambda: k4m.wide_fold_plain(meter, pv, ft, dur, acc,
                                                obs), reps=1)
    n_ctas = (n + k3.THREADS - 1) // k3.THREADS
    nb, C = fsim._fleet_params.bins + 2, fsim._n_cohorts
    obs_bytes = (n_ctas * 25 * 8 + 4 + n_ctas * (15 + 6 * C) * 8 + n * 4
                 + 4 * (nb + 8 + C * nb))
    out["K4MF89"] = (ms, plain, *bound(
        n * T * (WIDE_SECOND_I + WIDE_TEL_SECOND_I + WIDE_FLT_SECOND_I),
        n * T * (WIDE_SECOND_F + WIDE_TEL_SECOND_F + WIDE_FLT_SECOND_F),
        trace_bytes + T * 4 + n * 4 * 7 * 2 + obs_bytes), None)
    for name, (ms, plain, bms, by, ibms, lib) in out.items():
        print(f"timing {name}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
              f"bound {bms:.4f} ms ({by}), issue bound "
              f"{ibms:.4f} ms"
              + ("" if lib is None else f", library {lib:.4f} ms"))
    print(f"timing K4m series with series_sum: {whole:.4f} ms; "
          f"part.sum(1) on its (2, {n_ctas}, {T}) partials: "
          f"{lib_sum:.4f} ms")
    return out, lib_sum


# ---------------------------------------------------------------------------
# K12: compute_dtype='bf16'
# ---------------------------------------------------------------------------

#: the bf16 compute path, as its paths run it: telemetry is raised to at
#: least 'light' and the drift sentinel is strict
BF16 = dict(compute_dtype="bf16", telemetry_strict=True)
#: path G-H: the CLI on the bf16 path with strict telemetry and a report
PATH_GH_CHAINS = 4096
PATH_GH_ARGS = ["--output", "reduce", "--compute-dtype", "bf16",
                "--telemetry", "light", "--telemetry-strict", "--chains",
                str(PATH_GH_CHAINS), "--duration", "3600", "--no-realtime",
                "--start", "2019-09-05 11:00:00"]
#: K12's draws per chain-second: the bf16 z is a table lookup (the low
#: byte of the word, a shift, an index: 3 int32 ops) and the meter's
#: float32 uniform; the cycle uniform only on a redraw, as K3's
K12_DRAWS_F = UNIFORM_F + 1
K12_DRAWS_I = 3
#: the telemetry sums held to float64: (collapsed leaf, per-chain leaf)
TEL_SUMS = [(f"{k}_{f}", f"{k}_{f}") for f in ("meter", "csi", "pv",
                                              "residual")
            for k in ("sum", "sumsq")]


def bf16_ulp(a, b) -> float:
    """The largest |a - b| in units of the bf16 spacing at |b| (2**(e-7)
    for b in [2**e, 2**(e+1)))."""
    d = (a.double() - b.double()).abs()
    if d.numel() == 0 or float(d.max()) == 0.0:
        return 0.0
    e = torch.floor(torch.log2(b.double().abs().clamp_min(2.0 ** -126)))
    return float((d / torch.pow(2.0, e - 7)).max())


def k12_where(head, carry, mw, tilt, alb, site, fleet, ks, pv_k):
    """Where a K12 launch departs from its plain version: the first
    (second, chain) whose pv differs, and the source lines of the plain
    version's bf16 steps whose float32 value lies within one float32 ULP
    of a bf16 rounding tie there (the steps a float32 difference upstream
    would round the other way)."""
    import traceback

    from tmhpvsim_torch.models import bf16 as mx

    _, _, pv_p = k3.trace_plain(*head, clone(carry), mw, tilt, alb,
                                site=site, fleet=fleet, kernels=ks,
                                compute_dtype="bf16")
    bad = (pv_k != pv_p).nonzero()
    if not len(bad):
        return "the trace agrees; the draws or the fold differ"
    s, c = (int(v) for v in bad[0])
    steps = []
    orig = mx.M.__init__

    def spy(self, v, kind, raw=None):
        orig(self, v, kind, raw)
        if kind == mx.BF16 and raw is not None and raw.dim() == 2:
            frame = next(f for f in reversed(traceback.extract_stack()[:-1])
                         if not f.filename.endswith("bf16.py"))
            steps.append((raw, f"{os.path.basename(frame.filename)}:"
                               f"{frame.lineno}"))

    mx.M.__init__ = spy
    try:
        k3.trace_plain(*head, clone(carry), mw, tilt, alb, site=site,
                       fleet=fleet, kernels=ks, compute_dtype="bf16")
    finally:
        mx.M.__init__ = orig
    near = []
    for raw, where in steps:
        x = raw[min(s, raw.shape[0] - 1), min(c, raw.shape[1] - 1)]
        x64 = float(x)
        if x64 == 0.0:
            continue
        half = 2.0 ** (np.floor(np.log2(abs(x64))) - 8)   # half a bf16 step
        ulp = float(torch.nextafter(x, torch.tensor(np.inf)) - x)
        if abs(abs(x64 - float(mx.rnd(x))) - half) <= ulp:
            near.append(where)
    return (f"second {s}, chain {c}: pv {float(pv_k[s, c])} against "
            f"{float(pv_p[s, c])}; bf16 steps within an ULP of a tie there: "
            f"{', '.join(dict.fromkeys(near)) or 'none'}")


def phase_k12(dev):
    """K12 against its plain bf16 version at the main paths' shape,
    65536 chains x 1080 s, 2 daylight blocks (the site grid's and the
    strided runs, and the grid's trace: the first of them), bit for bit:
    the acc
    step with telemetry light, the launch paths R-H, B-H and B-HL make
    (the plan raises telemetry under bf16), on a shared site (the exact
    set; also on the 00:00 block, where no second has clear-sky GHI, and
    with its telemetry rows through the grouped collapse against the
    host's index-order fold), on path B's grid (site geometry) and on path B's grid with both
    levers (strided, table set): statistics, renewal carry, per-chain
    telemetry leaves, counts and extrema bit for bit, telemetry sums
    within 1e-6 of the float64 plain sums, and the statistics equal to
    the no-observer launch's; then the series and the trace on a shared
    site, the trace on path B's grid, and K8 + K9 on path F's fleet
    (phase_k89, path F-H's noon block).  A difference prints its size in bf16 ULP and where it
    starts, and fails.  Returns each check's measured largest difference
    by its timing key (``(relative, absolute)`` where telemetry sums are
    held to float64)."""
    errs = {}
    for key, label, extra, depth in (
            ("K12", "acc + K8 light, shared site", {}, 2),
            ("K12N", "acc + K8 light, shared site, 00:00",
             dict(start=HEADLINE["start"]), 1),
            ("K12B", "acc + K8 light, site grid", dict(site_grid=grid_b()),
             1),
            ("K12BL", "acc + K8 light, strided",
             dict(site_grid=grid_b(), **LEVERS), 1)):
        night = key == "K12N"
        cfg = SimConfig(**{**HEADLINE, "start": CHECK_START, **BF16,
                           **extra})
        sim, state, blocks = check_blocks(cfg, dev)
        blocks = blocks[:depth]
        tilt, alb, site = sim.geometry_args(state)
        ks = sim.plan.kernel_impl
        obs = sim.observers(state)
        if obs is None or obs.telemetry != "light" or obs.analytics != "off":
            fail(f"K12 ({label}): the plan's observers are {obs}, not "
                 "telemetry light alone")
        obs = dataclasses.replace(obs, per_chain=True)
        mw = cfg.meter_max_w
        kw = dict(site=site, kernels=ks, compute_dtype="bf16")
        acc_k, acc_a, acc_p = (sim.init_reduce_acc() for _ in range(3))
        carry_k, carry_a, carry_p = (clone(state["carry"]) for _ in range(3))
        rel = err = 0.0
        n_leaves = 0
        for ins, tables in blocks:
            head = head_of(state, ins, tables)
            tail = (cfg.duration_s, mw, tilt, alb)
            start = clone(carry_k)
            carry_k, acc_k, out_k = k3.block_step_obs(
                *head, carry_k, acc_k, *tail, obs=obs, **kw)
            carry_a, acc_a = k3.block_step_acc(*head, carry_a, acc_a, *tail,
                                               **kw)
            carry_p, acc_p, out_p = k3.block_step_obs_plain(
                *head, carry_p, acc_p, *tail, obs=obs, **kw)
            torch.cuda.synchronize()
            for name in list(acc_p) + ["carry"]:
                a, b = (carry_k, carry_p) if name == "carry" else \
                    (acc_k[name], acc_p[name])
                same = all(torch.equal(a[k], b[k]) for k in a) \
                    if name == "carry" else torch.equal(a, b)
                if not same:
                    pk = k3.block_step_trace(*head, clone(start), mw, tilt,
                                             alb, **kw)[2]
                    ulp = bf16_ulp(a, b) if name != "carry" else None
                    fail(f"K12 ({label}) {name} differs from the plain "
                         f"version: {ulp} bf16 ULP at most; "
                         + k12_where(head, start, mw, tilt, alb, site, None,
                                     ks, pk))
                err = max(err, max_abs(a, b) if name != "carry" else
                          max(max_abs(a[k], b[k]) for k in a))
            if not (all(torch.equal(acc_k[k], acc_a[k]) for k in acc_k)
                    and all(torch.equal(carry_k[k], carry_a[k])
                            for k in carry_k)):
                fail(f"K12 ({label}): the statistics or the carry differ "
                     "from the no-observer launch's")
            n_leaves = check_chain(f"K12 ({label})", out_k["telemetry_chain"],
                                   out_p["telemetry_chain"])
            p64 = _plain_sums(out_p["telemetry_chain"], TEL_SUMS)
            r, e = check_sketch(f"K12 ({label}) telemetry", out_k["telemetry"],
                                out_p["telemetry"], p64)
            rel, err = max(rel, r), max(err, e)
            if float(out_k["telemetry"]["count"]) != \
                    int((ins.rows_i[0] < cfg.duration_s).sum()) * cfg.n_chains:
                fail(f"K12 ({label}): the telemetry count misses samples")
            if key in ("K12", "K12N"):  # path R-H's row set
                check_collapse(obs_row_sets(out_k["partials"]))
        if night:
            ghi = ins.rows_f[k3.ROWS_F.index("ghi_clear")]
            if float(ghi.abs().max()) != 0.0:
                fail(f"K12 ({label}): the block has clear-sky GHI")
        elif float(acc_k["pv_max"].max()) <= 10.0:
            fail(f"K12 ({label}) check blocks saw no daylight")
        errs[key] = (rel, err)
        print(f"K12 ({label}, {ks} set) vs plain on {depth} block(s) x "
              f"{cfg.n_chains} chains: 7/7 statistics, the renewal carry, "
              f"{n_leaves} per-chain telemetry leaves, counts and extrema "
              f"bit-identical; telemetry sums within {rel:.3g} (relative; "
              f"{err:.3g} absolute) of the float64 plain sums; the "
              "statistics and carry equal the no-observer launch's"
              + ("; the telemetry rows' grouped collapse bit-identical to "
                 "the host's index-order fold" if key in ("K12", "K12N")
                 else "")
              + ("; no clear-sky GHI in the block" if night else ""))
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, **BF16))
    sim, state, blocks = check_blocks(cfg, dev)
    tilt, alb, _ = sim.geometry_args(state)
    mw = cfg.meter_max_w
    carry_s, carry_sp = clone(state["carry"]), clone(state["carry"])
    carry_t, carry_tp = clone(state["carry"]), clone(state["carry"])
    err = t_err = 0.0
    for ins, tables in blocks:
        head = head_of(state, ins, tables)
        start = clone(carry_t)
        carry_s, part = k3.series_partials_cuda(*head, carry_s, mw, tilt, alb,
                                                compute_dtype="bf16")
        out = k3.series_sum(part)
        carry_sp, m_p, p_p = k3.series_plain(*head, carry_sp, mw, tilt, alb,
                                             compute_dtype="bf16")
        carry_t, mk, pk = k3.block_step_trace(*head, carry_t, mw, tilt, alb,
                                              compute_dtype="bf16")
        carry_tp, mp, pp = k3.trace_plain(*head, carry_tp, mw, tilt, alb,
                                          compute_dtype="bf16")
        torch.cuda.synchronize()
        for what, a, b in (("meter", out[0], m_p), ("pv", out[1], p_p)):
            if not close(a, b, rtol=1e-6, atol=0.0):
                fail(f"K12 series {what} sums differ from the plain version:"
                     f" max abs {max_abs(a, b)}")
            err = max(err, max_abs(a, b))
        check_same("K12 series renewal carry", carry_s, carry_sp)
        t_err = max(t_err, max_abs(mk, mp), max_abs(pk, pp))
        if not (torch.equal(mk, mp) and torch.equal(pk, pp)):
            fail(f"K12 trace differs from the plain version: pv "
                 f"{bf16_ulp(pk, pp)} bf16 ULP at most; "
                 + k12_where(head, start, mw, tilt, alb, None, None,
                             "exact", pk))
        check_same("K12 trace renewal carry", carry_t, carry_tp)
        del mk, pk, mp, pp
    print(f"K12 series and trace vs plain on 2 blocks x {cfg.n_chains} "
          f"chains: per-second sums within rtol 1e-6 (max abs {err:.3g} W), "
          "every trace value and both renewal carries bit-identical")
    # the trace on path B's grid: the wide formulation's producer there
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, site_grid=grid_b(),
                           **BF16))
    sim, state, blocks = check_blocks(cfg, dev)
    _, _, site = sim.geometry_args(state)
    carry_t, carry_tp = clone(state["carry"]), clone(state["carry"])
    for ins, tables in blocks[:1]:
        head = head_of(state, ins, tables)
        start = clone(carry_t)
        carry_t, mk, pk = k3.block_step_trace(*head, carry_t, mw, None, None,
                                              site=site,
                                              compute_dtype="bf16")
        carry_tp, mp, pp = k3.trace_plain(*head, carry_tp, mw, None, None,
                                          site=site, compute_dtype="bf16")
        torch.cuda.synchronize()
        t_err = max(t_err, max_abs(mk, mp), max_abs(pk, pp))
        if not (torch.equal(mk, mp) and torch.equal(pk, pp)):
            fail(f"K12 trace (site grid) differs from the plain version: pv "
                 f"{bf16_ulp(pk, pp)} bf16 ULP at most; "
                 + k12_where(head, start, mw, None, None, site, None,
                             "exact", pk))
        del mk, pk, mp, pp
    check_same("K12 trace (site grid) renewal carry", carry_t, carry_tp)
    print(f"K12 trace on path B's grid vs plain on 1 block x {cfg.n_chains}"
          " sites: every value and the renewal carry bit-identical")
    obs_err, _ = phase_k89(dev, BF16, "K12 K8+K9", path="F-H",
                           blocks=OBS_BLOCKS[1:])
    return dict(errs, K12S=err, K12T=t_err, K12F=obs_err)


def k12_sentinel(name, cfg, blocks, n_chains):
    """The drift sentinel, strict, over a per-second path's blocks (the
    reference checks reduce mode only; here each block's meter, pv and
    residual means stand in for its telemetry summary)."""
    from tmhpvsim_torch.obs.sentinel import DriftSentinel

    sen = DriftSentinel(cfg, level="light", strict=True)
    for bi, (meter, pv_, res, n_valid) in enumerate(blocks):
        fields = {}
        for f, v in (("meter", meter), ("pv", pv_), ("residual", res)):
            v = np.asarray(v, np.float64)
            fields[f] = {"nan": int(np.isnan(v).sum()),
                         "inf": int(np.isinf(v).sum()), "observed": True,
                         "mean": float(np.mean(v)), "min": None, "max": None,
                         "std": 0.0}
        sen.observe_block(bi, {"count": float(n_valid * n_chains),
                               "fields": fields})
    if sen.verdict != "ok":
        fail(f"path {name}: sentinel verdict {sen.verdict}")
    return sen.report()


def check_sentinel(name, sim, n_blocks):
    rep = sim.sentinel.report() if sim.sentinel is not None else None
    if rep is None or rep["verdict"] != "ok" or not rep["strict"] or \
            rep["blocks_checked"] != n_blocks:
        fail(f"path {name}: sentinel report {rep}")
    return rep


def phase_path_rh(dev, reduced_r):
    cfg = SimConfig(**dict(HEADLINE, **BF16))
    sim = Simulation(cfg, device=dev)
    if sim.plan.telemetry != "light":
        fail(f"path R-H: telemetry {sim.plan.telemetry}, not raised to light")
    reduced, wall, launches = run_path(
        "R-H", ("sampler_windows", "block_step_bf16", "block_step_tel",
                "chainwise_collapse"), sim.run_reduced)
    pv_max = check_reduced("R-H", reduced, cfg.duration_s)
    rep = check_sentinel("R-H", sim, sim.n_blocks)
    diff = {k: float(np.max(np.abs(reduced[k].astype(np.float64)
                                   - reduced_r[k]))
                     / max(float(np.max(np.abs(reduced_r[k]))), 1.0))
            for k in reduced}
    rate = cfg.n_chains * cfg.duration_s / wall
    print(f"path R-H (reduce, shared site, bf16, telemetry light, strict "
          f"sentinel): {wall:.3f} s wall, {rate:.6g} site-s/s (incl. init, "
          f"host inputs, the per-block telemetry read-back and the golden "
          f"reference); fleet pv_max {pv_max:.2f} W; sentinel "
          f"{json.dumps(rep)}; field-scale difference from path R (f32): "
          f"{json.dumps({k: round(v, 6) for k, v in diff.items()})}; "
          f"launches {launches}")
    print(f"ensemble (R-H): {json.dumps(sim.ensemble_stats())}")
    return launches, reduced


def phase_path_rhw(dev, reduced_rh):
    """Path R-H in the wide formulation: the K4 trace under bf16 (float32
    draws, as the JAX wide step), then the wide fold with telemetry."""
    cfg = SimConfig(**dict(HEADLINE, block_impl="wide", **BF16))
    sim = Simulation(cfg, device=dev)
    reduced, wall, launches = run_path(
        "R-HW", ("sampler_windows", "block_step_trace_bf16", "wide_fold_tel"),
        sim.run_reduced)
    pv_max = check_reduced("R-HW", reduced, cfg.duration_s)
    rep = check_sentinel("R-HW", sim, sim.n_blocks)
    diff = max(float(np.max(np.abs(reduced[k].astype(np.float64)
                                   - reduced_rh[k])))
               / max(float(np.max(np.abs(reduced_rh[k]))), 1.0)
               for k in reduced)
    print(f"path R-HW (path R-H, block_impl=wide): {wall:.3f} s wall, "
          f"{cfg.n_chains * cfg.duration_s / wall:.6g} site-s/s; fleet "
          f"pv_max {pv_max:.2f} W; sentinel {json.dumps(rep)}; largest "
          f"field-scale difference from R-H {diff:.3g} (the wide step draws "
          f"float32, another stream); launches {launches}")
    return launches


def phase_path_ah(dev):
    cfg = SimConfig(**dict(HEADLINE, output="ensemble", **BF16))
    sim = Simulation(cfg, device=dev)
    blocks, wall, launches = run_path(
        "A-H", ("sampler_windows", "block_step_series_bf16", "series_sum"),
        lambda: list(sim.run_ensemble()))
    n_rows = sum(b.pv.shape[1] for b in blocks)
    pv = np.concatenate([b.pv[0] for b in blocks])
    if n_rows != cfg.duration_s or not np.isfinite(pv).all() or \
            pv.max() <= 10.0:
        fail(f"path A-H: {n_rows} seconds, pv max {pv.max()}")
    rep = k12_sentinel("A-H", cfg, [(b.meter[0], b.pv[0], b.residual[0],
                                     b.pv.shape[1]) for b in blocks],
                       cfg.n_chains)
    print(f"path A-H (ensemble, bf16): {wall:.3f} s wall, "
          f"{cfg.n_chains * cfg.duration_s / wall:.6g} site-s/s; "
          f"{n_rows} per-second means, fleet-mean pv max {pv.max():.2f} W; "
          f"sentinel over the block means {json.dumps(rep)}; launches "
          f"{launches}")
    return launches


def phase_path_bh(dev, name="B-H", levers=None):
    cfg = SimConfig(**dict(HEADLINE, site_grid=grid_b(), **BF16,
                           **(levers or {})))
    sim = Simulation(cfg, device=dev)
    inst = "block_step_strided_table_bf16" if levers else \
        "block_step_site_bf16"
    reduced, wall, launches = run_path(
        name, ("sampler_windows", inst, "block_step_tel"), sim.run_reduced)
    pv_max = check_reduced(name, reduced, cfg.duration_s)
    rep = check_sentinel(name, sim, sim.n_blocks)
    print(f"path {name} (site-grid reduce, 256 x 256 sites, bf16"
          f"{', geom_stride 60, table set' if levers else ''}): {wall:.3f} "
          f"s wall, {cfg.n_chains * cfg.duration_s / wall:.6g} site-s/s; "
          f"fleet pv_max {pv_max:.2f} W; sentinel {json.dumps(rep)}; "
          f"launches {launches}")
    return launches


def phase_path_fh(dev):
    cfg = SimConfig(**dict(HEADLINE, fleet=fleet_f(), telemetry="full",
                           analytics="full", **BF16))
    sim = Simulation(cfg, device=dev)
    reduced, wall, launches = run_path(
        "F-H", ("sampler_windows_regime", "block_step_prod_site_bf16",
                "block_step_tel_analytics", "obs_fold",
                "chainwise_collapse"),
        sim.run_reduced)
    pv_max = check_reduced("F-H", reduced, cfg.duration_s)
    rep = check_sentinel("F-H", sim, sim.n_blocks)
    summary = sim.fleet_summary()
    if summary is None or summary["count"] != cfg.n_chains * cfg.duration_s:
        fail(f"path F-H: fleet summary count "
             f"{None if summary is None else summary['count']}")
    print(f"path F-H (fleet reduce, bf16, telemetry and analytics full, "
          f"strict sentinel): {wall:.3f} s wall, "
          f"{cfg.n_chains * cfg.duration_s / wall:.6g} site-s/s; fleet "
          f"pv_max {pv_max:.2f} W; {summary['count']} samples in the sketch;"
          f" sentinel {json.dumps(rep)}; launches {launches}")
    return launches


def phase_path_ch(dev):
    cfg = SimConfig(**dict(PATH_C, **BF16))
    sim = Simulation(cfg, device=dev)

    def run():
        out = []
        for b in sim.run_blocks():
            if b.pv.shape != (cfg.n_chains, cfg.block_s):
                fail(f"path C-H: block of shape {b.pv.shape}")
            if not (np.isfinite(b.pv).all() and np.isfinite(b.meter).all()):
                fail("path C-H: non-finite trace values")
            out.append((float(b.meter.mean()), float(b.pv.mean()),
                        float(b.residual.mean()), b.pv.shape[1],
                        float(b.pv.max())))
        return out

    blocks, wall, launches = run_path(
        "C-H", ("sampler_windows", "block_step_trace_bf16"), run)
    rep = k12_sentinel("C-H", cfg, [b[:4] for b in blocks], cfg.n_chains)
    print(f"path C-H (trace, bf16, 4 blocks from 10:00): {wall:.3f} s wall, "
          f"{cfg.n_chains * cfg.duration_s / wall:.6g} site-s/s incl. the "
          f"gather; pv max {max(b[4] for b in blocks):.2f} W; sentinel over "
          f"the block means {json.dumps(rep)}; launches {launches}")
    return launches


def phase_path_gh():
    from tmhpvsim_torch.cli import main as cli

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "path_gh_reduce.csv")
    rep = os.path.join(build.BUILD_DIR, "path_gh_report.json")
    try:
        rc, wall, launches = run_path(
            "G-H", ("sampler_windows", "block_step_bf16", "block_step_tel"),
            lambda: cli(["pvsim", out] + PATH_GH_ARGS + ["--run-report",
                                                        rep]))
        if rc != 0:
            fail(f"path G-H: the CLI returned {rc}")
        with open(out) as f:
            rows = f.read().splitlines()
        with open(rep) as f:
            report = json.load(f)
    finally:
        for path in (out, rep):
            if os.path.exists(path):
                os.remove(path)
    n = PATH_GH_CHAINS
    if len(rows) != n + 2 or rows[-1].split(",")[0] != "ensemble":
        fail(f"path G-H: {len(rows)} CSV lines")
    try:
        validate_report(report)
    except ValueError as e:
        fail(f"path G-H: the run report fails validation: {e}")
    tel, prec = report["telemetry"], report["precision"]
    if report["plan"]["compute_dtype"] != "bf16" or prec is None or \
            prec["compute_dtype"] != "bf16" or prec["telemetry"] != "light" \
            or tel is None or tel["verdict"] != "ok" or not tel["strict"]:
        fail(f"path G-H: plan {report['plan']}, precision {prec}, "
             f"telemetry {tel}")
    print(f"path G-H (CLI pvsim --output reduce --compute-dtype bf16 "
          f"--telemetry light --telemetry-strict --chains {n} --duration "
          f"3600 --run-report): {wall:.3f} s wall incl. the CSV, the golden "
          f"reference and the report; the report validates, plan "
          f"compute_dtype bf16, telemetry {json.dumps(tel)}; launches "
          f"{launches}")
    return launches


def phase_reference_bf16(dev):
    """Paths R-H's and F-H's configurations at the reference file's bf16
    shape (``small_config``'s chains over 2 x 600 s) against the JAX
    package's bf16 results (its ``bf16`` section): n_seconds exact, the
    rest rtol 2e-5 / atol 1e-2; the fleet summary as phase_reference holds
    it."""
    path = os.path.join(HERE, "tests", "data", "torch_port_reference.json")
    with open(path) as f:
        ref = json.load(f)
    br = ref["bf16"]
    worst = 0.0

    def stats(what, got, want):
        nonlocal worst
        for name, w in want.items():
            w = np.asarray(w, np.float64)
            g = np.asarray(got[name], np.float64)
            if name == "n_seconds":
                if not np.array_equal(g, w):
                    fail(f"reference bf16: {what} n_seconds differs")
                continue
            if not np.allclose(g, w, rtol=TOL[0], atol=TOL[1]):
                fail(f"reference bf16: {what} {name} differs from the JAX "
                     f"package: max abs {float(np.max(np.abs(g - w)))}")
            worst = max(worst, float(np.max(np.abs(g - w)
                                            / np.maximum(np.abs(w), 1.0))))

    shape = br["config"]
    stats("reduce", Simulation(SimConfig(**dict(shape, **BF16)),
                               device=dev).run_reduced(), br["reduced"])
    fr = br["fleet"]
    n_f, seed_f = ref["fleet"]["synthetic"]
    sim = Simulation(SimConfig(**dict(
        shape, fleet=FleetParams.synthetic(n_f, seed=seed_f),
        **ref["fleet"]["config"], **BF16)), device=dev)
    stats("fleet", sim.run_reduced(), fr["reduced"])
    slack = max(2, int(1e-4 * fr["summary"]["count"]))
    width = fr["summary"]["sketch"]["width_w"]
    worst_int = held_summary("bf16 fleet summary", sim.fleet_summary(),
                             fr["summary"], slack, width)
    print(f"reference bf16: R-H's and F-H's configurations at the reference "
          f"file's bf16 shape on the card match the JAX package's bf16 runs "
          f"(max relative "
          f"error {worst:.3g}; fleet summary counts within {slack}, largest "
          f"difference {worst_int})")


def phase_timing_k12(dev):
    """K12's instantiations that the paths launch, and their plain
    versions, on a noon block at the main paths' shape: acc with telemetry
    light (R-H's), the series (A-H's), the trace (C-H's), acc with
    telemetry on path B's grid (B-H's) and with both levers (B-HL's), and
    K8 + K9 on path F's fleet (F-H's)."""
    out = {}
    n, T = HEADLINE["n_chains"], HEADLINE["block_s"]
    draws_f = K12_DRAWS_F

    def setup(block=40, **extra):
        cfg = SimConfig(**dict(HEADLINE, **BF16, **extra))
        sim = Simulation(cfg, device=dev)
        state = sim.init_state()
        ins = sim.host_inputs(block)
        tables, _ = sim._windows(state, ins)
        tilt, alb, site = sim.geometry_args(state)
        head = (tables, ins.rows_i, ins.rows_f, state["k_scan"],
                state["k_meter"])
        table_bytes = sum(t.numel() * 4 for t in tables.values())
        in_bytes = (table_bytes + n * 8 * 2 + n * 4 * 3 * 2
                    + ins.rows_i.numel() * 4 + ins.rows_f.numel() * 4)
        return cfg, sim, state, head, (tilt, alb, site), in_bytes

    int_ops = n * (T * (K3_SECOND_I + K12_DRAWS_I) + (T // 60) * K3_MINUTE_I)
    tel_f, tel_i = n * T * TEL_SECOND_F, n * T * TEL_SECOND_I
    # acc + telemetry light, shared site (R-H)
    cfg, sim, state, head, (tilt, alb, site), in_b = setup()
    obs = sim.observers(state)
    a1 = (*head, clone(state["carry"]), sim.init_reduce_acc(),
          cfg.duration_s, cfg.meter_max_w, tilt, alb)
    a2 = (*head, clone(state["carry"]), sim.init_reduce_acc(),
          cfg.duration_s, cfg.meter_max_w, tilt, alb)
    ms = time_ms(lambda: k3.block_step_obs(*a1, obs=obs,
                                           compute_dtype="bf16"))
    plain = time_ms(lambda: k3.block_step_obs_plain(*a2, obs=obs,
                                                    compute_dtype="bf16"),
                    reps=1)
    out["K12"] = (ms, plain, *bound(
        int_ops + tel_i, n * T * (K3_SECOND_F + draws_f) + tel_f,
        in_b + n * 4 * 7 * 2))
    # the same launch on the 00:00 block (no clear-sky GHI in any second)
    _, sim0, state0, head0, _, _ = setup(block=0)
    a0 = (*head0, clone(state0["carry"]), sim0.init_reduce_acc(),
          cfg.duration_s, cfg.meter_max_w, tilt, alb)
    k12_0000 = time_ms(lambda: k3.block_step_obs(*a0, obs=obs,
                                                 compute_dtype="bf16"))
    # the series and the trace (A-H, C-H)
    c1 = clone(state["carry"])
    tail = (cfg.meter_max_w, tilt, alb)
    ms = time_ms(lambda: k3.series_partials_cuda(*head, c1, *tail,
                                                 compute_dtype="bf16"))
    plain = time_ms(lambda: k3.series_plain(*head, clone(state["carry"]),
                                            *tail, compute_dtype="bf16"),
                    reps=1)
    out["K12S"] = (ms, plain, *bound(
        int_ops, n * T * (SERIES_SECOND_F + draws_f),
        in_b + 2 * T * 4))
    ms = time_ms(lambda: k3.block_step_trace(*head, c1, *tail,
                                             compute_dtype="bf16"))
    plain = time_ms(lambda: k3.trace_plain(*head, clone(state["carry"]),
                                           *tail, compute_dtype="bf16"),
                    reps=1)
    # the trace draws its u / z in float32, as K4's
    out["K12T"] = (ms, plain, *bound(
        n * (T * K3_SECOND_I + (T // 60) * K3_MINUTE_I),
        n * T * (TRACE_SECOND_F + NORMAL_F + UNIFORM_F + 1),
        in_b + 2 * n * T * 4))
    # acc + telemetry on path B's grid, plain and strided table set
    for key, extra in (("K12B", {}), ("K12BL", LEVERS)):
        cfg, sim, state, head, (_, _, site), in_b = setup(
            site_grid=grid_b(), **extra)
        obs = sim.observers(state)
        ks = sim.plan.kernel_impl
        a1 = (*head, clone(state["carry"]), sim.init_reduce_acc(),
              cfg.duration_s, cfg.meter_max_w, None, None)
        ms = time_ms(lambda: k3.block_step_obs(*a1, site=site, obs=obs,
                                               kernels=ks,
                                               compute_dtype="bf16"))
        plain = time_ms(lambda: k3.block_step_obs_plain(
            *head, clone(state["carry"]), sim.init_reduce_acc(),
            cfg.duration_s, cfg.meter_max_w, None, None, site=site,
            obs=obs, kernels=ks, compute_dtype="bf16"), reps=1)
        if extra:  # K6s's count, the bf16 draws in place of the normal
            f32 = strided_f32(ks, n, T, LEVERS["geom_stride"]) - \
                n * T * NORMAL_F
        else:  # K6's count
            f32 = n * T * (K3_SECOND_F + K6_SITE_SECOND_F + draws_f) + \
                T * K6_TIME_F
        out[key] = (ms, plain, *bound(
            int_ops + tel_i, f32 + tel_f,
            in_b + n * 4 * 6 + n * 4 * 7 * 2))
    # K8 + K9 on path F's fleet (F-H)
    cfg, sim, state, head, (_, _, site), in_b = setup(
        fleet=fleet_f(), telemetry="full", analytics="full")
    obs = sim.observers(state)
    fleet = sim.fleet_leaves(state)
    a1 = (*head, clone(state["carry"]), sim.init_reduce_acc(),
          cfg.duration_s, cfg.meter_max_w, None, None)
    ms = time_ms(lambda: k3.block_step_obs(*a1, site=site, fleet=fleet,
                                           obs=obs, compute_dtype="bf16"))
    plain = time_ms(lambda: k3.block_step_obs_plain(
        *head, clone(state["carry"]), sim.init_reduce_acc(),
        cfg.duration_s, cfg.meter_max_w, None, None, site=site, fleet=fleet,
        obs=obs, compute_dtype="bf16"), reps=1)
    ms_p, ms_f, plain_p, plain_f = obs_parts_ms(
        a1, dict(site=site, fleet=fleet, compute_dtype="bf16"), obs)
    out["K12FP"] = (ms_p, plain_p, *bound(
        int_ops, n * T * (K3_SECOND_F + draws_f + K7_SECOND_F +
                          K6_SITE_SECOND_F) + T * K6_TIME_F,
        in_b + n * 4 * (6 + 4) + n * 4 * 7 * 2 + n * T * OBS_FOLD_BYTES))
    out["K12FF"] = (ms_f, plain_f, *obs_fold_bound(n, T, obs))
    out["K12F"] = (ms, plain, *bound(
        int_ops + tel_i + n * T * FLT_SECOND_I,
        n * T * (K3_SECOND_F + draws_f + K7_SECOND_F + K6_SITE_SECOND_F +
        FLT_SECOND_F) + tel_f + T * K6_TIME_F,
        in_b + n * 4 * (6 + 4) + n * 4 * 7 * 2))
    for name, (ms, plain, bms, by, ibms) in out.items():
        print(f"timing {name}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
              f"bound {bms:.4f} ms ({by}), issue bound "
              f"{ibms:.4f} ms")
    print(f"timing K12 at 00:00 (no clear-sky GHI): kernel {k12_0000:.4f} "
          "ms")
    out["K12_0000"] = k12_0000
    return out


# ---------------------------------------------------------------------------
# K13 (prng_impl='rbg') and K12 in K10 (bf16 scenario serving)
# ---------------------------------------------------------------------------

#: K13's check size: 2**26 words, from a key whose 128-bit counter carries
#: from w2 through w3 into w0 within the first 2**24 Philox calls
K13_WORDS = 1 << 26
K13_KEY = (0x12345678, 0x9ABCDEF0, 0xFFF00000, 0xFFFFFFFF)
#: one Philox4x32-10 call (four words): 10 rounds of two 32-bit multiplies
#: (hi and lo halves, 4 ops), 4 xors and the 2 key bumps, plus the 128-bit
#: counter add (6) and the word select (2)
PHILOX_I = 10 * (2 * 2 + 4 + 2) + 6 + 2
#: one rbg key derivation (split or fold_in): threefry on each half
RBG_KEY_I = 2 * HASH_I
#: the rbg block step per chain-second: the z and meter words at a quarter
#: Philox call each (four batched words share a call), and the bits'
#: conversions; once per block in the scan layout, not per chain, the
#: three keys all chains read: chain 0's key folded with the block's first
#: minute, then 0 | 1, and the meter's (4 derivations)
RBG_SECOND_I = 2 * PHILOX_I // 4 + 10
RBG_KEYS_I = 4 * RBG_KEY_I
#: one gamma draw from an rbg key, one Marsaglia-Tsang round (a rejection
#: is rare and not counted): 8 key derivations, the normal's and the
#: uniform's Philox call (one word each, from a key of its own), the
#: acceptance test's two logs; a shape below 1 adds a call and a powf
GAMMA_I = 8 * RBG_KEY_I + 2 * PHILOX_I
GAMMA_F = NORMAL_F + UNIFORM_F + 2 * TRANS_F + 12
GAMMA_BOOST_I, GAMMA_BOOST_F = PHILOX_I, POW_F + UNIFORM_F
#: K14: an unsafe_rbg key derivation is one Philox call (a row of a
#: draw); the step's three tile keys (chain 0's keys folded with the
#: block's first minute, then 0 | 1, and the meter's: a Philox row each)
#: are shared by every chain and counted once; one gamma draw: its entry
#: row, seven splits and two draws
URBG_KEYS_I = 3 * PHILOX_I
URBG_GAMMA_I = 10 * PHILOX_I
RBG = dict(prng_impl="rbg")
URBG = dict(prng_impl="unsafe_rbg")
#: the kernel route of each non-threefry key implementation
K_OF = {"rbg": "K13", "unsafe_rbg": "K14"}
#: path R-P through the entry point: path R's shape with --prng-impl rbg
PATH_RP_ARGS = ["--output", "reduce", "--no-realtime", "--chains",
                str(HEADLINE["n_chains"]), "--duration",
                str(HEADLINE["duration_s"]), "--block-s",
                str(HEADLINE["block_s"]), "--seed", str(HEADLINE["seed"]),
                "--start", HEADLINE["start"], "--prng-impl", "rbg"]
#: path S-H's plain check: path S's requests served at this width and two
#: blocks' depth (horizons clipped to it), so that the renewal and Markov
#: carry cross a block under bf16 serving, by the kernels and by the plain
#: bf16 scenario (the plain fold is a Python loop per second: a full-depth
#: plain run of 32 requests would take hours)
PATH_SH_CHECK = dict(PATH_S, n_chains=4096,
                     duration_s=2 * HEADLINE["block_s"], start=CHECK_START)


def rbg_sim(cfg, dev):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return Simulation(cfg, device=dev)


def phase_k13(dev):
    """K13's bits launch against rng's Philox: 2**26 words from a key whose
    counter carries, batched (one key, flat words) and per key (65536
    keys x 60 words), bit for bit; init_state's two rbg launches (the
    renewal uniforms) bit for bit; timed beside its plain version and
    torch.rand for the same word count."""
    key = torch.tensor(K13_KEY, dtype=torch.int64, device=dev)
    a = k1.philox_fill("bits", key[None], K13_WORDS)[0]
    b = rng.rbg_stream(key, K13_WORDS)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        bad = int((a != b).nonzero()[0, 0])
        fail(f"K13 bits differ from the plain Philox from word {bad}")
    err = max_abs(a, b)
    del a, b
    q_end = (K13_WORDS - 1) // 4
    if K13_KEY[2] + q_end < 2 ** 32 or K13_KEY[3] != 0xFFFFFFFF:
        fail("K13's check key does not carry")
    n = HEADLINE["n_chains"]
    R = "rbg"
    keys = rng.split(rng.rbg_key(99, dev), n, R)
    pk = k1.philox_fill("bits", keys, 60, per_key=True)
    pp = rng.random_bits(keys, (60,), per_key=True, impl=R)
    if not torch.equal(pk, pp):
        fail("K13 per-key bits differ from the plain version")
    err = max(err, max_abs(pk, pp))
    for op, plain in (("uniform", rng.uniform(keys, (), impl=R)),
                      ("normal", rng.normal(keys, (), impl=R))):
        got = getattr(k1, op)(keys, impl=R)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            fail(f"K13 batched {op} differs from the plain version")
        err = max(err, max_abs(got, plain))
    # init_state's launches on the very keys it makes them on: K1 on the
    # key halves, then the two batched renewal uniforms (K13)
    root = rng.split(rng.rbg_key(HEADLINE["seed"], dev), 2, R)[0]
    chains = k1.split(root, n, R)
    s5 = k1.split(chains, 5, R)
    if not (torch.equal(chains, rng.split(root, n, R))
            and torch.equal(s5, rng.split(chains, 5, R))):
        fail("K1 on rbg key halves differs from the plain split")
    kr = k1.split(s5[:, 2, :].contiguous(), 2, R)
    for j in (0, 1):
        k = kr[:, j, :].contiguous()
        got, plain = k1.uniform(k, impl=R), rng.uniform(k, (), impl=R)
        if not torch.equal(got, plain):
            fail(f"K13 init_state uniform(kr[{j}]) differs from the plain "
                 "version")
        err = max(err, max_abs(got, plain))
    sim = rbg_sim(SimConfig(**dict(HEADLINE, **RBG)), dev)
    if sim.init_state()["k_scan"].shape != (n, 4):
        fail("rbg init_state's keys are not (n, 4)")
    ms = time_ms(lambda: k1.philox_fill("bits", key[None], K13_WORDS))
    ms_u = time_ms(lambda: k1.philox_fill("uniform", key[None], K13_WORDS))
    plain = time_ms(lambda: rng.rbg_stream(key, K13_WORDS), reps=2)
    yard = time_ms(lambda: torch.rand(K13_WORDS, device=dev))
    # the function's words are uint32 (4 bytes; the port holds the bits
    # in int64, the uniforms path R-P draws in float32)
    bms, by, ibms = bound(K13_WORDS // 4 * PHILOX_I, 0, 32 + K13_WORDS * 4)
    bms_u, by_u, _ = bound(K13_WORDS // 4 * PHILOX_I, K13_WORDS * UNIFORM_F,
                           32 + K13_WORDS * 4)
    print(f"K13 vs plain: {K13_WORDS} words bit-identical (counter carried "
          f"from w2 through w3 into w0), {n} keys x 60 per-key words "
          f"bit-identical, batched uniform and normal bit-identical; "
          f"init_state's rbg splits and renewal uniforms bit-identical")
    print(f"timing K13: kernel {ms:.4f} ms for {K13_WORDS} words, plain "
          f"{plain:.3f} ms, bound {bms:.4f} ms ({by}); as float32 "
          f"uniforms (path R-P's op) {ms_u:.4f} ms, bound {bms_u:.4f} ms "
          f"({by_u}); torch.rand for the same count (another key and "
          f"counter layout, a yardstick only) {yard:.4f} ms; largest "
          f"difference {err:.3g}")
    return {"err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "issue_bound_ms": ibms, "ms_uniform": ms_u,
            "bound_ms_uniform": bms_u, "torch_rand_ms": yard}


def phase_k13_k2(dev, keys=RBG):
    """K2's rbg (``keys=RBG``, K13) or unsafe_rbg (``URBG``, K14)
    instantiation against its plain version at 65536 chains: init_state's
    two launches and two consecutive blocks, and (K14) a block of path B's
    site grid, bit for bit.  Returns the largest difference measured."""
    impl = keys["prng_impl"]
    label = f"{K_OF[impl]} in K2"
    sim = rbg_sim(SimConfig(**dict(HEADLINE, **keys)), dev)
    state = sim.init_state()
    k_arr, k_min = state["k_arr"], state["k_min"]
    ones = torch.ones(sim.config.n_chains, dtype=torch.float32, device=dev)
    no_min = (torch.zeros(0, dtype=torch.int32, device=dev),
              torch.zeros(0, dtype=torch.float32, device=dev))

    err = []

    def check(what, *args):
        tk, ck = k2.sampler_windows(*args, impl=impl)
        tp, cp = k2.windows_plain(*args, impl=impl)
        torch.cuda.synchronize()
        for name in tk:
            if not torch.equal(tk[name], tp[name]):
                fail(f"{label}: table {name} differs from the plain "
                     f"version in {what}: max abs "
                     f"{max_abs(tk[name], tp[name])}")
            err.append(max_abs(tk[name], tp[name]))
        if not torch.equal(ck, cp):
            fail(f"{label}: Markov carry differs in {what}")
        err.append(max_abs(ck, cp))
        return ck

    check("init cc01/ws0", k_arr, k_min, ones, ones,
          k2.Bounds(0, 2, 0, 0, 0, 0, 0, 1), *no_min)
    check("init cloudy pair", k_arr, k_min, ones, state["cc0"],
          k2.Bounds(0, 0, 2, 0, 0, 0, 0, 0), *no_min)
    cc_carry = state["cc_carry"]
    for bi in (40, 41):
        ins = sim.host_inputs(bi)
        cc_carry = check(f"block {bi}", k_arr, k_min, cc_carry, state["cc0"],
                         ins.bounds, ins.mh_idx, ins.mh_frac)
    site = ""
    if impl == "unsafe_rbg":
        sim_b = rbg_sim(SimConfig(**dict(HEADLINE, start=CHECK_START,
                                         site_grid=grid_b(), **keys)), dev)
        st_b = sim_b.init_state()
        ins = sim_b.host_inputs(0)
        check("path B's grid, block 0", st_b["k_arr"], st_b["k_min"],
              st_b["cc_carry"], st_b["cc0"], ins.bounds, ins.mh_idx,
              ins.mh_frac)
        site = f" and block 0 of path B's {sim_b.config.n_chains}-site grid"
        del sim_b, st_b
    print(f"{label} vs plain at {sim.config.n_chains} chains, init_state's"
          f" 2 launches and blocks 40-41{site}: every table and the carry "
          f"bit-identical (largest difference {max(err):.3g})")
    return max(err)


def rbg_acc_held(what, ak, ap):
    """An rbg acc's statistics against the plain version's: n_seconds
    exact, the rest bit-identical or within the engine tolerance.
    Returns (statistics bit-identical, largest difference)."""
    same, worst = 0, 0.0
    for name in ak:
        a, b = ak[name], ap[name]
        if torch.equal(a, b):
            same += 1
            continue
        if name == "n_seconds" or not close(a, b):
            fail(f"{what} {name} differs from the plain version: max abs "
                 f"{max_abs(a, b)}")
        worst = max(worst, max_abs(a, b))
    return same, worst


def phase_k13_k3(dev, keys=RBG):
    """The block step's rbg (``keys=RBG``, K13) or unsafe_rbg (``URBG``,
    K14) instantiations against their plain versions at 65536 chains x 2
    daylight blocks: acc in the scan, scan2 and trace layouts (the
    renewal carry with it), the series (sums rtol 1e-6: the kernel's
    fixed-order float32 sums against float64), the trace (meter, the
    Philox stream alone, bit for bit; pv), the site grid's acc, and the
    bf16 acc with telemetry light (path R-H's instantiation; under K14 in
    each layout, scan2 and trace on the first block).  K13's float32 statistics are held within the engine
    tolerance (the count of bit-identical ones printed), every K14 check
    bit for bit."""
    impl = keys["prng_impl"]
    K, strict = K_OF[impl], impl == "unsafe_rbg"

    def held(what, ak, ap):
        if strict:
            check_same(what, ak, ap)
            return len(ak), 0.0
        return rbg_acc_held(what, ak, ap)

    worst = 0.0
    cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, **keys))
    sim = rbg_sim(cfg, dev)
    state = sim.init_state()
    blocks = []
    cc_carry = state["cc_carry"]
    for bi in (0, 1):
        ins = sim.host_inputs(bi)
        tables, cc_carry = sim._windows(dict(state, cc_carry=cc_carry), ins)
        blocks.append((ins, tables))
    tilt, alb, _ = sim.geometry_args(state)
    mw = cfg.meter_max_w
    report = []
    for layout in ("scan", "scan2", "trace"):
        acc_k, acc_p = sim.init_reduce_acc(), sim.init_reduce_acc()
        ck, cp = clone(state["carry"]), clone(state["carry"])
        for ins, tables in blocks:
            head = head_of(state, ins, tables)
            tail = (cfg.duration_s, mw, tilt, alb)
            ck, acc_k = k3.block_step_acc(*head, ck, acc_k, *tail,
                                          layout=layout, impl=impl)
            cp, acc_p = k3.block_step_plain(*head, cp, acc_p, *tail,
                                            layout=layout, impl=impl)
        torch.cuda.synchronize()
        same, e = held(f"{K} acc ({layout} layout)", acc_k, acc_p)
        worst = max(worst, e)
        if strict:
            check_same(f"{K} acc ({layout}) renewal carry", ck, cp)
        for name in ck:
            if not close(ck[name], cp[name], rtol=1e-5, atol=1e-3):
                fail(f"{K} acc ({layout}) renewal carry {name} differs")
        report.append(f"acc {layout} layout {same}/7")
        if float(acc_k["pv_max"].max()) <= 10.0:
            fail(f"{K} check blocks saw no daylight")
    cs, csp = clone(state["carry"]), clone(state["carry"])
    ct, ctp = clone(state["carry"]), clone(state["carry"])
    same_pv = True
    for ins, tables in blocks:
        head = head_of(state, ins, tables)
        cs, part = k3.series_partials_cuda(*head, cs, mw, tilt, alb,
                                           impl=impl)
        out = k3.series_sum(part)
        csp, m_p, p_p = k3.series_plain(*head, csp, mw, tilt, alb,
                                        impl=impl)
        ct, mk, pk = k3.block_step_trace(*head, ct, mw, tilt, alb,
                                         impl=impl)
        ctp, mp, pp = k3.trace_plain(*head, ctp, mw, tilt, alb, impl=impl)
        torch.cuda.synchronize()
        for what, a, b in (("meter", out[0], m_p), ("pv", out[1], p_p)):
            if not close(a, b, rtol=1e-6, atol=0.0):
                fail(f"{K} series {what} sums differ: max abs "
                     f"{max_abs(a, b)}")
        if not torch.equal(mk, mp):
            fail(f"{K} trace meter (the Philox stream in the trace layout) "
                 "differs from the plain version")
        if not close(pk, pp) or (strict and not torch.equal(pk, pp)):
            fail(f"{K} trace pv differs: max abs {max_abs(pk, pp)}")
        same_pv = same_pv and torch.equal(pk, pp)
        worst = max(worst, max_abs(pk, pp))
        del mk, pk, mp, pp
    report.append("series sums rtol 1e-6, trace meter bit-identical, pv "
                  + ("bit-identical" if same_pv else "within the tolerance"))
    # the site grid (K6 under rbg / unsafe_rbg) on one block
    cfg_b = SimConfig(**dict(HEADLINE, start=CHECK_START, site_grid=grid_b(),
                             **keys))
    sim_b = rbg_sim(cfg_b, dev)
    st_b = sim_b.init_state()
    ins = sim_b.host_inputs(0)
    tables, _ = sim_b._windows(st_b, ins)
    head = head_of(st_b, ins, tables)
    _, _, site = sim_b.geometry_args(st_b)
    tail = (cfg_b.duration_s, mw, None, None)
    ck, ak = k3.block_step_acc(*head, clone(st_b["carry"]),
                               sim_b.init_reduce_acc(), *tail, site=site,
                               impl=impl)
    cp, ap = k3.block_step_plain(*head, clone(st_b["carry"]),
                                 sim_b.init_reduce_acc(), *tail, site=site,
                                 impl=impl)
    torch.cuda.synchronize()
    same, e = held(f"{K} acc (site grid)", ak, ap)
    if strict:
        check_same(f"{K} acc (site grid) renewal carry", ck, cp)
    worst = max(worst, e)
    report.append(f"site-grid acc {same}/7")
    del sim_b, st_b, tables, head
    # bf16 acc with telemetry light (R-H's instantiation under rbg /
    # unsafe_rbg)
    cfg_h = SimConfig(**dict(HEADLINE, start=CHECK_START, compute_dtype="bf16",
                             **keys))
    sim_h = rbg_sim(cfg_h, dev)
    st_h = sim_h.init_state()
    obs = sim_h.observers(st_h)
    hblocks = []
    cc_carry = st_h["cc_carry"]
    for bi in (0, 1):
        ins = sim_h.host_inputs(bi)
        tables, cc_carry = sim_h._windows(dict(st_h, cc_carry=cc_carry), ins)
        hblocks.append((ins, tables))
    for layout in ("scan", "scan2", "trace") if strict else ("scan",):
        ck, cp = clone(st_h["carry"]), clone(st_h["carry"])
        acc_k, acc_p = sim_h.init_reduce_acc(), sim_h.init_reduce_acc()
        for ins, tables in hblocks if layout == "scan" else hblocks[:1]:
            head = head_of(st_h, ins, tables)
            tail = (cfg_h.duration_s, mw, tilt, alb)
            kw = dict(obs=obs, compute_dtype="bf16", layout=layout,
                      impl=impl)
            ck, acc_k, ok = k3.block_step_obs(*head, ck, acc_k, *tail, **kw)
            cp, acc_p, op = k3.block_step_obs_plain(*head, cp, acc_p, *tail,
                                                    **kw)
            torch.cuda.synchronize()
            for k in acc_k:
                if not torch.equal(acc_k[k], acc_p[k]):
                    fail(f"{K} bf16 acc ({layout}) {k} differs from the "
                         f"plain version: "
                         f"{bf16_ulp(acc_k[k], acc_p[k])} bf16 ULP at most")
            check_same(f"{K} bf16 ({layout}) renewal carry", ck, cp)
            for k, v in op["telemetry"].items():
                if not v.is_floating_point() and not torch.equal(
                        ok["telemetry"][k], v):
                    fail(f"{K} bf16 ({layout}) telemetry {k} differs")
        report.append(f"bf16 acc + K8 light ({layout} layout) 7/7 and the "
                      "carry bit-identical")
    print(f"{K} in the block step vs plain on 2 blocks x {cfg.n_chains} "
          f"chains: " + "; ".join(report)
          + f"; largest difference {worst:.3g}")
    return worst


def phase_k13_rest(dev, keys=RBG):
    """The rbg (``keys=RBG``, K13) or unsafe_rbg (``URBG``, K14)
    instantiations phase_k13_k3 leaves out, against their plain versions
    at the main paths' width: the strided table set in float32 and bf16
    (block_step_{rbg,urbg}_table.cu, block_step_{rbg,urbg}_bf16_table.cu)
    on path B's grid, the first check block of acc; path F's fleet: its regime windows
    (K7 in K2) and its acc with K8 + K9 at level full (phase_k89); the
    scenario epilogue (K10) on the noon block at 16 rows (K14: at 1, 4
    and 16), and its neutral row against the acc launch.  Every K14 check
    bit for bit.  Returns (largest difference from a plain version, the
    K8 + K9 sums' relative difference from float64)."""
    import warnings

    impl = keys["prng_impl"]
    K, strict = K_OF[impl], impl == "unsafe_rbg"
    worst, report = 0.0, []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for cd in ("f32", "bf16"):
            cfg = SimConfig(**dict(HEADLINE, start=CHECK_START,
                                   site_grid=grid_b(), compute_dtype=cd,
                                   **LEVERS, **keys))
            sim, state, blocks = check_blocks(cfg, dev)
            tilt, alb, site = sim.geometry_args(state)
            ck, cp = clone(state["carry"]), clone(state["carry"])
            acc_k, acc_p = sim.init_reduce_acc(), sim.init_reduce_acc()
            kw = dict(site=site, kernels="table", compute_dtype=cd,
                      impl=impl)
            for ins, tables in blocks[:1]:
                head = head_of(state, ins, tables)
                tail = (cfg.duration_s, cfg.meter_max_w, tilt, alb)
                ck, acc_k = k3.block_step_acc(*head, ck, acc_k, *tail, **kw)
                cp, acc_p = k3.block_step_plain(*head, cp, acc_p, *tail,
                                                **kw)
            torch.cuda.synchronize()
            what = f"{K} acc (strided table set, {cd})"
            if cd == "bf16" or strict:
                check_same(what, acc_k, acc_p)
                check_same(f"{what} renewal carry", ck, cp)
                same = len(acc_k)
            else:
                same, e = rbg_acc_held(what, acc_k, acc_p)
                worst = max(worst, e)
                for name in ck:
                    if not close(ck[name], cp[name], rtol=1e-5, atol=1e-3):
                        fail(f"{what} renewal carry {name} differs")
            if float(acc_k["pv_max"].max()) <= 10.0:
                fail(f"{what}: the check blocks saw no daylight")
            report.append(f"strided table set {cd} acc {same}/7")
            del sim, state, blocks
        fp = fleet_f()
        cfg = SimConfig(**dict(HEADLINE, start=CHECK_START, fleet=fp,
                               **keys))
        sim = Simulation(cfg, device=dev)
        state = sim.init_state()
        ins = sim.host_inputs(0)
        regime = state["fleet"]["regime"]
        args = (state["k_arr"], state["k_min"], state["cc_carry"],
                state["cc0"], ins.bounds, ins.mh_idx, ins.mh_frac)
        tk, ck = k2.sampler_windows(*args, regime=regime, impl=impl)
        tp, cp = k2.windows_plain(*args, regime=regime, impl=impl)
        torch.cuda.synchronize()
        check_same(f"{K} in K7's regime windows", dict(tk, carry=ck),
                   dict(tp, carry=cp))
        report.append("the fleet's regime windows bit-identical")
        del sim, state, tk, tp
        # the noon block only: the night block's observers are checked
        # in K8+K9's own phase and F-L's (the sharded phase's time)
        (rel89, _), _ = phase_k89(dev, keys, f"K8+K9 ({impl})",
                                  path=f"F's fleet under {impl}",
                                  blocks=OBS_BLOCKS[1:])
        cfg = SimConfig(**dict(HEADLINE, **keys))
        sim = Simulation(cfg, device=dev)
        state = sim.init_state()
    ins = sim.host_inputs(K10_BLOCK)
    tables, _ = sim._windows(state, ins)
    head = head_of(state, ins, tables)
    tail = (cfg.duration_s, cfg.meter_max_w, cfg.site.surface_tilt,
            cfg.site.albedo)
    rows = k10_rows(K10_BLOCK * cfg.block_s, cfg.duration_s)
    params = sim.scenario_fleet_params()
    _, acc = k3.block_step_acc(*head, clone(state["carry"]),
                               sim.init_reduce_acc(), *tail, impl=impl)
    sames = []
    for b in (1, 4, K10_B) if strict else (K10_B,):
        scen = schema.encode_batch(rows[:b], b, device=dev)
        ck, ak, dk = k3.block_step_scenario(
            *head, clone(state["carry"]), sim.init_scenario_acc(b), *tail,
            scen=scen, params=params, per_chain=True, impl=impl)
        cp, ap, dp = k3.scenario_plain(
            *head, clone(state["carry"]), sim.init_scenario_acc(b), *tail,
            scen=scen, params=params, per_chain=True, impl=impl)
        torch.cuda.synchronize()
        e, same = check_scenario(f"{impl} keys, {b} rows", ak, dk, ap, dp)
        if strict:
            check_same(f"K10 ({impl} keys, {b} rows)", ak, ap)
            check_same(f"K10 ({impl} keys, {b} rows) renewal carry", ck, cp)
        worst = max(worst, e)
        sames.append(same)
        for name in ck:
            if not close(ck[name], cp[name], rtol=1e-5, atol=1e-3):
                fail(f"K10 ({impl} keys) renewal carry {name} differs")
        if not all(torch.equal(ak[k][0], acc[k]) for k in acc):
            fail(f"K10 ({impl} keys): the neutral row differs from the "
                 "acc launch")
    report.append(f"scenario at {'1, 4 and ' if strict else ''}{K10_B} "
                  f"rows {sames}/7 with every FleetAcc leaf bit-identical, "
                  f"its neutral row equal to the {impl} acc launch")
    print(f"{K} in the other instantiations vs plain at "
          f"{HEADLINE['n_chains']} chains or sites: " + "; ".join(report)
          + f"; K8+K9 under {impl} as above; largest difference "
          f"{worst:.3g}")
    return worst, rel89


def phase_k12_k10(dev):
    """K12 in K10: the bf16 scenario epilogue against its plain bf16
    version on the main path's noon block at 1, 4 and 16 rows (every
    statistic and FleetAcc leaf as phase_k10 checks them), each row
    against its batch-of-1 launch, timed at 1, 4 and 16 rows; its bf16
    producer and the fold on their own (k10_parts)."""
    cfg = SimConfig(**dict(HEADLINE, compute_dtype="bf16"))
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    ins = sim.host_inputs(K10_BLOCK)
    tables, _ = sim._windows(state, ins)
    head = head_of(state, ins, tables)
    tail = (cfg.duration_s, cfg.meter_max_w, cfg.site.surface_tilt,
            cfg.site.albedo)
    n, T = cfg.n_chains, cfg.block_s
    t0 = K10_BLOCK * T
    rows = k10_rows(t0, cfg.duration_s)
    params = sim.scenario_fleet_params()

    def launch(fn, scs, per_chain=True):
        scen = schema.encode_batch(scs, len(scs), device=dev)
        return fn(*head, clone(state["carry"]),
                  sim.init_scenario_acc(len(scs)), *tail, scen=scen,
                  params=params, per_chain=per_chain, compute_dtype="bf16")

    err, same_all = 0.0, []
    plain_ms = None
    for b in (1, 4, K10_B):
        _, ak, dk = launch(k3.block_step_scenario, rows[:b])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, ap, dp = launch(k3.scenario_plain, rows[:b])
        end.record()
        torch.cuda.synchronize()
        if b == K10_B:
            plain_ms = start.elapsed_time(end)
        e, same = check_scenario(f"bf16, {b} rows", ak, dk, ap, dp)
        err = max(err, e)
        same_all.append(same)
        del ap, dp
    for i, row in enumerate(rows):
        _, a1, d1 = launch(k3.block_step_scenario, [row], per_chain=False)
        torch.cuda.synchronize()
        if not all(torch.equal(a1[k][0], ak[k][i]) for k in a1) or \
                not all(torch.equal(d1[k][0], dk[k][i]) for k in d1):
            fail(f"K12 in K10: row {i} of the batch-of-{K10_B} launch "
                 "differs from its batch-of-1 launch")
    _, acc = k3.block_step_acc(*head, clone(state["carry"]),
                               sim.init_reduce_acc(), *tail,
                               compute_dtype="bf16")
    torch.cuda.synchronize()
    if not all(torch.equal(ak[k][0], acc[k]) for k in acc):
        fail("K12 in K10: the neutral row differs from K12's acc launch")
    ms = {}
    for b in (1, 4, K10_B):
        scen = schema.encode_batch(rows[:b], b, device=dev)
        acc_b = sim.init_scenario_acc(b)
        ms[b] = time_ms(lambda: k3.block_step_scenario(
            *head, clone(state["carry"]), acc_b, *tail, scen=scen,
            params=params, compute_dtype="bf16"))
    ns = ak["n_seconds"]
    valid = int(ns.sum())
    nsl = ns.long()
    grid = sum(int(((t0 + nsl) // w - t0 // w).sum())
               for w in params.ramp_windows)
    int_ops = n * (T * (K3_SECOND_I + K12_DRAWS_I) + (T // 60) * K3_MINUTE_I)\
        + T * (K10_SECOND_I + K10_B * K10_ROW_SECOND_I) + \
        K10_B * n * K10_ROW_CHAIN_I + valid * K10_VALID_I + \
        grid * K10_GRID_I
    f32_ops = n * T * (K3_SECOND_F + K12_DRAWS_F) + valid * K10_VALID_F + \
        grid * K10_GRID_F
    table_bytes = sum(t.numel() * 4 for t in tables.values())
    nb, ne = params.bins + 2, len(params.thresholds) + 1
    nbytes = (table_bytes + n * 8 * 2 + n * 4 * 3 * 2
              + ins.rows_i.numel() * 4 + ins.rows_f.numel() * 4
              + K10_B * (n * 4 * 7 * 2 + 4 * (nb + ne) + 8 * 4))
    bms, by, ibms = bound(int_ops, f32_ops, nbytes)
    print(f"K12 in K10 vs plain bf16 on the noon block x {n} chains at 1, 4 "
          f"and {K10_B} rows: {same_all} of 7 statistics bit-identical "
          f"(float sums max abs {err:.3g}), every FleetAcc leaf "
          f"bit-identical; each row equals its batch-of-1 launch; the "
          f"neutral row equals K12's acc launch")
    print(f"timing K12 in K10: kernel {ms[1]:.4f} ms (1 row), {ms[4]:.4f} "
          f"ms (4 rows), {ms[K10_B]:.4f} ms ({K10_B} rows); plain "
          f"{plain_ms:.1f} ms ({K10_B} rows); bound {bms:.4f} ms ({by})")
    parts = k10_parts("K12 in K10", sim, head + (state["carry"],), tail,
                      rows, params, ms, cd="bf16", sketches=False)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "issue_bound_ms": ibms, **parts}


def phase_path_rp(dev, reduced_r, wall_r):
    """Path R-P: path R's shape under prng_impl='rbg', through the entry
    point (``python -m tmhpvsim_torch pvsim --prng-impl rbg``), its CSV's
    statistics checked as check_reduced does; then the engine's
    run_reduced under rbg and path R's, timed in alternating pairs in
    this call."""
    import warnings

    from tmhpvsim_torch.cli import main as cli

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "path_rp_reduce.csv")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            rc, wall, launches = run_path(
                "R-P", ("threefry_fill", "philox_fill", "sampler_windows_rbg",
                        "block_step_rbg"),
                lambda: cli(["pvsim", out] + PATH_RP_ARGS))
        if rc != 0:
            fail(f"path R-P: the CLI returned {rc}")
        with open(out) as f:
            header = f.readline().strip().split(",")
            lines = f.read().splitlines()
    finally:
        if os.path.exists(out):
            os.remove(out)
    n = HEADLINE["n_chains"]
    if len(lines) != n + 1 or not lines[-1].startswith("ensemble,"):
        fail(f"path R-P: {len(lines)} CSV rows, not {n} chains + ensemble")
    data = np.asarray([[float(v) for v in ln.split(",")]
                       for ln in lines[:n]])
    reduced = {k: data[:, header.index(k)] for k in reduced_r}
    pv_max = check_reduced("R-P", reduced, HEADLINE["duration_s"])
    diff = {k: float(np.mean(reduced[k]) / max(abs(float(np.mean(
        reduced_r[k]))), 1.0)) for k in ("pv_sum", "meter_sum")}
    # the engine loop under rbg against path R's, alternating pairs
    walls = {"R": [], "R-P": []}
    for pair in range(3):
        for name in (("R", "R-P") if pair % 2 == 0 else ("R-P", "R")):
            cfg = SimConfig(**dict(HEADLINE, **(RBG if name == "R-P"
                                                else {})))
            s = rbg_sim(cfg, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run_reduced()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    print(f"path R-P (CLI pvsim --output reduce --prng-impl rbg, {n} chains "
          f"x {HEADLINE['duration_s']} s): {wall:.3f} s wall incl. the CSV; "
          f"fleet pv_max {pv_max:.2f} W; all chains n_seconds="
          f"{HEADLINE['duration_s']}; mean pv_sum / meter_sum relative to "
          f"path R's {json.dumps(diff)}; launches {launches}")
    print("paths R and R-P (run_reduced), same call, 3 alternating pairs: "
          + "; ".join(f"{k} median {np.median(v):.4f} s ("
                      + ", ".join(f"{w:.4f}" for w in v) + ")"
                      for k, v in walls.items())
          + f" (path R's own run {wall_r:.4f} s)")
    return launches, walls


def phase_path_sh(dev, replies_s):
    """Path S-H: path S's 32 requests served under bf16 (an in-process
    server over local://, window batching) at 65536 chains x 86400 s, each
    reply checked as path S's are and against path S's float32 reply
    (sums within 1 % of the field's scale); then the same
    requests at PATH_SH_CHECK's width and two blocks' depth, every reply
    of the kernels' engine against the plain bf16 scenario's."""
    replies, launches = phase_path_s(
        "S-H", "window", dev, extra=dict(compute_dtype="bf16"),
        need=("threefry_fill", "sampler_windows",
              "block_step_scenario_bf16", "scenario_fold"))
    # each reply's sums against path S's, at the field's scale (the
    # largest of path S's sums of that field): a dawn horizon's pv sums
    # are tiny, and there bf16 differs by a large fraction of nothing
    sums = {k: [json.loads(replies_s[rid])["stats"][k]
                for rid in replies_s
                if json.loads(replies_s[rid])["mode"] == "reduce"]
            for k in ("pv_sum_w", "meter_sum_w")}
    scale = {k: max(max(abs(v) for v in vs), 1.0) for k, vs in sums.items()}
    worst, n_cmp = 0.0, 0
    for rid, text in replies.items():
        got, want = json.loads(text), json.loads(replies_s[rid])
        if want["mode"] != "reduce":
            continue
        for k in ("pv_sum_w", "meter_sum_w"):
            g, w = got["stats"][k], want["stats"][k]
            rel = abs(g - w) / scale[k]
            worst, n_cmp = max(worst, rel), n_cmp + 1
            if rel > 0.01:
                fail(f"path S-H: request {rid} {k} {g} differs from path "
                     f"S's {w} by {rel:.3g} of the field's scale")
    if n_cmp == 0 or worst == 0.0:
        fail("path S-H: its replies were not compared with path S's, or "
             "equal them (not bf16)")
    print(f"path S-H: the reduce replies' sums within {worst:.3g} of the "
          f"field's scale of path S's float32 replies ({n_cmp} sums)")
    # every reply against the plain bf16 scenario, at the check's size
    from tmhpvsim_torch.serve.schema import Request, parse_scenario
    from tmhpvsim_torch.serve.server import ScenarioEngine

    cfg = SimConfig(**dict(PATH_SH_CHECK, compute_dtype="bf16"))
    eng = ScenarioEngine(cfg, (K10_B,), device=dev)
    reqs = []
    for rid, doc, mode in path_s_requests():
        doc = dict(doc, horizon_s=min(doc["horizon_s"], cfg.duration_s))
        reqs.append(Request(id=rid, reply_to="r", mode=mode,
                            scenario=parse_scenario(
                                doc, max_horizon_s=cfg.duration_s)))
    got = []
    for j in range(0, len(reqs), K10_B):
        got += eng.run(reqs[j:j + K10_B])
    orig = eng.sim.scenario_step

    def plain_step(state, inputs, acc, scen):
        s = eng.sim
        tables, cc_carry = s._windows(state, inputs)
        tilt, alb, site = s.geometry_args(state)
        carry, acc, delta = k3.scenario_plain(
            tables, inputs.rows_i, inputs.rows_f, state["k_scan"],
            state["k_meter"], state["carry"], acc, s.config.duration_s,
            s.config.meter_max_w, tilt, alb, site=site,
            fleet=s.fleet_leaves(state), scen=scen,
            params=s.scenario_fleet_params(), cohort=s.scenario_cohort(),
            kernels=s.plan.kernel_impl, compute_dtype="bf16")
        return dict(state, carry=carry, cc_carry=cc_carry), acc, delta

    eng.sim.scenario_step = plain_step
    try:
        want = []
        for j in range(0, len(reqs), K10_B):
            want += eng.run(reqs[j:j + K10_B])
    finally:
        eng.sim.scenario_step = orig
    def same(g, w, where):
        """Ints, strings and Nones equal; floats within the engine
        tolerance."""
        if isinstance(w, dict):
            if set(g) != set(w):
                fail(f"path S-H check: {where} keys differ")
            for k in w:
                same(g[k], w[k], f"{where}.{k}")
        elif isinstance(w, list):
            if len(g) != len(w):
                fail(f"path S-H check: {where} lengths differ")
            for i, (a, b) in enumerate(zip(g, w)):
                same(a, b, f"{where}[{i}]")
        elif isinstance(w, float):
            if not np.isclose(g, w, rtol=TOL[0], atol=TOL[1]):
                fail(f"path S-H check: {where} {g} != plain {w}")
        elif g != w:
            fail(f"path S-H check: {where} {g!r} != plain {w!r}")

    exact = 0
    for r, g, w in zip(reqs, got, want):
        exact += int(g == w)
        same(g, w, r.id)
    print(f"path S-H check ({cfg.n_chains} chains x {cfg.duration_s} s, "
          f"horizons clipped to it): {exact}/{len(reqs)} replies equal to "
          f"the plain bf16 scenario's, the rest within the engine "
          f"tolerance")
    return launches


def rbg_windows_ops(tables, cc_carry, cc0, ins):
    """(int32, float32) operations K13 in K2 needs on this block's data
    (shared site, regime 0).  Batched words (the Markov step's uniform or
    the Student-t's normal, the cloudy values outside the gamma bands,
    clear-day values, both minute noises) at a quarter Philox call each,
    since four consecutive words of chain 0's stream share a call; chain
    0's key derivations once per value index; each gamma draw (the
    Student-t steps, cloudy values in the gamma bands, windspeed) with
    the derivations of the chain's own key that lead to it."""
    kc = k2.kernel_constants()
    dev = cc0.device
    bins = torch.tensor(kc["MK_BINS"], device=dev)
    is_t = torch.tensor(kc["MK_IS_T"][:6], device=dev) > 0.5
    half_df = torch.tensor(kc["MK_DF"][:6], device=dev) / 2
    b = ins.bounds
    n, n_min = cc0.shape[0], int(ins.mh_idx.shape[0])
    cc = tables["cc"]
    # the Markov step of hour j reads the state before it: its bin
    # chooses asymmetric Laplace (a batched uniform) or Student-t
    prev = torch.cat([cc_carry[None], cc[:-1]])
    idx = (bins < prev[..., None]).sum(-1).clamp(max=5)
    t = is_t[idx]
    t_boost = int((t & (half_df[idx] < 1.0)).sum())
    # cloudy value j reads the cover of the hour before it (the kernel's
    # clamp); the gamma bands start at 0.75
    w = max(b.n_hours, 1)
    at = []
    for j in range(b.n_cloudy):
        h = b.hour_lo + j
        at.append(cc[min(max(h - 1 - b.hour_lo, 0), w - 1)] if h >= 2
                  else cc0)
    g_cl = (torch.stack(at) >= 0.75) if at else         torch.zeros((0, n), dtype=torch.bool, device=dev)
    n_t, n_gcl = int(t.sum()), int(g_cl.sum())
    n_ws = n * b.n_days
    words = n * b.n_hours + (n * b.n_cloudy - n_gcl) + n * (b.n_cd
                                                            + 2 * n_min)
    keys = (n + int(t.any(0).sum()) + int(g_cl.any(0).sum())
            + 4 * b.n_hours + 9)
    int_ops = (words * PHILOX_I / 4 + keys * RBG_KEY_I
               + n_t * (3 * RBG_KEY_I + GAMMA_I) + t_boost * GAMMA_BOOST_I
               + n_gcl * (2 * RBG_KEY_I + GAMMA_I)
               + n_ws * (RBG_KEY_I + GAMMA_I))
    n_al = n * b.n_hours - n_t
    f32_ops = ((words - n_al) * (NORMAL_F + 2) + n_al * (UNIFORM_F + TRANS_F
                                                         + 8)
               + n * b.n_hours * 8 + (n_t + n_gcl + n_ws) * (GAMMA_F + 4)
               + t_boost * GAMMA_BOOST_F + n * n_min * 9)
    return int_ops, f32_ops


def urbg_windows_ops(tables, cc_carry, cc0, ins):
    """(int32, float32) operations K14 in K2 needs on this block's data
    (shared site, regime 0): K13's batched words and float work, with the
    keys every chain shares derived once (per hour chain 0's fold and
    four rows, per window a handful: a Philox call each) and each gamma
    draw's own key chain at one Philox call per derivation (its entry row
    of the batched split, then seven splits and two draws of one
    Marsaglia-Tsang round)."""
    int_rbg, f32_ops = rbg_windows_ops(tables, cc_carry, cc0, ins)
    kc = k2.kernel_constants()
    dev = cc0.device
    bins = torch.tensor(kc["MK_BINS"], device=dev)
    is_t = torch.tensor(kc["MK_IS_T"][:6], device=dev) > 0.5
    half_df = torch.tensor(kc["MK_DF"][:6], device=dev) / 2
    b = ins.bounds
    n, n_min = cc0.shape[0], int(ins.mh_idx.shape[0])
    cc = tables["cc"]
    prev = torch.cat([cc_carry[None], cc[:-1]])
    idx = (bins < prev[..., None]).sum(-1).clamp(max=5)
    t = is_t[idx]
    t_boost = int((t & (half_df[idx] < 1.0)).sum())
    w = max(b.n_hours, 1)
    at = [cc[min(max(b.hour_lo + j - 1 - b.hour_lo, 0), w - 1)]
          if b.hour_lo + j >= 2 else cc0 for j in range(b.n_cloudy)]
    g_cl = (torch.stack(at) >= 0.75) if at else \
        torch.zeros((0, n), dtype=torch.bool, device=dev)
    n_t, n_gcl = int(t.sum()), int(g_cl.sum())
    n_ws = n * b.n_days
    words = n * b.n_hours + (n * b.n_cloudy - n_gcl) + n * (b.n_cd
                                                            + 2 * n_min)
    shared = 5 * b.n_hours + 12
    int_ops = (words * PHILOX_I / 4 + shared * PHILOX_I
               + (n_t + n_gcl + n_ws) * URBG_GAMMA_I
               + t_boost * GAMMA_BOOST_I)
    return int_ops, f32_ops


def phase_timing_k13(dev, keys=RBG):
    """The rbg (``keys=RBG``) or unsafe_rbg (``URBG``) block step (path
    R-P's or R-U's launch) and its plain version on a noon block at the
    main path's shape; the K2 windows under the same keys; under URBG
    also K14 in K1 (init_state's batched 5-way split of 65536 chains)."""
    impl = keys["prng_impl"]
    K = K_OF[impl]
    n, T = HEADLINE["n_chains"], HEADLINE["block_s"]
    cfg = SimConfig(**dict(HEADLINE, **keys))
    sim = rbg_sim(cfg, dev)
    state = sim.init_state()
    ins = sim.host_inputs(40)
    tables, _ = sim._windows(state, ins)
    head = head_of(state, ins, tables)
    tilt, alb, _ = sim.geometry_args(state)
    tail = (cfg.duration_s, cfg.meter_max_w, tilt, alb)
    a1 = (*head, clone(state["carry"]), sim.init_reduce_acc(), *tail)
    ms = time_ms(lambda: k3.block_step_acc(*a1, impl=impl))
    plain = time_ms(lambda: k3.block_step_plain(
        *head, clone(state["carry"]), sim.init_reduce_acc(), *tail,
        impl=impl), reps=1)
    table_bytes = sum(t.numel() * 4 for t in tables.values())
    in_b = (table_bytes + 2 * 32 + n * 4 * 3 * 2
            + ins.rows_i.numel() * 4 + ins.rows_f.numel() * 4)
    keys_i = RBG_KEYS_I if impl == "rbg" else URBG_KEYS_I
    out = {f"{K}S": (ms, plain, *bound(
        n * T * (K3_SECOND_I - 2 * HASH_I + RBG_SECOND_I) + keys_i,
        n * T * (K3_SECOND_F + NORMAL_F + UNIFORM_F + 1),
        in_b + n * 4 * 7 * 2))}
    args = (state["k_arr"], state["k_min"], state["cc_carry"], state["cc0"],
            ins.bounds, ins.mh_idx, ins.mh_frac)
    ms = time_ms(lambda: k2.sampler_windows(*args, impl=impl))
    plain = time_ms(lambda: k2.windows_plain(*args, impl=impl), reps=1)
    ops = rbg_windows_ops if impl == "rbg" else urbg_windows_ops
    int_ops, f32_ops = ops(tables, state["cc_carry"], state["cc0"], ins)
    b = ins.bounds
    n_min = int(ins.mh_idx.shape[0])
    # outputs, the carry and cc0 in float32, the two keys as 4 uint32
    out_b = n * 4 * (b.n_hours + b.n_cloudy + b.n_cd + b.n_days
                     + 2 * n_min + 1)
    out[f"{K}W"] = (ms, plain, *bound(
        int_ops, f32_ops, out_b + n * 4 * 2 + n * 16 * 2))
    if impl == "unsafe_rbg":
        # K14 in K1: init_state's batched 5-way split of the chains' keys
        chains = k1.split(rng.split(rng.root_key(7, impl, dev), 2, impl)[0],
                          n, impl)
        ms = time_ms(lambda: k1.split(chains, 5, impl))
        plain = time_ms(lambda: rng.split(chains, 5, impl), reps=2)
        out["K14D"] = (ms, plain, *bound(
            5 * n * PHILOX_I, 0, 16 + n * 5 * 16))
    for name, (ms, plain, bms, by, ibms) in out.items():
        print(f"timing {name}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
              f"bound {bms:.4f} ms ({by}), issue bound "
              f"{ibms:.4f} ms")
    return out


def phase_reference_rbg(dev, keys=RBG):
    """The ``rbg`` (``keys=RBG``) or ``unsafe_rbg`` (``URBG``) section of
    the reference file: each formulation's reduce statistics at
    ``small_config`` under those keys (the draws of the scan, scan2 and
    wide formulations differ, as in the JAX package) and chain 0's trace
    over the section's first seconds, against the JAX package's on the
    CPU."""
    impl = keys["prng_impl"]
    path = os.path.join(HERE, "tests", "data", "torch_port_reference.json")
    with open(path) as f:
        ref = json.load(f)[impl]
    if ref["config"] != SMALL:
        fail(f"reference {impl} config {ref['config']} != {SMALL}")
    worst = {}
    for name, (form, rb) in ref["forms"].items():
        got = rbg_sim(SimConfig(**dict(SMALL, block_impl=form, rng_batch=rb,
                                       **keys)), dev).run_reduced()
        for k, w in ref["reduced"][name].items():
            w = np.asarray(w)
            if k == "n_seconds":
                if not np.array_equal(got[k], w):
                    fail(f"reference {impl} {name}: n_seconds differs")
                continue
            if not np.allclose(got[k], w, rtol=TOL[0], atol=TOL[1]):
                fail(f"reference {impl} {name}: {k} differs from the JAX "
                     "package")
            worst[f"{name} {k}"] = float(np.max(np.abs(got[k] - w)
                                                / np.maximum(np.abs(w), 1.0)))
    blocks = list(rbg_sim(SimConfig(**dict(SMALL, **keys)),
                          dev).run_blocks())
    tr = ref["trace"]
    for k in ("meter", "pv"):
        have = getattr(blocks[0], k)[tr["chain"], :len(tr[k])]
        if not np.allclose(have, tr[k], rtol=TOL[0], atol=TOL[1]):
            fail(f"reference {impl} trace {k} differs from the JAX package")
    print(f"reference ({impl}): small_config on the card matches the JAX "
          f"package's {impl} runs, scan / scan2 / scan2 with rng_batch "
          f"block / wide and chain 0's first {len(tr['meter'])} s of "
          f"trace; largest relative error {max(worst.values()):.3g}")


def phase_k14(dev):
    """K14 in K1 (philox_derive) against the plain unsafe_rbg derivations
    at 65536 chains, bit for bit: init_state's unbatched
    split(k_chains, n), the batched 5-way split of the chains' keys, the
    renewal split, a per-key split, a batched fold_in over the chains and
    a scalar one; the renewal uniforms (K13) on those keys; and the keys
    of init_state itself (with a chain slab, whose batched splits start
    at the slab's first key) against the plain functions on the card."""
    U = "unsafe_rbg"
    n = HEADLINE["n_chains"]
    root = rng.split(rng.root_key(HEADLINE["seed"], U, dev), 2, U)[0]
    chains = k1.split(root, n, U)
    checks = [("split(k_chains, n)", chains, rng.split(root, n, U))]
    s5 = k1.split(chains, 5, U)
    checks.append(("split(chains, 5)", s5, rng.split(chains, 5, U)))
    k_renew = s5[:, 2, :].contiguous()
    kr = k1.split(k_renew, 2, U)
    checks.append(("split(k_renew, 2)", kr, rng.split(k_renew, 2, U)))
    checks.append(("per-key split(chains, 3)",
                   k1.split(chains, 3, U, per_key=True),
                   rng.split(chains, 3, U, per_key=True)))
    d = torch.arange(n, dtype=torch.int64, device=dev) + 1000
    checks.append(("batched fold_in(chains, 1000 + c)",
                   k1.fold_in(chains, d, U), rng.fold_in(chains, d, U)))
    checks.append(("fold_in(chains, 7)", k1.fold_in(chains, 7, U),
                   rng.fold_in(chains, 7, U)))
    for j in (0, 1):
        k = kr[:, j, :].contiguous()
        checks.append((f"uniform(kr[{j}]) (K13)", k1.uniform(k, impl=U),
                       rng.uniform(k, (), impl=U)))
    for slab in (dict(), dict(n_chains=n // 2, n_chains_total=n,
                             chain_offset=n // 4)):
        sim = rbg_sim(SimConfig(**dict(HEADLINE, **slab, **URBG)), dev)
        st = sim.init_state()
        cfg = sim.config
        total = cfg.n_chains_total or cfg.n_chains
        ks = rng.split(rng.split(rng.root_key(cfg.seed, U, dev), 2, U)[0],
                       total, U)[cfg.chain_offset:cfg.chain_offset
                                 + cfg.n_chains]
        p5 = rng.split(ks, 5, U)
        for i, name in enumerate(("k_arr", "k_min", "k_renew", "k_scan",
                                  "k_meter")):
            if name != "k_renew":
                checks.append((f"init_state {name} {slab or ''}", st[name],
                               p5[:, i, :]))
    torch.cuda.synchronize()
    err = 0.0
    for what, a, b in checks:
        if not torch.equal(a, b):
            fail(f"K14 in K1: {what} differs from the plain version: "
                 f"{int((a != b).sum())} of {a.numel()} words")
        err = max(err, max_abs(a.double(), b.double()))
    print(f"K14 in K1 vs plain at {n} chains: {len(checks)} derivations "
          "and draws bit-identical (init_state's splits, per-key and "
          "batched split and fold_in, the renewal uniforms, init_state's "
          "keys with and without a chain slab)")
    return err


def phase_path_ru(dev, reduced_r, wall_r):
    """Path R-U: path R's shape under prng_impl='unsafe_rbg' through the
    Python API (``Simulation(SimConfig(prng_impl='unsafe_rbg'))
    .run_reduced()``; the JAX CLI offers no unsafe_rbg, so neither does
    the port's), its statistics checked as check_reduced does; then
    run_reduced under unsafe_rbg and path R's, timed in alternating pairs
    in this call."""
    sim = rbg_sim(SimConfig(**dict(HEADLINE, **URBG)), dev)
    reduced, wall, launches = run_path(
        "R-U", ("philox_derive", "philox_fill", "sampler_windows_urbg",
                "block_step_urbg"), sim.run_reduced)
    pv_max = check_reduced("R-U", reduced, HEADLINE["duration_s"])
    diff = {k: float(np.mean(reduced[k]) / max(abs(float(np.mean(
        reduced_r[k]))), 1.0)) for k in ("pv_sum", "meter_sum")}
    walls = {"R": [], "R-U": []}
    for pair in range(3):
        for name in (("R", "R-U") if pair % 2 == 0 else ("R-U", "R")):
            cfg = SimConfig(**dict(HEADLINE, **(URBG if name == "R-U"
                                                else {})))
            s = rbg_sim(cfg, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run_reduced()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    n = HEADLINE["n_chains"]
    print(f"path R-U (Simulation(SimConfig(prng_impl='unsafe_rbg'))"
          f".run_reduced(), {n} chains x {HEADLINE['duration_s']} s): "
          f"{wall:.3f} s wall; fleet pv_max {pv_max:.2f} W; all chains "
          f"n_seconds={HEADLINE['duration_s']}; mean pv_sum / meter_sum "
          f"relative to path R's {json.dumps(diff)}; launches {launches}")
    print("paths R and R-U (run_reduced), same call, 3 alternating pairs: "
          + "; ".join(f"{k} median {np.median(v):.4f} s ("
                      + ", ".join(f"{w:.4f}" for w in v) + ")"
                      for k, v in walls.items())
          + f" (path R's own run {wall_r:.4f} s)")
    return launches, walls


# ---------------------------------------------------------------------------
# K15 and the streaming deployment: metersim's device producer, the fanout
# broker and pvsim's streaming join


#: the metersim producer's block (the JAX producer's block_s) and ceiling
METER_BLOCK_S = 600
METER_MAX_W = 9000.0
#: K15's checks: block starts and sizes, the day's blocks
K15_BLOCKS = ((0, 600), (600, 600), (85800, 600), (0, 60))
K15_DAY = 86400
#: path M (the JAX README's ``metersim --backend=jax --no-realtime
#: --duration 86400 --seed 1``), paths SP / SP-T (the pair from 10:00)
PATH_M = dict(duration_s=86400, seed=1)
PATH_SP = dict(start="2019-09-05 10:00:00", duration_s=3600, pv_seed=1,
               meter_seed=2)
PATH_SPT_S = 600
#: the share of the pair's seconds that must join
SP_JOINED = 0.95


def k15_plain(key, sec0, block_s, impl):
    """K15's plain version on ``key``'s device."""
    from tmhpvsim_torch.models import clearsky_index as tci

    t = sec0 + torch.arange(block_s, dtype=torch.int64, device=key.device)
    return tci.meter_block(key, t, METER_MAX_W, impl)


def phase_k15(dev):
    """K15 against its plain version bit for bit for threefry2x32, rbg and
    unsafe_rbg: blocks at sec0 0, 600 and 85800 and a 60-second block
    (the plain version on the card and on the host), then a whole day's
    144 launches (the plain version on the card, block for block), then
    the card's first three blocks at seed 7 against the JAX producer's
    (their SHA-256 and first values in tests/data/
    torch_port_reference.json); timed per launch (host clock around a
    synchronised call, and device time from a CUDA graph) beside its
    plain version and torch.rand(600) (another generator: a yardstick)."""
    import hashlib

    from tmhpvsim_torch.kernels import meter as k15

    with open(os.path.join(HERE, "tests", "data",
                           "torch_port_reference.json")) as f:
        ref = json.load(f)["metersim"]
    n_checks, err = 0, 0.0
    for impl in rng.IMPLS:
        key = rng.root_key(1, impl, dev)
        for sec0, T in K15_BLOCKS:
            got = k15.meter_block(key, sec0, T, METER_MAX_W, impl)
            for where, want in (("card", k15_plain(key, sec0, T, impl)),
                                ("host", k15_plain(key.cpu(), sec0, T,
                                                   impl))):
                if not torch.equal(got.cpu(), want.cpu()):
                    fail(f"K15 {impl} at sec0 {sec0} x {T} differs from "
                         f"its plain version on the {where}")
                err = max(err, max_abs(got.cpu(), want.cpu()))
                n_checks += 1
        for b in range(K15_DAY // METER_BLOCK_S):
            sec0 = b * METER_BLOCK_S
            got = k15.meter_block(key, sec0, METER_BLOCK_S, METER_MAX_W,
                                  impl)
            if not torch.equal(got, k15_plain(key, sec0, METER_BLOCK_S,
                                              impl)):
                fail(f"K15 {impl}: the day's block {b} differs from its "
                     "plain version")
            if not bool(((got >= 0) & (got < METER_MAX_W)).all()):
                fail(f"K15 {impl}: block {b} leaves [0, 9000)")
        key7 = rng.root_key(ref["seed"], impl, dev)
        vals = torch.cat([k15.meter_block(key7, b * ref["block_s"],
                                          ref["block_s"], METER_MAX_W, impl)
                          for b in range(ref["blocks"])]).cpu().numpy()
        digest = hashlib.sha256(vals.astype("<f4").tobytes()).hexdigest()
        heads = np.stack([vals[b * ref["block_s"]:b * ref["block_s"] + 4]
                          for b in range(ref["blocks"])])
        if digest != ref[impl]["sha256"] or not np.array_equal(
                heads, np.asarray(ref[impl]["head"], np.float32)):
            fail(f"K15 {impl}: the first {ref['blocks']} blocks at seed "
                 f"{ref['seed']} differ from the JAX producer's")
    print(f"K15 vs plain: {n_checks} blocks (sec0 0, 600, 85800 x 600 s "
          "and 60 s; card and host plain versions) and a day's 144 "
          "launches per key implementation (threefry2x32, rbg, "
          "unsafe_rbg) bit-identical; the first 3 blocks at seed "
          f"{ref['seed']} equal the JAX producer's (SHA-256)")
    key = rng.root_key(1, "threefry2x32", dev)
    T = METER_BLOCK_S

    def launch():
        return k15.meter_block(key, 600, T, METER_MAX_W)

    def synced():
        launch()
        torch.cuda.synchronize()

    ms = time_ms(launch, reps=50)
    synced_ms = time_ms(synced, reps=50)
    device_ms = time_graph_ms(launch)
    plain = time_ms(lambda: k15_plain(key, 600, T, "threefry2x32"), reps=5)
    yard = time_ms(lambda: torch.rand(T, device=dev), reps=50)
    # the work the function needs: one fold_in per minute group (11) and
    # one bits hash per second, a uniform and the multiply per second;
    # the key read once, the values written once
    n_groups = (T + 119) // 60
    bms, by, ibms = bound((n_groups + T) * HASH_I, T * (UNIFORM_F + 1),
                          8 * 2 + 4 * T)
    print(f"timing K15 (threefry, one {T}-second block): kernel {ms:.4f} "
          f"ms per launch ({synced_ms:.4f} ms with its copy-free "
          f"synchronise, device time from a CUDA graph {device_ms:.4f} "
          f"ms), plain {plain:.3f} ms, bound {bms:.6f} ms ({by}), issue "
          f"bound {ibms:.6f} ms; torch.rand({T}) (another generator, a "
          f"yardstick) {yard:.4f} ms")
    return {"err": err, "ms": ms, "synced_ms": synced_ms,
            "device_ms": device_ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "issue_bound_ms": ibms, "torch_rand_ms": yard}


def phase_path_m(dev):
    """Path M: ``metersim_main`` over ``local://`` without realtime for a
    day (86400 s, seed 1) on the device producer, with a subscriber that
    counts: 86400 messages, every value in [0, 9000) and equal to K15's
    plain stream on the host, 144 launches (a block is filled only when
    the previous one is used up); the wall and the time per launch."""
    from tmhpvsim_torch.apps.metersim import metersim_main
    from tmhpvsim_torch.obs import metrics as obs_metrics

    url = "local://path-m"
    start = _dt_start(HEADLINE["start"])
    reg = obs_metrics.MetricsRegistry()

    async def run():
        got = []
        ready = asyncio.Event()

        async def count():
            from tmhpvsim_torch.runtime.broker import LocalTransport

            async with LocalTransport(url, "meter") as t:
                sub = t.subscribe()
                ready.set()
                async for _, v in sub:
                    got.append(v)

        task = asyncio.create_task(count())
        await asyncio.sleep(0)
        await ready.wait()
        await metersim_main(url, "meter", False, PATH_M["seed"],
                            PATH_M["duration_s"], start, device=dev)
        await asyncio.sleep(0.01)
        task.cancel()
        return got

    with obs_metrics.use_registry(reg):
        got, wall, launches = run_path("M", ("meter_block",),
                                       lambda: asyncio.run(run()))
    n = PATH_M["duration_s"]
    if len(got) != n:
        fail(f"path M: {len(got)} messages, not {n}")
    if launches.get("meter_block") != n // METER_BLOCK_S:
        fail(f"path M: {launches.get('meter_block')} K15 launches, not "
             f"{n // METER_BLOCK_S}")
    vals = np.asarray(got)
    if not ((vals >= 0) & (vals < METER_MAX_W)).all():
        fail("path M: a value outside [0, 9000)")
    key = rng.root_key(PATH_M["seed"])
    plain = torch.cat([k15_plain(key, b * METER_BLOCK_S, METER_BLOCK_S,
                                 "threefry2x32")
                       for b in range(n // METER_BLOCK_S)]).numpy()
    if not np.array_equal(vals, plain.astype(np.float64)):
        fail("path M: the published values differ from K15's plain stream")
    dropped = reg.snapshot()["counters"].get("broker.dropped_total", 0)
    print(f"path M (metersim_main over local://, device producer, "
          f"{n} s, seed {PATH_M['seed']}, --no-realtime): {wall:.3f} s "
          f"wall, {n / wall:.1f} messages/s; {len(got)} messages, all in "
          f"[0, 9000) and equal to K15's plain stream; {dropped:.0f} "
          f"dropped; {launches['meter_block']} K15 launches, "
          f"{wall / launches['meter_block'] * 1e3:.3f} ms of wall per "
          f"launch; launches {launches}")
    return launches, wall


def _dt_start(text):
    import datetime as _dt

    return _dt.datetime.fromisoformat(text)


def run_pair_stream(dev, url, duration_s, broker=None):
    """pvsim's streaming consumer (seed PATH_SP['pv_seed'], unbounded) and
    metersim's device producer (seed PATH_SP['meter_seed'], ``duration_s``
    s) in one event loop from PATH_SP['start'] over ``url``; pvsim is
    stopped once every second is joined or a deadline passes.  Returns
    the CSV's rows."""
    import csv
    import tempfile

    from tmhpvsim_torch.apps.metersim import metersim_main
    from tmhpvsim_torch.apps.pvsim import pvsim_main

    start = _dt_start(PATH_SP["start"])
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "pair.csv")

        async def both():
            srv = None
            u = url
            if broker is not None:
                srv = broker(port=0)
                await srv.start()
                u = f"tcp://127.0.0.1:{srv.port}"
            try:
                consumer = asyncio.ensure_future(pvsim_main(
                    out, u, "meter", False, PATH_SP["pv_seed"], None,
                    start))
                await asyncio.sleep(0.3)
                await metersim_main(u, "meter", False, PATH_SP["meter_seed"],
                                    duration_s, start, device=dev)
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    await asyncio.sleep(0.02)
                    with open(out) as f:
                        if sum(1 for _ in f) > duration_s:
                            break
                consumer.cancel()
                try:
                    await consumer
                except asyncio.CancelledError:
                    pass
            finally:
                if srv is not None:
                    await srv.stop()

        asyncio.run(both())
        with open(out) as f:
            rows = list(csv.reader(f))
    if rows[0] != ["time", "meter", "pv", "residual load"]:
        fail(f"pair over {url}: header {rows[0]}")
    return rows[1:]


def phase_path_sp(dev, name, url, duration_s, broker=None):
    """Paths SP (``local://``, 3600 s) and SP-T (``tcp://`` through an
    in-process TcpFanoutBroker on port 0, 600 s): the pair from 10:00;
    at least 95 % of the seconds joined, every row's residual equal to
    meter - pv, the meter column equal to K15's plain stream for the
    producer's seed computed on the host."""
    import datetime as _dt

    rows, wall, launches = run_path(
        name, ("meter_block",),
        lambda: run_pair_stream(dev, url, duration_s, broker))
    if len(rows) < SP_JOINED * duration_s:
        fail(f"path {name}: {len(rows)} of {duration_s} seconds joined")
    key = rng.root_key(PATH_SP["meter_seed"])
    n_blocks = -(-duration_s // METER_BLOCK_S)
    plain = torch.cat([k15_plain(key, b * METER_BLOCK_S, METER_BLOCK_S,
                                 "threefry2x32")
                       for b in range(n_blocks)]).numpy()
    start = _dt_start(PATH_SP["start"])
    pv_max = 0.0
    for t, meter, pv, residual in rows:
        s = int((_dt.datetime.fromisoformat(t) - start).total_seconds())
        if float(meter) - float(pv) != float(residual):
            fail(f"path {name}: at {t} residual {residual} != meter - pv")
        if not 0 <= s < duration_s or float(meter) != float(plain[s]):
            fail(f"path {name}: at {t} meter {meter} is not K15's plain "
                 "value")
        pv_max = max(pv_max, float(pv))
    if launches.get("meter_block") != n_blocks:
        fail(f"path {name}: {launches.get('meter_block')} K15 launches, "
             f"not {n_blocks}")
    print(f"path {name} (pvsim --backend asyncio + metersim over {url}, "
          f"{duration_s} s from {PATH_SP['start']}, seeds "
          f"{PATH_SP['pv_seed']} / {PATH_SP['meter_seed']}): {wall:.3f} s "
          f"wall, {len(rows)} of {duration_s} seconds joined "
          f"({len(rows) / wall:.1f} rows/s); every residual = meter - pv, "
          f"the meter column K15's plain stream; pv max {pv_max:.2f} W; "
          f"launches {launches}")
    return launches, wall, len(rows)


# ---------------------------------------------------------------------------
# NaNs and signed zeros: the kernels' minimum, maximum and clamp keep a NaN
# and order -0.0 below +0.0, as jnp's and the plain versions' torch ones do
# (csrc/nanminmax.cuh)


#: every NAN_EVERY-th chain from an offset carries one case: a NaN fleet
#: leaf (a NaN meter from the demand pair, a NaN pv from the power pair) or
#: a signed zero (offsets 5-7: -0.0 DC scale, inverter limit, demand)
NAN_EVERY = 997
NAN_CASES = ((1, "demand_scale", float("nan")),
             (2, "demand_shift_w", float("nan")),
             (3, "pv_scale", float("nan")),
             (4, "ac_limit_w", float("nan")),
             (5, "pv_scale", -0.0), (6, "ac_limit_w", -0.0),
             (7, "demand_scale", -0.0), (7, "demand_shift_w", -0.0))
#: the power pair's inverter limit where a fleet has none [W]
NAN_AC_LIMIT = 200.0


def nan_chains(n, off, dev):
    return torch.arange(off, n, NAN_EVERY, device=dev)


def nan_fleet(leaves, n, dev):
    """K7's leaves (``leaves``, or neutral pairs with a binding inverter
    limit when None) with ``NAN_CASES`` set."""
    def col(v, default):
        return v.clone() if v is not None else torch.full(
            (n,), default, dtype=torch.float32, device=dev)

    leaves = leaves or k3.FleetLeaves()
    out = k3.FleetLeaves(pv_scale=col(leaves.pv_scale, 1.0),
                         ac_limit_w=col(leaves.ac_limit_w, NAN_AC_LIMIT),
                         demand_scale=col(leaves.demand_scale, 1.0),
                         demand_shift_w=col(leaves.demand_shift_w, 0.0))
    for off, leaf, v in NAN_CASES:
        getattr(out, leaf)[nan_chains(n, off, dev)] = v
    return out


def nan_acc(sim):
    """``init_reduce_acc`` with signed-zero starts where NAN_CASES makes
    the chain's values signed zeros: pv_max +0.0 against a -0.0 pv
    (offsets 5, 6), -0.0 against a night's +0.0 (offset 8), and the
    residual extrema +0.0 against -0.0 residuals (offset 7)."""
    acc = sim.init_reduce_acc()
    n, dev = sim.config.n_chains, sim.device
    acc["pv_max"][nan_chains(n, 5, dev)] = 0.0
    acc["pv_max"][nan_chains(n, 6, dev)] = 0.0
    acc["pv_max"][nan_chains(n, 8, dev)] = -0.0
    acc["residual_max"][nan_chains(n, 7, dev)] = 0.0
    acc["residual_min"][nan_chains(n, 7, dev)] = 0.0
    return acc


def nan_held(what, got, want, rtol=None, atol=0.0):
    """``got`` against its plain version ``want``, NaN-aware: NaN exactly
    where ``want`` has one (not its payload: PTX gives the canonical NaN),
    every zero of the same sign, every other value equal (``rtol``: within
    rtol / atol); integers equal.  Returns (NaNs, signed zeros checked,
    max abs difference)."""
    if not want.dtype.is_floating_point:
        if not torch.equal(got, want):
            fail(f"{what} differs from the plain version")
        return 0, 0, 0.0
    gn, wn = got.isnan(), want.isnan()
    if not torch.equal(gn, wn):
        fail(f"{what}: NaN at {int((gn != wn).sum())} places where the "
             "plain version has a number, or the other way round")
    g, w = got[~wn], want[~wn]
    z = (g == 0) & (w == 0)
    if not torch.equal(g[z].signbit(), w[z].signbit()):
        fail(f"{what}: {int((g[z].signbit() != w[z].signbit()).sum())} "
             "zeros have the other sign than the plain version's")
    if rtol is None:
        if not torch.equal(g, w):
            fail(f"{what} differs from the plain version: max abs "
                 f"{max_abs(g, w)}")
    elif not close(g, w, rtol=rtol, atol=atol):
        fail(f"{what} differs from the plain version: max abs "
             f"{max_abs(g, w)}")
    return int(wn.sum()), int(z.sum()), max_abs(g, w)


def nan_tree(what, got, want, **kw):
    """``nan_held`` over every leaf of (nested) dicts; summed counts."""
    nans = zeros = 0
    err = 0.0
    for k, w in want.items():
        if isinstance(w, dict):
            a, b, e = nan_tree(f"{what} {k}", got[k], w, **kw)
        elif w is None:
            continue
        else:
            a, b, e = nan_held(f"{what} {k}", got[k], w, **kw)
        nans, zeros, err = nans + a, zeros + b, max(err, e)
    return nans, zeros, err


def phase_nan(dev):
    """The NaN-keeping minimum, maximum and clamp on the card, against the
    plain versions, NaN-aware (NaN where the plain version has one, zeros
    of its sign): the helpers on their own over every pair of NaN,
    infinities, signed zeros and numbers; K3 with a fleet whose leaves
    carry NaNs and signed zeros (``NAN_CASES``) on a shared site, in
    float32 (the statistics to the K3 tolerance) and in bf16 (K12, bit for
    bit), on the night block and the noon block; K8 + K9 on path F's
    fleet with those leaves (path F's launch; per-chain leaves, counts,
    histograms and extrema bit for bit, sums within 1e-6 of the float64
    plain sums); the scenario fold on the producer's noon block with NaN
    knobs (demand scale, weather bias, cap, a demand shift on a horizon
    ending mid-block) and signed-zero knobs and starts, with and without
    the producer's flags; the wide fold with both observers on a seeded
    trace with NaN meter and pv values and signed zeros."""
    vals = (float("nan"), -float("inf"), -2.0, -1.0, -0.0, 0.0, 0.5, 1.0,
            3.0, float("inf"))
    a = torch.tensor([x for x in vals for _ in vals], device=dev)
    b = torch.tensor([y for _ in vals for y in vals], device=dev)
    got = k3.nan_minmax(a, b, 0.0, 1.0)
    want = k3.nan_minmax_plain(a, b, 0.0, 1.0)
    torch.cuda.synchronize()
    counts = nan_held("nan_minmax", got, want)
    print(f"NaN-keeping min / max / clamp vs torch.minimum / maximum / "
          f"clamp on {len(vals)}^2 operand pairs: {counts[0]} NaNs where "
          f"torch has them, {counts[1]} signed zeros of torch's sign, every "
          "other value bit-identical")
    cfg = SimConfig(**HEADLINE)
    sim = Simulation(cfg, device=dev)
    state = sim.init_state()
    n = cfg.n_chains
    fl = nan_fleet(None, n, dev)
    tail = (cfg.duration_s, cfg.meter_max_w, cfg.site.surface_tilt,
            cfg.site.albedo)
    # the night block (pv +0.0 against the -0.0 cases) and the noon
    # block; float32 to the K3 tolerance, bf16 bit for bit (a bf16 run's
    # host rounds the shared rows to bf16: its own Simulation)
    bsim = Simulation(SimConfig(**dict(HEADLINE, compute_dtype="bf16")),
                      device=dev)
    bstate = bsim.init_state()
    for cd, s_, st_ in (("f32", sim, state), ("bf16", bsim, bstate)):
        nans = zeros = 0
        err = 0.0
        for bi in (0, K10_BLOCK):
            ins = s_.host_inputs(bi)
            tables, _ = s_._windows(st_, ins)
            head = head_of(st_, ins, tables)
            _, ak = k3.block_step_acc(*head, clone(st_["carry"]),
                                      nan_acc(s_), *tail, fleet=fl,
                                      compute_dtype=cd)
            _, ap = k3.block_step_plain(*head, clone(st_["carry"]),
                                        nan_acc(s_), *tail, fleet=fl,
                                        compute_dtype=cd)
            torch.cuda.synchronize()
            kw = {} if cd == "bf16" else dict(rtol=TOL[0], atol=TOL[1])
            c = nan_tree(f"K3 ({cd}, block {bi}) with NaN fleet leaves",
                         ak, ap, **kw)
            nans, zeros, err = nans + c[0], zeros + c[1], max(err, c[2])
        if nans == 0 or zeros == 0:
            fail(f"K3 ({cd}) with NaN fleet leaves: the check saw no NaN "
                 "or no signed zero")
        print(f"K3 ({cd}) with NaN and signed-zero fleet leaves vs plain on "
              f"the night and the noon block x {n} chains: {nans} NaN "
              f"statistics where the plain "
              f"version has them, {zeros} zeros of its sign, the rest max "
              f"abs {err:.3g}" + (" (bit for bit)" if cd == "bf16" else ""))
    # K10's fold on the producer's noon block
    ins = sim.host_inputs(K10_BLOCK)
    tables, _ = sim._windows(state, ins)
    head = head_of(state, ins, tables)
    _, mk, pk, tk = k3._scenario_producer_cuda(
        *head, clone(state["carry"]), cfg.meter_max_w,
        cfg.site.surface_tilt, cfg.site.albedo)
    t = ins.rows_i[0]
    B = 8
    scen = schema.encode_batch([Scenario(horizon_s=cfg.duration_s)] * B, B,
                               device=dev)
    for knob, row, v in (("demand_scale", 1, float("nan")),
                         ("weather_bias", 2, float("nan")),
                         ("curtail_w", 3, float("nan")),
                         ("demand_shift_w", 4, float("nan")),
                         ("pv_scale", 5, -0.0), ("curtail_w", 6, -0.0),
                         ("weather_bias", 7, -0.0), ("curtail_w", 7, 0.0)):
        scen[knob][row] = v
    scen["horizon_s"][4] = int(t[0]) + 500
    acc0 = sim.init_scenario_acc(B)
    acc0["pv_max"][5:8] = 0.0
    params = sim.scenario_fleet_params()
    want = k3.scenario_fold_plain(mk, pk, t, clone(acc0), cfg.duration_s,
                                  scen, params, per_chain=True)
    for tame in (None, tk):
        got = k3.scenario_fold(mk, pk, t, clone(acc0), cfg.duration_s,
                               scen=scen, params=params, per_chain=True,
                               tame=tame)
        torch.cuda.synchronize()
        nans, zeros, _ = nan_tree("scenario fold with NaN knobs",
                                  {"acc": got[0], "delta": got[1]},
                                  {"acc": want[0], "delta": want[1]})
    if nans == 0 or zeros == 0:
        fail("scenario fold with NaN knobs: the check saw no NaN or no "
             "signed zero")
    print(f"scenario fold with NaN and signed-zero knobs vs plain at {B} "
          f"rows x {n} chains (the noon block, with and without the "
          f"producer's flags): {nans} NaN leaves where the plain fold has "
          f"them, {zeros} zeros of its sign, every other leaf bit-identical")
    del mk, pk
    # K8 + K9 on path F's fleet, and the wide fold on a seeded trace
    fcfg = SimConfig(**dict(HEADLINE, fleet=fleet_f(), telemetry="full",
                            analytics="full"))
    fsim = Simulation(fcfg, device=dev)
    fstate = fsim.init_state()
    ins = fsim.host_inputs(K10_BLOCK)
    tables, _ = fsim._windows(fstate, ins)
    head = head_of(fstate, ins, tables)
    _, _, site = fsim.geometry_args(fstate)
    ffl = nan_fleet(fsim.fleet_leaves(fstate), n, dev)
    obs = dataclasses.replace(fsim.observers(fstate), per_chain=True)
    C = obs.n_cohorts
    args = (cfg.duration_s, cfg.meter_max_w, None, None)
    _, ak, ok_ = k3.block_step_obs(*head, clone(fstate["carry"]),
                                   nan_acc(fsim), *args, site=site,
                                   fleet=ffl, obs=obs)
    _, ap, op = k3.block_step_obs_plain(*head, clone(fstate["carry"]),
                                        nan_acc(fsim), *args, site=site,
                                        fleet=ffl, obs=obs)
    torch.cuda.synchronize()
    nans, zeros, err = nan_tree("K8+K9 with NaN fleet leaves", ak, ap,
                                rtol=TOL[0], atol=TOL[1])
    leaves = sum(check_chain("K8+K9 with NaN fleet leaves", ok_[d],
                             op[d])
                 for d in ("telemetry_chain", "fleet_chain"))
    tel_sums = [(f"{k}_{f}", f"{k}_{f}") for f in ("meter", "csi", "pv",
                                                  "residual")
                for k in ("sum", "sumsq")]
    flt_sums = [(f"{k}_{f}", f"{k}_{f}") for f in ("meter", "pv",
                                                  "residual")
                for k in ("sum", "cov_sum", "cohort_sum")]
    rel = 0.0
    for d, sums in (("telemetry", tel_sums), ("fleet", flt_sums)):
        p64 = _plain_sums(op[f"{d}_chain"], sums, obs.cohort, C)
        r, _ = check_sketch(f"K8+K9 with NaN fleet leaves {d}", ok_[d],
                            op[d], p64)
        rel = max(rel, r)
    nan_meter = int(ok_["telemetry"]["nan_meter"])
    if nans == 0 or nan_meter == 0:
        fail("K8+K9 with NaN fleet leaves: the check saw no NaN")
    print(f"K8+K9 with NaN and signed-zero fleet leaves vs plain on path F's "
          f"noon block x {n} sites: {nans} NaN statistics where the plain "
          f"version has them ({zeros} zeros of its sign; the rest max abs "
          f"{err:.3g}), {nan_meter} NaN meter samples counted, {leaves} "
          f"per-chain leaves, counts, histograms and extrema bit-identical, "
          f"sums within {rel:.3g} of the float64 plain sums")
    T = cfg.block_s
    gen = torch.Generator(device=dev).manual_seed(0)
    meter = torch.rand((T, n), generator=gen, device=dev) * 4000.0
    pv = torch.rand((T, n), generator=gen, device=dev) * 250.0
    c0, c1 = nan_chains(n, 5, dev), nan_chains(n, 6, dev)
    pv[0::2, c0] = 0.0
    pv[1::2, c0] = -0.0
    meter[:, c0] = -0.0
    meter[100:, nan_chains(n, 1, dev)] = float("nan")
    pv[500, nan_chains(n, 3, dev)] = float("nan")
    pv[:, c1] = float("nan")
    acc_k, out_k = k4m.wide_fold(meter, pv, t, cfg.duration_s,
                                 nan_acc(fsim), obs)
    acc_p, out_p = k4m.wide_fold_plain(meter, pv, t, cfg.duration_s,
                                       nan_acc(fsim), obs)
    torch.cuda.synchronize()
    nans = zeros = 0
    for k in acc_p:
        rtol = 1e-6 if k.endswith("_sum") else None
        a, b, _ = nan_held(f"wide fold with NaN values {k}", acc_k[k],
                           acc_p[k], rtol=rtol)
        nans, zeros = nans + a, zeros + b
    leaves = 0
    for d, sums in (("telemetry", tel_sums), ("fleet", flt_sums)):
        leaves += check_chain(f"wide fold with NaN values {d}",
                              out_k[f"{d}_chain"], out_p[f"{d}_chain"])
        p64 = _plain_sums(out_p[f"{d}_chain"],
                          [x for x in sums if x[1] in out_p[f"{d}_chain"]],
                          obs.cohort, C)
        check_sketch(f"wide fold with NaN values {d}", out_k[d], out_p[d],
                     p64)
    if nans == 0 or zeros == 0:
        fail("wide fold with NaN values: the check saw no NaN or no signed "
             "zero")
    print(f"wide fold (both observers) on a seeded {T} x {n} trace with NaN "
          f"meter and pv values and signed zeros vs plain: {nans} NaN "
          f"statistics where the plain fold has them, {zeros} zeros of its "
          f"sign, extrema and n_seconds bit-identical, sums rtol 1e-6; "
          f"{leaves} per-chain observer leaves, counts, histograms and "
          "extrema bit-identical")


def print_geometry_timing(timing, timing_k12):
    """The launches of the site geometry modes, as this run's timing phases
    measured them, beside their issue bounds (ab_kernels.py times them
    against the parent tree in one call)."""
    for key in ("K6", "K7T", "K89", "K12B", "K12F", "K6s", "K6sX", "K89L"):
        ms, _, _, _, ibms = timing.get(key) or timing_k12[key]
        print(f"timing geometry {key}: {ms:.4f} ms, issue bound "
              f"{ibms:.4f} ms ({ms / ibms:.2f}x)")


#: each block-step row's instantiation: (epilogue, geometry, telemetry,
#: kernel set, compute dtype, key implementation); a pair row (the acc
#: producer and the observer fold) names its producer
STEP_SHAPES = {
    "block_step": ("acc", "shared", False, "exact", "f32", "threefry2x32"),
    "block_step_series": ("series", "shared", False, "exact", "f32",
                          "threefry2x32"),
    "block_step_trace": ("trace", "shared", False, "exact", "f32",
                         "threefry2x32"),
    "block_step_site": ("acc", "site", False, "exact", "f32",
                        "threefry2x32"),
    "block_step_fleet": ("acc", "site", False, "exact", "f32",
                         "threefry2x32"),
    "block_step_tel": ("acc", "site", True, "exact", "f32", "threefry2x32"),
    "block_step_analytics": ("prod", "site", False, "exact", "f32",
                             "threefry2x32"),
    "block_step_tel_analytics": ("prod", "site", False, "exact", "f32",
                                 "threefry2x32"),
    "block_step_prod_site": ("prod", "site", False, "exact", "f32",
                             "threefry2x32"),
    "block_step_scenario": ("scen", "shared", False, "exact", "f32",
                            "threefry2x32"),
    "block_step_strided_table": ("acc", "strided", False, "table", "f32",
                                 "threefry2x32"),
    "block_step_prod_strided_table": ("prod", "strided", False, "table",
                                      "f32", "threefry2x32"),
    "block_step_strided_table+tel_analytics": (
        "prod", "strided", False, "table", "f32", "threefry2x32"),
    "block_step_table": ("acc", "shared", False, "table", "f32",
                         "threefry2x32"),
    "block_step_bf16": ("acc", "shared", True, "exact", "bf16",
                        "threefry2x32"),
    "block_step_series_bf16": ("series", "shared", False, "exact", "bf16",
                               "threefry2x32"),
    "block_step_trace_bf16": ("trace", "shared", False, "exact", "bf16",
                              "threefry2x32"),
    "block_step_site_bf16": ("acc", "site", True, "exact", "bf16",
                             "threefry2x32"),
    "block_step_strided_table_bf16": ("acc", "strided", True, "table",
                                      "bf16", "threefry2x32"),
    "block_step_prod_site_bf16": ("prod", "site", False, "exact", "bf16",
                                  "threefry2x32"),
    "block_step_prod_site_bf16+tel_analytics": (
        "prod", "site", False, "exact", "bf16", "threefry2x32"),
    "block_step_rbg": ("acc", "shared", False, "exact", "f32", "rbg"),
    "block_step_scenario_bf16": ("scen", "shared", False, "exact", "bf16",
                                 "threefry2x32"),
    "block_step_urbg": ("acc", "shared", False, "exact", "f32",
                        "unsafe_rbg"),
}
#: the main paths' chains, in 128-chain CTAs (one per chain group)
SHAPE_CHAINS = 65536


#: the window kernel's rows: their key implementation, and the hour
#: window of the main paths' 1080 s blocks (its shared bytes)
WINDOW_SHAPES = {"sampler_windows": "threefry2x32",
                 "sampler_windows_regime": "threefry2x32",
                 "sampler_windows_rbg": "rbg",
                 "sampler_windows_urbg": "unsafe_rbg"}
WINDOW_HOURS = 5


def waves(ctas_per_sm):
    """Waves of the main paths' 512 CTAs at ``ctas_per_sm`` CTAs an SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = -(-SHAPE_CHAINS // k3.THREADS)
    return -(-groups // (sms * ctas_per_sm)) if ctas_per_sm else None


def add_shapes(rows, fold_shape):
    """Every block-step row's registers, CTAs per SM and waves of the
    65536 chains; a pair row also the observer fold's; the window kernel's
    and the wide fold's rows likewise."""
    for r in rows:
        sh = None
        if r["name"] in WINDOW_SHAPES:
            sh = k2.windows_attrs(WINDOW_SHAPES[r["name"]], WINDOW_HOURS)
        elif r["name"] == "wide_fold":
            sh = k4m.wide_fold_attrs()
        if sh is not None:
            r.update(regs=sh["regs"], ctas_per_sm=sh["ctas_per_sm"],
                     local_bytes=sh["local_bytes"],
                     waves_65536=waves(sh["ctas_per_sm"]))
            print(f"shape {r['name']}: {r['regs']} registers, "
                  f"{r['ctas_per_sm']} CTAs per SM, {r['local_bytes']} "
                  f"local bytes, {r['waves_65536']} wave(s) at "
                  f"{SHAPE_CHAINS} chains")
            continue
        key = STEP_SHAPES.get(r["name"])
        if key is None:
            continue
        epi, geo, tel, ks, cd, impl = key
        sh = k3.step_attrs(epi, geo, tel, ks, cd, impl)
        r.update(regs=sh["regs"], ctas_per_sm=sh["ctas_per_sm"],
                 local_bytes=sh["local_bytes"],
                 waves_65536=waves(sh["ctas_per_sm"]))
        if epi == "prod" and not r["name"].startswith("block_step_prod"):
            r.update(fold_regs=fold_shape["regs"],
                     fold_ctas_per_sm=fold_shape["ctas_per_sm"],
                     fold_groups_per_cta=fold_shape["groups_per_cta"])
        print(f"shape {r['name']}: {r['regs']} registers, "
              f"{r['ctas_per_sm']} CTAs per SM, {r['local_bytes']} local "
              f"bytes, {r['waves_65536']} wave(s) at {SHAPE_CHAINS} chains")


def obs_fold_shape(dev):
    """The observer fold's launch shape for path F's observers at 65536
    chains x 1080 s."""
    cfg = SimConfig(**dict(HEADLINE, fleet=fleet_f(), telemetry="full",
                           analytics="full"))
    sim = Simulation(cfg, device=dev)
    obs = sim.observers(sim.init_state())
    sh = k3.obs_fold_attrs(SHAPE_CHAINS, obs, cfg.block_s, dev)
    print(f"shape obs_fold: {sh['regs']} registers, {sh['ctas_per_sm']} "
          f"CTAs per SM, {sh['groups_per_cta']} chain group(s) per CTA, "
          f"{sh['ctas']} CTAs (one wave), {sh['smem']} dynamic shared bytes")
    return sh


# --------------------------------------------------------------------------
# the sharded phase: chain-sharded runs over torch.distributed
# --------------------------------------------------------------------------

#: the two-rank cases' depth: A-2 and F-2 run 4 blocks, the NaN case 2
SHARDED_BLOCKS = 4
#: NaN fleet leaves of the NaN case, all in rank 1's rows (chains from
#: 32768): a NaN meter, a NaN pv and a NaN inverter limit
SHARDED_NAN = (("demand_scale", 40001), ("pv_scale", 50002),
               ("ac_limit_w", 60003))
#: the kernels each sharded path must launch (on every rank)
SHARDED_NEED = {
    "R": ("threefry_fill", "sampler_windows", "block_step"),
    "A": ("threefry_fill", "sampler_windows", "block_step_series",
          "series_sum"),
    "F": ("threefry_fill", "sampler_windows", "sampler_windows_regime",
          "block_step_prod_site", "block_step_fleet",
          "block_step_tel_analytics", "obs_fold", "chainwise_collapse"),
}
#: seconds the parent waits for the two ranks
SHARDED_TIMEOUT_S = 300


def sharded_configs():
    """The sharded cases' configs: R (path R's), A (path A's config over
    4 blocks), F (path F's fleet over 4 blocks from 11:00, both observers
    full) and F-NaN (F over 2 blocks)."""
    f = dict(HEADLINE, start=CHECK_START,
             duration_s=SHARDED_BLOCKS * HEADLINE["block_s"], fleet=fleet_f(),
             telemetry="full", analytics="full")
    return {
        "R": SimConfig(**HEADLINE),
        "A": SimConfig(**dict(HEADLINE, output="ensemble",
                              duration_s=SHARDED_BLOCKS
                              * HEADLINE["block_s"])),
        "F": SimConfig(**f),
        "F-NaN": SimConfig(**dict(f, duration_s=2 * HEADLINE["block_s"])),
    }


def sharded_jobs(suffix):
    cfgs = sharded_configs()
    out = {"R": ("reduce",), "A": ("ensemble",), "F": ("reduce",),
           "F-NaN": ("reduce",)}
    return [{"name": f"{k}-{suffix}", "config": cfg, "outputs": out[k],
             **({"nan": SHARDED_NAN} if k == "F-NaN" else {})}
            for k, cfg in cfgs.items()]


def time_collectives(sims, dev, reps=20):
    """Each all_reduce wrapper the sharded paths call, at the shapes they
    call it, timed with CUDA events (and the host's clock) in this
    process's group: the series pair of a block (path A), the telemetry
    and analytics deltas of a block in one packed tree (path F),
    ``ensemble_stats`` (every reduce run, once).  Returns ``{kind: {ms,
    host_ms, calls, bytes}}`` per call of the wrapper."""
    from tmhpvsim_torch.engine.simulation import REDUCE_STATS
    from tmhpvsim_torch.parallel import distributed

    f = sims["F"]
    stats = {k: (1 if d == "i" else 1.5) for k, (_, d) in REDUCE_STATS.items()}
    calls = {
        "series": lambda: distributed.allreduce_sums(
            torch.zeros(HEADLINE["block_s"], device=dev),
            torch.zeros(HEADLINE["block_s"], device=dev)),
        "observers": lambda: distributed.allreduce_deltas(f._tel_last,
                                                          f._fleet_last),
        "stats": lambda: distributed.allreduce_stats(stats, REDUCE_STATS,
                                                     dev),
    }
    out = {}
    for kind, fn in calls.items():
        distributed.reset_counts()
        fn()
        n, nbytes = distributed.ALL_REDUCE.calls, distributed.ALL_REDUCE.bytes
        for _ in range(3):
            fn()
        ms, host = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ms.append(e0.elapsed_time(e1))
        out[kind] = {"ms": float(np.median(ms)),
                     "host_ms": float(np.median(host)), "calls": n,
                     "bytes": nbytes}
    return out


def sharded_rank(rank: int, d: str) -> int:
    """One rank of the two-rank check (``chip_smoke.py --sharded-rank R
    DIR``): the test topology of one card, two ranks over gloo on its
    CUDA tensors (NCCL refuses two ranks on one device), joined through
    a file in DIR; runs DIR/jobs.pkl once DIR/go exists and writes each
    job's ``.npz`` (parallel/_check.py), its launches and wall, and the
    collectives' times to DIR/rank{R}.json."""
    import datetime as _dt
    import pickle

    import torch.distributed as dist

    from tmhpvsim_torch.parallel._check import run_job

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{d}/gloo.rdv",
                            world_size=2, rank=rank,
                            timeout=_dt.timedelta(seconds=SHARDED_TIMEOUT_S))
    with open(os.path.join(d, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    for src in build.build_all():
        build.library(src)
    deadline = time.time() + SHARDED_TIMEOUT_S
    while not os.path.exists(os.path.join(d, "go")):
        if time.time() > deadline:
            raise RuntimeError("the parent never started the two ranks")
        time.sleep(0.05)
    out, sims = {}, {}
    for job in jobs:
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = run_job(job, d, device=dev)
        torch.cuda.synchronize()
        key = job["name"].rsplit("-", 1)[0]
        sims[key] = sim
        out[job["name"]] = {
            "wall_s": time.perf_counter() - t0, "n_blocks": sim.n_blocks,
            "launches": {k: v for k, v in kernels.counts().items() if v}}
    out["timing"] = time_collectives(sims, dev)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _npz(d, name, rank):
    with np.load(os.path.join(d, f"{name}.rank{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


def _check_rows(what, got, want):
    """Reduce rows bit for bit (NaN where the reference has NaN)."""
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or not np.array_equal(
                g.view(np.uint32 if g.dtype.itemsize == 4 else np.uint64),
                w.view(np.uint32 if w.dtype.itemsize == 4 else np.uint64)):
            fail(f"{what}: rows of {k} differ from the unsharded run's "
                 f"({int((g != w).sum())} of {w.size})")


def _check_stats(what, got, want, rtol):
    for k, w in want.items():
        g = got[k]
        if np.isnan(w) or np.isnan(g):
            if not (np.isnan(w) and np.isnan(g)):
                fail(f"{what}: ensemble_stats {k} {g} against {w}")
        elif isinstance(w, int) or k.endswith(("_min", "_max")):
            if g != w:
                fail(f"{what}: ensemble_stats {k} {g} != {w}")
        elif abs(g - w) > rtol * abs(w):
            fail(f"{what}: ensemble_stats {k} {g} against {w}")


def _check_observers(what, part, sim, rtol):
    """Run totals and the last telemetry delta against the unsharded
    run's: integers and extrema exact, float sums within ``rtol``."""
    for prefix, tree in (("fleet_total", sim._fleet_total),
                         ("tel_last", sim._tel_last)):
        for k, v in tree.items():
            w = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            g = part[f"{prefix}.{k}"]
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{what}: {prefix}.{k} {g.dtype}{g.shape}")
            if g.dtype.kind == "f" and not k.startswith(("min", "max")):
                if not np.allclose(g, w, rtol=rtol, atol=1e-6,
                                   equal_nan=True):
                    fail(f"{what}: {prefix}.{k} differs beyond {rtol}")
            elif not np.array_equal(g, w, equal_nan=g.dtype.kind == "f"):
                fail(f"{what}: {prefix}.{k} differs")


def _fleet_summary_counts(what, got, want, path=""):
    if isinstance(want, dict):
        if set(got) != set(want):
            fail(f"{what}: fleet summary keys at {path}")
        for k in want:
            _fleet_summary_counts(what, got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _fleet_summary_counts(what, g, w, f"{path}[{i}]")
    elif isinstance(want, (int, bool, str)) or want is None:
        if got != want:
            fail(f"{what}: fleet summary {path} {got} != {want}")
    elif not np.isclose(got, want, rtol=1e-5, atol=1e-9, equal_nan=True):
        fail(f"{what}: fleet summary {path} {got} against {want}")


def phase_sharded(dev, reduced_r, stats_r, means_a):
    """(a) NCCL in a group of one through the package's ``initialize``:
    R-N1 (path R's config through ``ShardedSimulation``: rows bit for bit
    and ``ensemble_stats`` equal to path R's), A-N1 and F-N1 (bit for bit
    against A's first 4 blocks and an unsharded 4-block F run), the NaN
    case; (b) two ranks on the card over gloo: R-2 (rows bit for bit,
    ``ensemble_stats`` within 1e-12), A-2 (means within rtol 1e-5 / atol
    1e-3), F-2 (rows bit for bit; the observers' integers and extrema
    exact, float sums within 1e-5; the fleet summary's counts exact) and
    the NaN case (rows NaN where the unsharded run's are, the NaN
    winning MIN and MAX in ``ensemble_stats``); each rank's paths must
    launch their kernels.  Times every all_reduce in both topologies."""
    import pickle
    import shutil
    import tempfile

    import torch.distributed as dist

    from tmhpvsim_torch.parallel import distributed
    from tmhpvsim_torch.parallel._check import run_job

    d = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    procs = []
    try:
        with open(os.path.join(d, "jobs.pkl"), "wb") as f:
            pickle.dump(sharded_jobs("2"), f)
        # the ranks start up (python, torch, the card, the libraries)
        # while (a) runs, and wait for DIR/go before touching the card
        for r in range(2):
            log = open(os.path.join(d, f"rank{r}.log"), "w")
            procs.append((log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--sharded-rank",
                 str(r), d], stdout=log, stderr=subprocess.STDOUT,
                cwd=HERE)))
        # the unsharded references of the 4-block runs
        cfgs = sharded_configs()
        ref = {}
        for k in ("F", "F-NaN"):
            sim = Simulation(cfgs[k], device=dev)
            state = None
            if k == "F-NaN":
                state = sim.init_state()
                for leaf, c in SHARDED_NAN:
                    state["fleet"][leaf][c] = float("nan")
            ref[k] = (sim.run_reduced(state=state), sim)
        # (a) NCCL, a group of one
        if not distributed.initialize(f"file://{d}/nccl.rdv", 1, 0,
                                      device=dev):
            fail("sharded: initialize made no process group")
        if dist.get_backend() != "nccl":
            fail(f"sharded: the card's group is {dist.get_backend()}")
        sims, launch_n1, walls = {}, {}, {}
        for job in sharded_jobs("N1"):
            key = job["name"].rsplit("-", 1)[0]
            sim, walls[key], launch_n1[key] = run_path(
                job["name"], SHARDED_NEED[key[0]],
                lambda job=job: run_job(job, d, device=dev))
            sims[key] = sim
        p = _npz(d, "R-N1", 0)
        _check_rows("R-N1", {k: p[f"reduce.{k}"] for k in reduced_r},
                    reduced_r)
        _check_stats("R-N1", json.loads(str(p["ensemble_stats"])), stats_r,
                     0.0)
        p = _npz(d, "A-N1", 0)
        n_a = SHARDED_BLOCKS * HEADLINE["block_s"]
        for i, f in enumerate(("meter", "pv")):
            if not np.array_equal(p[f"ensemble.{f}"][0], means_a[i][:n_a]):
                fail(f"A-N1: the {f} means differ from path A's")
        for k in ("F", "F-NaN"):
            p = _npz(d, f"{k}-N1", 0)
            _check_rows(f"{k}-N1", {s: p[f"reduce.{s}"] for s in reduced_r},
                        ref[k][0])
            _check_stats(f"{k}-N1", json.loads(str(p["ensemble_stats"])),
                         ref[k][1].ensemble_stats(), 0.0)
            _check_observers(f"{k}-N1", p, ref[k][1], 0.0)
        timing_n1 = time_collectives(sims, dev)
        distributed.shutdown()
        del sims
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        # (b) the two gloo ranks on this card
        t0 = time.perf_counter()
        open(os.path.join(d, "go"), "w").close()
        for r, (log, p) in enumerate(procs):
            try:
                rc = p.wait(timeout=SHARDED_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.close()
            if rc != 0:
                with open(os.path.join(d, f"rank{r}.log")) as f:
                    tail = f.read()[-4000:]
                fail(f"sharded: rank {r} exited {rc}:\n{tail}")
        wall_2 = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        for r, info in enumerate(ranks):
            for name, need in (("R-2", "R"), ("A-2", "A"), ("F-2", "F"),
                               ("F-NaN-2", "F")):
                for k in SHARDED_NEED[need]:
                    if not info[name]["launches"].get(k):
                        fail(f"sharded: rank {r}'s {name} never launched {k}")
        parts = {name: [_npz(d, name, r) for r in range(2)]
                 for name in ("R-2", "A-2", "F-2", "F-NaN-2")}

        def rows(name):
            return {k: np.concatenate([p[f"reduce.{k}"] for p in
                                       parts[name]]) for k in reduced_r}

        _check_rows("R-2", rows("R-2"), reduced_r)
        for p in parts["R-2"]:
            _check_stats("R-2", json.loads(str(p["ensemble_stats"])),
                         stats_r, 1e-12)
        for p in parts["A-2"]:
            for i, f in enumerate(("meter", "pv")):
                if not np.allclose(p[f"ensemble.{f}"][0], means_a[i][:n_a],
                                   rtol=1e-5, atol=1e-3):
                    fail(f"A-2: the {f} means differ from path A's")
        for k in ("F", "F-NaN"):
            name = f"{k}-2"
            _check_rows(name, rows(name), ref[k][0])
            want = ref[k][1]
            for p in parts[name]:
                _check_stats(name, json.loads(str(p["ensemble_stats"])),
                             want.ensemble_stats(), 1e-12)
                _check_observers(name, p, want, 1e-5)
                _fleet_summary_counts(
                    name, json.loads(str(p["fleet_summary"])),
                    json.loads(json.dumps(want.fleet_summary(),
                                          default=float)))
        st = json.loads(str(parts["F-NaN-2"][0]["ensemble_stats"]))
        if not all(np.isnan(st[k]) for k in ("pv_max", "residual_min",
                                             "residual_max", "meter_sum")):
            fail(f"F-NaN-2: a NaN in rank 1's rows did not win: {st}")
        nan_rows = {k: int(np.isnan(v).sum())
                    for k, v in rows("F-NaN-2").items() if k != "n_seconds"}
        per_block = {}
        stats = timing_n1["stats"]
        for name, out in (("R-2", "reduce"), ("A-2", "ensemble"),
                          ("F-2", "reduce")):
            p = parts[name][0]
            n_blocks = ranks[0][name]["n_blocks"]
            end = out == "reduce"           # ensemble_stats, once
            calls = int(p[f"{out}.all_reduce_calls"])
            nbytes = int(p[f"{out}.all_reduce_bytes"])
            per_block[name] = {
                "calls": (calls - end * stats["calls"]) / n_blocks,
                "bytes": (nbytes - end * stats["bytes"]) / n_blocks,
                "rank_walls_s": [ranks[r][name]["wall_s"] for r in range(2)]}
        timing_2 = [info["timing"] for info in ranks]
        print(f"sharded R-N1 (NCCL, a group of one, through initialize): "
              f"rows bit-identical to path R's, ensemble_stats equal; "
              f"{walls['R']:.3f} s wall (path R's loop through "
              f"ShardedSimulation); A-N1, F-N1 and F-NaN-N1 bit-identical "
              f"to their unsharded runs; launches R-N1 {launch_n1['R']}")
        print(f"sharded, two ranks over gloo on this card: R-2 rows "
              f"bit-identical to path R's, ensemble_stats within 1e-12; A-2 "
              f"means within rtol 1e-5; F-2 rows bit-identical, observers' "
              f"integers and extrema exact, sums within 1e-5; F-NaN-2's "
              f"NaN rows {nan_rows}, NaN ensemble_stats; {wall_2:.3f} s from "
              f"go to both ranks' exit; per block {json.dumps(per_block)}")
        print(f"sharded all_reduce per call, NCCL group of one: "
              f"{json.dumps(timing_n1)}")
        for r, t in enumerate(timing_2):
            print(f"sharded all_reduce per call, gloo rank {r} of 2 (CUDA "
                  f"tensors, one card): {json.dumps(t)}")
        return {"n1": timing_n1, "gloo2": timing_2, "per_block": per_block,
                "walls": walls, "wall_2": wall_2}
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        distributed.shutdown()
        shutil.rmtree(d, ignore_errors=True)


def collective_rows(sharded):
    """The ``{"collectives": [...]}`` rows: each all_reduce wrapper the
    sharded paths call (the library's collective, not a hand-written
    kernel), per call and per block of the path that calls it, in both
    topologies; the bound is its bytes read and written once at the
    card's memory rate."""
    mesh = "tmhpvsim_tpu/parallel/mesh.py"
    dis = "tmhpvsim_tpu/parallel/distributed.py"
    pb = sharded["per_block"]
    rows = []
    for kind, replaces, path in (
            ("series", f"{mesh}:447-448, {mesh}:468-469", "A-2"),
            ("observers", f"{dis}:210, {dis}:222", "F-2"),
            ("stats", f"{mesh}:660", "R-2")):
        n1 = sharded["n1"][kind]
        g2 = sharded["gloo2"][0][kind]
        nbytes = n1["bytes"]
        bms = 2 * nbytes / PEAK_BYTES * 1e3
        rows.append({
            "name": f"all_reduce_{kind}", "route": "library",
            "source": "tmhpvsim_torch/parallel/distributed.py",
            "replaces": replaces, "path": path,
            "launches": n1["calls"],
            "launches_per_block": (pb[path]["calls"] if kind != "stats"
                                   else 0),
            "bytes": nbytes, "ms": n1["ms"], "host_ms": n1["host_ms"],
            "ms_gloo_2": g2["ms"], "host_ms_gloo_2": g2["host_ms"],
            "plain_ms": None, "bound_ms": bms, "bound_by": "bytes",
            "library_ms": n1["ms"]})
    return rows

# ---------------------------------------------------------------------------
# checkpoints, preemption and chain slabs: paths R-SL, R-CK, D-CK, R-2CK
# ---------------------------------------------------------------------------

#: path R's config as the CLI's flags
PATH_R_ARGS = ["--output", "reduce", "--no-realtime", "--chains",
               str(HEADLINE["n_chains"]), "--duration",
               str(HEADLINE["duration_s"]), "--start", HEADLINE["start"],
               "--block-s", str(HEADLINE["block_s"]), "--seed",
               str(HEADLINE["seed"])]
#: the preemption notice goes out once a generation past this block exists
CK_BLOCK = 20
#: path R-SL's slab (a whole number of the block step's 128-chain CTAs)
SLAB_CHAINS = 16384
#: rounds of path R-CK's in-process loops (none, sync, async), in turns
CK_ROUNDS = 3
#: seconds a checkpointing process may take before the phase fails
CK_TIMEOUT_S = 300


def _latest_block(path) -> int:
    """The newest resume point the manifest of checkpoint ``path`` names
    (0 before the first generation)."""
    from tmhpvsim_torch.engine import checkpoint as ckpt

    man = ckpt.read_manifest(path)
    if man is None:
        return 0
    return max((int(e.get("next_block", 0)) for e in man["generations"]),
               default=0)


def _spawn(args, log_path):
    """Start ``args`` (a Python module command line) on its own, its output
    to ``log_path``; returns ``(log, process)``."""
    log = open(log_path, "w")
    return log, subprocess.Popen([sys.executable, *args], stdout=log,
                                 stderr=subprocess.STDOUT, cwd=HERE)


def _signal_when(procs, paths, block, sig, what, throttle=False):
    """Send ``sig`` to every process of ``procs`` once each checkpoint of
    ``paths`` holds a generation past ``block``; fail when a process ends
    first or the wait passes ``CK_TIMEOUT_S``.  With ``throttle``, once a
    checkpoint's first write has begun, the processes run 1 ms in every 5
    (SIGSTOP / SIGCONT) while the wait lasts: an async writer stalled on
    the disk (an fsync behind the earlier phases' writes) goes on while
    the run's loop is held, so the run cannot reach its end first."""
    deadline = time.time() + CK_TIMEOUT_S
    while not all(_latest_block(p) > block for p in paths):
        if any(p.poll() is not None for p in procs):
            fail(f"{what}: a process ended before its checkpoint passed "
                 f"block {block}")
        if time.time() > deadline:
            fail(f"{what}: no checkpoint past block {block} in "
                 f"{CK_TIMEOUT_S} s")
        if throttle and any(os.path.exists(p + ".tmp") or
                            _latest_block(p) > 0 for p in paths):
            for p in procs:
                p.send_signal(signal.SIGSTOP)
            time.sleep(0.004)
            for p in procs:
                p.send_signal(signal.SIGCONT)
            time.sleep(0.001)
        else:
            time.sleep(0.002)
    for p in procs:
        p.send_signal(sig)


def _reap(procs, what):
    """Wait for each ``(log, process)`` at most ``CK_TIMEOUT_S``, kill any
    still alive, and return the exit codes."""
    rcs = []
    try:
        for log, p in procs:
            try:
                rcs.append(p.wait(timeout=CK_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                fail(f"{what}: a process ran past {CK_TIMEOUT_S} s")
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return rcs


def phase_path_rsl(dev, reduced_r, means_a):
    """Path R-SL: path R under a plan with ``slab_chains`` 16384 (four
    slabs run one after another, engine/slab.py): rows bit for bit
    against path R's; its wall against path R's in alternating pairs;
    then path A under the same plan: the per-second means bit for bit
    against path A's."""
    import dataclasses as _dc

    from tmhpvsim_torch.config import resolve_plan

    cfg = SimConfig(**HEADLINE)
    plan = _dc.replace(resolve_plan(cfg), slab_chains=SLAB_CHAINS)
    sim = Simulation(cfg, device=dev, plan=plan)
    reduced, wall, launches = run_path(
        "R-SL", ("threefry_fill", "sampler_windows", "block_step"),
        sim.run_reduced)
    _check_rows("R-SL", reduced, reduced_r)
    walls = {"R": [], "R-SL": []}
    for pair in range(3):
        for kind in (("R", "R-SL") if pair % 2 == 0 else ("R-SL", "R")):
            s = Simulation(cfg, device=dev,
                           plan=plan if kind == "R-SL" else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run_reduced()
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
    print(f"path R-SL (path R in {HEADLINE['n_chains'] // SLAB_CHAINS} "
          f"slabs of {SLAB_CHAINS} chains): rows bit-identical to path R's; "
          f"{wall:.3f} s wall; 3 alternating pairs: "
          + "; ".join(f"{k} median {np.median(v):.4f} s ("
                      + ", ".join(f"{w:.4f}" for w in v) + ")"
                      for k, v in walls.items())
          + f"; launches {launches}")
    cfg_a = SimConfig(**dict(HEADLINE, output="ensemble"))
    sim_a = Simulation(cfg_a, device=dev, plan=plan)
    blocks, wall_a, launches_a = run_path(
        "R-SL (ensemble)", ("threefry_fill", "sampler_windows",
                            "block_step_series"),
        lambda: list(sim_a.run_ensemble()))
    for i, f in enumerate(("meter", "pv")):
        got = np.concatenate([getattr(b, f)[0] for b in blocks])
        if got.dtype != means_a[i].dtype or \
                not np.array_equal(got, means_a[i]):
            fail(f"path R-SL (ensemble): the slabbed {f} means differ from "
                 "path A's")
    print(f"path R-SL (ensemble, path A in the same slabs): per-second "
          f"means bit-identical to path A's; {wall_a:.3f} s wall; launches "
          f"{launches_a}")
    return launches


def snapshot_ms(dev, reps=10):
    """A checkpoint's host copy at path R's shape (the state and the
    accumulator of 65536 chains): ``(bytes, ms of the copy waited for,
    ms to enqueue it)``, medians of ``reps`` (``checkpoint._Snapshot``:
    one pinned buffer, copies on the current stream)."""
    from tmhpvsim_torch.engine import checkpoint as ckpt

    sim = Simulation(SimConfig(**HEADLINE), device=dev)
    tree = {"state": sim.init_state(), "acc": sim.init_reduce_acc()}
    nbytes = sum(v.numel() * v.element_size()
                 for _, _, v in ckpt._leaves(tree))
    copy, enqueue = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = ckpt._Snapshot(tree)
        t1 = time.perf_counter()
        snap.flat()
        t2 = time.perf_counter()
        enqueue.append((t1 - t0) * 1e3)
        copy.append((t2 - t0) * 1e3)
    return nbytes, float(np.median(copy[1:])), float(np.median(enqueue[1:]))


def ck_loops(dev, d):
    """Path R's ``run_reduced`` in process after each block doing nothing,
    a synchronous ``checkpoint.save`` or an async writer's ``submit``, in
    turns for ``CK_ROUNDS`` rounds: ``(walls {mode: [s]}, the async
    writer's final drains [s])``; a loop's wall ends at a device
    synchronise, the writer's drain (``close``) is timed apart."""
    from tmhpvsim_torch.engine import checkpoint as ckpt

    cfg = SimConfig(**HEADLINE)
    walls = {"none": [], "sync": [], "async": []}
    drains = []
    for rnd in range(CK_ROUNDS):
        for mode in (list(walls) if rnd % 2 == 0 else list(walls)[::-1]):
            sim = Simulation(cfg, device=dev)
            path = os.path.join(d, f"loop_{mode}{rnd}.npz")
            w = (ckpt.AsyncCheckpointWriter(path, config=sim.config)
                 if mode == "async" else None)

            def cb(bi, state, acc, mode=mode, w=w, sim=sim, path=path):
                tree = {"state": state, "acc": acc}
                if mode == "sync":
                    ckpt.save(path, tree, bi + 1, sim.config)
                elif w is not None:
                    w.submit(tree, bi + 1)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run_reduced(on_block=cb)
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            if w is not None:
                t0 = time.perf_counter()
                w.close(timeout=CK_TIMEOUT_S)
                drains.append(time.perf_counter() - t0)
    return walls, drains


def phase_path_rck(dev):
    """Path R-CK: a checkpoint's host copy at path R's shape on its own
    (``snapshot_ms``); path R's run loop in process with a save a block,
    sync and async (``ck_loops``); then path R's config through the CLI
    with ``--checkpoint`` in process: without checkpoints, with
    synchronous and with async saves (each CSV byte-equal to the first;
    the run reports' save counts and seconds); then for each save mode
    the CLI as a process of its own with ``--preempt-grace 30``, sent
    SIGTERM once a generation past block 20 exists: it must exit 0 with the resume line and no CSV; the same
    command rerun must write the uninterrupted run's bytes."""
    import shutil
    import signal
    import tempfile

    from tmhpvsim_torch.cli import main as cli

    need = ("sampler_windows", "block_step")
    n_blocks = HEADLINE["duration_s"] // HEADLINE["block_s"]
    nbytes, copy_ms, enqueue_ms = snapshot_ms(dev)
    print(f"path R-CK: a checkpoint's host copy ({nbytes} B, the state "
          f"and the accumulator of {HEADLINE['n_chains']} chains): "
          f"{copy_ms:.4f} ms waited for ({nbytes / copy_ms / 1e6:.2f} "
          f"GB/s), {enqueue_ms:.4f} ms to enqueue (medians of 10)")
    d = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    try:
        loops, drains = ck_loops(dev, d)
        med = {m: float(np.median(v)) for m, v in loops.items()}
        added = {m: (med[m] - med["none"]) / n_blocks * 1e3
                 for m in ("sync", "async")}
        print(f"path R-CK, run_reduced in process with a save a block, "
              f"{CK_ROUNDS} rounds in turns: "
              + "; ".join(f"{m} " + ", ".join(f"{w:.4f}" for w in v) + " s"
                          for m, v in loops.items())
              + f"; the loop's added ms a block (medians): sync "
              f"{added['sync']:.3f}, async {added['async']:.3f}, against "
              f"the copy's {copy_ms:.4f} ms waited for; the async writer's "
              f"final drain " + ", ".join(f"{x:.3f}" for x in drains) + " s")
        ref, walls, secs = None, {}, {}
        for mode in ("none", "off", "on"):
            out = os.path.join(d, f"{mode}.csv")
            rep = os.path.join(d, f"{mode}.json")
            extra = [] if mode == "none" else [
                "--checkpoint", os.path.join(d, f"{mode}.npz"),
                "--checkpoint-async", mode, "--run-report", rep]
            rc, walls[mode], _ = run_path(
                f"R-CK ({mode})", need,
                lambda: cli(["pvsim", out, *PATH_R_ARGS, *extra]))
            if rc != 0:
                fail(f"path R-CK ({mode}): the CLI returned {rc}")
            with open(out, "rb") as f:
                data = f.read()
            ref = data if ref is None else ref
            if data != ref:
                fail(f"path R-CK ({mode}): the CSV differs from the "
                     "uninterrupted run's")
            if mode != "none":
                with open(rep) as f:
                    secs[mode] = json.load(f)["checkpoint"]
        print("path R-CK, uninterrupted CLI runs in process incl. the CSV "
              "and the writer's drain: "
              + "; ".join(f"{m} {w:.4f} s" for m, w in walls.items()))
        for m, sec in secs.items():
            print(f"path R-CK ({m}) checkpoint section: {json.dumps(sec)}; "
                  f"save s a generation "
                  f"{sec['save_total_s'] / sec['saves']:.4f}")
        for mode in ("off", "on"):
            out = os.path.join(d, f"pre_{mode}.csv")
            ck = os.path.join(d, f"pre_{mode}.npz")
            args = ["pvsim", out, *PATH_R_ARGS, "--checkpoint", ck,
                    "--preempt-grace", "30", "--checkpoint-async", mode]
            log_path = os.path.join(d, f"pre_{mode}.log")
            t0 = time.perf_counter()
            proc = _spawn(["-m", "tmhpvsim_torch", *args], log_path)
            _signal_when([proc[1]], [ck], CK_BLOCK, signal.SIGTERM,
                         f"R-CK ({mode})", throttle=mode == "on")
            rc, = _reap([proc], f"R-CK ({mode})")
            wall_pre = time.perf_counter() - t0
            with open(log_path) as f:
                text = f.read()
            if rc != 0 or "preempted" not in text:
                fail(f"path R-CK ({mode}): the preempted run returned {rc}: "
                     f"{text[-2000:]}")
            if os.path.exists(out):
                fail(f"path R-CK ({mode}): a preempted run wrote its CSV")
            stopped = _latest_block(ck)
            rc, wall, launches = run_path(f"R-CK ({mode}) rerun", need,
                                          lambda: cli(args))
            with open(out, "rb") as f:
                if rc != 0 or f.read() != ref:
                    fail(f"path R-CK ({mode}): the resumed CSV differs from "
                         "the uninterrupted run's")
            print(f"path R-CK ({mode}, preempted): SIGTERM once a "
                  f"generation past block {CK_BLOCK} existed; rc 0, stopped "
                  f"with block {stopped}/{n_blocks} checkpointed, "
                  f"{wall_pre:.3f} s as a process incl. its start; the "
                  f"rerun resumed and finished in {wall:.3f} s, CSV "
                  f"byte-equal to the uninterrupted run's; launches "
                  f"{launches}")
        return med
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_path_dck(csv_d):
    """Path D-CK: path D through the CLI with ``--checkpoint`` as a process
    of its own, SIGKILLed once its first checkpoint exists (rows past it
    may be on disk), then the same command rerun: its CSV must be path
    D's bytes, each row once."""
    import shutil
    import signal
    import tempfile

    from tmhpvsim_torch.cli import main as cli

    d = tempfile.mkdtemp(prefix="chip_smoke_dck_")
    try:
        out, ck = os.path.join(d, "d.csv"), os.path.join(d, "d.npz")
        args = ["pvsim", out, *PATH_D_ARGS, "--checkpoint", ck]
        proc = _spawn(["-m", "tmhpvsim_torch", *args],
                      os.path.join(d, "d.log"))
        _signal_when([proc[1]], [ck], 0, signal.SIGKILL, "D-CK")
        _reap([proc], "D-CK")
        at_kill = _latest_block(ck)
        with open(out) as f:
            rows_kill = len(f.read().splitlines()) - 1
        rc, wall, launches = run_path(
            "D-CK", ("sampler_windows", "block_step_trace"),
            lambda: cli(args))
        with open(out, "rb") as f:
            if rc != 0 or f.read() != csv_d:
                fail("path D-CK: the resumed CSV differs from path D's")
        print(f"path D-CK: SIGKILLed with block {at_kill} checkpointed and "
              f"{rows_kill} rows on disk; the rerun cut them to "
              f"{min(86400, at_kill * 8640)} and finished in {wall:.3f} s; "
              f"CSV byte-equal to path D's; launches {launches}")
        return launches
    finally:
        shutil.rmtree(d, ignore_errors=True)


def ck_rank(rank: int, d: str) -> int:
    """One rank of path R-2CK (``chip_smoke.py --ck-rank R DIR``): two
    ranks over gloo on the card's CUDA tensors (NCCL refuses two ranks on
    one device), joined through a file in DIR; runs path R's config
    through ``pvsim(sharded=True, checkpoint=DIR/r2.npz,
    preempt_grace_s=30)``, so that each rank checkpoints its chains to
    ``DIR/r2.npz.host{R}`` until SIGTERM stops it, and writes its launches
    to DIR/rank{R}.json."""
    import datetime as _dt

    import torch.distributed as dist

    from tmhpvsim_torch.apps.pvsim import pvsim

    torch.cuda.set_device(torch.device("cuda", 0))
    dist.init_process_group("gloo", init_method=f"file://{d}/ck.rdv",
                            world_size=2, rank=rank,
                            timeout=_dt.timedelta(seconds=CK_TIMEOUT_S))
    for src in build.build_all():
        build.library(src)
    kernels.reset_counts()
    h = HEADLINE
    pvsim(os.path.join(d, "r2.csv"), h["duration_s"], h["n_chains"],
          h["seed"], h["start"], block_s=h["block_s"], output="reduce",
          device="cuda", sharded=True, checkpoint=os.path.join(d, "r2.npz"),
          preempt_grace_s=30.0)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump({k: v for k, v in kernels.counts().items() if v}, f)
    dist.destroy_process_group()
    return 0


def phase_path_r2ck(dev, reduced_r):
    """Path R-2CK: path R-2's two gloo ranks on the card (``ck_rank``),
    each checkpointing its chains, stopped by SIGTERM once both have a
    generation past block 20 (the ranks agree on the block to stop
    after: their newest generations must name one resume point); then
    this process resumes their files through ``checkpoint.load_elastic``
    and finishes the run: rows bit for bit against path R's."""
    import shutil
    import signal
    import tempfile

    from tmhpvsim_torch.engine import checkpoint as ckpt

    d = tempfile.mkdtemp(prefix="chip_smoke_r2ck_")
    try:
        t0 = time.perf_counter()
        procs = [_spawn([os.path.abspath(__file__), "--ck-rank", str(r), d],
                        os.path.join(d, f"rank{r}.log")) for r in range(2)]
        paths = [os.path.join(d, f"r2.npz.host{r}") for r in range(2)]
        _signal_when([p for _, p in procs], paths, CK_BLOCK, signal.SIGTERM,
                     "R-2CK")
        rcs = _reap(procs, "R-2CK")
        wall_ranks = time.perf_counter() - t0
        for r, rc in enumerate(rcs):
            with open(os.path.join(d, f"rank{r}.log")) as f:
                text = f.read()
            if rc != 0 or "preempted" not in text:
                fail(f"path R-2CK: rank {r} returned {rc}: {text[-2000:]}")
            with open(os.path.join(d, f"rank{r}.json")) as f:
                counts = json.load(f)
            for k in ("threefry_fill", "sampler_windows", "block_step"):
                if not counts.get(k):
                    fail(f"path R-2CK: rank {r} never launched {k}")
        stopped = [_latest_block(p) for p in paths]
        if stopped[0] != stopped[1]:
            fail(f"path R-2CK: the ranks stopped after different blocks "
                 f"{stopped}")
        cfg = SimConfig(**HEADLINE)
        sim = Simulation(cfg, device=dev)
        t1 = time.perf_counter()
        tree, nb = ckpt.load_elastic(os.path.join(d, "r2.npz"), sim.config)
        load_s = time.perf_counter() - t1
        reduced, wall, launches = run_path(
            "R-2CK", ("sampler_windows", "block_step"),
            lambda: sim.run_reduced(state=tree["state"], acc=tree["acc"],
                                    start_block=nb))
        _check_rows("R-2CK", reduced, reduced_r)
        print(f"path R-2CK: two gloo ranks stopped with blocks {stopped} "
              f"checkpointed ({wall_ranks:.3f} s as processes incl. their "
              f"start); one process reassembled them at block {nb} "
              f"(load_elastic {load_s:.3f} s) and finished in {wall:.3f} s; "
              f"rows bit-identical to path R's; launches {launches}")
        return launches
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    timed("build", phase_build)
    smi = smi_line()
    print(f"card: {smi}")
    err1 = timed("k1", phase_k1, dev)
    err2 = timed("k2", phase_k2, dev)
    err3 = timed("k3", phase_k3, dev)
    err_s, err_r = timed("k4_series", phase_k4_series, dev)
    err_t = timed("k4_trace", phase_k4_trace, dev)
    timed("lean_edges", phase_lean_edges, dev)
    err6 = timed("k6", phase_k6, dev)
    err7r, err7t = timed("k7", phase_k7, dev)
    err8 = timed("k8", phase_k8, dev)
    err9 = timed("k9", phase_k9, dev)
    err89, err_c = timed("k89", phase_k89, dev)
    k10 = timed("k10", phase_k10, dev)
    err10f = timed("k10_fleet", phase_k10_fleet, dev)
    k11_fn, err11 = timed("k11", phase_k11, dev)
    err6s = timed("k6s", phase_k6s, dev)
    err89l, _ = timed("k89_fl", phase_k89, dev, LEVERS, "K8+K9 (F-L)")
    timed("reference_levers", phase_reference_levers, dev)
    err4mf, err4mo, err4ms = timed("k4m", phase_k4m, dev)
    timed("wide_fused", phase_wide_fused, dev)
    err12 = timed("k12", phase_k12, dev)
    k13 = timed("k13", phase_k13, dev)
    err14d = timed("k14", phase_k14, dev)
    k15 = timed("k15", phase_k15, dev)
    err13w = timed("k13_k2", phase_k13_k2, dev)
    err14w = timed("k14_k2", phase_k13_k2, dev, URBG)
    err13 = timed("k13_k3", phase_k13_k3, dev)
    err14 = timed("k14_k3", phase_k13_k3, dev, URBG)
    err13r, rel13r = timed("k13_rest", phase_k13_rest, dev)
    err14r, rel14r = timed("k14_rest", phase_k13_rest, dev, URBG)
    k12s = timed("k12_k10", phase_k12_k10, dev)
    timed("nan", phase_nan, dev)
    torch.cuda.empty_cache()
    sim_r, launch_r, reduced_r, wall_r = timed("path_r", phase_path_r, dev)
    stats_r = sim_r.ensemble_stats()
    del sim_r
    launch_a, means_a = timed("path_a", phase_path_a, dev)
    launch_b = timed("path_b", phase_path_b, dev)
    launch_c = timed("path_c", phase_path_c, dev)
    _, csv_d = timed("path_d", phase_path_d)
    launch_f, reduced_f = timed("path_f", phase_path_f, dev)
    timed("path_g", phase_path_g)
    launch_h = timed("path_h", phase_path_h, dev)
    torch.cuda.empty_cache()
    sharded = timed("sharded", phase_sharded, dev, reduced_r, stats_r,
                    means_a)
    timed("path_rsl", phase_path_rsl, dev, reduced_r, means_a)
    timed("path_rck", phase_path_rck, dev)
    timed("path_dck", phase_path_dck, csv_d)
    timed("path_r2ck", phase_path_r2ck, dev, reduced_r)
    torch.cuda.empty_cache()
    replies_s, launch_s = timed("path_s", phase_path_s, "S", "window", dev)
    replies_c, launch_sc = timed("path_sc", phase_path_s, "S-c",
                                 "continuous", dev)
    if replies_c != replies_s:
        bad = sorted(r for r in replies_s if replies_c.get(r) !=
                     replies_s[r])
        fail(f"path S-c: replies {bad} differ from path S's")
    print(f"path S-c: all {len(replies_s)} replies byte-equal to path S's "
          f"(block_step_scenario launches: S "
          f"{launch_s['block_step_scenario']}, S-c "
          f"{launch_sc['block_step_scenario']})")
    launch_rt, ens_rt = timed("path_rt", phase_path_rt, dev)
    launch_bl, ens_bl = timed("path_bl", phase_path_bl, dev)
    launch_fl, ens_fl = timed("path_fl", phase_path_fl, dev)
    launch_gl = timed("path_gl", phase_path_gl)
    print(f"the levers' fleet aggregates (R-T, B-L, F-L): "
          f"{json.dumps([ens_rt, ens_bl, ens_fl])}")
    torch.cuda.empty_cache()
    launch_rw = timed("path_rw", phase_path_rw, dev, reduced_r)
    launch_aw = timed("path_aw", phase_path_aw, dev, means_a)
    launch_fw = timed("path_fw", phase_path_fw, dev, reduced_f)
    timed("path_rk", phase_path_rk, dev, reduced_r, wall_r)
    timed("path_gw", phase_path_gw)
    torch.cuda.empty_cache()
    launch_rh, reduced_rh = timed("path_rh", phase_path_rh, dev, reduced_r)
    timed("path_rhw", phase_path_rhw, dev, reduced_rh)
    launch_ah = timed("path_ah", phase_path_ah, dev)
    launch_bh = timed("path_bh", phase_path_bh, dev)
    launch_bhl = timed("path_bhl", phase_path_bh, dev, "B-HL", LEVERS)
    launch_fh = timed("path_fh", phase_path_fh, dev)
    launch_ch = timed("path_ch", phase_path_ch, dev)
    launch_gh = timed("path_gh", phase_path_gh)
    torch.cuda.empty_cache()
    launch_rp, _ = timed("path_rp", phase_path_rp, dev, reduced_r, wall_r)
    launch_ru, walls_ru = timed("path_ru", phase_path_ru, dev, reduced_r,
                                wall_r)
    launch_sh = timed("path_sh", phase_path_sh, dev, replies_s)
    launch_m, wall_m = timed("path_m", phase_path_m, dev)
    launch_sp, wall_sp, _ = timed("path_sp", phase_path_sp, dev, "SP",
                                  "local://path-sp", PATH_SP["duration_s"])
    from tmhpvsim_torch.runtime.tcpbroker import TcpFanoutBroker

    launch_spt, _, _ = timed("path_spt", phase_path_sp, dev, "SP-T",
                             "tcp://", PATH_SPT_S, TcpFanoutBroker)
    torch.cuda.empty_cache()
    timing = timed("timing", phase_timing, dev)
    timing.update(timed("timing_fleet", phase_timing_fleet, dev))
    timing.update(timed("timing_levers", phase_timing_levers, dev))
    timing_wide, lib_sum = timed("timing_wide", phase_timing_wide, dev)
    timing_k12 = timed("timing_k12", phase_timing_k12, dev)
    timing_k5 = timed("timing_k5", phase_timing_k5, dev)
    timing_k13 = timed("timing_k13", phase_timing_k13, dev)
    timing_k14 = timed("timing_k14", phase_timing_k13, dev, URBG)
    print_geometry_timing(timing, timing_k12)
    fold_shape = obs_fold_shape(dev)
    timed("reference", phase_reference, dev)
    timed("reference_bf16", phase_reference_bf16, dev)
    timed("reference_rbg", phase_reference_rbg, dev)
    timed("reference_urbg", phase_reference_rbg, dev, URBG)
    sim_py = "tmhpvsim_tpu/engine/simulation.py"
    src = "tmhpvsim_torch/csrc/block_step.cuh"
    rows_of = {
        "K1": ("threefry_fill", "tmhpvsim_torch/csrc/threefry.cu",
               "tmhpvsim_tpu/models/clearsky_index.py:278", err1, launch_r),
        "K2": ("sampler_windows", "tmhpvsim_torch/csrc/windows.cu",
               f"{sim_py}:785", err2, launch_r),
        "K3": ("block_step", src, f"{sim_py}:1276", err3, launch_r),
        "K4S": ("block_step_series", src, f"{sim_py}:1692", err_s,
                launch_a),
        "K4R": ("series_sum", src, f"{sim_py}:1703", err_r, launch_a),
        "K4T": ("block_step_trace", src, f"{sim_py}:844", err_t, launch_c),
        "K6": ("block_step_site", src, "tmhpvsim_tpu/models/solar.py:434",
               err6, launch_b),
        "K7R": ("sampler_windows_regime", "tmhpvsim_torch/csrc/windows.cu",
                "tmhpvsim_tpu/models/markov_hourly.py:70", err7r, launch_f),
        "K7T": ("block_step_fleet", src, f"{sim_py}:1228", err7t,
                launch_h["H0"]),
        "K8": ("block_step_tel", src, "tmhpvsim_tpu/obs/telemetry.py:110",
               err8, launch_h["H8"]),
        "K9": ("block_step_analytics", src,
               "tmhpvsim_tpu/obs/analytics.py:223", err9, launch_h["H9"]),
        "K89": ("block_step_tel_analytics", src, f"{sim_py}:1524", err89,
                launch_f),
        "KC": ("chainwise_collapse", src,
               "tmhpvsim_tpu/obs/analytics.py:311", err_c, launch_f),
    }
    rows = []
    # one PyTorch call computes series_sum's function: part.sum(1), timed
    # in turns with it
    # and the collapse's: a sum, a minimum and a maximum per row set
    library = {"K4R": timing.pop("K4R_library"),
               "KC": timing.pop("KC_library")}
    k4r_dev, k4r_dev_lib = timing.pop("K4R_device")
    kc_dev, kc_dev_lib = timing.pop("KC_device")
    for key, (name, source, replaces, err, launches) in rows_of.items():
        ms, plain, bms, by, ibms = timing[key]
        # the observers' sums are checked relative to float64: both errors
        rel, err = err if isinstance(err, tuple) else (None, err)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bms, "bound_by": by, "issue_bound_ms": ibms,
                     "library_ms": library.get(key),
                     **({} if rel is None else {"max_rel_err": rel})})
    # the observers' two launches on path F: the acc producer and the
    # observer fold (the fold's times on paths F-L's and F-H's arrays
    # beside it)
    ms, plain, bms, by, ibms = timing["K89P"]
    rows.append({"name": "block_step_prod_site", "route": "cuda",
                 "source": src, "replaces": f"{sim_py}:1436",
                 "launches": launch_f["block_step_prod_site"],
                 "launches_h9": launch_h["H9"]["block_step_prod_site"],
                 "max_abs_err": err89[1], "ms": ms, "plain_ms": plain,
                 "bound_ms": bms, "bound_by": by, "issue_bound_ms": ibms,
                 "library_ms": None})
    ms, plain, bms, by, ibms = timing["KF"]
    rows.append({"name": "obs_fold", "route": "cuda",
                 "source": "tmhpvsim_torch/csrc/wide_fold.cu",
                 "replaces": "tmhpvsim_tpu/obs/analytics.py:223",
                 "launches": launch_f["obs_fold"],
                 "launches_h9": launch_h["H9"]["obs_fold"],
                 "launches_fl": launch_fl["obs_fold"],
                 "launches_fh": launch_fh["obs_fold"],
                 "max_abs_err": err89[1], "max_rel_err": err89[0],
                 "ms": ms, "plain_ms": plain, "bound_ms": bms,
                 "bound_by": by, "issue_bound_ms": ibms, "library_ms": None,
                 "ms_fl": timing["K89LF"][0], "ms_fh": timing_k12["K12FF"][0],
                 "regs": fold_shape["regs"],
                 "ctas_per_sm": fold_shape["ctas_per_sm"],
                 "groups_per_cta": fold_shape["groups_per_cta"],
                 "ctas": fold_shape["ctas"]})
    # series_sum: per call as every row; device time from CUDA graphs too
    next(r for r in rows if r["name"] == "series_sum").update(
        device_ms=k4r_dev, library_device_ms=k4r_dev_lib)
    next(r for r in rows if r["name"] == "chainwise_collapse").update(
        device_ms=kc_dev, library_device_ms=kc_dev_lib)
    # the K4 merges: the fold (path R-W's launch; path F-W's, with both
    # observers, beside it) and the series (path A-W's)
    wsrc = "tmhpvsim_torch/csrc/wide_fold.cu"
    for key, name, replaces, err, launches in (
            ("K4MF", "wide_fold", f"{sim_py}:958", err4mf, launch_rw),
            ("K4MF89", "wide_fold_analytics",
             "tmhpvsim_tpu/obs/analytics.py:337", err4mo, launch_fw),
            ("K4MS", "wide_series", f"{sim_py}:983", err4ms, launch_aw)):
        ms, plain, bms, by, ibms, lib = timing_wide[key]
        rel, err = err if isinstance(err, tuple) else (None, err)
        rows.append({"name": name, "route": "cuda", "source": wsrc,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bms, "bound_by": by,
                     "issue_bound_ms": ibms, "library_ms": lib,
                     **({} if rel is None else {"max_rel_err": rel})})
    # K10: timed at 16 rows; launches on path S (path S-c's beside them)
    # K10: the whole wrapper (producer, fold, collapse) timed at 1, 4 and
    # 16 rows; launches on path S (path S-c's beside them); the producer
    # and the fold on their own beside it, and the fold's own row
    def k10_keys(k):
        return {"ms_producer": k["ms_producer"],
                "bound_ms_producer": k["bound_ms_producer"],
                "bound_by_producer": k["bound_by_producer"],
                "issue_bound_ms_producer": k["issue_bound_ms_producer"],
                "producer_max_abs_err": k["producer_max_abs_err"],
                "ms_fold": k["ms_fold"][K10_B]}

    rows.append({"name": "block_step_scenario", "route": "cuda",
                 "source": src, "replaces": f"{sim_py}:1871",
                 "launches": launch_s["block_step_scenario"],
                 "launches_continuous": launch_sc["block_step_scenario"],
                 "max_abs_err": max(k10["err"], err10f),
                 "ms": k10["ms"][K10_B], "ms_1_row": k10["ms"][1],
                 "ms_4_rows": k10["ms"][4], "plain_ms": k10["plain_ms"],
                 "bound_ms": k10["bound_ms"], "bound_by": k10["bound_by"],
                 "issue_bound_ms": k10["issue_bound_ms"],
                 "library_ms": None, **k10_keys(k10)})
    rows.append({"name": "scenario_fold", "route": "cuda", "source": src,
                 "replaces": f"{sim_py}:1890",
                 "launches": launch_s["scenario_fold"],
                 "launches_continuous": launch_sc["scenario_fold"],
                 "launches_bf16": launch_sh["scenario_fold"],
                 "max_abs_err": max(k10["fold_max_abs_err"],
                                    k12s["fold_max_abs_err"]),
                 "ms": k10["ms_fold"][K10_B],
                 "ms_1_row": k10["ms_fold"][1],
                 "ms_4_rows": k10["ms_fold"][4],
                 "ms_bf16_producer_output": k12s["ms_fold"][K10_B],
                 "plain_ms": k10["plain_ms_fold"],
                 "bound_ms": k10["bound_ms_fold"],
                 "bound_by": k10["bound_by_fold"],
                 "issue_bound_ms": k10["issue_bound_ms_fold"],
                 "library_ms": None})
    # K6s: path B-L's launch (strided, table set), the exact set's beside
    ms, plain, bms, by, ibms = timing["K6s"]
    ms_x, plain_x, bms_x, _, ibms_x = timing["K6sX"]
    rows.append({"name": "block_step_strided_table", "route": "cuda",
                 "source": src,
                 "replaces": "tmhpvsim_tpu/models/solar.py:587",
                 "launches": launch_bl["block_step_strided_table"],
                 "launches_gl": launch_gl["block_step_strided_table"],
                 "max_abs_err": err6s, "ms": ms, "plain_ms": plain,
                 "bound_ms": bms, "bound_by": by,
                 "issue_bound_ms": ibms, "library_ms": None,
                 "ms_exact_set": ms_x, "plain_ms_exact_set": plain_x,
                 "bound_ms_exact_set": bms_x,
                 "issue_bound_ms_exact_set": ibms_x})
    # path F-L's K8+K9: the strided table-set producer and the observer
    # fold (the pair, then the producer on its own)
    ms, plain, bms, by, ibms = timing["K89L"]
    rel, err = err89l
    rows.append({"name": "block_step_strided_table+tel_analytics",
                 "route": "cuda", "source": src,
                 "replaces": f"{sim_py}:1524",
                 "launches": launch_fl["block_step_tel_analytics"],
                 "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                 "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                 "issue_bound_ms": ibms,
                 "library_ms": None, "ms_producer": timing["K89LP"][0],
                 "ms_fold": timing["K89LF"][0]})
    ms, plain, bms, by, ibms = timing["K89LP"]
    rows.append({"name": "block_step_prod_strided_table", "route": "cuda",
                 "source": "tmhpvsim_torch/csrc/block_step_table.cu",
                 "replaces": f"{sim_py}:1436",
                 "launches": launch_fl["block_step_prod_strided_table"],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": bms, "bound_by": by, "issue_bound_ms": ibms,
                 "library_ms": None})
    # K11: path R-T's launch (the shared step with the table set), and
    # each function on its own (table_eval)
    ms, plain, bms, by, ibms = timing["K11"]
    rows.append({"name": "block_step_table", "route": "cuda",
                 "source": "tmhpvsim_torch/csrc/tables.cuh",
                 "replaces": "tmhpvsim_tpu/models/tables.py:354",
                 "launches": launch_rt["block_step_table"],
                 "max_abs_err": err11, "ms": ms,
                 "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                 "issue_bound_ms": ibms,
                 "library_ms": None, "functions": k11_fn})
    # K12: each bf16 instantiation a path launches, with that path's count
    bsrc = "tmhpvsim_torch/csrc/block_step_bf16.cu"
    for key, name, source, replaces, launches, path in (
            ("K12", "block_step_bf16", bsrc, f"{sim_py}:1129", launch_rh,
             "R-H"),
            ("K12S", "block_step_series_bf16", bsrc, f"{sim_py}:1600",
             launch_ah, "A-H"),
            ("K12T", "block_step_trace_bf16", bsrc, f"{sim_py}:911",
             launch_ch, "C-H"),
            ("K12B", "block_step_site_bf16", bsrc, f"{sim_py}:830",
             launch_bh, "B-H"),
            ("K12BL", "block_step_strided_table_bf16",
             "tmhpvsim_torch/csrc/block_step_bf16_table.cu", f"{sim_py}:765",
             launch_bhl, "B-HL"),
            ("K12F", "block_step_prod_site_bf16+tel_analytics", bsrc,
             f"{sim_py}:1218", launch_fh, "F-H"),
            ("K12FP", "block_step_prod_site_bf16", bsrc, f"{sim_py}:1436",
             launch_fh, "F-H")):
        ms, plain, bms, by, ibms = timing_k12[key]
        counter = name.split("+")[0]
        e12 = err12["K12F" if key == "K12FP" else key]
        rel, err = e12 if isinstance(e12, tuple) else (None, e12)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[counter],
                     "path": path, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                     "issue_bound_ms": ibms,
                     "library_ms": None,
                     **({} if rel is None else {"max_rel_err": rel})})
    rows[-7].update(launches_gh=launch_gh["block_step_bf16"],
                    ms_0000=timing_k12["K12_0000"])
    rows[-2].update(ms_producer=timing_k12["K12FP"][0],
                    ms_fold=timing_k12["K12FF"][0],
                    launches_pairs=launch_fh["block_step_tel_analytics"])
    # K13: the Philox bits launch (timed on 2**26 words; its launches on
    # path R-P are init_state's renewal uniforms), the rbg windows and the
    # rbg block step path R-P launches
    rows.append({"name": "philox_fill", "route": "cuda",
                 "source": "tmhpvsim_torch/csrc/philox.cu",
                 "replaces": f"{sim_py}:333",
                 "launches": launch_rp["philox_fill"], "path": "R-P",
                 "max_abs_err": k13["err"], "ms": k13["ms"],
                 "plain_ms": k13["plain_ms"], "bound_ms": k13["bound_ms"],
                 "bound_by": k13["bound_by"],
                 "issue_bound_ms": k13["issue_bound_ms"], "library_ms": None,
                 "words": K13_WORDS, "ms_uniform": k13["ms_uniform"],
                 "bound_ms_uniform": k13["bound_ms_uniform"],
                 "torch_rand_ms": k13["torch_rand_ms"]})
    for key, name, source, replaces, err in (
            ("K13W", "sampler_windows_rbg", "tmhpvsim_torch/csrc/windows.cu",
             f"{sim_py}:785", err13w),
            ("K13S", "block_step_rbg",
             "tmhpvsim_torch/csrc/block_step_rbg.cu", f"{sim_py}:1130",
             err13)):
        ms, plain, bms, by, ibms = timing_k13[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launch_rp[name],
                     "path": "R-P", "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                     "issue_bound_ms": ibms,
                     "library_ms": None})
    # the rbg instantiations no path launches (phase_k13_rest)
    rows[-1].update(max_abs_err_other_instantiations=err13r,
                    max_rel_err_k89_rbg=rel13r)
    # K12 in K10: timed at 16 rows; launches on path S-H
    rows.append({"name": "block_step_scenario_bf16", "route": "cuda",
                 "source": "tmhpvsim_torch/csrc/block_step_bf16.cu",
                 "replaces": f"{sim_py}:1887",
                 "launches": launch_sh["block_step_scenario_bf16"],
                 "path": "S-H", "max_abs_err": k12s["err"],
                 "ms": k12s["ms"][K10_B], "ms_1_row": k12s["ms"][1],
                 "ms_4_rows": k12s["ms"][4], "plain_ms": k12s["plain_ms"],
                 "bound_ms": k12s["bound_ms"], "bound_by": k12s["bound_by"],
                 "issue_bound_ms": k12s["issue_bound_ms"],
                 "library_ms": None, **k10_keys(k12s)})
    # K14: the derivations launch (timed on init_state's batched 5-way
    # split of 65536 chains), the unsafe_rbg windows and block step; their
    # launches on path R-U
    ms, plain, bms, by, ibms = timing_k14["K14D"]
    rows.append({"name": "philox_derive", "route": "cuda",
                 "source": "tmhpvsim_torch/csrc/philox.cu",
                 "replaces": f"{sim_py}:510",
                 "launches": launch_ru["philox_derive"], "path": "R-U",
                 "max_abs_err": err14d, "ms": ms, "plain_ms": plain,
                 "bound_ms": bms, "bound_by": by,
                 "issue_bound_ms": ibms, "library_ms": None})
    for key, name, source, replaces, err in (
            ("K14W", "sampler_windows_urbg",
             "tmhpvsim_torch/csrc/windows.cu", f"{sim_py}:798", err14w),
            ("K14S", "block_step_urbg",
             "tmhpvsim_torch/csrc/block_step_urbg.cu", f"{sim_py}:1130",
             err14)):
        ms, plain, bms, by, ibms = timing_k14[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launch_ru[name],
                     "path": "R-U", "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                     "issue_bound_ms": ibms,
                     "library_ms": None})
    rows[-1].update(max_abs_err_other_instantiations=err14r,
                    max_rel_err_k89_urbg=rel14r,
                    r_u_median_s=float(np.median(walls_ru["R-U"])),
                    r_median_s=float(np.median(walls_ru["R"])))
    # K15: the metersim producer's block (timed on a 600-second block);
    # its launches on path M (SP's and SP-T's beside them)
    rows.append({"name": "meter_block", "route": "cuda",
                 "source": "tmhpvsim_torch/csrc/meter.cu",
                 "replaces": "tmhpvsim_tpu/apps/metersim.py:84",
                 "launches": launch_m["meter_block"], "path": "M",
                 "launches_sp": launch_sp["meter_block"],
                 "launches_spt": launch_spt["meter_block"],
                 "max_abs_err": k15["err"], "ms": k15["ms"],
                 "synced_ms": k15["synced_ms"],
                 "device_ms": k15["device_ms"],
                 "plain_ms": k15["plain_ms"], "bound_ms": k15["bound_ms"],
                 "bound_by": k15["bound_by"],
                 "issue_bound_ms": k15["issue_bound_ms"],
                 "library_ms": None, "torch_rand_ms": k15["torch_rand_ms"],
                 "path_m_wall_s": wall_m,
                 "path_m_wall_ms_per_launch":
                     wall_m / launch_m["meter_block"] * 1e3,
                 "path_sp_wall_s": wall_sp})
    add_shapes(rows, fold_shape)
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"phase_s": PHASE_S}))
    print(json.dumps({"collectives": collective_rows(sharded)}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--sharded-rank":
        sys.exit(sharded_rank(int(sys.argv[2]), sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--ck-rank":
        sys.exit(ck_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
