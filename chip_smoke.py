#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (mcbrat3d_tpu_torch) on one GPU.

    python3 chip_smoke.py [--only PHASE,...]

Phases, each asserting; any failure exits non-zero. The kernel-against-
plain phases 2-2j run in COMPARE_WORKERS processes started together once
the kernels are built (their plain steps are host-bound), each printed
when all have ended; the rest run one after another in this process,
alone on the card:

1. print the card (nvidia-smi name and power limit) and build the CUDA
   record, column, separable and tiled kernels (the record and column
   libraries with their walk kernels) and the probe kernels from
   mcbrat3d_tpu_torch/csrc (one nvcc each, started together), reporting
   the build times and ptxas registers/spills;
2. flux kernel against its plain PyTorch version on the card, same seeds,
   both on run_batch's refill schedule (the card's resident slots):
   the step cloud at 2^20 photons for macro_factor 0 and 8, both tally
   layouts, plus the tabulated-phase configuration the namelist deck runs
   and a reflecting surface without roulette; then, at 2^18 photons, the
   random-azimuth, flux and spotlight sources and the step cloud with gas
   (2 components) and with gas and Rayleigh (3), analytic and tabulated
   (10,001 steps), roulette on and off (albedo 0.3), and a 256 x 1 x 54
   cut of bench.py:269-303's radar_scale with the 3D tally (absorbed
   cells in global memory);
   domain-mean R/T/A within 2e-3 and per-pixel fluxes within 5 sigma;
2g. the emission refill and the LW pre-credits of the record kernel
   against its plain version, same seeds, on bench.py:173-218's scene at
   2^18 photons: macro 8 and 0, analytic and 10,001-step rows, albedo
   0.05 and 0, roulette on and off (eight cases); equal photons, real
   collisions within 1e-4, R/T within 2e-3, per-pixel fluxes and per-cell
   net absorption within 5 sigma;
2b. radiance kernel against its plain version, same seeds, on the step
   cloud with the radiance deck's 6 directions, 16,384 photons per case
   (4,096 lanes x 4; the plain step runs 50-80 s per 65,536): exact
   estimator with
   analytic HG, Iwabuchi roulette with the hybrid table, the original
   table, a contribution cap low enough to clip, and that cap on the
   tabulated 3-component step cloud with the random-azimuth source (one
   excess slot per component); per-direction
   domain-mean gap, per-pixel gap and z < 5, kernel reruns within 1e-5;
   plus an image too large for shared memory (global-atomic tally) and
   LW radiance from the per-voxel emission source (the fresh hold, 4
   directions);
2h. the column kernel's gas template and local estimate against its
   plain version on the card, same seeds, on the 128 x 128 x 64 broken
   cloud: the gas template (a uniform pure absorber under the cloud) as a
   flux run at 2^16 photons, analytic HG and the tabulated row with the 3D
   tally; the local estimate at 2^13 photons (4,096 lanes x 2; the plain
   walk takes ~25-35 s per case): the hybrid row with roulette and
   bench.py's 16 directions, the gas template with analytic HG and no
   roulette, and the original row with tabulated scattering, 8 directions
   (every octant of azimuth, both fast axes; the gas case has one at the
   floor mu 0.4); equal photons, lane-steps,
   events and walk iterations,
   fluxes, profile and per-direction image totals within 1e-5 relative,
   every pixel with signal within 2e-3; the flux cases on the refill
   schedule (two photons a slot), with equal launches;
2i. the column kernel's emission refill and pre-credits (K3-b) and its
   per-pixel albedo (K3-c) against its plain version on the card, same
   seeds, at full width (128 x 128 x 64): path A's Landsat-scale 10 um case
   at macro 8 and 0 with lw_mode and at macro 8 without (2^16 photons,
   profile and 3D tally), path B's 16 x 16 per-pixel surface as a flux run
   (2^16 photons) and with the 16 directions of run/landsat_radiance.nml
   (4,096 photons); equal photons, lane-steps, events and walk iterations,
   per-column fluxes and net absorption within 1e-5 of the photons per
   column, the profile within 5e-4 of its largest level, image totals
   within 1e-5 and pixels with signal within 2e-3; the flux cases on the
   refill schedule (two photons a slot), with equal launches;
2j. the record kernel's surfaces (K1-d) against its plain version on the
   card, same seeds: the uniform RPV surface (rho0 0.25, k 0.8, theta
   -0.15) on the step cloud, on the 3-component step cloud and in lw_mode
   with bench.py:173-218's emission source, the per-pixel checker (8 x 1,
   albedos 0.05 / 0.65) on the step cloud as a flux run and with the
   radiance deck's 6 directions (K2), and the 4,096-column cap
   (broken_cloud_scene(nx=64, ny=64, nz=7) over a 64 x 64 albedo grid),
   2^18 photons (the radiance case 16,384); each launch on its surface
   branch; K1's tolerances (R/T/A 2e-3, pixels and cells z < 5, real
   collisions 1e-4, radiance 5e-3 and 0.02);
2k. each walk kernel alone against its plain twin on one captured event
   buffer: two launches of 4,096 lanes x 128 steps (with their walks, as
   on the main path), then the second launch's queue fed to the walk
   kernel and to its twin: the column walk on bench.py:547-573's 16
   directions and on 2h's gas case (analytic HG, exact, 8 directions), the
   record walk on the radiance deck's 6 directions and on 64; equal walk
   (march) iterations, no cut, each direction's image total within 1e-5
   and each pixel within 1e-4 of its direction's largest; prints the
   queue's fill against its capacity, the walk's ms (median of 5), its
   bound and the twin's ms;
2c. analytic radiance anchors: a thin isotropic slab (I = tau / (4 pi mu))
   and a clear atmosphere over a Lambertian surface (I = albedo / pi per
   unit incident flux on the horizontal); and the emission anchors: an
   isothermal black box radiates Planck's B(T) upward (within 5%), and
   the isothermal pre-credit balance;
2d. column kernel against its plain version, same seeds, both on the
   refill schedule (the first case on the card's resident slots, the
   others on half the photons' count, two photons a slot), on the
   128 x 128 x 64 broken cloud at 2^17 photons (the plain step takes
   ~6 ms a step; the two macro_factor 0 cases, whose null-collision tails
   are long, run 2^16): macro_factor 8 with analytic HG and the tabulated
   row, each with and without the 3D tally, macro_factor 0 with HG and no
   3D tally
   and with the table and the 3D tally, plus a table too large for shared
   memory, the random-azimuth and flux sources, and roulette off;
   domain-mean R/T/A within 2e-3, per-column fluxes within 1e-5 and the
   z profile within 5e-4 of its peak (float32 atomic order: same paths),
   per-pixel fluxes within 5 sigma, kernel reruns within 1e-5, equal
   photons, launches, lane-steps and n_bad (2h and 2i hold the gas
   template, the emission with lw and the per-pixel albedo the same way);
2e. separable-template kernel against its plain version, same seeds, on
   the LW flagship scene at 16 x 16 x 150 (macro 8 and 0), its two-slice
   cut 132 x 132 x 60 (17,424 columns) and the deck's 325 x 325 x 150
   with the 9,001-step row (72 KB, which the occupancy rule reads from
   global memory, as on the two-slice cut): separable emission with LW
   pre-credits (roulette on and off), the directional, random-azimuth and
   flux sources, analytic HG and the tabulated row in shared memory and
   from global memory; 2^17 photons on the refill schedule, two a slot;
   equal photons, launches, n_bad and lane-steps, per-column fluxes and
   net absorption within 1e-5 and the z profile within 5e-4 of its
   largest level;
2f. tiled dense-domain kernel against its plain twin, same seeds, whole
   runs of 2^16 photons on the bench's 128 x 128 x 64 dense scene: analytic
   HG, per-cell ssa, the 10,001-step row in shared memory (past the 48 KB
   opt-in), from global memory (a zero budget) and a 20,001-step row past
   the budget, 2 and 3 components (gas, Rayleigh), an empty half (the skip
   chain), the random-azimuth, flux and spotlight sources, roulette off,
   each on the refill schedule (2^15 slots, at most 8 launches of 128
   steps under the relaunch loop: the kernel starts the photons), and the
   four sources also on the sorted schedule (a pool of 2^15 slots, the JAX
   package's pool / 64 drain floor, then a tail of 4 passes of 64 steps in
   which photons follow their paths across tiles); equal photons, passes
   or launches, tail passes, n_bad, lane-steps and real collisions,
   per-column fluxes and absorption within 1e-5 (of the photons per
   column, or of a hotter column's value) and R/T/A within 1e-6;
3. the main path through the command line: mkdomain step_cloud (512
   Legendre moments), then run/step_cloud_mono.nml (16 x 1,048,576
   photons, 3D absorption tally)
   on cuda; n_bad == 0, R/T/A within 4.5 sigma of the frozen step-cloud
   goldens, output files written, the kernel launched and the plain step
   never run;
3b. the radiance deck through the command line on cuda:
   run/step_cloud_radiance.nml (8 x 262,144 photons, 6 directions) with a
   netCDF output added; n_bad == 0, radiance file and netCDF written, the
   radiance kernel launched and the plain step never run, R/T/A within
   4.5 sigma of the goldens, domain-mean radiances within 4.5 combined
   sigma of values frozen from the JAX package; then
   run/step_cloud_radiance_648.nml at 2 x 32,768 photons (11 chunked
   passes): image (32, 1, 648), n_bad == 0;
3c. the Landsat-scale deck through the command line: mkdomain broken_cloud,
   then run/landsat_scale.nml (16 x 1,048,576 photons, absorption profile)
   on cuda; n_bad == 0, flux and netCDF files written, the column kernel
   launched and no plain step run, R/T/A and the profile's column integral
   within 4.5 combined sigma of values frozen from the JAX package;
3d. the broadband-LW flagship through the command line: the port's
   write_lw_flagship_inputs writes common325.nc and ssp_thermal.nc (325 x
   325 x 150, 64 bins) into a temporary directory, then
   run/I3RC_bench_LW_325.nml (16 x 4,194,304 photons) on cuda: 67,108,864
   photons, n_bad == 0, the separable kernel launched and no record,
   column or plain step, flux and netCDF files written; then the same
   generator's 48 x 48 x 150 deck with 8 bins (16 x 131,072 photons):
   domain-mean up, down and net absorbed flux within 4.5 combined sigma of
   values frozen from the JAX package;
3e. the dense MODIS-class deck through the command line: the port's
   write_domain of dense_cloud_scene() (surface albedo 0.2) as
   DenseCloud.dom in a temporary directory, then run/dense_cloud_mono.nml
   (16 x 2,097,152 photons) on cuda: n_bad <= 16 (photons reflected at
   the reference's floor mu = 1e-6, ~1 per deck), flux and netCDF files
   written, the tiled kernel launched once per reported launch (pass) and
   no record,
   column, separable or plain step; then the deck cut to 16 x 262,144
   photons (nLanes 32,768): R/T/A within 4.5 combined sigma of values
   frozen from the JAX package's CLI on the CPU;
3f. the 3-component deck through the command line: the port's write_domain
   of step_cloud_multi_scene(analytic=False) (gas + cloud + Rayleigh with
   its true phase, so three tabulated rows) as StepCloudMulti3.dom, then
   run/step_cloud_multi3_mono.nml (16 x 1,048,576 photons, 3D tally) on
   cuda: n_bad == 0, flux and netCDF files written, only the record kernel
   launched and no plain step, R/T/A within 4.5 combined sigma of values
   frozen from the JAX package's CLI on the CPU;
3g. the non-separable broadband-LW deck through the command line: the
   port's tools/lw_inputs.py writes common.nc and ssp_thermal.nc (32 x 32
   x 24, 64 bins, 3D temperatures) into a temporary directory, then
   run/broadband_lw.nml (8 x 1,048,576 photons, 3D tally) on cuda: every
   bin built generically with the per-voxel emission source, n_bad == 0,
   flux and netCDF files written, only the record kernel launched, every
   launch with the emission refill, no plain step; the domain-mean fluxes
   and the absorption profile within 4.5 combined sigma of values frozen
   from the JAX package's CLI on the CPU; prints the setup, the later
   bins' host builds and the rest (transport);
3h. the Landsat-scale radiance deck through the command line: mkdomain
   broken_cloud, then run/landsat_radiance.nml (8 x 262,144 photons, 16
   directions) on cuda; n_bad == 0, the column kernel's local estimate
   launched, no record kernel and no plain step, the netCDF image
   (16, 128, 128), R/T/A, the profile's column integral and every
   direction's domain-mean radiance within 4.5 combined sigma of values
   frozen from the JAX package; prints the wall clock split into setup
   and output, and transport;
3i. the gas template at full width: broken_cloud_scene() plus a uniform
   pure absorber through run_batch on cuda, a flux run (8 x 2^20 photons,
   albedo 0.2, profile) and a radiance run with bench.py's 16 directions
   (4 x 2^19 photons), the column kernel only and no plain step, n_bad ==
   0, R/T/A and the radiances within 4.5 combined sigma of values frozen
   from the JAX package; the same cut to 32 x 32 x 64 with the 8 distinct
   directions (8 x 2^19 photons) within 4.5 combined sigma of both JAX
   estimators, XLA and the column kernel; then the gas flux path's times
   (2^20 photons: the A/B of the refill schedule and JAX's geometry, the
   occupancy, CUDA-event ms a launch, busy share, kernel and plain ms of
   the refill schedule's first launch);
3j. path A through run_simulation: broken_cloud_scene(ssa=0.5) at full
   width with the lapse-rate temperatures T(z) = 288 K - 6.5 K/km, 10 um,
   the per-voxel emission source, albedo 0.05, lw_mode, profile and 3D
   field, 8 x 2^20 photons: the column kernel alone, the emission refill on
   every launch, no plain step, n_bad == 0, the net 3D field's marginals
   equal to the column and profile tallies, up, down, net absorption and
   the 64-level net profile within 4.5 combined sigma of values frozen
   from the JAX package's XLA path (tools/landsat_lw_px_reference.py);
   the 64 x 32 x 32 cut (8 x 2^17) against the JAX package's column kernel
   in interpret mode (up, down, net absorption);
3k. path B through run_simulation: broken_cloud_scene() over a 16 x 16
   per-pixel Lambertian surface (albedos 0.1-0.8), beam mu0 0.5, a flux
   run (8 x 2^20 photons, profile) and a radiance run with the 16
   directions of run/landsat_radiance.nml (4 x 2^19): the column kernel
   alone, the per-pixel albedo on every launch, no plain step, n_bad == 0,
   R/T/A, the profile and the radiances within 4.5 combined sigma of
   values frozen from the JAX package's XLA path; the cut's flux run
   against its column kernel in interpret mode; then the per-pixel flux
   path's times, as 3i's;
3l. path C through run_simulation: the step cloud of
   run/step_cloud_mono.nml over the uniform RPV surface, 16 x 2^20
   photons, iseed 10, flux and column absorption: the record kernel alone
   with the RPV branch on every launch, no plain step, n_bad == 0, R/T/A
   and the 32 columns of the up flux within 4.5 combined sigma of values
   frozen from the JAX package's XLA path
   (tools/record_surface_reference.py); then the RPV flux path (2^20
   photons) as 4f;
3m. path D through run_simulation: the step cloud over the 8 x 1 albedo
   mosaic, a flux run (16 x 2^20 photons) and a radiance run with the
   radiance deck's 6 directions (8 x 262,144): the record kernel alone
   with the per-pixel branch on every launch (and the local estimate on
   every radiance launch), no plain step, n_bad == 0, R/T/A and the up
   flux's columns or the 6 radiances within 4.5 combined sigma of values
   frozen from the JAX package's XLA path; then the per-pixel flux path
   as 3l's;
3n. the broadband-SW deck through the command line: the port's
   tools/sw_inputs.py writes common_sw.nc, ssp_solar.nc and solar.nc
   (bench.py:576-650's scene: 16 bins at 0.4-1.0 um, 32 x 32 x 32 cells,
   cloud water and Rayleigh, 9,001 CDF steps) into a temporary directory,
   then run/broadband_sw.nml (16 x 262,144 photons) on cuda: every bin on
   the record kernel, no batch on the wave kernel, no plain step, n_bad ==
   0, flux and netCDF files written, the incident flux equal to the JAX
   package's and the domain-mean fluxes within 4.5 combined sigma of its
   frozen values (tools/wave_reference.py sw); prints the wall clock split
   into setup, the later bins' host builds and the rest, and K1's
   launches; then the deck's bin 0 (2 components, 9,001-step phase rows)
   built as run_broadband builds it, its first refill launch of 2^18
   photons K1 against its plain twin;
3o. the wave kernel (plain PyTorch, the JAX package's XLA path) on cuda:
   one 2^20-photon batch of run/step_cloud_mono.nml's step cloud on it and
   on K1 through run_batch (ms a wave step, photons/s of each); then
   through the command line the deck with usePallas = 'off' (as many
   batches of 2^20 as fit in about 60 s), the step cloud with
   useRayTracing and numRecScatOrd = 3 (2 x 2^18 photons, its auxhist01
   file) and run/step_cloud_radiance.nml with one direction at mu 0.1 (2
   x 16,384), each deck's wave steps and ms a step: no kernel launched,
   every batch on the wave kernel, n_bad == 0, R/T/A (and the fluxes by order, the radiance) within 4.5 combined
   sigma of values frozen from the JAX package's XLA path
   (tools/wave_reference.py step, rt, rad);
4. the flux headline (macro_factor 16, 2^16 lanes x 1024 photons, flux
   tallies only, through run_batch_record_tallies): the A/B of the refill
   schedule (run_batch's) and JAX's geometry in turns (refill, JAX, JAX,
   refill), each with photons/s, launches a batch, kernel and wall ms a
   launch from CUDA events and busy share; the refill schedule at 128 to
   8,192 steps a launch and at 0.25 to 2 x the resident slots; the
   occupancy record (blocks an SM, registers, spills); the first refill
   launch of a 2^20-photon batch (the deck's) on the resident slots,
   kernel against plain twin (equal photons, steps, lane-steps and n_bad,
   columns within 1e-5 of the photons a column) with both ms; 4f, 4g, 3l
   and 3m do the same on theirs, without the sweeps;
4b. a radiance headline: one step-cloud batch of the radiance deck at 6
   and at 64 directions (32 rows of 128 lanes), kernel and plain
   photons/s and ms per launch (the kernel's also from CUDA events, the
   transport with its walk and the walk alone), the local-estimate events
   and march iterations per photon (counted by the kernels), and the
   kernel once more at 512 rows;
4c. the Landsat headline (bench.py:497-545: the broken cloud with analytic
   HG, macro_factor 8, 2^20 photons, no 3D tally): the A/B of the refill
   schedule (run_batch's) and JAX's geometry in turns (refill, JAX, JAX,
   refill), each with photons/s, launches a batch, kernel and wall ms a
   launch from CUDA events, busy share and live lane-steps a launch; the
   refill schedule at 128 to 8,192 steps a launch and at 0.25 to 2 x the
   resident slots; the occupancy record (blocks an SM, registers,
   spills); kernel and plain ms of the refill schedule's first launch on
   the resident slots, the kernel held against its plain twin there
   (equal photons, lane-steps and n_bad, the 2d or 2e tolerances; 3i, 3k
   and 4i do the same on theirs);
4d. the separable headline (bench.py:454-494: the 325 x 325 x 150
   flagship scene, compact, macro 8, 201 CDF steps, 10 um, separable
   emission, LW, 2^24 photons): as 4c;
4e. the dense headline (bench.py:306-342: 128 x 128 x 64, 2^18-slot pool,
   2,097,152 photons): the A/B of the tiled kernel's two schedules in
   turns (refill, sorted, sorted, refill): the refill schedule through
   run_batch (its default) and the sorted passes with the tail; for each,
   photons/s, launches (passes) per batch, kernel and wall ms per launch,
   live lane-steps per photon and the card's busy share (kernel time from
   CUDA events over the batch's wall time); the refill schedule at 128 to
   8,192 steps a launch; the sorted passes with the JAX
   package's pool / 64 drain floor alone; and kernel and plain ms of the
   refill schedule's first launch;
4f. the 3-component headline (bench.py:150-170: gas + cloud + Rayleigh,
   analytic, macro_factor 8, 2^16 lanes x 256 photons, 3D tally): as 4
   without the sweeps (the A/B, the occupancy, the first refill launch
   kernel against twin and its bound, charging the component choice per
   real collision);
4g. the LW emission headline (bench.py:173-218: 32 x 32 x 24 random
   cloud + gas, per-voxel emission, analytic, macro_factor 8, albedo 0.05,
   lw_mode, 2^16 lanes x 256 photons): as 4f; then bench.py:269-303's
   radar_scale (640 x 1 x 54, the 3D tally, 2^16 lanes x 64 photons): the
   A/B and the occupancy; and the occupancy of the 3D-tally launches
   (blocks an SM), with the flux columns alone in shared memory and with
   the whole tally there;
4h. the Landsat radiance headline (bench.py:547-573: the broken cloud with
   analytic HG and the hybrid forward row, macro_factor 8, 16 directions,
   2^13 lanes x 256 photons, through run_batch): column-kernel local
   estimate ms per launch from CUDA events (the transport with its walk,
   and the walk alone), launches per batch, the card's
   busy share, photons/s, live lane-steps, events and walk iterations per
   photon, and plain ms of one launch;
4i. path A's configuration, one batch through run_batch (2^20 photons):
   the column kernel with the emission refill, its times as 3i's, the
   atmospheric births (counted by the kernel) and the bound (the refill's
   operations per birth counted from csrc/col_kernel.cu);
5. the gather and tally probes P1-P5: ``python -m
   mcbrat3d_tpu_torch.tools.probes all`` (every variant at its TPU probe's
   shape through its kernel), then each variant's kernel against its plain
   twin (equal bit for bit), its ns per iteration, bytes and the PyTorch
   call's time, all device time (CUDA graph replays).

Prints the card line, then one JSON line describing each kernel (with its
time, the least time the card could take for the same work and what bounds
that), then the final JSON status line. ``--only`` runs a subset of the phases (1 always
runs) and prints no result lines; with ``--out-json PATH`` (how a compare
worker is started) it writes the phases' results to PATH.
"""

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (ssa, mu0) = (0.99, 0.5) row of tests/test_golden.py: frozen from the
# native C++ tracer at 40M photons (one-sigma ~8e-5).
GOLDEN_RTA = (0.47656, 0.32485, 0.19860)
RTA_TOL_KERNEL_VS_PLAIN = 2e-3
# Real collisions of K1 against its plain step, relative: equal on all
# fifteen cases of phase 2 on the H100; the limit leaves room for a few
# photons parted by float32 rounding.
REAL_TOL_KERNEL_VS_PLAIN = 1e-4
# Radiance kernel vs plain, same seeds and so the same photon paths: the
# per-direction domain means differ by float rounding (~1e-6) unless a
# photon's path diverges after a 1-ulp difference in a transcendental (the
# flux phase shows such photons at ~3e-5 of all). Radiance is heavy
# tailed: the few diverged photons among 65,536 carry long local-estimate
# histories and moved the means by 1.2e-3 to 1.9e-3 on an H100 (the same
# code emulated on the CPU, with fewer divergences, agrees to ~1e-6);
# 5e-3 relative leaves room for that and still flags a systematic error
# of the estimator (any wrong branch shifts a mean by whole percents).
RAD_REL_TOL_KERNEL_VS_PLAIN = 5e-3
# Per-pixel limit of the same comparison, on the normalized images (pixels
# of 0.1 to 0.5): the diverged photons moved single pixels by up to 5.8e-3
# on an H100, while a contribution tallied in the wrong column (exit
# column, x/y wrap) moves pixels by a large part of their value.
RAD_PIXEL_TOL_KERNEL_VS_PLAIN = 0.02
# Contribution cap of the capped 2b case: low enough that the forward
# peak's contributions clip (checked: the image must change).
RAD_LOW_CAP = 0.1
# Column kernel vs plain, same seeds: both divide and round alike, so every
# photon takes the same path (equal lane-steps on an H100) and the tallies
# differ only by float32 atomic order. Per column, on the fluxes normalized
# by photons per column (values of 0.1 to 0.6), the gap was <= 9.5e-7; on
# the z profile, relative to its largest level, <= 4.5e-5 (64 levels, each
# a sum of ~1e5 weights). A tally in the wrong column (x/y swapped, a
# wrong wrap) or a profile flushed into the wrong levels moves single
# columns or levels by a large part of their value.
COL_PIXEL_TOL_KERNEL_VS_PLAIN = 1e-5
COL_PROFILE_TOL_KERNEL_VS_PLAIN = 5e-4
# Shared memory the kernel's tallies may take (csrc/record_kernel.cu
# kMaxSmem); a larger radiance image goes to global atomics.
KERNEL_SMEM_BUDGET = 200 * 1024
# Domain-mean radiances of run/step_cloud_radiance.nml from the JAX
# package on the CPU (XLA wave kernel with its own local estimator and
# threefry streams, independent of the port's kernel), on a step-cloud file
# of 512 Legendre moments with ssa 0.99: 16 batches of 262,144 photons,
# iseed 10; mean and standard error over batches, in the deck's direction
# order (mu 1, 1, 0.866, 0.866, 0.5, 0.5 x phi 0, 90).
JAX_RADIANCE = (0.10267673, 0.10264964, 0.14451702, 0.11127655, 0.28103105,
                0.13953311)
JAX_RADIANCE_SE = (0.00012624, 0.00013953, 0.00018308, 0.00016109,
                   0.00034415, 0.00038115)
# run/landsat_scale.nml from the JAX package on the CPU (XLA wave kernel,
# independent of the port's kernels), on the file of `mkdomain
# broken_cloud` (64 Legendre moments, macro factor 8): 16 batches of
# 131,072 photons, iseed 10; domain-mean R, T, A and the absorption
# profile's column integral (sum of profile * dz * 1000), each with its
# standard error over batches (the integral's is A's: it is the same
# quantity).
JAX_LANDSAT_RTA = (0.4628094509243965, 0.3781909700483084,
                   0.15901039727032185)
JAX_LANDSAT_RTA_SE = (2.66297028e-04, 2.85904954e-04, 8.17650074e-05)
JAX_LANDSAT_PROFILE_TOTAL = 0.15901039629769975
# Column kernel's gas template and local estimate vs plain, same seeds:
# totals (domain sums of the fluxes, the profile and each direction's
# image) and, where a pixel has signal (over 1e-3 of its largest), every
# pixel; both sum the same contributions in another float32 order.
COL_LE_TOTAL_TOL_KERNEL_VS_PLAIN = 1e-5
COL_LE_PIXEL_TOL_KERNEL_VS_PLAIN = 2e-3
# bench.py:555-559's 16 radiance directions (run/landsat_radiance.nml's)
MUS16 = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.45, 0.4] * 2
PHIS16 = [(i * 45.0 + 15.0) % 360.0 for i in range(16)]
# run/landsat_radiance.nml from the JAX package on the CPU (XLA wave kernel
# and XLA local estimator, threefry streams, independent of the port's
# kernels), on the file of `mkdomain broken_cloud`: 16 unchanged runs of
# `python -m mcbrat3d_tpu.driver.cli run` on one-batch copies of the deck
# with 8,192 photons and iseed 10-25 (tools/landsat_radiance_reference.py
# cut and stats; the deck's 8 x 262,144 photons cut 16-fold: the XLA
# estimator takes ~25 ms per photon on the CPU); domain-mean R, T, A, the
# profile's column integral and the 16 domain-mean radiances in the deck's
# order, each with its standard error over the runs.
JAX_LANDSAT_RAD = (
    0.4605214091, 0.3802499699, 0.1591047347, 0.1591043799, 0.055943774,
    0.1125144121, 0.1130556903, 0.109721014, 0.1159825993, 0.1324581701,
    0.1840113965, 0.3020353076, 0.05580172048, 0.1122461304, 0.1129843562,
    0.1098698405, 0.1162082952, 0.1327885071, 0.1841313921, 0.3018033263)
JAX_LANDSAT_RAD_SE = (
    0.00134695, 0.00128863, 0.000239671, 0.000239669, 0.00066132,
    0.00135728, 0.00136758, 0.00112675, 0.00181054, 0.00218613, 0.00213573,
    0.00235968, 0.000631669, 0.00135415, 0.00136648, 0.00107169, 0.00188044,
    0.00223148, 0.00215236, 0.00241712)
# The gas template at full width (tools/landsat_radiance_reference.py gas:
# broken_cloud_scene() plus q(z) = 2.5e-4 m^-1 exp(-z_c / 2000 m), macro
# 8, 201 CDF steps, analytic HG, beam mu0 0.5, albedo 0.2, seed 7) from the
# JAX package's XLA path on the CPU: 28 batches of 8,192 photons each for
# the flux run (R, T, A) and the 16-direction radiance run (R, T, A and
# the 16 domain-mean radiances), means and standard errors over batches.
JAX_GAS_FLUX = (0.2803435081, 0.2406617297, 0.5272333196)
JAX_GAS_FLUX_SE = (0.000819216, 0.000863049, 0.00081304)
JAX_GAS_RAD = (
    0.2803435081, 0.2406617297, 0.5272333196, 0.04506082824, 0.07596918261,
    0.07368789331, 0.06869232464, 0.06878217422, 0.07896200343, 0.1098154046,
    0.182901901, 0.04502950849, 0.07594063278, 0.07376221833, 0.06872264439,
    0.06876140964, 0.07908786573, 0.109801653, 0.182662599)
JAX_GAS_RAD_SE = (
    0.000819216, 0.000863049, 0.00081304, 0.000374273, 0.00059573,
    0.000697497, 0.000641818, 0.00073098, 0.000958975, 0.00102928,
    0.00113775, 0.000375392, 0.000551829, 0.000736583, 0.000632121,
    0.000779674, 0.000966359, 0.0010323, 0.00112455)
# The gas template cut to 32 x 32 x 64 columns (the same column height,
# so the same slant paths, which wrap the domain three times at mu 0.4),
# radiance with the eight distinct directions of the 16 (mu 1 ... 0.4),
# from the JAX package on the CPU by tools/landsat_radiance_reference.py
# witness: its XLA estimator and its column kernel (K3) in Pallas interpret
# mode, 96 batches of 4,096 photons each (seed 8), R, T, A and the 8
# domain-mean radiances, means and standard errors over batches.
JAX_GAS_MID_XLA = (
    0.279873423, 0.2383065644, 0.5291274165, 0.0453381738, 0.07567766499,
    0.07364039941, 0.0678886529, 0.07044089635, 0.07857129426, 0.109258638,
    0.1753786522)
JAX_GAS_MID_XLA_SE = (
    0.000607544, 0.000662925, 0.000653009, 0.000340243, 0.000535521,
    0.000478996, 0.0004818, 0.000535375, 0.00068279, 0.000852341,
    0.00114502)
JAX_GAS_MID_K3 = (
    0.2801370372, 0.2370023131, 0.529919376, 0.04512440076, 0.07570305856,
    0.07322699269, 0.06787839142, 0.06883812183, 0.07775307605,
    0.1093382683, 0.1771497695)
JAX_GAS_MID_K3_SE = (
    0.000692267, 0.000659739, 0.000686007, 0.000273506, 0.000457286,
    0.000486854, 0.000581079, 0.000507022, 0.000595615, 0.000935467,
    0.00115807)
# Separable kernel vs plain, same seeds: as for the column kernel, every
# photon takes the same path (equal lane-steps) and the tallies differ only
# by float32 atomic order; the same per-column and profile limits apply.
SEP_COLUMN_TOL_KERNEL_VS_PLAIN = 1e-5
SEP_PROFILE_TOL_KERNEL_VS_PLAIN = 5e-4
# The 48 x 48 x 150, 8-bin cut of run/I3RC_bench_LW_325.nml (the same
# generator, write_lw_flagship_inputs(nx=48, ny=48, n_lambda=8), 16 batches
# of 131,072 photons, iseed 31) from the JAX package on the CPU with
# usePallas = 'off' (its XLA wave kernel with a per-voxel emission alias and
# threefry streams, independent of the port's kernel): domain-mean up, down
# and net absorbed flux [W m^-2] and their standard errors over its 19
# batches, and the total emitted flux that scales them (the setup pass,
# deterministic: the JAX package without its separable plan sums the cells,
# the port through its plan of float32 amplitudes; they agree to 7.3e-10).
JAX_LW48 = (89.51026173281286, 118.68254518942129, -73.32991880564167)
JAX_LW48_SE = (2.22200146, 1.59225717, 2.51300316)
JAX_LW48_TOTAL_FLUX = 2054.728052554276
# Tiled kernel vs plain, same seeds and injection: as for the column and
# separable kernels every photon takes the same path (equal lane-steps,
# passes and n_bad), and the tallies differ only by float32 atomic order.
TILE_COLUMN_TOL_KERNEL_VS_PLAIN = 1e-5
TILE_RTA_TOL_KERNEL_VS_PLAIN = 1e-6
# 2f's runs: 2^16 photons through a pool of 2^15 slots; sorted: the JAX
# package's drain floor (pool / 64), then a tail of 4 passes of 64 steps
# (the plain pass takes ~1.5 ms per step at this pool, so a longer tail
# costs seconds); refill: 8 launches of 128 steps at most (~7 ms a plain
# step), so the rebalance runs between launches and most photons finish
TILE_COMPARE_POOL, TILE_COMPARE_PHOTONS = 1 << 15, 1 << 16
TILE_COMPARE_TAIL = dict(tail_steps=64, tail_passes=4)
TILE_COMPARE_REFILL = dict(k_steps=128, max_passes=8)
# run/dense_cloud_mono.nml cut to 16 batches of 262,144 photons (nLanes
# 32,768), from the JAX package's CLI on the CPU (its XLA wave kernel with
# threefry streams, independent of the port's kernel), on the file that
# write_domain makes of dense_cloud_scene() with surface albedo 0.2 (64
# Legendre moments, so a tabulated phase row), iseed 10: domain-mean R, T,
# A and their standard errors over batches.
JAX_DENSE_RTA = (0.45576259680092335, 0.5423019416630268,
                 0.11056571174412966)
JAX_DENSE_RTA_SE = (2.65830903e-04, 2.9748027e-04, 5.08438043e-05)
# The dense deck's n_bad: a Lambertian reflection whose uniform is exactly 0
# (probability 2^-24 per surface hit, about one per 16 x 2,097,152 photons)
# leaves with the reference's floor mu = 1e-6 and stays in the clear bottom
# layer of the scene past any step cap (mcbrat3d_tpu_torch/tools/
# dense_stragglers.py prints such photons), as it does in the reference.
DENSE_DECK_MAX_BAD = 16
# run/step_cloud_multi3_mono.nml cut to 16 batches of 262,144 photons, from
# the JAX package's CLI on the CPU (its XLA wave kernel with threefry
# streams, independent of the port's kernel), on the file that write_domain
# makes of step_cloud_multi_scene(analytic=False) (64 Legendre moments for
# the cloud, the Rayleigh moments, an isotropic gas), iseed 10: domain-mean
# R, T, A and their standard errors over batches.
JAX_MULTI3_RTA = (0.2938315160572529, 0.10033707739785314,
                  0.6058054529130459)
JAX_MULTI3_RTA_SE = (2.32650321e-04, 1.21101785e-04, 2.88821516e-04)
# run/broadband_sw.nml (bench.py:576-650's scene from
# mcbrat3d_tpu_torch/tools/sw_inputs.py: 16 bins, 32 x 32 x 32 cells, cloud
# water and Rayleigh, 9,001 CDF steps) from the JAX package on the CPU with
# usePallas = 'off' (its XLA wave kernel, threefry streams, independent of
# the port's kernels): tools/wave_reference.py sw, 16 unchanged runs of the
# deck with 16,384 photons each (nLanes 2,048, iseed 100-115); the domain-mean
# up, down and absorbed flux, their standard errors over the runs, and the
# incident flux that scales them (deterministic).
JAX_SW = (93.96829697485768, 99.93653854053916, 12.313683640720386)
JAX_SW_SE = (0.199601199, 0.198697789, 0.0113732373)
JAX_SW_TOTAL_FLUX = 206.2188826054112
# The step cloud of run/step_cloud_mono.nml (the file of `mkdomain
# step_cloud StepCloud.dom ssa=0.99 n_legendre=512`, 10,001 CDF steps,
# macro factor 8) on the JAX package's XLA wave kernel on the CPU
# (tools/wave_reference.py): ``step`` the deck (R, T, A; 32 batches of
# 16,384 photons, seed 16), ``rt`` with useRayTracing and numRecScatOrd = 3
# (R, T, A, the domain-mean up flux of orders 0-2 and the overflow, then
# the down flux's; 16 batches of 8,192, seed 17), ``rad``
# run/step_cloud_radiance.nml with one direction at mu 0.1 (R, T, A and the
# domain-mean radiance; 16 batches of 4,096, seed 18); means and standard
# errors over batches.
JAX_WAVE_STEP = (0.4770482499152422, 0.32438609562814236,
                 0.19845135835930705)
JAX_WAVE_STEP_SE = (0.000553607139, 0.000525647394, 0.00021271404)
JAX_WAVE_RT = (0.4771347641944885, 0.32405420392751694, 0.19860131293535233,
               0.0, 0.026428296372614568, 0.02604437620357203,
               0.4246621649945155, 0.0, 0.002409439090115484,
               0.007290630721399793, 0.3143541438621469)
JAX_WAVE_RT_SE = (0.00111847286, 0.00110267872, 0.000318644933, 0.0,
                  0.000431338604, 0.000397213096, 0.00102939422, 0.0,
                  0.000190910744, 0.000188685832, 0.000929704079)
JAX_WAVE_RAD = (0.4786494877189398, 0.3231675662100315, 0.19812197610735893,
                0.6656596236280166)
JAX_WAVE_RAD_SE = (0.00216906272, 0.00192910139, 0.000549273439,
                   0.0117856575)
# Phase 3o's wall seconds for the step-cloud deck on the wave kernel,
# sized by one timed batch.
WAVE_DECK_SECONDS = 60.0
# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W): device
# memory bytes/s and float32 operations/s outside
# the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
# Operations of one transport step of a lane with a live photon, counted
# from the kernel sources: five to seven counter uniforms of ~20 integer
# operations each, log1pf, the divisions, the wrap, cell indexing, the
# tally atomic, and on a scatter the sampling, sincosf and the rotation
# (transcendentals as their instruction expansions). Integer operations
# are charged at the float32 rate, which is the card's faster one, so the
# bound stays a lower bound. The local estimates' operations are counted
# apart (OPS_PER_MARCH_STEP and OPS_PER_K2_DIRECTION for the record kernel,
# OPS_PER_WALK_ITERATION and OPS_PER_LE_DIRECTION for the column kernel).
OPS_PER_LANE_STEP = {"record_kernel": 300, "col_kernel": 320,
                     "sep_kernel": 360, "tile_kernel": 340}
# Operations of one birth in the tiled kernel's refill mode from the
# directional source (csrc/tile_kernel.cu inject), counted from the source:
# the dead and quota tests, the quota and count updates (4); the two
# counter uniforms of the entry point at ~26 integer operations each (52);
# the entry point, a multiply and an add per axis (4); the direction, z
# and w moves (5); the entry column, a subtract, multiply, convert and a
# two-sided clamp per axis (10); the entry tile, two integer divides of
# ~20 each and five multiply-adds (45). Integer operations at the float32
# rate, as above.
OPS_PER_TILE_BIRTH = 120
# Operations the 2-3 component record adds to the record kernel, counted
# from csrc/record_kernel.cu's component choice, which runs on a real
# collision only (the kernel counts those): the uniform at site 8, 26
# integer operations (3 to form the counter, 1 xor with the lane, 2 x 8
# for the two fmix32 rounds, 3 to key the second round with the seed, 3
# to scale to float), then the two compares, the ncomp == 3 test and
# their and (4) and the two selects of the phase entry (2). The record's
# two float4 loads replace the one-component record's scalar loads and
# are charged as table bytes.
OPS_PER_COMPONENT_CHOICE = 32
# Operations the gas template adds to a live lane-step of the column
# kernel (csrc/col_kernel.cu): the gas maximum added to the ceiling, the
# load of qz[iz] and its add to the extinction; the effective ssa's divide
# runs on real collisions only and is not charged.
OPS_PER_GAS_STEP = 4
# Operations of the column kernel's local estimate (csrc/col_kernel.cu
# le_pair, run by col_walk), counted from the source when it read A and B
# with two __ldg; the interleaved table's one 8-byte load is still charged
# as those two, so the bound compares across the walk's redesign. One walk
# iteration is 39: the loop test and its branch (2), the two fminf of the
# next stop (2), the column index (1), the two __ldg with their addresses
# (4), the two CT evaluations, each an FMA for z, an FMA for A - B z and a
# fmaxf (6), their difference and its add to tau (2), the iteration count
# (1), the stop test and the axis test with their branches (4), the step
# of one axis with its periodic wrap, an add, a compare and two selects
# (5), and that axis's next face, four operations and an IEEE divide of ~8
# (12). The wrap needs no modulo inside the loop: the two integer modulos
# run once per direction, before it. One direction's fixed cost is 390:
# the phase value with its square root or HG divide, ~40; the two roulette
# uniforms, log1pf and logf, ~105; the walk's setup, ~110 (the two divides
# of t_top and t_stop, the first column's floors, the first two faces with
# their divides, and the two integer modulos of the first column at ~20
# each); the closed-form gas term, exp and the contribution, ~60; the exit
# pixel's two wraps, ~75. Integer operations at the float32 rate, as
# above.
OPS_PER_WALK_ITERATION = 39
OPS_PER_LE_DIRECTION = 390
# Operations of the record kernel's local estimate (csrc/record_kernel.cu
# le_pair, run by record_walk), counted from the source; the kernels count
# the events and the march iterations. One march iteration is 134: the
# loop test and its branch (2); the periodic wrap of x and y, each a
# subtract, fmodf (~20 as its expansion), its sign fix-up and an add (50);
# the cell indices, each a subtract, multiply, add of the nudge, convert
# and clamp, z's without the nudge (17); the record's address and load
# (6); the three faces, a select, convert, multiply and add each (12); the
# three distances, x's and y's a test, subtract and IEEE divide of ~8, z's
# a subtract and divide (31); the step, two fminf, a fmaxf and the nudge's
# add (4); tau's multiply-add (2); the next z (2); the top and roulette
# tests with their branches (4); the next x and y (4). One direction's
# fixed cost is 260: the phase value, a table or HG lookup with its square
# root (~40), and its divide by 4 pi mu (10); the two roulette uniforms,
# log1pf and logf with their compares (95); the march's setup (8); the
# exit point at the top, a divide, two wraps and the pixel's indices (71);
# the contribution with its exp and the roulette branches (30); the image
# address and atomic (5). Integer operations at the float32 rate.
OPS_PER_MARCH_STEP = 134
OPS_PER_K2_DIRECTION = 260


def _sync():
    import torch
    torch.cuda.synchronize()


def _rta(t):
    n = t.n_photons
    return tuple(float(a.sum()) / n
                 for a in (t.flux_up, t.flux_down, t.flux_absorbed))


def _timed(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def _bound(lane_steps, n_launch, ops_per_step, n_lanes, state_bytes,
           table_bytes, tally_bytes, extra_ops=0):
    """(bound_ms, bound_by) per launch: the least time the card could take
    for one launch's work, the larger of its bytes (state read and written
    once, tables read once, tallies written once) over the memory rate and
    its operations (this run's lane-steps with a live photon, plus
    ``extra_ops`` over the whole run) over the float32 rate."""
    nbytes = 2 * state_bytes * n_lanes + table_bytes + tally_bytes
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ((lane_steps * ops_per_step + extra_ops) / max(n_launch, 1)
             / H100_F32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def _pixel_z(pairs, n):
    """Largest per-pixel z of tally pairs and largest difference of the
    normalized fluxes (photons per column as the normalizer)."""
    z_max = err = 0.0
    for a, b in pairs:
        a = a.double().cpu()
        b = b.double().cpu()
        per_col = n / a[..., 0].numel() if a.dim() == 3 else n / a.numel()
        sigma = ((a + b).clamp(min=1.0) / 2).sqrt()
        z_max = max(z_max, float(((a - b).abs() / sigma).max()))
        err = max(err, float((a - b).abs().max()) / per_col)
    return z_max, err


def _sources(illumination):
    """The record kernel's sources by name, as phases 2 and 2b drive
    them."""
    return {"directional": illumination.directional(0.5, 0.0),
            "random_azimuth": illumination.random_azimuth(0.6),
            "flux": illumination.flux(),
            "spotlight": illumination.spotlight(0.8, 20.0, 0.3, 0.6)}


def radar_scene(m, nx=640):
    """bench.py:269-303's radar_scale scene built with the port: I3RC case
    3's radar cloud (Domain-Files/i3rcRadarCloud.f95:28-30), nx x 1 x 54
    cells of 0.055 x 35 x 0.045 km (640 columns at full width), beta up to
    20 km^-1 in 60% of the cells, ssa 0.99, analytic HG 0.85, macro 8, 201
    CDF steps. ``m`` holds the port's modules."""
    import numpy as np

    nz = 54
    rs = np.random.RandomState(2)
    grid = m.Grid.regular(nx, 1, nz, 0.055, 35.0, 0.045, device="cuda")
    ext = rs.rand(nx, 1, nz) * 20.0 * (rs.rand(nx, 1, nz) > 0.4)
    tbl = m.PhaseFunctionTable(
        [m.PhaseFunction.henyey_greenstein(0.85, 64)], key=[1.0])
    comp = m.OpticalComponent("radar cloud", ext, np.full_like(ext, 0.99),
                              np.zeros(ext.shape, np.int32), tbl)
    return m.build_domain(grid, [comp], macro_factor=8, n_cdf_steps=201)


def phase_compare(rk, make_step_cloud, make_step_cloud_multi, Surface,
                  illumination, KernelConfig, rng, m):
    """Kernel vs plain on the card; returns the largest per-pixel
    difference of the normalized fluxes, over the directional one-component
    cases and over the envelope's."""
    import dataclasses

    sources = _sources(illumination)
    # (macro_factor, 3D tally, components, analytic HG, surface albedo,
    # roulette, source, photons per lane[, scene])
    cases = [(mf, vol, 1, True, 0.0, True, "directional", 16)
             for mf in (0, 8) for vol in (False, True)]
    # tabulated, as the deck runs; reflection without roulette
    cases.append((8, True, 1, False, 0.0, True, "directional", 16))
    cases.append((8, False, 1, True, 0.3, False, "directional", 16))
    # the source and component envelope (K1-a, K1-b), at 2^18 photons
    cases += [(8, True, 1, True, 0.0, True, "random_azimuth", 4),
              (0, False, 1, True, 0.0, True, "flux", 4),
              (8, True, 1, True, 0.0, True, "spotlight", 4),
              (8, False, 2, True, 0.0, True, "directional", 4),
              (0, True, 2, False, 0.0, True, "random_azimuth", 4),
              (8, True, 3, True, 0.0, True, "directional", 4),
              (8, True, 3, False, 0.0, True, "flux", 4),
              (8, False, 3, False, 0.3, False, "spotlight", 4),
              # run/step_cloud_multi3_mono.nml's own configuration
              (8, True, 3, False, 0.0, True, "directional", 4),
              # a 256 x 1 x 54 cut of radar_scale, 3D tally: its 56 KB
              # tally would cost blocks an SM, so its absorbed cells go
              # to global memory
              (8, True, 1, True, 0.1, True, "directional", 4, "radar")]
    max_err = [0.0, 0.0]
    for i, (mf, vol, ncomp, analytic, albedo, rr, src, ppl,
            *scene) in enumerate(cases):
        surface = Surface.lambertian(albedo)
        source = sources[src]
        kw = dict(ssa=0.99, macro_factor=mf, n_cdf_steps=10001,
                  device="cuda")
        if scene == ["radar"]:
            dom = radar_scene(m, 256)
        elif ncomp == 1:
            dom = make_step_cloud(**kw)
        else:  # gas + cloud (+ Rayleigh, its true phase when tabulated)
            dom = make_step_cloud_multi(n_components=ncomp,
                                        analytic=analytic, **kw)
        if not analytic:
            # a file-read domain carries Legendre moments, not hg_g
            dom = dataclasses.replace(dom, all_hg=False)
        cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=ppl,
                           max_steps=100_000, need_volume_absorption=vol,
                           use_russian_roulette=rr)
        seed = rng.batch_seed(10, i)
        before = rk.LAUNCHES
        tk, sk = _timed(lambda: rk.run_batch_record_tallies(
            dom, surface, source, seed, cfg))
        assert rk.LAUNCHES > before, "kernel was not launched"
        tk2 = rk.run_batch_record_tallies(dom, surface, source, seed, cfg)
        assert (tk2.n_photons, tk2.n_bad) == (tk.n_photons, tk.n_bad)
        rerun = max(abs(float(a.sum()) / float(b.sum()) - 1.0)
                    for a, b in ((tk.flux_up, tk2.flux_up),
                                 (tk.flux_down, tk2.flux_down),
                                 (tk.flux_absorbed, tk2.flux_absorbed)))
        assert rerun < 1e-5, f"kernel reruns differ by {rerun:.2e}"
        tp, sp = _timed(lambda: rk.run_batch_record_tallies(
            dom, surface, source, seed, cfg, launch=rk.record_launch_plain))
        assert tk.n_photons == tp.n_photons == ppl << 16, (tk.n_photons,
                                                           tp.n_photons)
        assert tk.n_bad == 0 and tp.n_bad == 0, (tk.n_bad, tp.n_bad)
        # run_batch's refill schedule on the same slots for both: the same
        # launches and live lane-steps
        assert tk.n_steps % rk.REFILL_STEPS == 0, tk.n_steps
        assert (tk.n_steps, tk.n_lane_steps) == (tp.n_steps,
                                                 tp.n_lane_steps), (
            tk.n_steps, tp.n_steps, tk.n_lane_steps, tp.n_lane_steps)
        rta_k, rta_p = _rta(tk), _rta(tp)
        gap = max(abs(a - b) for a, b in zip(rta_k, rta_p))
        z_max, err = _pixel_z(
            [(tk.flux_up, tp.flux_up), (tk.flux_down, tp.flux_down),
             (tk.flux_absorbed, tp.flux_absorbed)], tk.n_photons)
        envelope = ncomp > 1 or src != "directional"
        max_err[envelope] = max(max_err[envelope], err)
        print(f"compare {''.join(scene) or 'step cloud'} macro={mf} "
              f"vol={vol} components={ncomp} "
              f"analytic={analytic} albedo={albedo} roulette={rr} "
              f"source={src}: "
              f"kernel R/T/A={rta_k} plain={rta_p} gap={gap:.3e} "
              f"pixel z_max={z_max:.2f} rerun rel={rerun:.1e} "
              f"real collisions {tk.n_real}/{tp.n_real} lane-steps "
              f"{tk.n_lane_steps}/{tp.n_lane_steps} launches "
              f"{tk.n_steps // rk.REFILL_STEPS}/"
              f"{tp.n_steps // rk.REFILL_STEPS} "
              f"kernel {sk:.3f} s plain {sp:.3f} s",
              flush=True)
        assert gap < RTA_TOL_KERNEL_VS_PLAIN, gap
        assert z_max < 5.0, z_max
        real_gap = abs(tk.n_real - tp.n_real)
        assert real_gap <= REAL_TOL_KERNEL_VS_PLAIN * tp.n_real, (
            tk.n_real, tp.n_real)
    return tuple(max_err)


# 512 Legendre moments: the file stores the phase function as moments, and
# the default 64 shift R by -1.9e-3 against the analytic-HG goldens (the
# JAX file path shows the same shift)
STEP_CLOUD_DOMAIN = ("step_cloud", "StepCloud.dom", "ssa=0.99",
                     "n_legendre=512")


def _run_cli_deck(cli, rk, deck_text, ck=None, domain=STEP_CLOUD_DOMAIN,
                  sk=None, tk=None, kernel=True):
    """mkdomain (unless ``domain`` is None) + run a deck through the CLI on
    cuda in the current directory; returns the JSON line, the seconds and
    the launches of the run (record kernel, its radiance launches, column
    kernel, separable kernel, tiled kernel, record-kernel launches with the
    emission refill, column-kernel launches with the local estimate, the
    record kernel's and the column kernel's walk kernels), and asserts
    that no plain step ran and (``kernel``) that a kernel launched and no
    batch ran on the wave kernel. Every
    count, the wave kernel's batches too, is set to 0 just before the run
    and read just after it."""
    from mcbrat3d_tpu_torch.transport import integrator

    Path("deck.nml").write_text(deck_text)
    if domain is not None:
        assert cli.main(["mkdomain", *domain]) == 0
    plain_steps = []
    patched = [(rk, "record_launch_plain")]
    if ck is not None:
        patched.append((ck, "col_launch_plain"))
    if sk is not None:
        patched.append((sk, "sep_launch_plain"))
    if tk is not None:
        patched.append((tk, "tile_pass_plain"))
    originals = [getattr(m, name) for m, name in patched]

    def counting(plain):
        def run_plain(*args, **kwargs):
            plain_steps.append(1)
            return plain(*args, **kwargs)
        return run_plain

    for (m, name), plain in zip(patched, originals):
        setattr(m, name, counting(plain))
    buf = io.StringIO()
    rk.LAUNCHES = rk.RADIANCE_LAUNCHES = rk.LW_LAUNCHES = 0
    rk.WALK_LAUNCHES = 0
    if ck is not None:
        ck.COL_LAUNCHES = ck.COL_LE_LAUNCHES = ck.COL_WALK_LAUNCHES = 0
    if sk is not None:
        sk.SEP_LAUNCHES = 0
    if tk is not None:
        tk.TILE_LAUNCHES = 0
    integrator.WAVE_BATCHES = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", "deck.nml", "--device", "cuda"])
    finally:
        for (m, name), plain in zip(patched, originals):
            setattr(m, name, plain)
    seconds = time.perf_counter() - t0
    launches = (rk.LAUNCHES, rk.RADIANCE_LAUNCHES,
                ck.COL_LAUNCHES if ck is not None else 0,
                sk.SEP_LAUNCHES if sk is not None else 0,
                tk.TILE_LAUNCHES if tk is not None else 0, rk.LW_LAUNCHES,
                ck.COL_LE_LAUNCHES if ck is not None else 0,
                rk.WALK_LAUNCHES,
                ck.COL_WALK_LAUNCHES if ck is not None else 0)
    assert rc == 0
    assert not kernel or launches[0] + sum(launches[2:5]) > 0, \
        "the deck launched no kernel"
    assert not plain_steps, "the deck ran a plain PyTorch step"
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert integrator.WAVE_BATCHES == out["launches"]["wave_kernel_batches"]
    assert not kernel or out["launches"]["wave_kernel_batches"] == 0, \
        "a batch of the deck left the hand-written kernels"
    return out, seconds, launches


def phase_main_path(rk, cli):
    """The namelist deck through the CLI on cuda."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            out, seconds, (launches, *_) = _run_cli_deck(
                cli, rk, (ROOT / "run" / "step_cloud_mono.nml").read_text())
            for f in ("StepCloud_flux.out", "StepCloud_results.nc"):
                assert Path(f).stat().st_size > 0, f
        finally:
            os.chdir(cwd)
    assert launches > 0, "the deck did not launch the record kernel"
    n = out["total_photons"]
    rta = (out["mean_flux_up"], out["mean_flux_down"],
           out["mean_flux_absorbed"])
    print(f"main path: {n} photons in {out['n_batches']} batches, "
          f"n_bad={out['n_bad']}, R/T/A={rta}, {seconds:.2f} s "
          f"({n / seconds:.4g} photons/s incl. setup and output), "
          f"{launches} kernel launches", flush=True)
    assert n == 16 * 1_048_576 and out["n_batches"] == 16
    assert out["n_bad"] == 0
    for got, want, name in zip(rta, GOLDEN_RTA, "RTA"):
        sigma = (max(want * (1 - want), 1e-8) / n) ** 0.5 + 8e-5
        assert abs(got - want) < 4.5 * sigma, (name, got, want, 4.5 * sigma)
    return launches


def _deck_directions(config, le, deck, n=None):
    mus, phis = config.load_config(str(ROOT / "run" / deck)).radiance_directions()
    mus, phis = (mus, phis) if n is None else (mus[:n], phis[:n])
    return le.make_intensity_directions(mus, phis, device="cuda")


def _image_gap(a, b, n_a, n_b):
    """Per-pixel z of two raw images (the formula of tests/test_pallas.py)
    and the largest absolute difference of the per-photon images."""
    a = a.double().cpu() / n_a
    b = b.double().cpu() / n_b
    sigma = (a / n_a + b / n_b + 1e-12).sqrt()
    return float(((a - b).abs() / sigma.clamp(min=1e-9)).max()), float(
        (a - b).abs().max())


def phase_radiance_compare(rk, le, make_step_cloud, make_step_cloud_multi,
                           make_slab, PhaseFunction, Surface, illumination,
                           KernelConfig, rng, dirs, m):
    """Radiance kernel vs plain on the card; returns the largest per-pixel
    difference of the per-photon images."""
    import dataclasses

    surface = Surface.lambertian(0.2)  # reflections estimate too
    n_dirs = dirs.shape[1]
    cap = dict(limit_contributions=True, max_contribution=RAD_LOW_CAP)
    # (name, all_hg, intensity knobs, components, source)
    cases = [
        ("exact estimator, analytic HG", True,
         dict(use_russian_roulette=False, use_hybrid_phase=False), 1,
         "directional"),
        ("Iwabuchi roulette, hybrid table", True,
         dict(use_russian_roulette=True, use_hybrid_phase=True), 1,
         "directional"),
        ("original table (all_hg=False)", False,
         dict(use_russian_roulette=True, use_hybrid_phase=False), 1,
         "directional"),
        (f"contribution cap {RAD_LOW_CAP}", True,
         dict(use_russian_roulette=False, use_hybrid_phase=True, **cap), 1,
         "directional"),
        # one slot per component: the tabulated gas + cloud + Rayleigh
        (f"3 components, random azimuth, cap {RAD_LOW_CAP}", False,
         dict(use_russian_roulette=False, use_hybrid_phase=False, **cap), 3,
         "random_azimuth"),
    ]
    cfg = KernelConfig(n_lanes=4096, photons_per_lane=4, max_steps=100_000,
                       need_volume_absorption=False)
    max_err = 0.0
    for i, (name, all_hg, kw, ncomp, src) in enumerate(cases):
        source = _sources(illumination)[src]
        dkw = dict(ssa=0.99, macro_factor=8, n_cdf_steps=10001,
                   compute_intensity_tables=True, hybrid_width_deg=7.0,
                   device="cuda")
        if ncomp == 1:
            dom = make_step_cloud(**dkw)
        else:
            dom = make_step_cloud_multi(n_components=ncomp,
                                        analytic=all_hg, **dkw)
        if not all_hg:
            dom = dataclasses.replace(dom, all_hg=False)
        icfg = le.IntensityConfig(n_dirs=n_dirs, **kw)
        seed = rng.batch_seed(20, i)

        def run(launch=rk.record_launch, icfg=icfg):
            return rk.run_batch_record_tallies(
                dom, surface, source, seed, cfg, launch=launch,
                intensity_config=icfg, intensity_dirs=dirs)

        before = rk.RADIANCE_LAUNCHES
        tk, sk = _timed(run)
        assert rk.RADIANCE_LAUNCHES > before, "kernel was not launched"
        tk2 = run()
        tot_k, tot_k2 = (t.intensity.double().sum(dim=(0, 1)) for t in (tk, tk2))
        rerun = float(((tot_k2 - tot_k).abs() / tot_k.abs()).max())
        assert rerun < 1e-5, f"kernel reruns differ by {rerun:.2e}"
        tp, sp = _timed(lambda: run(rk.record_launch_plain))
        n = tk.n_photons
        assert n == tp.n_photons == 4096 * 4, (n, tp.n_photons)
        assert tk.n_bad == 0 and tp.n_bad == 0, (tk.n_bad, tp.n_bad)
        mean_k, mean_p = (t.normalized(dom.grid).intensity.double()
                          .mean(dim=(0, 1)) for t in (tk, tp))
        gap = float(((mean_k - mean_p).abs() / mean_p.abs()).max())
        flux_gap = max(abs(a - b) for a, b in zip(_rta(tk), _rta(tp)))
        z_max, err = _image_gap(tk.intensity, tp.intensity, n, n)
        # per-photon image difference times the columns: the normalized one
        err *= tk.intensity[..., 0].numel()
        max_err = max(max_err, err)
        extra = ""
        if kw.get("limit_contributions"):
            # the cap must clip: against the uncapped kernel run the image
            # changes while each direction's total is redistributed intact
            tu = run(icfg=dataclasses.replace(icfg, limit_contributions=False))
            tot_u = tu.intensity.double().sum(dim=(0, 1))
            moved = float((tu.intensity - tk.intensity).abs().max()
                          / tu.intensity.abs().max())
            kept = float(((tot_u - tot_k).abs() / tot_u).max())
            extra = f" cap moved {moved:.2e} of the peak, totals kept {kept:.1e}"
            assert moved > 1e-3, "the cap did not clip"
            assert kept < 1e-4, kept
        print(f"radiance compare [{name}]: per-direction mean radiance "
              f"kernel {[round(float(v), 6) for v in mean_k]} "
              f"gap {gap:.2e} (R/T/A gap {flux_gap:.1e}), pixel gap "
              f"{err:.2e}, pixel z_max {z_max:.2f}, rerun rel "
              f"{rerun:.1e}, kernel {sk:.3f} s plain {sp:.3f} s{extra}",
              flush=True)
        assert gap < RAD_REL_TOL_KERNEL_VS_PLAIN, gap
        assert err < RAD_PIXEL_TOL_KERNEL_VS_PLAIN, err
        assert z_max < 5.0, z_max

    # an image past the kernel's shared-memory budget (64 x 64 columns x
    # 16 directions = 256 KB) is tallied with global atomics instead
    source = illumination.directional(0.5, 0.0)
    slab = make_slab(tau=2.0, ssa=0.99, nx=64, ny=64, nz=4,
                     n_cdf_steps=1001, compute_intensity_tables=True,
                     phase=PhaseFunction.henyey_greenstein(0.85, 64),
                     device="cuda")
    mus = [1.0 - 0.05 * i for i in range(16)]
    dirs16 = le.make_intensity_directions(mus, [22.5 * i for i in range(16)],
                                          device="cuda")
    icfg = le.IntensityConfig(n_dirs=16, use_russian_roulette=False)
    prm = rk.RecordParams.make(slab, surface, source, True, 1.0, False, icfg,
                               dirs16)
    assert 4 * (prm.n_acc + prm.n_exc + prm.n_img) > KERNEL_SMEM_BUDGET
    cfg = KernelConfig(n_lanes=4096, photons_per_lane=4, max_steps=100_000,
                       need_volume_absorption=False)
    tk, tp = (rk.run_batch_record_tallies(
        slab, surface, source, rng.batch_seed(21, 0), cfg, launch=launch,
        intensity_config=icfg, intensity_dirs=dirs16)
        for launch in (rk.record_launch, rk.record_launch_plain))
    assert tk.n_bad == tp.n_bad == 0
    mean_k, mean_p = (t.normalized(slab.grid).intensity.double()
                      .mean(dim=(0, 1)) for t in (tk, tp))
    gap = float(((mean_k - mean_p).abs() / mean_p.abs()).max())
    z_max, err = _image_gap(tk.intensity, tp.intensity, tk.n_photons,
                            tp.n_photons)
    err *= tk.intensity[..., 0].numel()
    max_err = max(max_err, err)
    print(f"radiance compare [image in global memory, 64x64 columns x 16 "
          f"dirs]: gap {gap:.2e}, pixel gap {err:.2e}, pixel z_max "
          f"{z_max:.2f}", flush=True)
    assert gap < RAD_REL_TOL_KERNEL_VS_PLAIN, gap
    assert err < RAD_PIXEL_TOL_KERNEL_VS_PLAIN, err
    assert z_max < 5.0, z_max

    # LW radiance from the per-voxel emission source (the headline's
    # scene): every birth contributes its emission local estimate in its
    # birth step and moves from the next (the fresh hold)
    dom, source = lw_emission_scene(m)
    dirs4 = le.make_intensity_directions([1.0, 0.8, 0.5, 0.3],
                                         [0.0, 45.0, 120.0, 250.0],
                                         device="cuda")
    icfg = le.IntensityConfig(n_dirs=4, use_russian_roulette=True,
                              use_hybrid_phase=False)
    cfg = KernelConfig(n_lanes=4096, photons_per_lane=4, max_steps=100_000,
                       lw_mode=True)
    before = rk.LW_LAUNCHES
    tk, tp = (rk.run_batch_record_tallies(
        dom, Surface.lambertian(0.05), source, rng.batch_seed(22, 0), cfg,
        launch=launch, intensity_config=icfg, intensity_dirs=dirs4)
        for launch in (rk.record_launch, rk.record_launch_plain))
    assert rk.LW_LAUNCHES > before, "kernel was not launched"
    assert tk.n_photons == tp.n_photons == 4096 * 4
    assert tk.n_bad == tp.n_bad == 0
    mean_k, mean_p = (t.normalized(dom.grid).intensity.double()
                      .mean(dim=(0, 1)) for t in (tk, tp))
    gap = float(((mean_k - mean_p).abs() / mean_p.abs()).max())
    z_max, err = _image_gap(tk.intensity, tp.intensity, tk.n_photons,
                            tp.n_photons)
    err *= tk.intensity[..., 0].numel()
    max_err = max(max_err, err)
    print(f"radiance compare [LW emission, fresh hold, 4 dirs]: mean "
          f"radiance kernel {[round(float(v), 6) for v in mean_k]} gap "
          f"{gap:.2e}, pixel gap {err:.2e}, pixel z_max {z_max:.2f}",
          flush=True)
    assert gap < RAD_REL_TOL_KERNEL_VS_PLAIN, gap
    assert err < RAD_PIXEL_TOL_KERNEL_VS_PLAIN, err
    assert z_max < 5.0, z_max
    return max_err


def phase_radiance_anchors(le, make_slab, Surface, illumination,
                           KernelConfig, run_batch, rng):
    """Analytic radiance oracles through run_batch on the card."""
    import math

    # thin isotropic slab at normal incidence: first order
    # I(mu_v) = ssa tau P / (4 pi mu_v), P = 1 (tests/test_intensity.py
    # :46-63, same photon count so the same 4 sigma + 3% tolerance)
    tau = 0.05
    dom = make_slab(tau=tau, ssa=1.0, nx=2, ny=2, nz=4, n_cdf_steps=501,
                    compute_intensity_tables=True, device="cuda")
    mus = [1.0, 0.5]
    icfg = le.IntensityConfig(n_dirs=2, use_russian_roulette=False)
    t = run_batch(dom, Surface.lambertian(0.0),
                  illumination.directional(1.0, 0.0), rng.batch_seed(0, 0),
                  KernelConfig(n_lanes=1 << 13, photons_per_lane=8,
                               max_steps=2000),
                  intensity_config=icfg,
                  intensity_dirs=le.make_intensity_directions(
                      mus, [0.0, 0.0], device="cuda"))
    assert t.n_bad == 0
    rad = t.normalized(dom.grid).intensity.mean(dim=(0, 1)).tolist()
    for mu_v, got in zip(mus, rad):
        expect = tau / (4 * math.pi * mu_v)
        sigma = expect / math.sqrt(tau * t.n_photons)
        print(f"anchor thin slab mu_v={mu_v}: I={got:.6g} first order "
              f"{expect:.6g} (tolerance {4 * sigma + 0.03 * expect:.3g})",
              flush=True)
        assert abs(got - expect) < 4 * sigma + 0.03 * expect, (mu_v, got)

    # clear atmosphere over a Lambertian surface: every photon reflects
    # once, so the domain mean is albedo / pi per unit incident flux on
    # the horizontal (albedo mu0 F0 / pi with F0 mu0 = 1), exactly up to
    # the slab's exp(-1e-6 / mu); 1e-3 covers float32 tally rounding
    albedo = 0.4
    dom = make_slab(tau=1e-6, ssa=1.0, nx=2, ny=2, nz=2, n_cdf_steps=101,
                    compute_intensity_tables=True, device="cuda")
    t = run_batch(dom, Surface.lambertian(albedo),
                  illumination.directional(0.7, 0.0), rng.batch_seed(0, 1),
                  KernelConfig(n_lanes=1 << 13, photons_per_lane=8,
                               max_steps=500),
                  intensity_config=le.IntensityConfig(
                      n_dirs=2, use_russian_roulette=False),
                  intensity_dirs=le.make_intensity_directions(
                      [1.0, 0.5], [0.0, 45.0], device="cuda"))
    assert t.n_bad == 0
    rad = t.normalized(dom.grid).intensity.mean(dim=(0, 1)).tolist()
    expect = albedo / math.pi
    print(f"anchor Lambertian surface: I={rad} expected {expect:.6g}",
          flush=True)
    for got in rad:
        assert abs(got / expect - 1.0) < 1e-3, (got, expect)


def _with_netcdf(text, name):
    return text.replace("&fileNames\n", "&fileNames\n  outputNetcdfFile = "
                        f"'{name}'\n")


def phase_radiance_deck(rk, cli):
    """The radiance decks through the CLI on cuda."""
    import numpy as np
    from scipy.io import netcdf_file

    deck = (ROOT / "run" / "step_cloud_radiance.nml").read_text()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            out, seconds, (_, launches, *_, walks, _) = _run_cli_deck(
                cli, rk, _with_netcdf(deck, "StepCloud_radiance.nc"))
            assert (tmp / "StepCloud_radiance.out").stat().st_size > 0
            with netcdf_file(str(tmp / "StepCloud_radiance.nc"), "r",
                             mmap=False) as nc:
                shape = nc.variables["intensity"].shape
                assert {"intensityMus", "intensityPhis",
                        "intensity_StdErr"} <= set(nc.variables)
        finally:
            os.chdir(cwd)
    n = out["total_photons"]
    rta = (out["mean_flux_up"], out["mean_flux_down"],
           out["mean_flux_absorbed"])
    rad, rad_se = out["mean_intensity"], out["mean_intensity_stderr"]
    print(f"radiance deck: {n} photons in {out['n_batches']} batches, "
          f"n_bad={out['n_bad']}, R/T/A={rta}, {seconds:.2f} s "
          f"({n / seconds:.4g} photons/s incl. setup and output), "
          f"{launches} radiance kernel launches, {walks} walk launches, "
          f"netCDF intensity {shape}", flush=True)
    print(f"radiance deck: domain-mean radiance {rad} +- {rad_se}; JAX "
          f"package {JAX_RADIANCE} +- {JAX_RADIANCE_SE}", flush=True)
    assert n == 8 * 262_144 and out["n_batches"] == 8
    assert out["n_bad"] == 0
    assert launches > 0, "the deck did not launch the radiance kernel"
    assert walks == launches, ("every radiance launch runs its walk kernel",
                               walks, launches)
    assert shape == (6, 1, 32), shape
    for got, want, name in zip(rta, GOLDEN_RTA, "RTA"):
        sigma = (max(want * (1 - want), 1e-8) / n) ** 0.5 + 8e-5
        assert abs(got - want) < 4.5 * sigma, (name, got, want, 4.5 * sigma)
    for d, (got, se, want, want_se) in enumerate(
            zip(rad, rad_se, JAX_RADIANCE, JAX_RADIANCE_SE)):
        sigma = (se ** 2 + want_se ** 2) ** 0.5
        assert abs(got - want) < 4.5 * sigma, (d, got, want, 4.5 * sigma)

    # the production 648-direction grid, chunked into 11 passes of <= 64
    deck = (ROOT / "run" / "step_cloud_radiance_648.nml").read_text()
    deck = deck.replace("numPhotonsPerBatch = 262144",
                        "numPhotonsPerBatch = 32768")
    deck = deck.replace("numBatches = 4", "numBatches = 2")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            out, seconds, (_, launches648, *_) = _run_cli_deck(
                cli, rk, _with_netcdf(deck, "StepCloud_radiance648.nc"))
            assert (tmp / "StepCloud_radiance648.out").stat().st_size > 0
            with netcdf_file(str(tmp / "StepCloud_radiance648.nc"), "r",
                             mmap=False) as nc:
                image = nc.variables["intensity"][:].T.copy()
        finally:
            os.chdir(cwd)
    print(f"648-direction deck: {out['total_photons']} photons, n_bad="
          f"{out['n_bad']}, image {image.shape}, {seconds:.2f} s, "
          f"{launches648} radiance kernel launches", flush=True)
    assert out["total_photons"] == 2 * 32_768 and launches648 > 0
    assert image.shape == (32, 1, 648), image.shape
    assert out["n_bad"] == 0
    means = image.mean(axis=(0, 1))
    assert np.isfinite(image).all() and (means > 0).all(), means.min()
    return launches, walks


def phase_radiance_headline(rk, le, config, make_step_cloud, Surface,
                            illumination, KernelConfig, rng):
    """One batch of the radiance deck's configuration (262,144 photons,
    hybrid table, roulette, file-read domain) at 6 and 64 directions:
    kernel and plain photons/s and ms per launch at the default 32 rows,
    and the kernel at 512 rows."""
    import dataclasses

    dom = make_step_cloud(ssa=0.99, n_legendre=512, macro_factor=8,
                          n_cdf_steps=10001, compute_intensity_tables=True,
                          hybrid_width_deg=7.0, device="cuda")
    dom = dataclasses.replace(dom, all_hg=False)  # as read from the file
    surface = Surface.lambertian(0.0)
    source = illumination.directional(0.5, 0.0)
    res = {}
    for n_dirs, deck in ((6, "step_cloud_radiance.nml"),
                         (64, "step_cloud_radiance_648.nml")):
        dirs = _deck_directions(config, le, deck, n_dirs)
        icfg = le.IntensityConfig(n_dirs=n_dirs)
        for name, n_lanes, ppl, launch, rows in (
                ("kernel", 131072, 2, rk.record_launch, rk.RADIANCE_ROWS),
                ("plain", 4096, 2, rk.record_launch_plain, rk.RADIANCE_ROWS),
                ("kernel512", 131072, 2, rk.record_launch, 512)):
            cfg = KernelConfig(n_lanes=n_lanes, photons_per_lane=ppl,
                               max_steps=100_000,
                               need_volume_absorption=False)

            def run(seed):
                return rk.run_batch_record_tallies(
                    dom, surface, source, seed, cfg, launch=launch,
                    intensity_config=icfg, intensity_dirs=dirs,
                    radiance_rows=rows)

            if name != "plain":  # warm-up batch
                run(rng.batch_seed(0, 98))
            # CUDA events around each launch (transport and walk) and
            # around each walk
            orig = (rk._launch_cuda, rk._walk_cuda)
            rk._launch_cuda, ev_launch = _event_timed(orig[0])
            rk._walk_cuda, ev_walk = _event_timed(orig[1])
            try:
                t, sec = _timed(lambda: run(rng.batch_seed(0, 1)))
            finally:
                rk._launch_cuda, rk._walk_cuda = orig
            _sync()
            assert t.n_bad == 0 and t.n_photons == n_lanes * ppl
            n_launch = t.n_steps // 128
            assert len(ev_walk) == len(ev_launch) == (
                0 if name == "plain" else n_launch)
            ev_ms = [sum(a.elapsed_time(b) for a, b in ev) / max(len(ev), 1)
                     for ev in (ev_launch, ev_walk)]
            res[(n_dirs, name)] = dict(
                event_ms_per_launch=ev_ms[0], walk_ms_per_launch=ev_ms[1],
                photons_per_s=t.n_photons / sec,
                ms_per_launch=1e3 * sec / n_launch, photons=t.n_photons,
                seconds=sec, launches=n_launch, rows=min(rows, 512),
                lane_steps=t.n_lane_steps, events=t.n_le_events,
                march=t.n_walk,
                # run_batch_record_tallies' radiance geometry
                n_lanes=128 * min(max(8, min(512, n_lanes // 128)), rows),
                table_bytes=4 * (dom.cell_records.numel() + 3 * n_dirs
                                 + 2 * rk.FWD_N_S
                                 * dom.tables.forward.shape[0]),
                tally_bytes=4 * (3 + n_dirs) * dom.grid.nx * dom.grid.ny)
            print(f"radiance headline {n_dirs} dirs {name}: {t.n_photons} "
                  f"photons in {sec:.3f} s = {t.n_photons / sec:.6g} "
                  f"photons/s, {n_launch} launches, "
                  f"{1e3 * sec / n_launch:.4f} ms/launch (CUDA events: "
                  f"transport and walk {ev_ms[0]:.4f}, walk {ev_ms[1]:.4f} "
                  "ms/launch), "
                  f"{t.n_le_events / t.n_photons:.2f} events and "
                  f"{t.n_walk / t.n_photons:.1f} march iterations per "
                  f"photon, R/T/A={_rta(t)}", flush=True)
    return res


# K1's first refill launch held against its plain twin: a batch of the main
# deck's 2^20 photons on the card's resident slots (about eight a slot),
# whose one launch of REFILL_STEPS steps starts and ends its photons as the
# deck's batches do
RECORD_FIRST_PHOTONS = 1 << 20
# Per column, of the photons a column, K1 against its plain twin on that
# launch: both follow the same paths, the twin sums each step's tallies in
# float64 (record_kernel.level_sums) and the kernel a block's share in
# shared memory, so float32 atomic order parts them; the twin's float32
# columns added lane by lane drifted ~2e-5 on the step cloud.
RECORD_COLUMN_TOL_KERNEL_VS_PLAIN = 1e-5


def _record_flux_timing(rk, label, dom, sfc, src, cfg, seed, table_bytes,
                        tally_bytes, extra_ops=None, sweep=False,
                        first=True):
    """``_flux_timing`` of a record-kernel flux path through
    run_batch_record_tallies (as run_batch runs it), on the batch of
    ``cfg``; with ``first``, the first refill launch of a batch of
    RECORD_FIRST_PHOTONS photons on the resident slots. Its bounds take
    40 bytes of state a slot and 300 operations a live lane-step."""
    vol = (cfg.need_volume_absorption or cfg.need_absorption_profile
           or cfg.lw_mode)
    prm = rk.RecordParams.make(dom, sfc, src, cfg.use_russian_roulette,
                               cfg.russian_roulette_weight, vol,
                               lw_mode=cfg.lw_mode)
    jax_cfg = rk.jax_geometry(cfg)

    def run(sd, sched, n_photons=None, launch=rk.record_launch):
        sched = {"refill": None, "jax": jax_cfg}.get(sched, sched)
        return rk.run_batch_record_tallies(dom, sfc, src, sd, cfg,
                                           n_photons=n_photons,
                                           launch=launch, rcfg=sched)

    def run_first(slots, launch):
        one = rk.RefillSchedule(rk.REFILL_STEPS, resident=slots)
        return run(seed, one, RECORD_FIRST_PHOTONS,
                   launch or rk.record_launch)

    return _flux_timing(
        rk, rk, label, "record_steps", rk.occupancy(prm), run,
        run_first if first else None, rk.record_launch_plain, cfg, seed,
        OPS_PER_LANE_STEP["record_kernel"], 40, table_bytes, tally_bytes,
        RECORD_COLUMN_TOL_KERNEL_VS_PLAIN, extra_ops=extra_ops, sweep=sweep)


def phase_headline(rk, make_step_cloud, Surface, illumination, KernelConfig,
                   rng):
    """The flux headline (macro_factor 16, 2^16 lanes x 1024 photons, flux
    tallies only) through run_batch_record_tallies: the A/B of the refill
    schedule and JAX's geometry, the launch-length and slot sweeps, the
    occupancy record, and the first refill launch of a 2^20-photon batch
    kernel against plain twin (``_record_flux_timing``); prints the
    ``headline kernel:`` (the refill batch, means of its two turns) and
    ``headline plain first launch:`` (the twin's first refill launch) lines
    that mcbrat3d_tpu_torch/tools/ab_headline.py reads."""
    dom = make_step_cloud(ssa=0.99, macro_factor=16, device="cuda")
    nxy = dom.grid.nx * dom.grid.ny
    cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=1024,
                       max_steps=1_600_000, need_volume_absorption=False)
    res = _record_flux_timing(
        rk, "flux headline", dom, Surface.lambertian(0.0),
        illumination.directional(0.5, 0.0), cfg, rng.batch_seed(0, 0),
        4 * dom.cell_records.numel(), 4 * 3 * nxy, sweep=True)
    r = res["ab"]["refill"]
    n_launch = int(round(r["launches"]))
    print(f"headline kernel: {cfg.photons_per_batch} photons in "
          f"{r['seconds']:.3f} s = {r['photons_per_s']:.6g} photons/s, "
          f"{n_launch} launches, {r['wall_ms_per_launch']:.4f} ms/launch, "
          f"R/T/A={res['ab']['turns']['refill'][0]['rta']}", flush=True)
    t, ms = res["first_tallies"], res["plain_ms_first"]
    print(f"headline plain first launch: {t.n_photons} photons in "
          f"{ms / 1e3:.3f} s = {t.n_photons / (ms / 1e3):.6g} photons/s, "
          f"1 launches, {ms:.4f} ms/launch", flush=True)
    return res


def _broken_cloud(broken_cloud_scene, build_domain, macro_factor,
                  n_cdf_steps):
    """The Landsat-class broken cloud (128 x 128 x 64, analytic HG) on the
    card."""
    grid, comps, _ = broken_cloud_scene(device="cuda")
    return build_domain(grid, comps, n_cdf_steps=n_cdf_steps,
                        macro_factor=macro_factor)


def phase_col_compare(ck, broken_cloud_scene, build_domain, Surface,
                      illumination, KernelConfig, rng):
    """Column kernel vs plain on the card, both on the refill schedule (the
    first case on the card's resident slots, the others on half the
    photons' count, so that every slot starts two photons in the kernel);
    returns the largest per-pixel difference of the normalized fluxes."""
    import dataclasses

    from mcbrat3d_tpu_torch.transport import record_kernel as rk

    sources = {"directional": illumination.directional(0.5, 0.0),
               "random_azimuth": illumination.random_azimuth(0.5),
               "flux": illumination.flux()}
    surface = Surface.lambertian(0.2)
    # (macro_factor, analytic HG, 3D tally, inverse-CDF steps, source,
    # roulette): every combination of the first three at macro 8; at macro
    # 0 two that still take each flag both ways (its long null-collision
    # tails keep the plain step ~60 s per case). The 10,001-step row
    # (80 KB) and the 20,001-step one (160 KB) would cost blocks an SM, so
    # the kernel reads them through __ldg. The last three rows take the
    # other two sources and roulette off, each a template flag of its own.
    cases = [(0, True, False, 10001), (0, False, True, 10001)]
    cases += [(8, analytic, vol, 10001) for analytic in (True, False)
              for vol in (False, True)]
    cases.append((8, False, False, 20001))
    cases = [c + ("directional", True) for c in cases]
    cases += [(8, True, False, 10001, "random_azimuth", True),
              (8, False, False, 10001, "flux", True),
              (8, True, True, 10001, "directional", False)]
    domains = {}
    max_err = 0.0
    for i, (mf, analytic, vol, n_cdf, src, rr) in enumerate(cases):
        if (mf, n_cdf) not in domains:
            domains[(mf, n_cdf)] = _broken_cloud(
                broken_cloud_scene, build_domain, mf, n_cdf)
        dom = domains[(mf, n_cdf)]
        if not analytic:  # as read from a file: the tabulated row
            dom = dataclasses.replace(dom, all_hg=False)
        ppl = 1 if mf == 0 else 2
        cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=ppl,
                           max_steps=400_000, need_volume_absorption=vol,
                           use_russian_roulette=rr)
        seed = rng.batch_seed(30, i)
        sched = (None if i == 0 else rk.RefillSchedule(
            cfg.max_steps, vol_tally=vol,
            resident=cfg.photons_per_batch // 2))

        def run(launch=ck.col_launch):
            return ck.run_batch_col_tallies(dom, surface, sources[src], seed,
                                            cfg, launch=launch, ccfg=sched)

        before = ck.COL_LAUNCHES
        tk, sk = _timed(run)
        assert ck.COL_LAUNCHES > before, "kernel was not launched"
        tk2 = run()
        assert (tk2.n_photons, tk2.n_bad) == (tk.n_photons, tk.n_bad)
        rerun = max(abs(float(a.sum()) / float(b.sum()) - 1.0)
                    for a, b in ((tk.flux_up, tk2.flux_up),
                                 (tk.flux_down, tk2.flux_down),
                                 (tk.flux_absorbed, tk2.flux_absorbed)))
        assert rerun < 1e-5, f"kernel reruns differ by {rerun:.2e}"
        tp, sp = _timed(lambda: run(ck.col_launch_plain))
        assert tk.n_photons == tp.n_photons == ppl << 16, (tk.n_photons,
                                                           tp.n_photons)
        assert tk.n_bad == 0 and tp.n_bad == 0, (tk.n_bad, tp.n_bad)
        assert tk.n_steps == tp.n_steps > 0, (tk.n_steps, tp.n_steps)
        assert tk.n_steps % rk.REFILL_STEPS == 0, tk.n_steps
        assert tk.n_lane_steps == tp.n_lane_steps, (tk.n_lane_steps,
                                                    tp.n_lane_steps)
        rta_k, rta_p = _rta(tk), _rta(tp)
        gap = max(abs(a - b) for a, b in zip(rta_k, rta_p))
        pairs = [(tk.flux_up, tp.flux_up), (tk.flux_down, tp.flux_down),
                 (tk.flux_absorbed, tp.flux_absorbed)]
        if vol:
            pairs.append((tk.volume_absorption, tp.volume_absorption))
        z_max, err = _pixel_z(pairs, tk.n_photons)
        max_err = max(max_err, err)
        # each tally's profile and 3D field sum to its column absorption
        for t in (tk, tp):
            total = float(t.flux_absorbed.double().sum())
            assert abs(float(t.absorption_profile.double().sum()) / total
                       - 1) < 1e-4
            if vol:
                assert abs(float(t.volume_absorption.double().sum())
                           / total - 1) < 1e-4
        prof_gap = float((tk.absorption_profile.double()
                          - tp.absorption_profile.double()).abs().max()
                         / tp.absorption_profile.double().abs().max())
        print(f"col compare macro={mf} analytic={analytic} vol={vol} "
              f"n_cdf={n_cdf} source={src} roulette={rr}: kernel "
              f"R/T/A={rta_k} plain={rta_p} "
              f"gap={gap:.3e} pixel z_max={z_max:.2f} pixel gap={err:.2e} "
              f"profile gap={prof_gap:.2e} rerun rel={rerun:.1e} "
              f"lane-steps {tk.n_lane_steps} / {tp.n_lane_steps}, launches "
              f"{tk.n_steps // rk.REFILL_STEPS} of {rk.REFILL_STEPS} steps, "
              f"kernel {sk:.3f} s plain {sp:.3f} s", flush=True)
        assert gap < RTA_TOL_KERNEL_VS_PLAIN, gap
        assert err < COL_PIXEL_TOL_KERNEL_VS_PLAIN, err
        assert prof_gap < COL_PROFILE_TOL_KERNEL_VS_PLAIN, prof_gap
        assert z_max < 5.0, z_max
    return max_err


def phase_landsat_deck(ck, rk, cli):
    """run/landsat_scale.nml through the CLI on cuda against the JAX
    package's frozen values."""
    import numpy as np
    from scipy.io import netcdf_file

    deck = (ROOT / "run" / "landsat_scale.nml").read_text()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            out, seconds, (rec_launches, _, launches, *_) = _run_cli_deck(
                cli, rk, deck, ck=ck,
                domain=("broken_cloud", "BrokenCloud.dom"))
            # the flux file's first data line: the domain means, each
            # followed by its standard error over batches
            with open(tmp / "landsat_flux.out") as f:
                means = [float(v) for v in next(
                    ln for ln in f if not ln.startswith("!")).split()]
            with netcdf_file(str(tmp / "landsat_results.nc"), "r",
                             mmap=False) as nc:
                prof = np.array(nc.variables["absorptionProfile"][:])
                dz = np.diff(np.array(nc.variables["z-Edges"][:],
                                      np.float64))
        finally:
            os.chdir(cwd)
    n = out["total_photons"]
    rta = (out["mean_flux_up"], out["mean_flux_down"],
           out["mean_flux_absorbed"])
    se = tuple(means[1::2])
    assert all(abs(a / b - 1) < 1e-6 for a, b in zip(means[0::2], rta))
    prof_total = float((prof * dz * 1000.0).sum())
    print(f"landsat deck: {n} photons in {out['n_batches']} batches, "
          f"n_bad={out['n_bad']}, R/T/A={rta} +- {se}, profile integral "
          f"{prof_total:.8f}, {seconds:.2f} s ({n / seconds:.4g} photons/s "
          f"incl. setup and output), {launches} column kernel launches; "
          f"JAX package {JAX_LANDSAT_RTA} +- {JAX_LANDSAT_RTA_SE}, profile "
          f"integral {JAX_LANDSAT_PROFILE_TOTAL:.8f}", flush=True)
    assert n == 16 * 1_048_576 and out["n_batches"] == 16
    assert out["n_bad"] == 0
    assert launches > 0 and rec_launches == 0, (launches, rec_launches)
    assert prof.shape == (64,) and np.isfinite(prof).all()
    # the profile integrates to the domain-mean absorption (one tally)
    assert abs(prof_total / rta[2] - 1.0) < 1e-4, (prof_total, rta[2])
    for got, got_se, want, want_se, name in zip(
            rta + (prof_total,), se + (se[2],),
            JAX_LANDSAT_RTA + (JAX_LANDSAT_PROFILE_TOTAL,),
            JAX_LANDSAT_RTA_SE + (JAX_LANDSAT_RTA_SE[2],),
            ("R", "T", "A", "profile")):
        sigma = (got_se ** 2 + want_se ** 2) ** 0.5
        assert abs(got - want) < 4.5 * sigma, (name, got, want, 4.5 * sigma)
    return launches


def _evented_batch(mod, run, seed, label):
    """One batch through ``run(seed)`` with CUDA events around every launch
    of ``mod``'s kernel (``mod._launch_cuda``): photons/s, launches, kernel
    and wall ms per launch, live lane-steps per launch and per photon, the
    card's busy share (kernel time over the batch's wall time) and the
    batch's ``n_steps``."""
    orig = mod._launch_cuda
    mod._launch_cuda, events = _event_timed(orig)
    try:
        t, sec = _timed(lambda: run(seed))
    finally:
        mod._launch_cuda = orig
    _sync()
    kernel_ms = sum(a.elapsed_time(b) for a, b in events)
    n = len(events)
    assert n > 0, f"{label}: the kernel was not launched"
    res = dict(photons_per_s=t.n_photons / sec, seconds=sec, launches=n,
               kernel_ms_per_launch=kernel_ms / n,
               wall_ms_per_launch=1e3 * sec / n,
               lane_steps=t.n_lane_steps,
               lane_steps_per_launch=t.n_lane_steps / n,
               lane_steps_per_photon=t.n_lane_steps / t.n_photons,
               busy=kernel_ms / (1e3 * sec), n_bad=t.n_bad,
               n_photons=t.n_photons, n_steps=t.n_steps, rta=_rta(t))
    print(f"{label}: {t.n_photons} photons in {sec:.4f} s = "
          f"{res['photons_per_s']:.6g} photons/s, {n} launches, kernel "
          f"{res['kernel_ms_per_launch']:.4f} ms/launch, wall "
          f"{res['wall_ms_per_launch']:.4f} ms/launch, busy share "
          f"{res['busy']:.3f}, {res['lane_steps_per_launch']:.6g} live "
          f"lane-steps/launch, {res['lane_steps_per_photon']:.2f}/photon, "
          f"n_bad {t.n_bad}, R/T/A={res['rta']}", flush=True)
    return t, res


def _occupancy_line(label, occ):
    """Print a kernel's occupancy record and return the thread slots the
    card holds resident for it."""
    resident = occ["blocks_per_sm"] * occ["threads"] * occ["n_sm"]
    print(f"{label} occupancy: {occ['blocks_per_sm']} blocks of "
          f"{occ['threads']} threads an SM x {occ['n_sm']} SMs = {resident} "
          f"resident threads, {occ['registers']} registers and "
          f"{occ['local_bytes']} spilled bytes a thread, {occ['smem']} B "
          f"dynamic shared memory a block", flush=True)
    return resident


# Slot counts of the refill schedule tried in 4c and 4d, as multiples of
# the card's resident threads
FLUX_SLOTS_SWEEP = (0.25, 0.5, 1.0, 2.0)


def _flux_ab(mod, rk, run, resident, seed, label, cfg, sweep=True):
    """The A/B of a transport kernel's flux schedules (K1, K3, K4) on the
    batch of ``cfg`` through ``run(seed, schedule)``, in turns refill, JAX,
    JAX, refill (the refill schedule as run_batch runs it, JAX's geometry
    ``rk.jax_geometry``); with ``sweep`` the refill schedule at
    STEPS_SWEEP steps a launch on the ``resident`` slots and at
    FLUX_SLOTS_SWEEP x resident slots. Each batch with CUDA events around
    every launch (``_evented_batch``), whose count must equal the batch's
    scheduled launches (its steps over its schedule's steps a launch):
    returns {"refill": mean, "jax": mean, "turns": ..., "tallies": the
    last refill turn's, "k_sweep": {k: photons/s}, "slot_sweep": {slots:
    photons/s}}."""
    def batch(sched, k, name):
        t, r = _evented_batch(mod, lambda sd: run(sd, sched), seed,
                              f"{label} [{name}]")
        assert r["n_steps"] == r["launches"] * k, (
            name, r["n_steps"], r["launches"], k)
        return t, r

    steps = {"refill": rk.REFILL_STEPS,
             "jax": rk.jax_geometry(cfg).steps_per_call}
    turns = {"refill": [], "jax": []}
    for name in ("refill", "jax", "jax", "refill"):
        t, r = batch(name, steps[name], f"{name} schedule")
        assert r["n_bad"] == 0, (name, r["n_bad"])
        turns[name].append(r)
    res = {name: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]
                  if k != "rta"} for name, rs in turns.items()}
    res.update(turns=turns, tallies=t)
    gain = res["refill"]["photons_per_s"] / res["jax"]["photons_per_s"]
    print(f"{label} A/B (means of two turns): refill "
          f"{res['refill']['photons_per_s']:.6g} photons/s, "
          f"{res['refill']['launches']:.1f} launches, kernel "
          f"{res['refill']['kernel_ms_per_launch']:.4f} ms/launch, busy "
          f"{res['refill']['busy']:.3f}; JAX's geometry "
          f"{res['jax']['photons_per_s']:.6g} photons/s, "
          f"{res['jax']['launches']:.1f} launches, kernel "
          f"{res['jax']['kernel_ms_per_launch']:.4f} ms/launch, busy "
          f"{res['jax']['busy']:.3f}; refill / JAX photons/s {gain:.3f}",
          flush=True)
    if not sweep:
        return res
    res["k_sweep"], res["slot_sweep"] = {}, {}
    for k in STEPS_SWEEP:
        sched = rk.RefillSchedule(cfg.max_steps, k_steps=k,
                                  resident=resident)
        _, r = batch(sched, k, f"refill, {k} steps a launch")
        res["k_sweep"][k] = r["photons_per_s"]
    for f in FLUX_SLOTS_SWEEP:
        slots = int(f * resident) // 128 * 128
        sched = rk.RefillSchedule(cfg.max_steps, resident=slots)
        _, r = batch(sched, rk.REFILL_STEPS, f"refill, {slots} slots")
        res["slot_sweep"][slots] = r["photons_per_s"]
    print(f"{label}, refill photons/s by steps a launch: "
          + ", ".join(f"{k}: {v:.6g}" for k, v in res["k_sweep"].items())
          + "; by slots: "
          + ", ".join(f"{k}: {v:.6g}" for k, v in res["slot_sweep"].items()),
          flush=True)
    return res


def _first_launch(mod, plain, run_one, column_tol, profile_tol=None):
    """Kernel and plain ms (CUDA events) of the refill schedule's first
    launch: ``run_one(launch)`` runs one launch of the same batch through
    ``launch`` (``mod``'s kernel, then ``plain``) and returns its tallies.
    The two are held equal in photons, steps, lane-steps and n_bad, with
    per-column fluxes (and a 3D field) within ``column_tol`` of the
    photons a column and, where the kernel tallies one (K3, K4), the z
    profile within ``profile_tol`` of its largest level. Returns the two
    ms and the kernel's tallies."""
    out, tallies = {}, {}
    for name, fn in (("kernel", mod._launch_cuda), ("plain", plain)):
        timed, ev = _event_timed(fn)
        if name == "kernel":
            mod._launch_cuda = timed
            try:
                tallies[name] = run_one(None)
            finally:
                mod._launch_cuda = fn
        else:
            tallies[name] = run_one(timed)
        _sync()
        assert len(ev) == 1, (name, len(ev))
        out[f"{name}_ms_first"] = ev[0][0].elapsed_time(ev[0][1])
    tk, tp = tallies["kernel"], tallies["plain"]
    counts = [(t.n_photons, t.n_steps, t.n_lane_steps, t.n_bad)
              for t in (tk, tp)]
    assert counts[0] == counts[1], counts
    pairs = [(tk.flux_up, tp.flux_up), (tk.flux_down, tp.flux_down),
             (tk.flux_absorbed, tp.flux_absorbed)]
    if tk.volume_absorption is not None:
        pairs.append((tk.volume_absorption, tp.volume_absorption))
    _, err = _pixel_z(pairs, tk.n_photons)
    out["tallies"] = tk
    if tk.absorption_profile is None:
        print(f"first launch kernel vs plain: photons, steps, lane-steps, "
              f"n_bad {counts[0]}; column gap {err:.2e}; real collisions "
              f"{tk.n_real}/{tp.n_real}", flush=True)
        assert err < column_tol, err
        return out
    prof_gap = float((tk.absorption_profile.double()
                      - tp.absorption_profile.double()).abs().max()
                     / tp.absorption_profile.double().abs().max())
    # each profile's total against its column absorption's (float64 sums
    # of the columns, whose float32 tallies stay small)
    sums = [abs(float(t.absorption_profile.double().sum())
                - float(t.flux_absorbed.double().sum()))
            / float(t.flux_absorbed.double().abs().sum()) for t in (tk, tp)]
    print(f"first launch kernel vs plain: photons, steps, lane-steps, "
          f"n_bad {counts[0]}; column gap {err:.2e}, profile gap "
          f"{prof_gap:.2e}; profile total against the columns' kernel "
          f"{sums[0]:.2e} plain {sums[1]:.2e}", flush=True)
    assert err < column_tol, err
    assert prof_gap < profile_tol, prof_gap
    return out


def _flux_timing(mod, rk, label, kernel, occ, run, run_first, plain, cfg,
                 seed, ops_per_step, state_bytes, table_bytes, tally_bytes,
                 column_tol, profile_tol=None, extra_ops=None, sweep=False):
    """A transport kernel's flux path through its run_batch entry, shared by
    K1, K3 and K4: the occupancy record ``occ`` of its instantiation
    ``kernel``; the A/B of the refill schedule and JAX's geometry in turns
    (``_flux_ab`` on ``run(seed, schedule)``, with ``sweep`` the
    launch-length and slot sweeps) on the batch of ``cfg``, every turn of
    its photons; the bound of the refill schedule's mean launch; with
    ``run_first``, its first launch on the resident slots, kernel against
    ``plain`` twin (``_first_launch`` on ``run_first(slots, launch)``),
    and the bound of that launch. A bound takes the slots' ``state_bytes``
    read and written once, ``table_bytes`` read and ``tally_bytes``
    written once, ``ops_per_step`` operations a live lane-step and
    ``extra_ops(tallies)``, the operations the kernel counts besides its
    steps."""
    slots = _occupancy_line(f"{label} ({kernel})", occ)

    def bound(t, lane_steps, n_launch):
        return _bound(lane_steps, n_launch, ops_per_step, slots, state_bytes,
                      table_bytes, tally_bytes,
                      extra_ops=extra_ops(t) if extra_ops else 0)

    for name in ("refill", "jax"):  # warm-up batches
        run((seed + 1) & 0xFFFF_FFFF, name)
    ab = _flux_ab(mod, rk, run, slots, seed, label, cfg, sweep=sweep)
    for rt in ab["turns"]["refill"] + ab["turns"]["jax"]:
        assert rt["n_photons"] == cfg.photons_per_batch, rt["n_photons"]
    r, j, t = ab["refill"], ab["jax"], ab["tallies"]
    out = dict(ab=ab, occupancy=occ, slots=slots, tallies=t,
               kernel_ms_per_launch=r["kernel_ms_per_launch"],
               launches_per_batch=r["launches"], busy=r["busy"],
               photons_per_s=r["photons_per_s"],
               jax_kernel_ms_per_launch=j["kernel_ms_per_launch"],
               jax_launches_per_batch=j["launches"],
               bound=bound(t, r["lane_steps"], r["launches"]))
    print(f"{label}: refill kernel {r['kernel_ms_per_launch']:.4f} "
          f"ms/launch of {rk.REFILL_STEPS} steps on {slots} slots (bound "
          f"{out['bound'][0]:.4f} ms by {out['bound'][1]}), "
          f"{r['launches']:.1f} launches a batch, busy share "
          f"{r['busy']:.3f}, {r['lane_steps_per_photon']:.2f} live "
          f"lane-steps per photon; JAX's geometry "
          f"{j['kernel_ms_per_launch']:.4f} ms/launch of "
          f"{rk.jax_geometry(cfg).steps_per_call} steps, "
          f"{j['launches']:.1f} launches, busy share {j['busy']:.3f}",
          flush=True)
    if run_first is None:
        return out
    first = _first_launch(mod, plain, lambda launch: run_first(slots, launch),
                          column_tol, profile_tol)
    ft = first.pop("tallies")
    out.update(first, first_tallies=ft,
               plain_ms_per_launch=first["plain_ms_first"],
               bound_first=bound(ft, ft.n_lane_steps, 1))
    print(f"{label}, first refill launch ({ft.n_photons} photons, "
          f"{slots} slots, {ft.n_lane_steps / ft.n_photons:.2f} live "
          f"lane-steps per photon): kernel {out['kernel_ms_first']:.4f} ms "
          f"(bound {out['bound_first'][0]:.4f} ms by "
          f"{out['bound_first'][1]}), plain {out['plain_ms_first']:.4f} ms",
          flush=True)
    return out


def phase_col_headline(ck, broken_cloud_scene, build_domain, Surface,
                       illumination, KernelConfig, rng):
    """The Landsat headline of bench.py:497-545 (2^20 photons, through
    run_batch_col_tallies): ``_col_flux_timing`` with the launch-length
    and slot sweeps."""
    dom = _broken_cloud(broken_cloud_scene, build_domain, 8, 201)
    cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=16,
                       max_steps=400_000, need_volume_absorption=False)
    nxy, nz = dom.grid.nx * dom.grid.ny, dom.grid.nz
    res = _col_flux_timing(
        ck, "landsat headline", dom, Surface.lambertian(0.2),
        illumination.directional(0.5, 0.0), cfg, rng.batch_seed(0, 0),
        OPS_PER_LANE_STEP["col_kernel"],
        4 * (2 * nxy + 2 * dom.macro_table.shape[0]), 4 * (3 * nxy + nz),
        sweep=True)
    assert res["tallies"].volume_absorption is None
    return res


def _gas_broken_cloud(m, macro_factor=8, n_cdf_steps=201, tables=False,
                      n=128):
    """broken_cloud_scene() (n x n x 64, n = 128 its full width) plus one
    horizontally uniform pure absorber, q(z) = 2.5e-4 m^-1 exp(-z_c /
    2000 m) at the cell centres (a vertical optical depth of ~0.24): the
    gas template, on the card; with ``tables`` the radiance tables
    (hybrid, 10 degrees)."""
    import numpy as np

    grid, comps, _ = m.broken_cloud_scene(nx=n, ny=n, device="cuda")
    nz = grid.nz
    q = (2.5e-4 * np.exp(-(np.arange(nz) + 0.5) * 20.0 / 2000.0)).reshape(
        1, 1, nz)
    gas = m.OpticalComponent(
        "gas absorber", q, np.zeros_like(q), np.zeros(q.shape, np.int32),
        m.PhaseFunctionTable([m.PhaseFunction.isotropic()], key=[1.0]))
    dom = m.build_domain(grid, [comps[0], gas], macro_factor=macro_factor,
                         n_cdf_steps=n_cdf_steps,
                         compute_intensity_tables=tables,
                         hybrid_width_deg=10.0 if tables else 0.0)
    assert dom.col_template and dom.col_qz is not None
    return dom


def _radiance_cloud(m, tables=True):
    """bench.py:530-535's domain: the broken cloud with analytic HG, macro
    8, 201 CDF steps and (``tables``) the hybrid radiance tables."""
    grid, comps, _ = m.broken_cloud_scene(device="cuda")
    return m.build_domain(grid, comps, macro_factor=8, n_cdf_steps=201,
                          compute_intensity_tables=tables,
                          hybrid_width_deg=10.0 if tables else 0.0)


def _total_and_pixel_gaps(pairs):
    """Largest relative gap of the totals and, over pixels with signal
    (above 1e-3 of the pair's largest), the largest relative gap."""
    total = pixel = 0.0
    for a, b in pairs:
        a, b = a.double().cpu(), b.double().cpu()
        total = max(total, abs(float(a.sum()) / float(b.sum()) - 1.0))
        sig = b.abs() > 1e-3 * float(b.abs().max())
        if bool(sig.any()):
            pixel = max(pixel, float(((a - b).abs() / b.abs())[sig].max()))
    return total, pixel


def phase_col_le_compare(ck, le, m, KernelConfig, rng):
    """The column kernel's gas template and local estimate vs the plain
    step on the card (flux runs on the refill schedule, two photons a
    slot); returns the largest per-pixel differences of the normalized
    fluxes (gas cases) and images (radiance cases)."""
    import dataclasses

    from mcbrat3d_tpu_torch.transport import record_kernel as rk

    surface = m.Surface.lambertian(0.2)
    sources = {"directional": m.illumination.directional(0.5, 30.0),
               "random_azimuth": m.illumination.random_azimuth(0.6),
               "flux": m.illumination.flux()}
    phis8 = [20.0, 70.0, 110.0, 160.0, 200.0, 250.0, 290.0, 340.0]
    dirs8 = ([1.0, 0.8, 0.6, 0.45, 0.8, 0.6, 0.45, 0.7], phis8)
    # the same with one direction at the floor mu 0.4 (the longest walks)
    dirs8_floor = ([1.0, 0.8, 0.6, 0.4, 0.8, 0.6, 0.45, 0.7], phis8)
    # (name, gas, radiance tables, tabulated scattering, 3D tally, source,
    # directions (None: flux only), roulette of the estimate, hybrid row)
    cases = [
        ("gas flux, HG", True, False, False, False, "directional", None,
         None, None),
        ("gas flux, table, 3D tally", True, False, True, True, "flux", None,
         None, None),
        ("hybrid row, roulette", False, True, False, False, "directional",
         (MUS16, PHIS16), True, True),
        ("gas, analytic HG, exact, 3D tally", True, False, False, True,
         "flux", dirs8_floor, False, True),
        ("original row, table, roulette", False, True, True, False,
         "random_azimuth", dirs8, True, False),
    ]
    domains = {}
    flux_err = img_err = 0.0
    for i, (name, gas, tables, table_row, vol, src, dirs_mp, rr,
            hybrid) in enumerate(cases):
        key = (gas, tables)
        if key not in domains:
            domains[key] = (_gas_broken_cloud(m, tables=tables) if gas
                            else _radiance_cloud(m, tables=tables))
        dom = domains[key]
        if table_row:  # as read from a file: the tabulated row
            dom = dataclasses.replace(dom, all_hg=False,
                                      col_analytic_hg=False)
        seed = rng.batch_seed(31, i)
        if dirs_mp is None:
            cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=1,
                               max_steps=400_000, need_volume_absorption=vol)
            icfg = dirs = None
        else:  # the plain walk takes ~3-4 s per 1,024 photons on the card
            cfg = KernelConfig(n_lanes=1 << 12, photons_per_lane=2,
                               max_steps=400_000, need_volume_absorption=vol)
            icfg = le.IntensityConfig(n_dirs=len(dirs_mp[0]),
                                      use_russian_roulette=rr,
                                      use_hybrid_phase=hybrid,
                                      pallas_min_mu=0.4)
            dirs = le.make_intensity_directions(*dirs_mp, device="cuda")

        # flux runs: the refill schedule on half the photons' count of
        # slots (two photons a slot, started in the kernel)
        sched = (rk.RefillSchedule(cfg.max_steps, vol_tally=vol,
                                   resident=cfg.photons_per_batch // 2)
                 if icfg is None else None)

        def run(launch=ck.col_launch):
            return ck.run_batch_col_tallies(
                dom, surface, sources[src], seed, cfg, launch=launch,
                intensity_config=icfg, intensity_dirs=dirs, ccfg=sched)

        before = (ck.COL_LAUNCHES, ck.COL_LE_LAUNCHES)
        tk, sk = _timed(run)
        assert ck.COL_LAUNCHES > before[0], "kernel was not launched"
        assert (ck.COL_LE_LAUNCHES > before[1]) == (icfg is not None)
        tp, sp = _timed(lambda: run(ck.col_launch_plain))
        n = tk.n_photons
        assert n == tp.n_photons == cfg.photons_per_batch, (n, tp.n_photons)
        assert tk.n_bad == tp.n_bad == 0, (tk.n_bad, tp.n_bad)
        assert tk.n_steps == tp.n_steps > 0, (tk.n_steps, tp.n_steps)
        assert tk.n_lane_steps == tp.n_lane_steps, (tk.n_lane_steps,
                                                    tp.n_lane_steps)
        assert tk.n_le_events == tp.n_le_events, (tk.n_le_events,
                                                  tp.n_le_events)
        assert tk.n_walk == tp.n_walk, (tk.n_walk, tp.n_walk)
        pairs = [(tk.flux_up, tp.flux_up), (tk.flux_down, tp.flux_down),
                 (tk.flux_absorbed, tp.flux_absorbed),
                 (tk.absorption_profile, tp.absorption_profile)]
        if vol:
            pairs.append((tk.volume_absorption, tp.volume_absorption))
        total, pixel = _total_and_pixel_gaps(pairs)
        per_col = n / tk.flux_up.numel()
        err = max(float((a.double() - b.double()).abs().max()) / per_col
                  for a, b in pairs[:3])
        flux_err = max(flux_err, err) if gas else flux_err
        line = (f"col LE compare [{name}]: photons {n}, lane-steps "
                f"{tk.n_lane_steps}/{tp.n_lane_steps}, events "
                f"{tk.n_le_events}/{tp.n_le_events}, walk iterations "
                f"{tk.n_walk}/{tp.n_walk}, flux total gap {total:.2e}, "
                f"pixel gap {pixel:.2e}, column gap {err:.2e}")
        if icfg is not None:
            assert tk.n_cut == tp.n_cut == 0 and tk.n_le_events > 0
            assert tk.intensity.shape == (128, 128, icfg.n_dirs)
            img_pairs = [(tk.intensity[:, :, d], tp.intensity[:, :, d])
                         for d in range(icfg.n_dirs)]
            i_total, i_pixel = _total_and_pixel_gaps(img_pairs)
            i_err = float((tk.intensity.double() - tp.intensity.double())
                          .abs().max()) / per_col
            img_err = max(img_err, i_err)
            total, pixel = max(total, i_total), max(pixel, i_pixel)
            means = (tk.intensity.sum(dim=(0, 1)) / n).tolist()
            line += (f"; image total gap {i_total:.2e}, pixel gap "
                     f"{i_pixel:.2e}, largest normalized pixel difference "
                     f"{i_err:.2e}, domain-mean radiance "
                     f"{[round(v, 6) for v in means]}")
        print(line + f"; kernel {sk:.3f} s plain {sp:.3f} s", flush=True)
        assert total < COL_LE_TOTAL_TOL_KERNEL_VS_PLAIN, total
        assert pixel < COL_LE_PIXEL_TOL_KERNEL_VS_PLAIN, pixel
    print(f"col LE compare: largest normalized flux difference "
          f"{flux_err:.3e} (gas), image {img_err:.3e}", flush=True)
    return flux_err, img_err


def _within_sigma(got, got_se, want, want_se, names):
    """Largest |got - want| in combined sigma; asserts each below 4.5 and
    prints the three largest. Where the reference is exactly 0 with no
    spread (a level without an absorber), the port must be 0 too."""
    gaps = []
    for g, gs, w, ws, name in zip(got, got_se, want, want_se, names):
        if w == 0.0 and ws == 0.0:
            assert g == 0.0, (name, g)
            continue
        z = abs(g - w) / (gs ** 2 + ws ** 2) ** 0.5
        assert z < 4.5, (name, g, w, z)
        gaps.append((z, name, g, w))
    gaps.sort(reverse=True)
    print("  largest gaps (sigma, name, port, reference): "
          + "; ".join(f"{z:.2f} {n} {g:.6g} {w:.6g}"
                      for z, n, g, w in gaps[:3]), flush=True)
    return gaps[0][0] if gaps else 0.0


def phase_landsat_radiance_deck(ck, rk, cli):
    """run/landsat_radiance.nml through the CLI on cuda against the JAX
    package's frozen values."""
    import numpy as np
    from scipy.io import netcdf_file

    deck = (ROOT / "run" / "landsat_radiance.nml").read_text()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            out, seconds, launches = _run_cli_deck(
                cli, rk, deck, ck=ck,
                domain=("broken_cloud", "BrokenCloud.dom"))
            means, se, _ = _flux_file_means(tmp / "landsat_radiance_flux.out")
            assert (tmp / "landsat_radiance.out").stat().st_size > 0
            with netcdf_file(str(tmp / "landsat_radiance.nc"), "r",
                             mmap=False) as nc:
                shape = nc.variables["intensity"].shape
                prof = np.array(nc.variables["absorptionProfile"][:])
                dz = np.diff(np.array(nc.variables["z-Edges"][:],
                                      np.float64))
        finally:
            os.chdir(cwd)
    n = out["total_photons"]
    rta = (out["mean_flux_up"], out["mean_flux_down"],
           out["mean_flux_absorbed"])
    rad, rad_se = out["mean_intensity"], out["mean_intensity_stderr"]
    prof_total = float((prof * dz * 1000.0).sum())
    transport = out["elapsed_seconds"]
    got = rta + (prof_total,) + tuple(rad)
    got_se = se + (se[2],) + tuple(rad_se)
    worst = _within_sigma(
        got, got_se, JAX_LANDSAT_RAD, JAX_LANDSAT_RAD_SE,
        ["R", "T", "A", "profile"] + [f"radiance {d}" for d in range(16)])
    print(f"landsat radiance deck: {n} photons in {out['n_batches']} "
          f"batches, n_bad={out['n_bad']}, R/T/A={rta} +- {se}, profile "
          f"integral {prof_total:.8f}, domain-mean radiance "
          f"{[round(v, 6) for v in rad]} +- "
          f"{[float(f'{v:.3g}') for v in rad_se]}; {seconds:.2f} s of CLI "
          f"(setup and output {seconds - transport:.2f} s, transport "
          f"{transport:.2f} s), launches record/column/column radiance/"
          f"column walk ({launches[0]}, {launches[2]}, {launches[6]}, "
          f"{launches[8]}), image {shape}; "
          f"largest gap to the JAX package {worst:.2f} combined sigma",
          flush=True)
    assert n == 8 * 262_144 and out["n_batches"] == 8
    assert out["n_bad"] == 0
    assert launches[6] > 0 and launches[6] == launches[2], launches
    assert launches[8] == launches[6], launches  # a walk after each launch
    assert launches[0] == launches[3] == launches[4] == 0, launches
    assert shape == (16, 128, 128), shape
    assert abs(prof_total / rta[2] - 1.0) < 1e-4, (prof_total, rta[2])
    return dict(launches=launches[6], walk_launches=launches[8],
                seconds=seconds, transport=transport)


def _col_flux_timing(ck, label, dom, sfc, src, cfg, seed, ops_per_step,
                     table_bytes, tally_bytes, extra_ops=None, sweep=False):
    """``_flux_timing`` of a column-kernel flux path through
    run_batch_col_tallies (as run_batch runs it), on the batch of ``cfg``,
    with the first refill launch of that batch on the resident slots. Its
    bounds take 44 bytes of state a slot."""
    from mcbrat3d_tpu_torch.transport import record_kernel as rk

    vol = cfg.need_volume_absorption
    prm = ck.ColParams.make(dom, sfc, src, cfg.use_russian_roulette,
                            cfg.russian_roulette_weight, vol,
                            lw_mode=cfg.lw_mode)
    jax_cfg = rk.jax_geometry(cfg)

    def run(sd, sched):
        sched = {"refill": None, "jax": jax_cfg}.get(sched, sched)
        return ck.run_batch_col_tallies(dom, sfc, src, sd, cfg, ccfg=sched)

    def run_first(slots, launch):
        one = rk.RefillSchedule(rk.REFILL_STEPS, vol_tally=vol,
                                resident=slots)
        return ck.run_batch_col(dom, sfc, src, seed, one,
                                n_photons=cfg.photons_per_batch,
                                launch=launch or ck.col_launch,
                                lw_mode=cfg.lw_mode)

    return _flux_timing(
        ck, rk, label, "col_steps", ck.occupancy(prm), run, run_first,
        ck.col_launch_plain, cfg, seed, ops_per_step, 44, table_bytes,
        tally_bytes, COL_PIXEL_TOL_KERNEL_VS_PLAIN,
        COL_PROFILE_TOL_KERNEL_VS_PLAIN, extra_ops=extra_ops, sweep=sweep)


def phase_gas(ck, rk, m, le, KernelConfig, run_batch, rng):
    """The gas template at full width through run_batch: flux and
    16-direction radiance against the JAX package's frozen values, the
    column kernel only; the same cut to 32 x 32 x 64 with the eight
    distinct directions against both JAX estimators; then the gas flux
    path's ms per launch (CUDA events, 2^16 lanes x 16 photons) and the
    plain step's."""
    import dataclasses

    import numpy as np

    dom = _gas_broken_cloud(m)
    mid = _gas_broken_cloud(m, n=32)
    surface = m.Surface.lambertian(0.2)
    source = m.illumination.directional(0.5, 0.0)
    icfg = le.IntensityConfig(n_dirs=16, use_russian_roulette=True,
                              use_hybrid_phase=True, pallas_min_mu=0.4)
    dirs = le.make_intensity_directions(MUS16, PHIS16, device="cuda")
    icfg8 = dataclasses.replace(icfg, n_dirs=8)
    dirs8 = le.make_intensity_directions(MUS16[:8], PHIS16[:8],
                                         device="cuda")
    plain_runs = []
    plain = ck.col_launch_plain

    def counting(*args, **kwargs):
        plain_runs.append(1)
        return plain(*args, **kwargs)

    ck.col_launch_plain = counting
    rk.LAUNCHES = ck.COL_LAUNCHES = ck.COL_LE_LAUNCHES = 0
    res = {}
    t0 = time.perf_counter()
    try:
        rad_cfg = KernelConfig(n_lanes=1 << 13, photons_per_lane=64,
                               max_steps=400_000,
                               need_volume_absorption=False)
        for name, d, cfg, ic, di, n_batches in (
                ("flux", dom, KernelConfig(n_lanes=1 << 16,
                                           photons_per_lane=16,
                                           max_steps=400_000,
                                           need_volume_absorption=False,
                                           need_absorption_profile=True),
                 None, None, 8),
                ("radiance", dom, rad_cfg, icfg, dirs, 4),
                ("mid", mid, rad_cfg, icfg8, dirs8, 8)):
            rows = []
            for b in range(n_batches):
                t = run_batch(d, surface, source, rng.batch_seed(7, b),
                              cfg, intensity_config=ic, intensity_dirs=di)
                assert t.n_bad == 0 and t.n_photons == cfg.photons_per_batch
                row = list(_rta(t))
                if ic is not None:
                    assert t.intensity.shape == d.grid.shape[:2] + (
                        ic.n_dirs,)
                    row += (t.intensity.double().sum(dim=(0, 1))
                            / t.n_photons).tolist()
                rows.append(row)
            a = np.asarray(rows)
            res[name] = (a.mean(axis=0), a.std(axis=0, ddof=1)
                         / np.sqrt(len(rows)))
    finally:
        ck.col_launch_plain = plain
    seconds = time.perf_counter() - t0
    launches = (rk.LAUNCHES, ck.COL_LAUNCHES, ck.COL_LE_LAUNCHES)
    assert not plain_runs, "the gas runs ran a plain step"
    assert launches[0] == 0 and launches[1] > launches[2] > 0, launches
    worst = _within_sigma(res["flux"][0], res["flux"][1], JAX_GAS_FLUX,
                          JAX_GAS_FLUX_SE, "RTA")
    worst = max(worst, _within_sigma(
        res["radiance"][0], res["radiance"][1], JAX_GAS_RAD, JAX_GAS_RAD_SE,
        ["R", "T", "A"] + [f"radiance {d}" for d in range(16)]))
    names8 = ["R", "T", "A"] + [f"radiance mu {mu}" for mu in MUS16[:8]]
    mid_z = [_within_sigma(res["mid"][0], res["mid"][1], want, want_se,
                           names8)
             for want, want_se in ((JAX_GAS_MID_XLA, JAX_GAS_MID_XLA_SE),
                                   (JAX_GAS_MID_K3, JAX_GAS_MID_K3_SE))]
    print(f"gas template: flux R/T/A={res['flux'][0].tolist()} +- "
          f"{res['flux'][1].tolist()} (8 x 2^20 photons), radiance run "
          f"R/T/A and radiances {res['radiance'][0].round(6).tolist()} +- "
          f"{res['radiance'][1].round(7).tolist()} (4 x 2^19 photons), "
          f"{seconds:.2f} s, launches record/column/column radiance "
          f"{launches}; largest gap to the JAX package {worst:.2f} "
          f"combined sigma", flush=True)
    print(f"gas template at 32 x 32 x 64: R/T/A and radiances "
          f"{res['mid'][0].round(6).tolist()} +- "
          f"{res['mid'][1].round(7).tolist()} (8 x 2^19 photons); largest "
          f"gap to JAX's XLA estimator {mid_z[0]:.2f}, to its column "
          f"kernel {mid_z[1]:.2f} combined sigma", flush=True)
    # the gas flux path's times (the Landsat headline's batch, 2^20)
    cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=16,
                       max_steps=400_000, need_volume_absorption=False)
    nxy, nz = dom.grid.nx * dom.grid.ny, dom.grid.nz
    out = _col_flux_timing(
        ck, "gas flux path", dom, surface, source, cfg,
        rng.batch_seed(0, 0),
        OPS_PER_LANE_STEP["col_kernel"] + OPS_PER_GAS_STEP,
        4 * (2 * nxy + 2 * dom.macro_table.shape[0] + 2 * nz),
        4 * (3 * nxy + nz))
    out.update(launches=launches[1], seconds=seconds)
    return out


def phase_col_le_headline(ck, rk, le, m, KernelConfig, run_batch, rng):
    """bench.py:547-573's landsat_radiance_16dir through run_batch: the
    column kernel's local-estimate ms per launch (CUDA events), launches
    per batch, the card's busy share, photons/s; plain ms of one launch
    at the same lanes."""
    dom = _radiance_cloud(m)
    surface = m.Surface.lambertian(0.2)
    source = m.illumination.directional(0.5, 0.0)
    icfg = le.IntensityConfig(n_dirs=16, use_russian_roulette=True,
                              use_hybrid_phase=True, pallas_min_mu=0.4)
    dirs = le.make_intensity_directions(MUS16, PHIS16, device="cuda")
    cfg = KernelConfig(n_lanes=1 << 13, photons_per_lane=256,
                       max_steps=400_000, need_volume_absorption=False)
    run_batch(dom, surface, source, rng.batch_seed(5, 99), cfg,
              n_photons=1 << 14, intensity_config=icfg,
              intensity_dirs=dirs)  # warm-up
    orig = (ck._launch_cuda, ck._walk_cuda)
    ck._launch_cuda, events = _event_timed(orig[0])
    ck._walk_cuda, walk_events = _event_timed(orig[1])
    try:
        t, sec = _timed(lambda: run_batch(
            dom, surface, source, rng.batch_seed(5, 0), cfg,
            intensity_config=icfg, intensity_dirs=dirs))
    finally:
        ck._launch_cuda, ck._walk_cuda = orig
    _sync()
    kernel_ms = sum(a.elapsed_time(b) for a, b in events)
    walk_ms = sum(a.elapsed_time(b) for a, b in walk_events)
    n_launch = len(events)
    assert len(walk_events) == n_launch
    assert n_launch == t.n_steps // 128 > 0 and t.n_bad == 0
    assert t.n_photons == cfg.photons_per_batch
    assert t.intensity.shape == (128, 128, 16)
    nxy, nz = dom.grid.nx * dom.grid.ny, dom.grid.nz
    res = dict(photons_per_s=t.n_photons / sec, seconds=sec,
               launches=n_launch, kernel_ms_per_launch=kernel_ms / n_launch,
               walk_ms_per_launch=walk_ms / n_launch,
               wall_ms_per_launch=1e3 * sec / n_launch,
               busy=kernel_ms / (1e3 * sec), lane_steps=t.n_lane_steps,
               events=t.n_le_events, walk=t.n_walk)
    # per launch: 4,096 lanes' state read and written once; the column
    # fields, A and B, the block table, the forward row and the directions
    # read once; the tallies and the image written once
    res["bound"] = _bound(
        t.n_lane_steps, n_launch, OPS_PER_LANE_STEP["col_kernel"], 1 << 12,
        44, 4 * (4 * nxy + 2 * dom.macro_table.shape[0]
                 + 2 * rk.FWD_N_S + 4 * 16),
        4 * (3 * nxy + nz + 16 * nxy),
        extra_ops=(t.n_walk * OPS_PER_WALK_ITERATION
                   + t.n_le_events * 16 * OPS_PER_LE_DIRECTION))
    print(f"landsat radiance headline (run_batch, 16 directions): "
          f"{t.n_photons} photons in {sec:.3f} s = "
          f"{res['photons_per_s']:.6g} photons/s, {n_launch} launches, "
          f"kernel {res['kernel_ms_per_launch']:.4f} ms/launch (bound "
          f"{res['bound'][0]:.4f} ms by {res['bound'][1]}; the walk "
          f"{res['walk_ms_per_launch']:.4f} ms of it), wall "
          f"{res['wall_ms_per_launch']:.4f} ms/launch, busy share "
          f"{res['busy']:.3f}, {t.n_lane_steps / t.n_photons:.2f} live "
          f"lane-steps, {t.n_le_events / t.n_photons:.2f} events and "
          f"{t.n_walk / t.n_photons:.1f} walk iterations per photon, "
          f"R/T/A={_rta(t)}", flush=True)
    plain, ev = _event_timed(ck.col_launch_plain)
    ck.run_batch_col(dom, surface, source, rng.batch_seed(5, 1),
                     rk.RecordConfig(rows=32, max_steps=128,
                                     vol_tally=False), 512,
                     launch=plain, intensity_config=icfg,
                     intensity_dirs=dirs)
    _sync()
    res["plain_ms_per_launch"] = sum(a.elapsed_time(b)
                                     for a, b in ev) / len(ev)
    print(f"landsat radiance headline: plain "
          f"{res['plain_ms_per_launch']:.4f} ms/launch over {len(ev)} "
          "launches", flush=True)
    return res


# ---------------------------------------------------------------------------
# The walk kernels (K3-d and K2 redesigned: the transport queues its events,
# col_walk and record_walk compute every (event, direction) pair): phase 2k
# ---------------------------------------------------------------------------

# Walk kernel vs its plain twin on one captured event buffer: the same
# pairs, so equal walk (march) iterations and cuts, and each direction's
# image total within float32 atomic order.
WALK_TOTAL_TOL_KERNEL_VS_PLAIN = 1e-5
# ... and each pixel within this share of its direction's largest pixel
# (of its cap section, for K2): float32 atomic order moves a pixel by at
# most 2.9e-6 of that (H100), and a contribution tallied at a wrong exit
# pixel moves its pixel and a neighbour by a whole share of the image.
WALK_PIXEL_TOL_KERNEL_VS_PLAIN = 1e-4
# Launches of a captured case: the second launch's queue is captured (the
# first starts every lane at once).
WALK_CAPTURE_LAUNCHES = 2
# Walk launches timed, the median kept.
WALK_TIMING_REPS = 5


def _capture_queue(kern, prm, tab, tally, state, seed, k=128):
    """WALK_CAPTURE_LAUNCHES transport launches (each with its walk, the
    main path's _launch_cuda) of ``state``; returns the last launch's
    queue and its events (f, i) on the card."""
    for n in range(WALK_CAPTURE_LAUNCHES):
        kern._launch_cuda(state, tab, prm, seed, n * k, k, tally)
    _sync()
    f, i = tally.queue.queued()
    return tally.queue, f.clone(), i.clone()


def _walk_case(name, kern, twin, zeros, prm, tab, seed, queue, f, i,
               walk_field, ops, table_bytes):
    """The walk kernel (``kern._walk_cuda``) and its plain twin on one
    captured buffer: asserts equal iterations and cuts, per-direction
    totals within WALK_TOTAL_TOL_KERNEL_VS_PLAIN and every pixel within
    WALK_PIXEL_TOL_KERNEL_VS_PLAIN of its direction's largest; times the
    kernel (median of WALK_TIMING_REPS) and the twin once (CUDA events).
    Returns the largest absolute pixel difference, the kernel's ms, the
    twin's ms and the bound: the buffer's records (4 bytes a row) and
    ``table_bytes`` read once, the image written once, and
    ``ops`` = (operations per iteration, per event and direction) over the
    counted iterations and pairs."""
    import torch

    n_ev = f.shape[1]
    kt, pt = zeros(prm, "cuda"), zeros(prm, "cuda")
    kern._walk_cuda(tab, prm, seed, queue, kt)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    twin(tab, prm, seed, f, i, pt)
    e1.record()
    _sync()
    plain_ms = e0.elapsed_time(e1)
    it_k, it_p = int(getattr(kt, walk_field)), int(getattr(pt, walk_field))
    cut_k, cut_p = int(kt.counts[4]), int(pt.counts[4])
    img_k = kt.img[:prm.n_img].reshape(-1, prm.n_dirs, prm.nx * prm.ny)
    img_p = pt.img[:prm.n_img].reshape(-1, prm.n_dirs, prm.nx * prm.ny)
    tot_k, tot_p = (a.double().sum(dim=(0, 2)) for a in (img_k, img_p))
    gap = float(((tot_k - tot_p).abs() / tot_p.abs().clamp(min=1e-30)).max())
    diff = (img_k.double() - img_p.double()).abs()
    err = float(diff.max())
    # each (section, direction)'s pixels against its largest
    peak = img_p.double().abs().amax(dim=2, keepdim=True)
    pix = float((diff / peak.clamp(min=1e-30)).max())
    times = []
    for _ in range(WALK_TIMING_REPS):
        a0, a1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = zeros(prm, "cuda")
        a0.record()
        kern._walk_cuda(tab, prm, seed, queue, t)
        a1.record()
        times.append((a0, a1))
    _sync()
    ms = sorted(a.elapsed_time(c) for a, c in times)[len(times) // 2]
    rows = queue.f.shape[0] + queue.i.shape[0]
    bound = _bound(0, 1, 0, 0, 0, 4 * rows * n_ev + table_bytes,
                   4 * prm.n_img,
                   extra_ops=it_k * ops[0] + n_ev * prm.n_dirs * ops[1])
    print(f"walk compare [{name}]: queue fill {n_ev} of {queue.capacity} "
          f"({n_ev / queue.capacity:.3f}; the batch's largest "
          f"{queue.check()}), {n_ev * prm.n_dirs} pairs, iterations "
          f"{it_k}/{it_p}, cuts {cut_k}/{cut_p}, direction totals gap "
          f"{gap:.2e}, largest pixel difference {err:.3e} ({pix:.2e} of "
          f"its direction's largest pixel); kernel {ms:.4f} ms (median of "
          f"{WALK_TIMING_REPS}); bound {bound[0]:.4f} ms by {bound[1]}; "
          f"plain twin {plain_ms:.2f} ms", flush=True)
    assert n_ev > 0 and tot_p.abs().min() > 0
    assert it_k == it_p, (it_k, it_p)
    assert cut_k == cut_p == 0, (cut_k, cut_p)
    assert gap < WALK_TOTAL_TOL_KERNEL_VS_PLAIN, gap
    assert pix < WALK_PIXEL_TOL_KERNEL_VS_PLAIN, pix
    return dict(max_err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                events=n_ev)


def phase_walk_compare(ck, rk, le, m, KernelConfig, rng, config):
    """Each walk kernel alone against its plain twin on one launch's
    captured event buffer (4,096 lanes, 128 steps): K3-d on bench.py:
    547-573's 16 directions and on 2h's gas case, K2 on the radiance deck's
    6 directions and on 64."""
    import dataclasses

    res = {}
    surface = m.Surface.lambertian(0.2)
    mus8 = [1.0, 0.8, 0.6, 0.4, 0.8, 0.6, 0.45, 0.7]
    phis8 = [20.0, 70.0, 110.0, 160.0, 200.0, 250.0, 290.0, 340.0]
    for name, dom, src, icfg, dirs in (
            ("K3-d, bench.py:547-573, 16 dirs", _radiance_cloud(m),
             m.illumination.directional(0.5, 0.0),
             le.IntensityConfig(n_dirs=16, use_russian_roulette=True,
                                use_hybrid_phase=True, pallas_min_mu=0.4),
             le.make_intensity_directions(MUS16, PHIS16, device="cuda")),
            ("K3-d, gas, analytic HG, exact, 8 dirs",
             _gas_broken_cloud(m, tables=False), m.illumination.flux(),
             le.IntensityConfig(n_dirs=8, use_russian_roulette=False,
                                use_hybrid_phase=True, pallas_min_mu=0.4),
             le.make_intensity_directions(mus8, phis8, device="cuda"))):
        dirs = dirs[:, list(ck.col_dir_order(dom, dirs))]
        prm = ck.ColParams.make(dom, surface, src, True, 1.0, False, icfg,
                                dirs)
        tab = ck.ColTables.from_domain(dom, icfg, dirs, surface=surface)
        quota = rk.initial_quota(4096, 512, None, "cuda")
        st = ck.ColState.initial(quota, prm[ck.C_BETA_MAX], prm.nz)
        tally = ck.ColTally.zeros(prm, "cuda", queue_capacity=4096 * 128)
        seed = rng.batch_seed(41, len(res))
        queue, f, i = _capture_queue(ck, prm, tab, tally, st, seed)
        # the (A, B) table, the forward row, the directions, the gas
        # profiles
        table_bytes = 4 * (2 * prm.nx * prm.ny + tab.fwd_v0.numel()
                           + tab.fwd_dd.numel() + 4 * prm.n_dirs
                           + 2 * tab.qz.numel())
        res[name] = _walk_case(
            name, ck, ck.col_local_estimate_plain, ck.ColTally.zeros, prm,
            tab, seed, queue, f, i, "walk", (OPS_PER_WALK_ITERATION, OPS_PER_LE_DIRECTION), table_bytes)
    # phase 4b's step cloud: the radiance deck's file-read domain
    dom = dataclasses.replace(
        m.make_step_cloud(ssa=0.99, n_legendre=512, macro_factor=8,
                          n_cdf_steps=10001, compute_intensity_tables=True,
                          hybrid_width_deg=7.0, device="cuda"),
        all_hg=False)
    for n_dirs, deck in ((6, "step_cloud_radiance.nml"),
                         (64, "step_cloud_radiance_648.nml")):
        name = f"K2, radiance deck, {n_dirs} dirs"
        icfg = le.IntensityConfig(n_dirs=n_dirs)
        dirs = _deck_directions(config, le, deck, n_dirs)
        src = m.illumination.directional(0.5, 0.0)
        sfc = m.Surface.lambertian(0.0)
        prm = rk.RecordParams.make(dom, sfc, src, True, 1.0, False, icfg,
                                   dirs)
        tab = rk.RecordTables.from_domain(dom, icfg, dirs, src, sfc)
        quota = rk.initial_quota(4096, 64, None, "cuda")
        st = rk.RecordState.initial(quota, prm[rk.P_BETA_MAX])
        tally = rk.RecordTally.zeros(prm, "cuda", queue_capacity=4096 * 128)
        seed = rng.batch_seed(42, n_dirs)
        queue, f, i = _capture_queue(rk, prm, tab, tally, st, seed)
        # beta, the forward table, the directions
        table_bytes = 4 * (tab.beta.numel() + tab.fwd_v0.numel()
                           + tab.fwd_dd.numel() + 3 * prm.n_dirs)
        res[name] = _walk_case(
            name, rk, rk.local_estimate_plain, rk.RecordTally.zeros, prm,
            tab, seed, queue, f, i, "march", (OPS_PER_MARCH_STEP, OPS_PER_K2_DIRECTION), table_bytes)
    return res


# ---------------------------------------------------------------------------
# K3-b (the column emission) and K3-c (the per-pixel albedo): phases 2i, 3j,
# 3k and 4i
# ---------------------------------------------------------------------------

# Operations of a column emission birth in csrc/col_kernel.cu's refill, on
# top of the birth step's own (OPS_PER_LANE_STEP counts none of the
# refill's), with a counter uniform at 24 operations as in
# OPS_PER_EMISSION_BIRTH. Every birth: five uniforms (x, y, split, mu,
# azimuth: 120); the split's compare and branch (2); the azimuth, the sine
# of the polar angle and cosf/sinf (53, as for K1). An atmospheric birth
# adds three uniforms (bin, acceptance, level: 72); the bin's multiply,
# convert and clamp (3); the acceptance's load, compare and branch with the
# alias target's and its height's loads, the convert and add (7); the
# truncation, a convert, subtract and clamp (3), the fcum load from shared
# memory and the multiply (2); the upper-bound search, 7 iterations at
# nz = 64 of a shift, add, load, compare and branch (35); the column split,
# one integer division and its remainder (23); the position, two converts,
# adds and multiplies for x and y (8) and z's convert, uniform, add,
# multiply, add and clamp (30); mu, 1 - 2u with its floor test (5); its
# count (1); the pre-credits' addresses, tests and three atomics (9). A
# surface birth adds its position (4), z (1) and mu, a maximum and a
# square root (8).
OPS_PER_COL_BIRTH = 175
OPS_PER_COL_ATMOSPHERIC_BIRTH = 198
OPS_PER_COL_SURFACE_BIRTH = 13
# Path A's and B's references, from the JAX package on the CPU by
# tools/landsat_lw_px_reference.py (its XLA path at full width, threefry
# streams, independent of the port's kernels; ``stats`` over its batches):
# ``lw`` 24 batches of 16,384 photons, seed 11: domain-mean up and down
# flux and net column absorption, then the 64 levels of the net absorption
# profile (normalized per photon), each with its standard error over
# batches; ``px``, seed 12: the flux run's R, T, A and 64 profile levels
# over 200 batches of 8,192 photons (24 beside the radiance runs, 176 with
# ``--flux-only``: at 24 batches one level's own error put it 4.0 sigma
# from the port), the radiance run's R, T, A and 16 domain-mean radiances
# in the deck's order over 24 batches of 8,192.
JAX_LW_LANDSAT = (
    0.05581149956, 0.05520884196, -0.05139290433, -2.144017134e-08,
    -9.999256079e-09, -1.80196565e-08, -1.320360127e-08, -3.860471548e-08,
    -2.220946574e-08, -1.814999157e-08, 1.395704387e-08, -5.362808409e-09,
    -1.993654171e-08, -1.458324997e-08, -1.871901696e-08, -8.892993166e-09,
    -2.224602309e-08, -1.325764248e-08, -1.271722745e-08, -5.473929605e-08,
    -2.011932987e-08, -1.396177308e-08, -3.746030799e-08, -5.192277878e-08,
    -7.063545744e-08, -3.593125098e-08, -6.46511513e-08, -6.844995478e-08,
    -5.438802716e-08, -1.022449931e-07, -9.617485644e-08, -7.658320735e-08,
    -9.238876945e-08, -1.396941941e-07, -1.50419851e-07, -1.736815572e-07,
    -2.017434247e-07, -1.835568591e-07, -1.66851667e-07, -1.340150744e-07,
    -1.221752098e-07, -7.113456257e-08, -5.174636537e-08, -3.355979738e-08,
    -2.608299132e-08, -1.621087314e-08, -8.042653106e-09, -5.59488911e-09,
    -1.811981128e-09, -3.496805392e-10, 6.357830003e-11, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0
)
JAX_LW_LANDSAT_SE = (
    0.0003304327858, 0.0003672181283, 0.0009835265992, 9.150833152e-09,
    1.24246361e-08, 1.526574917e-08, 1.523024522e-08, 1.751740124e-08,
    1.193321199e-08, 1.153589205e-08, 1.244566827e-08, 1.413384108e-08,
    1.114929499e-08, 1.507359906e-08, 1.31317263e-08, 1.194603282e-08,
    1.337327333e-08, 1.448488558e-08, 1.29842372e-08, 1.521172164e-08,
    1.338293198e-08, 1.099376445e-08, 1.004201437e-08, 1.267781167e-08,
    1.29927278e-08, 1.318912739e-08, 1.515412603e-08, 1.214284257e-08,
    1.358063088e-08, 1.551543813e-08, 1.082121685e-08, 1.165953123e-08,
    1.213125838e-08, 1.060624917e-08, 1.024082253e-08, 1.109397689e-08,
    1.259665282e-08, 1.07388272e-08, 1.078649461e-08, 8.27813158e-09,
    7.514251334e-09, 4.926012991e-09, 5.710440217e-09, 3.737402016e-09,
    2.553348014e-09, 2.138043059e-09, 1.281735595e-09, 7.842940566e-10,
    7.750238114e-10, 4.568855529e-10, 1.88883027e-10, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0
)
JAX_PX_FLUX = (
    0.5642128634, 0.4591199815, 0.1891878083, 1.457173247e-07, 1.520038258e-07,
    1.56873493e-07, 1.613357496e-07, 1.66303317e-07, 1.709698783e-07,
    1.751954411e-07, 1.799881227e-07, 1.845190743e-07, 1.897804467e-07,
    1.947893152e-07, 1.999240654e-07, 2.052090697e-07, 2.11642272e-07,
    2.176433701e-07, 2.236468837e-07, 2.300542854e-07, 2.367758974e-07,
    2.447954968e-07, 2.528413519e-07, 2.608746616e-07, 2.69334582e-07,
    2.777176159e-07, 2.875815003e-07, 2.970650071e-07, 3.068822127e-07,
    3.174807304e-07, 3.278117684e-07, 3.383314114e-07, 3.487111923e-07,
    3.591483228e-07, 3.686839056e-07, 3.781056857e-07, 3.610236528e-07,
    2.957956779e-07, 2.339632893e-07, 1.770718187e-07, 1.274792741e-07,
    8.595995214e-08, 5.666536796e-08, 3.664851499e-08, 2.207912129e-08,
    1.30657587e-08, 6.463062797e-09, 3.452108099e-09, 1.363856583e-09,
    5.769802655e-10, 4.471432136e-11, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0
)
JAX_PX_FLUX_SE = (
    0.0002936758671, 0.0004656195938, 9.860619404e-05, 3.229713927e-10,
    3.333989638e-10, 3.398321073e-10, 3.493358572e-10, 3.588326068e-10,
    3.756673394e-10, 3.769836735e-10, 3.908939178e-10, 4.19026742e-10,
    3.944321608e-10, 4.084232855e-10, 3.721408895e-10, 4.018294549e-10,
    4.026367484e-10, 3.868338541e-10, 3.813748548e-10, 3.825904307e-10,
    4.008033889e-10, 4.457660172e-10, 4.611888944e-10, 4.808703457e-10,
    4.320361024e-10, 4.552655373e-10, 4.98206143e-10, 4.724930385e-10,
    4.631808816e-10, 4.925432496e-10, 4.936263717e-10, 5.162775562e-10,
    5.113891067e-10, 4.859116269e-10, 5.284189835e-10, 5.265996422e-10,
    4.808690492e-10, 4.373225328e-10, 3.56389485e-10, 3.345970987e-10,
    2.770795957e-10, 2.247454303e-10, 1.843302499e-10, 1.550525813e-10,
    1.14764532e-10, 8.852758096e-11, 6.121124107e-11, 4.484293843e-11,
    2.972174607e-11, 1.821143941e-11, 4.279689823e-12, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0
)
JAX_PX_RAD = (
    0.5641616359, 0.4586098765, 0.1886107028, 0.1100165895, 0.1535250186,
    0.1491243714, 0.1429982553, 0.1453089146, 0.1601066209, 0.2098912106,
    0.3251343795, 0.1099582017, 0.153583421, 0.14917163, 0.1430066378,
    0.1451844616, 0.1600252772, 0.2098391947, 0.3251437144
)
JAX_PX_RAD_SE = (
    0.0008861876737, 0.001536876666, 0.0002581230319, 0.000796820538,
    0.0009276866553, 0.001110733352, 0.001118320063, 0.001256399408,
    0.001181937051, 0.002244205029, 0.00274757798, 0.0008254296831,
    0.0009327826474, 0.001143234892, 0.00113401317, 0.001243370178,
    0.001228428036, 0.002229928377, 0.002752111102
)
# The same runs on the 64 x 32 x 32 cut (65,536 cells) through the JAX
# package's column kernel (K3) in Pallas interpret mode (``--cut``), 16
# batches of 8,192 photons each: ``lw`` up, down and net column absorption
# (its profile is not used: JAX's K3 puts the profile's pre-credits at level
# 0, PERF.md section 6), ``px`` R, T, A and the 32 profile levels.
JAX_LW_CUT_K3 = (
    0.1043001814, 0.09157943726, -0.0863117245
)
JAX_LW_CUT_K3_SE = (
    0.001100158937, 0.0008829196277, 0.001449626916
)
JAX_PX_CUT_K3 = (
    0.5470099449, 0.6352050304, 0.1149824117, 2.135044914e-07, 2.24896084e-07,
    2.343735028e-07, 2.445599883e-07, 2.545844406e-07, 2.611483012e-07,
    2.739123257e-07, 2.871185121e-07, 2.991524735e-07, 3.099156398e-07,
    3.182090111e-07, 3.321815552e-07, 3.409874552e-07, 3.539123252e-07,
    3.662604495e-07, 3.698592401e-07, 3.75553121e-07, 3.272475606e-07,
    2.055987007e-07, 1.0213639e-07, 3.788948599e-08, 1.421767987e-08,
    1.901624441e-09, 0, 0, 0, 0, 0, 0, 0, 0, 0
)
JAX_PX_CUT_K3_SE = (
    0.0009740540463, 0.001618389571, 0.0003012389209, 1.142111441e-09,
    1.369701169e-09, 1.510438945e-09, 1.502224161e-09, 1.368399407e-09,
    1.892147569e-09, 1.168542995e-09, 1.682191732e-09, 1.651280247e-09,
    1.97313517e-09, 1.860995671e-09, 1.438687057e-09, 1.754093643e-09,
    1.731534055e-09, 1.949396286e-09, 1.977314952e-09, 2.291913107e-09,
    1.347932168e-09, 1.275316244e-09, 9.118595115e-10, 5.328622701e-10,
    3.039934349e-10, 9.336162707e-11, 0, 0, 0, 0, 0, 0, 0, 0, 0
)
LANDSAT_CUT = dict(nx=64, ny=32, nz=32)
_SCENES = {}


def _col_birth_ops(n_photons, n_atm):
    """Refill operations of ``n_photons`` column emission births, ``n_atm``
    of them atmospheric (as the kernel counted them)."""
    return (n_photons * OPS_PER_COL_BIRTH
            + n_atm * OPS_PER_COL_ATMOSPHERIC_BIRTH
            + (n_photons - n_atm) * OPS_PER_COL_SURFACE_BIRTH)


def lw_landsat(m, cut=False, macro_factor=8):
    """Path A's case on the card: broken_cloud_scene(ssa=0.5) (or its
    64 x 32 x 32 cut) with T(z) = 288 K - 6.5 K/km at the cell centres, 10
    um, macro 8, analytic HG (so the column emission tables build), the
    per-voxel emission source of emission_weighting (surface 288 K,
    emissivity 0.95) and a Lambertian surface of albedo 0.05; built once
    per process."""
    import numpy as np

    key = ("lw", cut, macro_factor)
    if key not in _SCENES:
        grid, comps, _ = m.broken_cloud_scene(
            ssa=0.5, device="cuda", **(LANDSAT_CUT if cut else {}))
        nx, ny, nz = grid.shape
        tz = 288.0 - 6.5 * (np.arange(nz) + 0.5) * 0.02
        temps = np.broadcast_to(tz, (nx, ny, nz)).copy()
        dom = m.build_domain(grid, comps, temps=temps, lambda_um=10.0,
                             macro_factor=macro_factor, n_cdf_steps=201)
        assert dom.col_template and dom.col_em_prob is not None
        kabs = (dom.total_ext.cpu().numpy()
                * (1.0 - dom.ssa.cpu().numpy()[..., 0]))
        w = m.weights.emission_weighting(grid, temps, kabs, 288.0, 0.95,
                                         10.0)
        src = m.illumination.emission(w.voxel_cdf, w.frac_atms_power,
                                      grid.shape, device="cuda")
        sfc = m.Surface.lambertian(0.05, temperature=288.0, emissivity=0.95)
        _SCENES[key] = (dom, sfc, src)
    return _SCENES[key]


def px_landsat(m, cut=False):
    """Path B's case on the card: broken_cloud_scene() (or its cut), macro
    8, analytic HG, the hybrid forward row of 10 degrees, a beam of mu0 0.5
    and azimuth 0 over a 16 x 16 grid of Lambertian albedos 0.1 + 0.7 *
    rand (np.random.RandomState(4), float32); built once per process."""
    import numpy as np

    key = ("px", cut)
    if key not in _SCENES:
        grid, comps, _ = m.broken_cloud_scene(
            device="cuda", **(LANDSAT_CUT if cut else {}))
        dom = m.build_domain(grid, comps, macro_factor=8, n_cdf_steps=201,
                             compute_intensity_tables=not cut,
                             hybrid_width_deg=0.0 if cut else 10.0)
        rs = np.random.RandomState(4)
        sfc = m.Surface(params=(0.1 + 0.7 * rs.rand(16, 16, 1)).astype(
            np.float32))
        _SCENES[key] = (dom, sfc, m.illumination.directional(0.5, 0.0))
    return _SCENES[key]


def phase_col_em_px_compare(ck, le, m, KernelConfig, rng):
    """K3-b and K3-c against the plain step on the card, same seeds and
    counter uniforms, at path A's and B's full width: the emission refill
    at macro 8 and 0 with lw_mode, and at macro 8 without (3D tally and
    profile, 2^16 photons each); the 16 x 16 per-pixel surface as a flux run
    (2^16 photons, 3D tally) and with the 16 directions of
    run/landsat_radiance.nml (4,096 photons: the plain walk is slow).
    Equal photons, lane-steps, events and walk iterations; per-column fluxes
    and (net) absorption within 1e-5 of the photons per column, the profile
    within 5e-4 of its largest level, image totals within 1e-5 and pixels
    with signal within 2e-3. The flux runs take the refill schedule, two
    photons a slot, with equal launches. Returns the largest normalized
    per-column gaps of the emission and per-pixel cases."""
    from mcbrat3d_tpu_torch.transport import record_kernel as rk

    cases = [("emission, macro 8, lw_mode", "lw", 8, True),
             ("emission, macro 0, lw_mode", "lw", 0, True),
             ("emission, macro 8, no lw_mode", "lw", 8, False),
             ("per-pixel albedo, flux", "px", 8, False),
             ("per-pixel albedo, 16 directions", "px_rad", 8, False)]
    errs = {"lw": 0.0, "px": 0.0}
    for i, (name, kind, mf, lw) in enumerate(cases):
        if kind == "lw":
            dom, sfc, src = lw_landsat(m, macro_factor=mf)
        else:
            dom, sfc, src = px_landsat(m)
        icfg = dirs = None
        if kind == "px_rad":
            cfg = KernelConfig(n_lanes=1 << 12, photons_per_lane=1,
                               max_steps=400_000,
                               need_volume_absorption=False,
                               need_absorption_profile=True)
            icfg = le.IntensityConfig(n_dirs=16, use_russian_roulette=True,
                                      zeta_min=0.3, use_hybrid_phase=True,
                                      pallas_min_mu=0.4)
            dirs = le.make_intensity_directions(MUS16, PHIS16, device="cuda")
        else:
            cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=1,
                               max_steps=400_000, lw_mode=lw,
                               need_volume_absorption=True,
                               need_absorption_profile=True)
        seed = rng.batch_seed(32, i)
        sched = (rk.RefillSchedule(cfg.max_steps, vol_tally=True,
                                   resident=cfg.photons_per_batch // 2)
                 if icfg is None else None)

        def run(launch=ck.col_launch):
            return ck.run_batch_col_tallies(
                dom, sfc, src, seed, cfg, launch=launch,
                intensity_config=icfg, intensity_dirs=dirs, ccfg=sched)

        before = (ck.COL_LAUNCHES, ck.COL_LW_LAUNCHES, ck.COL_PX_LAUNCHES)
        tk, sk = _timed(run)
        assert ck.COL_LAUNCHES > before[0], "kernel was not launched"
        assert (ck.COL_LW_LAUNCHES > before[1]) == (kind == "lw")
        assert (ck.COL_PX_LAUNCHES > before[2]) == (kind != "lw")
        tp, sp = _timed(lambda: run(ck.col_launch_plain))
        n = tk.n_photons
        assert n == tp.n_photons == cfg.photons_per_batch, (n, tp.n_photons)
        assert tk.n_bad == tp.n_bad == 0, (tk.n_bad, tp.n_bad)
        assert tk.n_steps == tp.n_steps > 0, (tk.n_steps, tp.n_steps)
        assert tk.n_lane_steps == tp.n_lane_steps, (tk.n_lane_steps,
                                                    tp.n_lane_steps)
        assert (tk.n_le_events, tk.n_walk) == (tp.n_le_events, tp.n_walk)
        assert tk.n_atm_births == tp.n_atm_births, (tk.n_atm_births,
                                                    tp.n_atm_births)
        assert (tk.n_atm_births > 0) == (kind == "lw")
        per_col = n / tk.flux_up.numel()
        pairs = [(tk.flux_up, tp.flux_up), (tk.flux_down, tp.flux_down),
                 (tk.flux_absorbed, tp.flux_absorbed)]
        if tk.volume_absorption is not None:
            pairs.append((tk.volume_absorption, tp.volume_absorption))
        err = max(float((a.double() - b.double()).abs().max()) / per_col
                  for a, b in pairs)
        errs["lw" if kind == "lw" else "px"] = max(
            errs["lw" if kind == "lw" else "px"], err)
        prof_gap = float((tk.absorption_profile.double()
                          - tp.absorption_profile.double()).abs().max()
                         / tp.absorption_profile.double().abs().max())
        line = (f"col emission/per-pixel compare [{name}]: photons {n}, "
                f"lane-steps {tk.n_lane_steps}/{tp.n_lane_steps}, "
                f"up/down/net per photon {_rta(tk)} / {_rta(tp)}, column "
                f"gap {err:.2e}, profile gap {prof_gap:.2e}")
        if kind == "lw" and lw:
            # net of -1 per atmospheric birth, and the net 3D field sums
            # to the net column absorption
            assert float(tk.flux_absorbed.double().sum()) < 0
            marg_gap = float((tk.volume_absorption.double().sum(dim=2)
                              - tk.flux_absorbed.double()).abs().max())
            assert marg_gap / per_col < 1e-4, marg_gap
        if icfg is not None:
            assert tk.n_cut == tp.n_cut == 0 and tk.n_le_events > 0
            img_pairs = [(tk.intensity[:, :, d], tp.intensity[:, :, d])
                         for d in range(icfg.n_dirs)]
            i_total, i_pixel = _total_and_pixel_gaps(img_pairs)
            line += (f", events {tk.n_le_events}, walk iterations "
                     f"{tk.n_walk}, image total gap {i_total:.2e}, pixel "
                     f"gap {i_pixel:.2e}")
            assert i_total < COL_LE_TOTAL_TOL_KERNEL_VS_PLAIN, i_total
            assert i_pixel < COL_LE_PIXEL_TOL_KERNEL_VS_PLAIN, i_pixel
        print(line + f"; kernel {sk:.3f} s plain {sp:.3f} s", flush=True)
        assert err < COL_PIXEL_TOL_KERNEL_VS_PLAIN, err
        assert prof_gap < COL_PROFILE_TOL_KERNEL_VS_PLAIN, prof_gap
    print(f"col emission/per-pixel compare: largest normalized column gap "
          f"{errs['lw']:.3e} (emission), {errs['px']:.3e} (per-pixel)",
          flush=True)
    return errs["lw"], errs["px"]


def _simulate(ck, rk, run_simulation, SimulationConfig, dom, sfc, src,
              sk=None, tk=None, **cfg_kw):
    """One run_simulation on the card (2^16 lanes and 400,000 steps unless
    ``cfg_kw`` says otherwise), no plain record or column step allowed;
    returns the results, the seconds and the launches (record, column,
    column with the emission refill, with the per-pixel albedo, with the
    local estimate, record with the RPV surface, with the per-pixel
    albedo, with the local estimate, and with ``sk``, ``tk`` the separable
    and tiled kernels), every count set to 0 just before the run and read
    just after."""
    cfg = SimulationConfig(**{"max_steps": 400_000, "n_lanes": 1 << 16,
                              **cfg_kw})
    plain_runs = []
    patched = [(ck, "col_launch_plain"), (rk, "record_launch_plain")]
    originals = [getattr(m, name) for m, name in patched]

    def counting(plain):
        def run_plain(*args, **kwargs):
            plain_runs.append(1)
            return plain(*args, **kwargs)
        return run_plain

    for (m, name), plain in zip(patched, originals):
        setattr(m, name, counting(plain))
    rk.LAUNCHES = ck.COL_LAUNCHES = ck.COL_LE_LAUNCHES = 0
    ck.COL_LW_LAUNCHES = ck.COL_PX_LAUNCHES = 0
    rk.RPV_LAUNCHES = rk.PX_LAUNCHES = rk.RADIANCE_LAUNCHES = 0
    for m, name in ((sk, "SEP_LAUNCHES"), (tk, "TILE_LAUNCHES")):
        if m is not None:
            setattr(m, name, 0)
    try:
        res, sec = _timed(lambda: run_simulation(dom, sfc, src, cfg))
    finally:
        for (m, name), plain in zip(patched, originals):
            setattr(m, name, plain)
    launches = (rk.LAUNCHES, ck.COL_LAUNCHES, ck.COL_LW_LAUNCHES,
                ck.COL_PX_LAUNCHES, ck.COL_LE_LAUNCHES, rk.RPV_LAUNCHES,
                rk.PX_LAUNCHES, rk.RADIANCE_LAUNCHES,
                sk.SEP_LAUNCHES if sk is not None else 0,
                tk.TILE_LAUNCHES if tk is not None else 0)
    assert not plain_runs, "a plain step ran"
    assert res.n_bad == 0, res.n_bad
    assert res.total_photons == (cfg.num_photons_per_batch
                                 * cfg.num_batches)
    return res, sec, launches


def _mean_row(res, profile=True, radiance=False):
    """(means, standard errors) of R, T, A, then the profile's levels or
    the domain-mean radiances."""
    import numpy as np

    keys = ["mean_flux_up", "mean_flux_down", "mean_flux_absorbed"]
    got = [float(res.mean[k]) for k in keys]
    se = [float(res.stderr[k]) for k in keys]
    extra = ("mean_intensity" if radiance else
             "absorption_profile" if profile else None)
    if extra is not None:
        got += np.asarray(res.mean[extra], np.float64).reshape(-1).tolist()
        se += np.asarray(res.stderr[extra], np.float64).reshape(-1).tolist()
    return got, se


def phase_lw_landsat(ck, rk, m, run_simulation, SimulationConfig):
    """Path A through run_simulation: the Landsat-scale 10 um run at full
    width (8 x 2^20 photons, lw_mode, profile and 3D field), the column
    kernel alone with the emission refill on every launch, n_bad 0; the
    3D field's marginals equal the column and profile tallies; up, down,
    net absorption and the 64-level net profile within 4.5 combined sigma
    of JAX's XLA path; then the 64 x 32 x 32 cut (8 x 2^17 photons) against
    JAX's K3 in interpret mode (up, down, net absorption)."""
    import numpy as np

    dom, sfc, src = lw_landsat(m)
    res, sec, launches = _simulate(
        ck, rk, run_simulation, SimulationConfig, dom, sfc, src,
        lw_flag=1.0, num_photons_per_batch=1 << 20, num_batches=8,
        iseed=21, report_absorption_profile=True,
        report_volume_absorption=True)
    assert launches[0] == 0 and launches[1] == launches[2] > 0, launches
    assert launches[3] == launches[4] == 0, launches
    vol = np.asarray(res.mean["volume_absorption"], np.float64)
    prof = np.asarray(res.mean["absorption_profile"], np.float64)
    net = np.asarray(res.mean["flux_absorbed"], np.float64)
    ze = dom.grid.edges_np()[2]
    dz_m = float(ze[-1] - ze[0]) / dom.grid.nz * 1000.0  # the 3D field's
    marg_z = float(np.abs(vol.mean(axis=(0, 1)) - prof).max()
                   / np.abs(prof).max())
    marg_col = float(np.abs(vol.sum(axis=2) * dz_m - net).max()
                     / np.abs(net).max())
    assert marg_z < 1e-4 and marg_col < 1e-4, (marg_z, marg_col)
    got, se = _mean_row(res)
    names = ["up", "down", "net"] + [f"profile {k}" for k in range(64)]
    worst = _within_sigma(got, se, JAX_LW_LANDSAT, JAX_LW_LANDSAT_SE, names)
    print(f"path A (Landsat LW, run_simulation): {res.total_photons} "
          f"photons in {sec:.2f} s, up/down/net {got[:3]} +- {se[:3]}, "
          f"launches record/column/emission/per-pixel/radiance {launches}, "
          f"marginal gaps z {marg_z:.1e} column {marg_col:.1e}; largest gap "
          f"to JAX's XLA path {worst:.2f} combined sigma (up/down/net "
          f"{list(JAX_LW_LANDSAT[:3])} +- {list(JAX_LW_LANDSAT_SE[:3])})",
          flush=True)
    dom_c, sfc_c, src_c = lw_landsat(m, cut=True)
    res_c, sec_c, launches_c = _simulate(
        ck, rk, run_simulation, SimulationConfig, dom_c, sfc_c, src_c,
        lw_flag=1.0, num_photons_per_batch=1 << 17, num_batches=8,
        iseed=22, report_absorption_profile=True)
    assert launches_c[1] == launches_c[2] > 0 and launches_c[0] == 0
    got_c, se_c = _mean_row(res_c, profile=False)
    worst_c = _within_sigma(got_c, se_c, JAX_LW_CUT_K3, JAX_LW_CUT_K3_SE,
                       ["up", "down", "net"])
    print(f"path A at 64 x 32 x 32: up/down/net {got_c} +- {se_c} in "
          f"{sec_c:.2f} s; largest gap to JAX's K3 {worst_c:.2f} combined "
          f"sigma", flush=True)
    return dict(launches=launches[1], lw_launches=launches[2], seconds=sec,
                worst=max(worst, worst_c))


def phase_px_landsat(ck, rk, le, m, run_simulation, SimulationConfig,
                     KernelConfig, rng):
    """Path B through run_simulation: the Landsat scene over the 16 x 16
    per-pixel surface at full width, a flux run (8 x 2^20 photons,
    profile) and a radiance run with run/landsat_radiance.nml's 16
    directions (4 x 2^19 photons), the column kernel alone with the
    per-pixel albedo on every launch, n_bad 0, R, T, A, the profile and the
    radiances within 4.5 combined sigma of JAX's XLA path; the 64 x 32 x 32
    cut's flux run (8 x 2^17) against JAX's K3 in interpret mode; then the
    per-pixel flux path's ms per launch (CUDA events, 2^16 lanes x 16
    photons) and the plain step's over 2 launches."""
    dom, sfc, src = px_landsat(m)
    res, sec, launches = _simulate(
        ck, rk, run_simulation, SimulationConfig, dom, sfc, src,
        num_photons_per_batch=1 << 20, num_batches=8, iseed=23,
        report_absorption_profile=True)
    assert launches[0] == 0 and launches[1] == launches[3] > 0, launches
    assert launches[2] == launches[4] == 0, launches
    got, se = _mean_row(res)
    worst = _within_sigma(got, se, JAX_PX_FLUX, JAX_PX_FLUX_SE,
                     ["R", "T", "A"] + [f"profile {k}" for k in range(64)])
    print(f"path B flux (run_simulation): {res.total_photons} photons in "
          f"{sec:.2f} s, R/T/A {got[:3]} +- {se[:3]}, launches {launches}; "
          f"largest gap to JAX's XLA path {worst:.2f} combined sigma",
          flush=True)
    res_r, sec_r, launches_r = _simulate(
        ck, rk, run_simulation, SimulationConfig, dom, sfc, src,
        num_photons_per_batch=1 << 19, num_batches=4, iseed=24,
        report_absorption_profile=True, intensity_mus=list(MUS16),
        intensity_phis=list(PHIS16), use_hybrid_phase_funs=True,
        hybrid_phase_fun_width=10.0, zeta_min=0.3)
    assert launches_r[0] == 0, launches_r
    assert launches_r[1] == launches_r[3] == launches_r[4] > 0, launches_r
    got_r, se_r = _mean_row(res_r, radiance=True)
    worst_r = _within_sigma(got_r, se_r, JAX_PX_RAD, JAX_PX_RAD_SE,
                       ["R", "T", "A"] + [f"radiance {d}" for d in range(16)])
    print(f"path B radiance (run_simulation, 16 directions): "
          f"{res_r.total_photons} photons in {sec_r:.2f} s, R/T/A and "
          f"radiances {[round(v, 6) for v in got_r]}, launches "
          f"{launches_r}; largest gap to JAX's XLA path {worst_r:.2f} "
          f"combined sigma", flush=True)
    dom_c, sfc_c, src_c = px_landsat(m, cut=True)
    res_c, sec_c, launches_c = _simulate(
        ck, rk, run_simulation, SimulationConfig, dom_c, sfc_c, src_c,
        num_photons_per_batch=1 << 17, num_batches=8, iseed=25,
        report_absorption_profile=True)
    assert launches_c[1] == launches_c[3] > 0 and launches_c[0] == 0
    got_c, se_c = _mean_row(res_c)
    worst_c = _within_sigma(got_c, se_c, JAX_PX_CUT_K3, JAX_PX_CUT_K3_SE,
                       ["R", "T", "A"] + [f"profile {k}" for k in range(32)])
    print(f"path B at 64 x 32 x 32: R/T/A {got_c[:3]} +- {se_c[:3]}; "
          f"largest gap to JAX's K3 {worst_c:.2f} combined sigma",
          flush=True)
    # the per-pixel flux path's times (2^20 photons a batch); per launch
    # the column fields, the block table and the albedo per column read
    # once, the tallies written once; the albedo's load and multiply on a
    # reflection are the flux step's own
    cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=16,
                       max_steps=400_000, need_volume_absorption=False,
                       need_absorption_profile=True)
    nxy, nz = dom.grid.nx * dom.grid.ny, dom.grid.nz
    out = _col_flux_timing(
        ck, "per-pixel flux path", dom, sfc, src, cfg, rng.batch_seed(6, 0),
        OPS_PER_LANE_STEP["col_kernel"],
        4 * (3 * nxy + 2 * dom.macro_table.shape[0]), 4 * (3 * nxy + nz))
    out.update(launches=launches[1], px_launches=launches[3]
               + launches_r[3], seconds=sec + sec_r,
               worst=max(worst, worst_r, worst_c))
    return out


def phase_lw_landsat_headline(ck, rk, m, KernelConfig, run_batch, rng):
    """Path A's configuration, one batch through run_batch (2^16 lanes x 16
    photons, lw_mode, profile and 3D field): the column kernel with the
    emission refill, the A/B of the refill schedule and JAX's geometry, its
    occupancy, ms per launch (CUDA events), launches, live lane-steps per
    photon, the atmospheric births' share, the card's busy share and the
    bound; kernel and plain ms of the refill schedule's first launch."""
    dom, sfc, src = lw_landsat(m)
    cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=16,
                       max_steps=400_000, lw_mode=True,
                       need_volume_absorption=True,
                       need_absorption_profile=True)
    run_batch(dom, sfc, src, rng.batch_seed(8, 99), cfg,
              n_photons=1 << 18)  # warm-up
    before = ck.COL_LW_LAUNCHES
    t, sec = _timed(lambda: run_batch(dom, sfc, src, rng.batch_seed(8, 0),
                                      cfg))
    assert ck.COL_LW_LAUNCHES > before, "not the column kernel's refill"
    assert t.n_photons == cfg.photons_per_batch and t.n_bad == 0
    nxy, nz = dom.grid.nx * dom.grid.ny, dom.grid.nz
    # per launch: the column fields, the block table, the column alias
    # (probability, target, its height) and the cumulative Planck table
    # read once; the tallies (the profile and its pre-credit row, the 3D
    # field) written once
    res = _col_flux_timing(
        ck, "path A headline", dom, sfc, src, cfg, rng.batch_seed(8, 0),
        OPS_PER_LANE_STEP["col_kernel"],
        4 * (5 * nxy + 2 * dom.macro_table.shape[0] + nz),
        4 * (3 * nxy + 2 * nz + nxy * nz),
        extra_ops=lambda tt: _col_birth_ops(tt.n_photons, tt.n_atm_births))
    print(f"path A headline (run_batch, lw_mode, emission refill): "
          f"{t.n_photons} photons in {sec:.3f} s = "
          f"{t.n_photons / sec:.6g} photons/s, {t.n_photons} births of "
          f"which {t.n_atm_births} atmospheric (counted; "
          f"{t.n_atm_births / t.n_photons:.4f} of them, the source's "
          f"configured share {src.atms_fraction:.4f}), up/down/net per "
          f"photon={_rta(t)}", flush=True)
    return res


def _lw_scene(lw_flagship_scene, build_domain, nx, nz, macro_factor,
              cloud_base_level=55, cloud_top_level=85, n_cdf_steps=201,
              **kw):
    """The LW flagship scene (or a cut of it) as a compact separable
    domain on the card, with its emission tables at 10 um."""
    grid, comps, temps = lw_flagship_scene(
        nx=nx, ny=nx, nz=nz, cloud_base_level=cloud_base_level,
        cloud_top_level=cloud_top_level, device="cuda", **kw)
    return build_domain(grid, comps, temps=temps, macro_factor=macro_factor,
                        n_cdf_steps=n_cdf_steps, lambda_um=10.0,
                        device_fields="compact")


def _sep_smem(sk, prm, emission):
    """A separable-kernel block's shared memory as csrc/sep_kernel.cu lays it
    out by the occupancy rule: (bytes, block ceilings in shared memory,
    inverse-CDF row in shared memory, blocks an SM)."""
    base = 4 * (3 * prm.nz + (4 * prm.nz + 3 * prm.n_groups if emission
                              else 0))
    blk_b = 4 * prm.n_blk
    inv_b = 0 if prm.analytic_hg else 8 * prm.inv_n_steps
    occ = sk.occupancy(prm)
    extra = occ["smem"] - base
    # the rule stages the ceilings, then the row, while they cost no blocks
    blk = extra >= blk_b
    inv = inv_b > 0 and extra == blk_b + inv_b
    assert extra == (blk_b if blk else 0) + (inv_b if inv else 0), (
        occ["smem"], base, blk_b, inv_b)
    return occ["smem"], blk, inv, occ["blocks_per_sm"]


def phase_sep_compare(sk, lw_flagship_scene, build_domain, Surface,
                      illumination, KernelConfig, rng):
    """Separable kernel vs plain on the card, both on the refill schedule
    (the slots half the photons' count, so that every slot starts two
    photons in the kernel); returns the largest per-column difference of
    the normalized fluxes."""
    import dataclasses

    from mcbrat3d_tpu_torch.transport import record_kernel as rk

    surface = Surface.lambertian(0.05)
    # the configurations of tests/test_torch_sep_kernel.py at 2^17 photons,
    # the two-slice cut (columns past 16,384) with emission, that cut with
    # the deck's 9,001-step row (72 KB), which the occupancy rule reads
    # from global memory, and the deck's own shape: 325 x 325 x 150, macro
    # 8, emission with LW pre-credits and that row of nPhaseIntervals
    defaults = dict(mf=8, rr=True, analytic=True, slab=(55, 85),
                    n_cdf=201, ppl=2, kw=dict(cloud_beta_max=8.0))
    cases = [
        dict(label="emission", nx=16, nz=150, src="emission"),
        dict(label="emission, no roulette, table", nx=16, nz=150, mf=0,
             src="emission", rr=False, analytic=False),
        dict(label="directional, table", nx=16, nz=150, src="directional",
             analytic=False),
        dict(label="random azimuth, no roulette", nx=16, nz=150,
             src="random_azimuth", rr=False),
        dict(label="flux, slab to the top", nx=16, nz=150, mf=0, src="flux",
             slab=(55, 150)),
        dict(label="two slices, emission, table", nx=132, nz=60,
             src="emission", analytic=False, slab=(20, 35)),
        dict(label="two slices, emission, 9001-step table from global "
             "memory", nx=132, nz=60, src="emission", analytic=False,
             slab=(20, 35), n_cdf=9001),
        dict(label="the deck's shape, emission, 9001-step table", nx=325,
             nz=150, src="emission", analytic=False, n_cdf=9001, kw={}),
    ]
    max_err = 0.0
    for i, case in enumerate(cases):
        c = {**defaults, **case}
        label, nx, nz, mf, src = (c[k] for k in ("label", "nx", "nz", "mf",
                                                 "src"))
        dom = _lw_scene(lw_flagship_scene, build_domain, nx, nz, mf,
                        *c["slab"], n_cdf_steps=c["n_cdf"], **c["kw"])
        if not c["analytic"]:  # as an SSP table gives it: the tabulated row
            dom = dataclasses.replace(dom, sep_analytic_hg=False)
        source = {"emission": lambda: illumination.emission_separable(
                      dom, 288.0, 0.95),
                  "directional": lambda: illumination.directional(0.5, 0.0),
                  "random_azimuth": lambda: illumination.random_azimuth(0.5),
                  "flux": illumination.flux}[src]()
        cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=c["ppl"],
                           max_steps=400_000, need_volume_absorption=False,
                           use_russian_roulette=c["rr"],
                           lw_mode=src == "emission")
        seed = rng.batch_seed(40, i)
        prm = sk.SepParams.make(dom, surface, source, c["rr"], 1.0,
                                src == "emission")
        smem, blk_s, inv_s, per_sm = _sep_smem(sk, prm, src == "emission")
        if c["n_cdf"] == 9001:  # the row would cost blocks an SM
            assert blk_s and not inv_s, (label, smem)
        elif not c["analytic"]:
            assert blk_s and inv_s, (label, smem)
        sched = rk.RefillSchedule(cfg.max_steps,
                                  resident=cfg.photons_per_batch // 2)

        def run(launch=sk.sep_launch):
            return sk.run_batch_sep_tallies(dom, surface, source, seed, cfg,
                                            launch=launch, scfg=sched)

        before = sk.SEP_LAUNCHES
        tk, s_k = _timed(run)
        assert sk.SEP_LAUNCHES > before, "kernel was not launched"
        tk2 = run()
        assert (tk2.n_photons, tk2.n_bad) == (tk.n_photons, tk.n_bad)
        rerun = max(float((a - b).abs().max())
                    for a, b in ((tk.flux_up, tk2.flux_up),
                                 (tk.flux_down, tk2.flux_down),
                                 (tk.flux_absorbed, tk2.flux_absorbed)))
        tp, s_p = _timed(lambda: run(sk.sep_launch_plain))
        assert tk.n_photons == tp.n_photons == (1 << 16) * c["ppl"], (
            tk.n_photons, tp.n_photons)
        assert tk.n_bad == 0 and tp.n_bad == 0, (tk.n_bad, tp.n_bad)
        assert tk.n_steps == tp.n_steps > 0, (tk.n_steps, tp.n_steps)
        assert tk.n_steps % rk.REFILL_STEPS == 0, tk.n_steps
        per_col = tk.n_photons / tk.flux_up.numel()
        err = max(float((a.double() - b.double()).abs().max()) / per_col
                  for a, b in ((tk.flux_up, tp.flux_up),
                               (tk.flux_down, tp.flux_down),
                               (tk.flux_absorbed, tp.flux_absorbed)))
        max_err = max(max_err, err)
        prof_gap = float((tk.absorption_profile.double()
                          - tp.absorption_profile.double()).abs().max()
                         / tp.absorption_profile.double().abs().max())
        # the z profile is the column field's z marginal (one tally)
        for t in (tk, tp):
            total = float(t.flux_absorbed.double().sum())
            assert abs(float(t.absorption_profile.double().sum()) - total) \
                < 1e-4 * max(abs(total), 1.0), label
        print(f"sep compare [{label}] {nx}x{nx}x{nz} macro={mf} "
              f"roulette={c['rr']} analytic={c['analytic']} cdf steps "
              f"{c['n_cdf']}: shared memory {smem} B (ceilings "
              f"{'shared' if blk_s else 'global'}, row "
              f"{'shared' if inv_s else 'global'}, {per_sm} blocks an "
              f"SM); {tk.n_steps // rk.REFILL_STEPS} launches, kernel R/T/A="
              f"{_rta(tk)} plain={_rta(tp)} column gap={err:.2e} profile "
              f"gap={prof_gap:.2e} rerun abs={rerun:.1e} lane-steps "
              f"{tk.n_lane_steps} / {tp.n_lane_steps}, kernel {s_k:.3f} s "
              f"plain {s_p:.3f} s", flush=True)
        assert tk.n_lane_steps == tp.n_lane_steps, label
        assert err < SEP_COLUMN_TOL_KERNEL_VS_PLAIN, (label, err)
        assert prof_gap < SEP_PROFILE_TOL_KERNEL_VS_PLAIN, (label, prof_gap)
    return max_err


def _flux_file_means(path):
    """The flux file's domain means, each with its standard error, and the
    flux that scales them: ((up, down, absorbed), (their standard errors),
    solarFlux)."""
    with open(path) as f:
        lines = f.readlines()
    flux = float(next(ln for ln in lines if ln.startswith("! solarFlux"))
                 .split("=")[1])
    vals = [float(v) for v in next(
        ln for ln in lines if not ln.startswith("!")).split()]
    return tuple(vals[0::2][:3]), tuple(vals[1::2][:3]), flux


def phase_lw_deck(sk, ck, rk, cli, write_lw_flagship_inputs):
    """run/I3RC_bench_LW_325.nml through the CLI on cuda on the port's
    generated inputs, then the same generator's 48 x 48 x 150 x 8-bin deck
    against the JAX package's frozen values."""
    deck = (ROOT / "run" / "I3RC_bench_LW_325.nml").read_text()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            write_lw_flagship_inputs()
            gen_s = time.perf_counter() - t0
            inputs_mb = sum((tmp / f).stat().st_size for f in
                            ("common325.nc", "ssp_thermal.nc")) / 2 ** 20
            out, seconds, launches = _run_cli_deck(cli, rk, deck, ck=ck,
                                                   domain=None, sk=sk)
            for f in ("LW325_flux.out", "LW325_results.nc"):
                assert (tmp / f).stat().st_size > 0, f
            means, se, _ = _flux_file_means(tmp / "LW325_flux.out")
        finally:
            os.chdir(cwd)
    n = out["total_photons"]
    print(f"LW flagship deck: inputs written in {gen_s:.2f} s "
          f"({inputs_mb:.0f} MiB); {n} photons in {out['n_batches']} "
          f"batches, n_bad={out['n_bad']}, up/down/absorbed={means} +- "
          f"{se}; CLI {seconds:.2f} s (setup {out['setup_seconds']} s before "
          f"the first transport, run {out['elapsed_seconds']} s), launches "
          f"record/radiance/column/separable {launches}", flush=True)
    assert n == 16 * 4_194_304 and out["n_batches"] >= 16
    assert out["n_bad"] == 0
    assert launches[3] > 0 and launches[0] == launches[2] == 0, launches
    assert all(abs(a / b - 1) < 1e-6 for a, b in zip(
        means, (out["mean_flux_up"], out["mean_flux_down"],
                out["mean_flux_absorbed"])))
    flagship = dict(out=out, seconds=seconds, gen_s=gen_s,
                    launches=launches[3])

    deck48 = (deck.replace("numLambda = 64", "numLambda = 8")
              .replace("numPhotonsPerBatch = 4194304",
                       "numPhotonsPerBatch = 131072")
              .replace("common325.nc", "common48.nc")
              .replace("ssp_thermal.nc", "ssp48.nc"))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            write_lw_flagship_inputs("common48.nc", "ssp48.nc", nx=48, ny=48,
                                     nz=150, n_lambda=8)
            out48, seconds48, launches48 = _run_cli_deck(
                cli, rk, deck48, ck=ck, domain=None, sk=sk)
            means48, se48, flux48 = _flux_file_means(tmp / "LW325_flux.out")
        finally:
            os.chdir(cwd)
    print(f"LW 48x48x150 deck: {out48['total_photons']} photons, n_bad="
          f"{out48['n_bad']}, up/down/absorbed={means48} +- {se48}, "
          f"{seconds48:.2f} s, {launches48[3]} separable launches, total "
          f"flux {flux48!r}; JAX package {JAX_LW48} +- {JAX_LW48_SE}, total "
          f"flux {JAX_LW48_TOTAL_FLUX!r}", flush=True)
    assert out48["total_photons"] == 16 * 131_072 and out48["n_bad"] == 0
    assert out48["n_batches"] == 19, out48["n_batches"]
    assert abs(flux48 / JAX_LW48_TOTAL_FLUX - 1.0) < 1e-8, flux48
    assert launches48[3] > 0 and launches48[0] == launches48[2] == 0
    for got, got_se, want, want_se, name in zip(
            means48, se48, JAX_LW48, JAX_LW48_SE, ("up", "down", "net")):
        sigma = (got_se ** 2 + want_se ** 2) ** 0.5
        assert abs(got - want) < 4.5 * sigma, (name, got, want, 4.5 * sigma)
    return flagship


def phase_sep_headline(sk, lw_flagship_scene, build_domain, Surface,
                       illumination, KernelConfig, rng):
    """The separable headline of bench.py:454-494 (2^24 photons, through
    run_batch_sep_tallies): ``_flux_timing`` with the launch-length and
    slot sweeps, its bounds at 40 bytes of state a slot."""
    from mcbrat3d_tpu_torch.transport import record_kernel as rk

    t0 = time.perf_counter()
    dom = _lw_scene(lw_flagship_scene, build_domain, 325, 150, 8)
    print(f"separable headline: domain build "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    surface = Surface.lambertian(0.05)
    source = illumination.emission_separable(dom, 288.0, 0.95)
    cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=256,
                       max_steps=1_600_000, lw_mode=True,
                       need_volume_absorption=False)
    prm = sk.SepParams.make(dom, surface, source, True, 1.0, True)
    seed = rng.batch_seed(0, 0)
    jax_cfg = rk.jax_geometry(cfg)

    def run(sd, sched):
        sched = {"refill": None, "jax": jax_cfg}.get(sched, sched)
        return sk.run_batch_sep_tallies(dom, surface, source, sd, cfg,
                                        scfg=sched)

    def run_first(slots, launch):
        one = rk.RefillSchedule(rk.REFILL_STEPS, resident=slots)
        return sk.run_batch_sep(dom, surface, source, seed, one,
                                n_photons=cfg.photons_per_batch,
                                lw_mode=True, launch=launch or sk.sep_launch)

    nxy = dom.grid.nx * dom.grid.ny
    res = _flux_timing(
        sk, rk, "separable headline", "sep_steps", sk.occupancy(prm), run,
        run_first, sk.sep_launch_plain, cfg, seed,
        OPS_PER_LANE_STEP["sep_kernel"], 40,
        # amp (padded to whole groups), block ceilings, p, q, z aliases,
        # group tables; tallies: 3 per column + the profile
        4 * (-(-nxy // 128) * (128 + 3) + dom.sep_block.numel()
             + 6 * dom.grid.nz),
        4 * (3 * nxy + dom.grid.nz), SEP_COLUMN_TOL_KERNEL_VS_PLAIN,
        SEP_PROFILE_TOL_KERNEL_VS_PLAIN, sweep=True)
    assert res["tallies"].volume_absorption is None
    return res


def _dense_domain(dense_cloud_scene, build_domain, OpticalComponent,
                  PhaseFunction, PhaseFunctionTable, n_cdf_steps=201,
                  cell_ssa=False, empty_half=False, ncomp=1):
    """The bench's dense MODIS-class scene (128 x 128 x 64, ssa 0.99, HG
    0.85) on the card, optionally with per-cell ssa, an empty half (empty
    tiles for the skip chain) or a uniform absorbing gas (and a
    Rayleigh-like scatterer) as further components."""
    import numpy as np

    grid, comps, _ = dense_cloud_scene(ssa=0.99, device="cuda")
    cloud = comps[0]
    rs = np.random.RandomState(3)
    if cell_ssa:
        cloud.single_scattering_albedo = np.clip(
            0.99 - 0.3 * rs.rand(*cloud.extinction.shape), 0.05, 1.0)
    if empty_half:
        cloud.extinction[64:] = 0.0
    for beta, ssa, g in [(0.002, 0.0, 0.0), (0.001, 1.0, 0.1)][:ncomp - 1]:
        ext = np.full(cloud.extinction.shape, beta)
        comps.append(OpticalComponent(
            f"gas {g}", ext, np.full_like(ext, ssa),
            np.zeros(ext.shape, np.int32),
            PhaseFunctionTable([PhaseFunction.henyey_greenstein(g, 64)],
                               key=[1.0])))
    return build_domain(grid, comps, macro_factor=0, n_cdf_steps=n_cdf_steps)


def phase_tile_compare(tk, dense_args, Surface, illumination, rng):
    """Tiled kernel vs plain on the card, same seeds, whole runs of 2^16
    photons: every case on the refill schedule (2^15 slots), and the four
    sources on the sorted schedule (a pool of 2^15, the JAX package's
    drain floor, pool / 64, then a short tail) with the same injection;
    returns the largest per-column difference of the normalized fluxes."""
    import dataclasses
    import functools

    sources = {"directional": illumination.directional(0.5, 0.0),
               "random_azimuth": illumination.random_azimuth(0.5),
               "flux": illumination.flux(),
               "spotlight": illumination.spotlight(0.6, 30.0, 0.5, 0.5)}
    surface = Surface.lambertian(0.2)
    schedules = {
        "refill": tk.TileConfig(refill=True, **TILE_COMPARE_REFILL),
        "sorted": tk.TileConfig(**TILE_COMPARE_TAIL)}
    defaults = dict(n_cdf=201, tab=False, budget=tk.TABLE_SMEM, rr=True,
                    src="directional", scene={})
    cases = [
        dict(label="bench scene, HG"),
        dict(label="per-cell ssa", scene=dict(cell_ssa=True)),
        dict(label="10001-step row in shared memory (opt-in)", n_cdf=10001,
             tab=True),
        dict(label="10001-step row from global memory", n_cdf=10001,
             tab=True, budget=0),
        dict(label="20001-step row past the budget", n_cdf=20001, tab=True),
        dict(label="2 components", scene=dict(ncomp=2)),
        dict(label="3 components, tabulated", scene=dict(ncomp=3),
             tab=True),
        dict(label="empty half (skip chain)", scene=dict(empty_half=True)),
        dict(label="random azimuth", src="random_azimuth"),
        dict(label="flux", src="flux"),
        dict(label="spotlight", src="spotlight"),
        dict(label="no roulette", rr=False),
    ]
    # the refill schedule on every case, the sorted one on the four
    # sources (the bench scene's directional beam and the three others)
    runs = [(i, case, "refill") for i, case in enumerate(cases)]
    runs += [(i, case, "sorted") for i, case in enumerate(cases)
             if case["label"] == "bench scene, HG" or "src" in case]
    domains = {}
    max_err = 0.0
    for i, case, schedule in runs:
        c = {**defaults, **case}
        tcfg = schedules[schedule]
        key = (c["n_cdf"], tuple(sorted(c["scene"].items())))
        if key not in domains:
            domains[key] = _dense_domain(*dense_args, n_cdf_steps=c["n_cdf"],
                                         **c["scene"])
        dom = domains[key]
        if c["tab"]:  # as read from a file: the tabulated rows
            dom = dataclasses.replace(dom, all_hg=False)
        inv_bytes = 8 * dom.tables.inverse.numel()
        table = ("analytic HG" if not c["tab"] else
                 f"table {inv_bytes} B in "
                 + ("shared memory" if inv_bytes <= c["budget"]
                    else "global memory"))
        if c["n_cdf"] == 10001 and c["budget"]:
            assert 48 * 1024 < inv_bytes <= c["budget"], inv_bytes
        seed = rng.batch_seed(50, i)

        def run(launch):
            return tk.run_batch_tile(dom, surface, sources[c["src"]], seed,
                                     tcfg, TILE_COMPARE_POOL,
                                     TILE_COMPARE_PHOTONS,
                                     use_russian_roulette=c["rr"],
                                     launch=launch)

        before = tk.TILE_LAUNCHES
        rk_, s_k = _timed(lambda: run(functools.partial(
            tk.tile_pass, table_smem=c["budget"])))
        assert tk.TILE_LAUNCHES - before == rk_.n_passes > 0, "kernel not run"
        rp, s_p = _timed(lambda: run(tk.tile_pass_plain))
        n = rk_.n_started
        per_col = n / rk_.flux_up.numel()
        # per column, relative to the photons per column or, in a column
        # that holds more (the spotlight's), to its own value
        err = max(float(((a.double() - b.double()).abs()
                         / b.double().abs().clamp(min=per_col)).max())
                  for a, b in ((rk_.flux_up, rp.flux_up),
                               (rk_.flux_down, rp.flux_down),
                               (rk_.flux_absorbed, rp.flux_absorbed)))
        rta_k = tuple(float(a.double().sum()) / n for a in (
            rk_.flux_up, rk_.flux_down, rk_.flux_absorbed))
        rta_p = tuple(float(a.double().sum()) / rp.n_started for a in (
            rp.flux_up, rp.flux_down, rp.flux_absorbed))
        gap = max(abs(a - b) for a, b in zip(rta_k, rta_p))
        max_err = max(max_err, err)
        print(f"tile compare {schedule} [{c['label']}] plan "
              f"{tk.plan_for(dom)}, "
              f"{c['src']}, roulette={c['rr']}, {table}: kernel "
              f"R/T/A={rta_k} plain={rta_p} gap={gap:.2e} column "
              f"gap={err:.2e}; photons {n}/{rp.n_started} passes "
              f"{rk_.n_passes}/{rp.n_passes} (tail {rk_.n_tail}/"
              f"{rp.n_tail}) n_bad {rk_.n_bad}/{rp.n_bad} "
              f"lane-steps {rk_.lane_steps}/{rp.lane_steps}; kernel "
              f"{s_k:.3f} s plain {s_p:.3f} s", flush=True)
        assert n == rp.n_started == TILE_COMPARE_PHOTONS, c["label"]
        if schedule == "sorted":
            assert rk_.n_tail > 0, c["label"]  # the follow mode ran
        assert (rk_.n_passes, rk_.n_tail, rk_.n_bad, rk_.lane_steps,
                rk_.n_real) == (rp.n_passes, rp.n_tail, rp.n_bad,
                                rp.lane_steps, rp.n_real), c["label"]
        assert err < TILE_COLUMN_TOL_KERNEL_VS_PLAIN, (c["label"], err)
        assert gap < TILE_RTA_TOL_KERNEL_VS_PLAIN, (c["label"], gap)
    return max_err


def phase_dense_deck(tk, sk, ck, rk, cli, io_netcdf, dense_cloud_scene):
    """run/dense_cloud_mono.nml through the CLI on cuda on the port's
    DenseCloud.dom, then the deck cut to 16 x 262,144 photons against the
    JAX package's frozen values."""
    deck = (ROOT / "run" / "dense_cloud_mono.nml").read_text()
    cut = (deck.replace("numPhotonsPerBatch = 2097152",
                        "numPhotonsPerBatch = 262144")
           .replace("nLanes = 262144", "nLanes = 32768"))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            grid, comps, _ = dense_cloud_scene()
            io_netcdf.write_domain("DenseCloud.dom", grid, comps,
                                   surface_albedo=0.2)
            out, seconds, launches = _run_cli_deck(
                cli, rk, deck, ck=ck, domain=None, sk=sk, tk=tk)
            for f in ("dense_flux.out", "dense_results.nc"):
                assert (tmp / f).stat().st_size > 0, f
            out_c, seconds_c, launches_c = _run_cli_deck(
                cli, rk, cut, ck=ck, domain=None, sk=sk, tk=tk)
            means, se, _ = _flux_file_means(tmp / "dense_flux.out")
        finally:
            os.chdir(cwd)
    n = out["total_photons"]
    rta = (out["mean_flux_up"], out["mean_flux_down"],
           out["mean_flux_absorbed"])
    print(f"dense deck: {n} photons in {out['n_batches']} batches, "
          f"n_bad={out['n_bad']}, R/T/A={rta}, {seconds:.2f} s "
          f"({n / seconds:.4g} photons/s incl. setup and output), "
          f"{out['tile_passes']} passes, launches "
          f"record/radiance/column/separable/tiled {launches}", flush=True)
    assert n == 16 * 2_097_152 and out["n_batches"] == 16
    assert out["n_bad"] <= DENSE_DECK_MAX_BAD, out["n_bad"]
    assert launches[4] == out["tile_passes"] > 0, launches
    assert launches[0] == launches[2] == launches[3] == 0, launches
    n_c = out_c["total_photons"]
    print(f"dense deck at 16 x 262,144: R/T/A={means} +- {se}, "
          f"n_bad={out_c['n_bad']}, {seconds_c:.2f} s, {launches_c[4]} tiled "
          f"launches; JAX package "
          f"{JAX_DENSE_RTA} +- {JAX_DENSE_RTA_SE}", flush=True)
    assert n_c == 16 * 262_144 and out_c["n_bad"] <= DENSE_DECK_MAX_BAD
    assert launches_c[4] > 0 and sum(launches_c[:4]) == 0, launches_c
    assert all(abs(a / b - 1) < 1e-6 for a, b in zip(
        means, (out_c["mean_flux_up"], out_c["mean_flux_down"],
                out_c["mean_flux_absorbed"])))
    for got, got_se, want, want_se, name in zip(
            means, se, JAX_DENSE_RTA, JAX_DENSE_RTA_SE, "RTA"):
        sigma = (got_se ** 2 + want_se ** 2) ** 0.5
        assert abs(got - want) < 4.5 * sigma, (name, got, want, 4.5 * sigma)
    return dict(launches=launches[4], passes=out["tile_passes"],
                seconds=seconds, out=out)


def _event_timed(fn):
    """``fn`` with CUDA events recorded around each call; returns (the
    wrapper, the list of (start, end) events)."""
    import torch

    events = []

    def timed(*args, **kwargs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args, **kwargs)
        e1.record()
        events.append((e0, e1))

    return timed, events


def _tile_batch(tk, run, seed, label):
    """One dense batch through ``run(seed)`` (``_evented_batch``), with
    its launches (the tiled kernel's passes) under the names 4e reports."""
    t, res = _evented_batch(tk, run, seed, f"dense headline [{label}]")
    assert res["launches"] == t.n_passes, (res["launches"], t.n_passes)
    res.update(passes=t.n_passes,
               kernel_ms_per_pass=res["kernel_ms_per_launch"],
               wall_ms_per_pass=res["wall_ms_per_launch"])
    return t, res


# Steps a launch of the refill schedules tried in 4c, 4d and 4e
# (record_kernel.REFILL_STEPS and tile_kernel.REFILL_STEPS are chosen from
# them)
STEPS_SWEEP = (128, 256, 512, 1024, 2048, 4096, 8192)


def phase_tile_headline(tk, dense_cloud_scene, build_domain, Surface,
                        illumination, KernelConfig, run_batch, rng):
    """The dense headline of bench.py:306-342 (2^18 slots, 2^21 photons):
    the A/B of the two schedules in turns, refill, sorted, sorted, refill
    (the refill schedule through run_batch, its default; the sorted passes
    to the JAX package's drain floor, pool / 64, then the tail, through
    run_batch_tile_tallies): photons/s, launches (passes), kernel and wall
    ms per launch, lane-steps per photon and the card's busy share (CUDA
    events); the refill schedule at STEPS_SWEEP steps a launch; the sorted
    passes with the drain floor alone; kernel and plain ms of the refill
    schedule's first launch."""
    import dataclasses

    grid, comps, _ = dense_cloud_scene(128, 128, 64, ssa=0.99, device="cuda")
    t0 = time.perf_counter()
    dom = build_domain(grid, comps, macro_factor=0, n_cdf_steps=201)
    build_s = time.perf_counter() - t0
    surface = Surface.lambertian(0.2)
    source = illumination.directional(0.5, 0.0)
    n_slots, n_photons = 1 << 18, 1 << 21
    cfg = KernelConfig(n_lanes=n_slots, photons_per_lane=8,
                       max_steps=1_000_000, need_volume_absorption=False)
    sorted_cfg = tk.sorted_config(cfg.max_steps)

    def refill(seed):
        before = tk.TILE_LAUNCHES
        t = run_batch(dom, surface, source, seed, cfg)
        assert tk.TILE_LAUNCHES - before == t.n_passes, "not the tiled kernel"
        return t

    def sorted_passes(seed):
        return tk.run_batch_tile_tallies(dom, surface, source, seed, cfg,
                                         tcfg=sorted_cfg)

    schedules = {"refill": refill, "sorted": sorted_passes}
    for run in schedules.values():  # warm-up batches
        run(rng.batch_seed(0, 99))
    turns = {"refill": [], "sorted": []}
    for name in ("refill", "sorted", "sorted", "refill"):
        t, r = _tile_batch(tk, schedules[name], rng.batch_seed(0, 0),
                           f"{name} schedule")
        assert t.n_photons == n_photons and t.volume_absorption is None
        assert t.n_bad == 0, (name, t.n_bad)
        turns[name].append(r)
    res = {}
    for name, rs in turns.items():
        res[name] = {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]
                     if k != "rta"}
        res[name]["turns"] = rs
    gain = res["refill"]["photons_per_s"] / res["sorted"]["photons_per_s"]
    print(f"dense headline A/B (means of two turns): refill "
          f"{res['refill']['photons_per_s']:.6g} photons/s, "
          f"{res['refill']['passes']:.1f} launches, kernel "
          f"{res['refill']['kernel_ms_per_pass']:.4f} ms/launch, busy "
          f"{res['refill']['busy']:.3f}; sorted "
          f"{res['sorted']['photons_per_s']:.6g} photons/s, "
          f"{res['sorted']['passes']:.1f} passes, kernel "
          f"{res['sorted']['kernel_ms_per_pass']:.4f} ms/pass, busy "
          f"{res['sorted']['busy']:.3f}; refill / sorted photons/s "
          f"{gain:.3f} (domain build {build_s:.2f} s)", flush=True)
    # steps per launch of the refill schedule
    res["k_sweep"] = {}
    for k in STEPS_SWEEP + STEPS_SWEEP[::-1]:
        tcfg = tk.refill_config(cfg.max_steps, k)
        _, r = _tile_batch(tk, lambda seed: tk.run_batch_tile_tallies(
            dom, surface, source, seed, cfg, tcfg=tcfg),
            rng.batch_seed(0, 0), f"refill, {k} steps a launch")
        res["k_sweep"].setdefault(k, []).append(r["photons_per_s"])
    print("dense headline, refill photons/s by steps a launch: "
          + ", ".join(f"{k}: {sum(v) / len(v):.6g}"
                      for k, v in sorted(res["k_sweep"].items())),
          flush=True)
    # the JAX package's default: the sorted passes stop at pool / 64 alive
    t64, sec64 = _timed(lambda: tk.run_batch_tile_tallies(
        dom, surface, source, rng.batch_seed(0, 0), cfg,
        tcfg=tk.TileConfig()))
    res["drain64"] = dict(photons_per_s=t64.n_photons / sec64,
                          passes=t64.n_passes, n_bad=t64.n_bad)
    print(f"dense headline with the pool / 64 drain floor: "
          f"{t64.n_photons / sec64:.6g} photons/s, {t64.n_passes} passes, "
          f"n_bad {t64.n_bad}", flush=True)
    # kernel and plain on the refill schedule's first launch
    tcfg1 = dataclasses.replace(tk.refill_config(cfg.max_steps),
                                max_passes=1)
    for name, fn in (("kernel", tk.tile_pass), ("plain", tk.tile_pass_plain)):
        launch, ev = _event_timed(fn)
        tk.run_batch_tile(dom, surface, source, rng.batch_seed(0, 1), tcfg1,
                          n_slots, n_photons, launch=launch)
        _sync()
        res[f"{name}_ms_first"] = ev[0][0].elapsed_time(ev[0][1])
    print(f"dense headline, refill schedule's first launch "
          f"({tcfg1.k_steps} steps): kernel {res['kernel_ms_first']:.4f} ms, "
          f"plain {res['plain_ms_first']:.4f} ms", flush=True)
    res.update(n_slots=n_slots, n_f=tk.tile_fields(dom)[0],
               n_cells=dom.grid.nx * dom.grid.ny * dom.grid.nz,
               nxy=dom.grid.nx * dom.grid.ny)
    return res


def phase_multi_deck(rk, ck, sk, tk, cli, io_netcdf, step_cloud_multi_scene):
    """run/step_cloud_multi3_mono.nml through the CLI on cuda on the
    file its header writes; only the record kernel may launch; the means
    against the JAX package's frozen values."""
    deck = (ROOT / "run" / "step_cloud_multi3_mono.nml").read_text()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            grid, comps, temps = step_cloud_multi_scene(analytic=False,
                                                        device="cpu")
            io_netcdf.write_domain("StepCloudMulti3.dom", grid, comps,
                                   temps=temps)
            out, seconds, launches = _run_cli_deck(
                cli, rk, deck, ck=ck, domain=None, sk=sk, tk=tk)
            for f in ("StepCloudMulti3_flux.out",
                      "StepCloudMulti3_results.nc"):
                assert (tmp / f).stat().st_size > 0, f
            means, se, _ = _flux_file_means(tmp / "StepCloudMulti3_flux.out")
        finally:
            os.chdir(cwd)
    n = out["total_photons"]
    print(f"3-component deck: {n} photons in {out['n_batches']} batches, "
          f"n_bad={out['n_bad']}, R/T/A={means} +- {se}, {seconds:.2f} s "
          f"({n / seconds:.4g} photons/s incl. setup and output), launches "
          f"record/radiance/column/separable/tiled {launches}; JAX package "
          f"{JAX_MULTI3_RTA} +- {JAX_MULTI3_RTA_SE}", flush=True)
    assert n == 16 * 1_048_576 and out["n_batches"] == 16
    assert out["n_bad"] == 0, out["n_bad"]
    assert launches[0] > 0 and sum(launches[1:]) == 0, launches
    for got, got_se, want, want_se, name in zip(
            means, se, JAX_MULTI3_RTA, JAX_MULTI3_RTA_SE, "RTA"):
        sigma = (got_se ** 2 + want_se ** 2) ** 0.5
        assert abs(got - want) < 4.5 * sigma, (name, got, want, 4.5 * sigma)
    return dict(launches=launches[0], seconds=seconds, out=out)


def phase_multi_headline(rk, make_step_cloud_multi, Surface, illumination,
                         KernelConfig, rng):
    """bench.py:150-170's multi_component_3_step_cloud (2^16 lanes x 256
    photons, 3D tally) through run_batch_record_tallies, as run_batch
    runs it: the A/B of the refill schedule and JAX's geometry (photons/s,
    launches per batch, kernel ms per launch from CUDA events, busy
    share), the occupancy, and the first refill launch of a 2^20-photon
    batch kernel against plain twin, with its bound
    (``_record_flux_timing``)."""
    dom = make_step_cloud_multi(ssa=0.99, n_components=3, macro_factor=8,
                                device="cuda")
    cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=256,
                       max_steps=800_000)
    nx, ny, nz = dom.grid.shape
    res = _record_flux_timing(
        rk, "3-component headline", dom, Surface.lambertian(0.0),
        illumination.directional(0.5, 0.0), cfg, rng.batch_seed(0, 0),
        4 * 8 * nx * ny * nz, 4 * (2 * nx * ny + nx * ny * nz),
        extra_ops=lambda t: t.n_real * OPS_PER_COMPONENT_CHOICE)
    t = res["tallies"]
    assert t.volume_absorption is not None and t.n_bad == 0
    assert 0 < t.n_real <= t.n_lane_steps, (t.n_real, t.n_lane_steps)
    return res


# Operations of an emission birth in csrc/record_kernel.cu's refill, on
# top of the birth step's own (OPS_PER_LANE_STEP counts the step's tau,
# collision, angle, azimuth, roulette and component uniforms, none of the
# refill's). A counter uniform is 24 integer operations once the step's
# ctr * 256 * K is hoisted: the two fmix32 (16), the site add, the xors and
# the second key's add (5), the shift, convert and scale (3). Every birth:
# seven uniforms (x, y, split, bin, acceptance, mu, azimuth: 168); the split,
# the bin (multiply, convert, clamp) and the acceptance with its alias
# select (8); the azimuth, the sine of the polar angle (a square root's
# expansion) and cosf/sinf (~40 each as instruction expansions) (53).
OPS_PER_EMISSION_BIRTH = 229
# An atmospheric birth adds the z uniform (24), the cell decomposition
# (two integer divisions of ~20 instructions each and their remainders:
# 46), the position in the voxel (three converts, adds, multiplies and adds)
# with the z clamp (14), mu with its floor (6) and the pre-credit's address
# and atomic (3); a surface birth adds its position (4) and mu (a maximum
# and a square root, 6).
OPS_PER_ATMOSPHERIC_BIRTH = 93
OPS_PER_SURFACE_BIRTH = 10
# run/broadband_lw.nml cut to 8 batches of 131,072 photons, from the JAX
# package's CLI on the CPU (its XLA wave kernel with the per-voxel emission
# source, threefry streams, independent of the port's kernel), on the files
# that mcbrat3d_tpu_torch/tools/lw_inputs.py writes:
# 64 batches (one per bin); domain-mean up, down and net absorbed flux
# [W m^-2] with their standard errors over batches, the total emitted flux,
# and the net absorption profile [W m^-3 per unit km] with its standard
# errors per level.
JAX_LW_GENERIC = (80.25655936395336, 106.82387924909106, -65.20011669518334)
JAX_LW_GENERIC_SE = (1.06476693, 0.792354479, 1.49502190)
JAX_LW_GENERIC_TOTAL_FLUX = 1779.0873694047132
JAX_LW_GENERIC_PROFILE = (
    -0.012841932, -0.0113515287, -0.0057186631, -0.0046268058,
    -0.0018193546, -0.0013025778, 0.0036257545, 0.0024083331, 0.001248404,
    0.017882476, 0.0105800755, -0.0035338005, -0.0296375278, -0.1639696351,
    -0.0116248507, -0.0096243315, -0.0088716703, -0.0071496344,
    -0.0058607442, -0.0046419063, -0.0042952532, -0.0036376084,
    -0.0033602159, -0.0026774821)
JAX_LW_GENERIC_PROFILE_SE = (
    0.0017857813, 0.0014269312, 0.0014874039, 0.0011509424, 0.0013470681,
    0.0013494869, 0.0009747237, 0.0010229717, 0.0009476272, 0.0021449879,
    0.0020501336, 0.0022630923, 0.0023767999, 0.0030498103, 0.0005975178,
    0.0004941512, 0.0005519183, 0.000482439, 0.0004605089, 0.0004457313,
    0.0003639319, 0.0003128483, 0.0003045646, 0.0003134025)


def _emission_birth_ops(n_photons, atms_fraction):
    """Refill operations of ``n_photons`` emission births, a share
    ``atms_fraction`` of them atmospheric (the source's own split: the
    count that a run draws differs from it by a binomial spread, ~1e-3 of
    it at the headline's 2^24 photons)."""
    n_atm = n_photons * atms_fraction
    return (n_photons * OPS_PER_EMISSION_BIRTH
            + n_atm * OPS_PER_ATMOSPHERIC_BIRTH
            + (n_photons - n_atm) * OPS_PER_SURFACE_BIRTH)


def lw_emission_scene(m, macro_factor=8, n_cdf_steps=None):
    """bench.py:173-218's lw_emission_2comp scene built with the port: a
    32 x 32 x 24 random cloud (half the cells filled, beta up to 30 km^-1,
    ssa 0.6, HG 0.85, analytic) over an isotropic gas of beta 1.0 km^-1,
    3D temperatures of 250-290 K, and its per-voxel emission source (surface
    290 K, emissivity 0.95, 10 um). ``n_cdf_steps`` tabulates the cloud's
    HG row instead (the deck's 10,001 steps). ``m`` holds the port's
    modules."""
    import dataclasses

    import numpy as np

    nx, ny, nz = 32, 32, 24
    rs = np.random.RandomState(0)
    grid = m.Grid.regular(nx, ny, nz, 0.1, 0.1, 0.05, device="cuda")
    tbl = m.PhaseFunctionTable(
        [m.PhaseFunction.henyey_greenstein(0.85, 64)], key=[1.0])
    gas_tbl = m.PhaseFunctionTable([m.PhaseFunction.isotropic()], key=[1.0])
    cld = rs.rand(nx, ny, nz) * 30.0 * (rs.rand(nx, ny, nz) > 0.5)
    gas = np.full((1, 1, nz), 1.0)
    comps = [m.OpticalComponent("cloud", cld, np.full_like(cld, 0.6),
                                np.zeros(cld.shape, np.int32), tbl),
             m.OpticalComponent("gas", gas, np.zeros_like(gas),
                                np.zeros(gas.shape, np.int32), gas_tbl)]
    temps = 250.0 + 40.0 * rs.rand(nx, ny, nz)
    kw = {} if n_cdf_steps is None else dict(n_cdf_steps=n_cdf_steps)
    dom = m.build_domain(grid, comps, temps=temps, macro_factor=macro_factor,
                         **kw)
    if n_cdf_steps is not None:  # a file-read domain: tabulated rows
        dom = dataclasses.replace(dom, all_hg=False)
    w = m.weights.emission_weighting(
        grid, temps, m.weights.absorption_coefficient(comps, grid), 290.0,
        0.95, 10.0)
    return dom, m.illumination.emission(w.voxel_cdf, w.frac_atms_power,
                                        grid.shape, device="cuda")


def _net_cell_z(a, b):
    """Largest per-cell z of two net absorption tallies (pre-credits of
    -1 included): the difference over the square root of the cell's
    weight, at least 1."""
    a, b = a.double().cpu(), b.double().cpu()
    sigma = ((a.abs() + b.abs()) / 2).clamp(min=1.0).sqrt()
    return float(((a - b).abs() / sigma).max())


def phase_lw_compare(rk, m, KernelConfig, rng):
    """K1's emission refill and pre-credits against the plain step on the
    card, same seeds, on the headline's scene at 2^18 photons: macro 8 and
    0, analytic HG and the deck's 10,001-step rows, albedo 0.05 and 0,
    roulette on and off (a half fraction of the 16 combinations, every pair
    of settings covered). Equal photons, real collisions within 1e-4, flux
    up/down and the net absorption (pre-credits included) per photon within
    2e-3, per-cell net absorption within 5 sigma; returns the
    largest per-pixel difference of the normalized fluxes."""
    cases = [(8, None, 0.05, True), (8, None, 0.0, False),
             (8, 10001, 0.05, False), (8, 10001, 0.0, True),
             (0, None, 0.05, False), (0, None, 0.0, True),
             (0, 10001, 0.05, True), (0, 10001, 0.0, False)]
    max_err = 0.0
    for i, (mf, steps, albedo, rr) in enumerate(cases):
        dom, source = lw_emission_scene(m, mf, steps)
        surface = m.Surface.lambertian(albedo)
        cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=4,
                           max_steps=800_000, lw_mode=True,
                           use_russian_roulette=rr)
        seed = rng.batch_seed(30, i)
        before = rk.LW_LAUNCHES
        tk, sk = _timed(lambda: rk.run_batch_record_tallies(
            dom, surface, source, seed, cfg))
        assert rk.LW_LAUNCHES > before, "kernel was not launched"
        tp, sp = _timed(lambda: rk.run_batch_record_tallies(
            dom, surface, source, seed, cfg, launch=rk.record_launch_plain))
        assert tk.n_photons == tp.n_photons == 1 << 18, (tk.n_photons,
                                                         tp.n_photons)
        assert tk.n_bad == 0 and tp.n_bad == 0, (tk.n_bad, tp.n_bad)
        assert tk.volume_absorption is not None
        rta_k, rta_p = _rta(tk), _rta(tp)
        gap = max(abs(a - b) for a, b in zip(rta_k, rta_p))
        z_flux, err = _pixel_z([(tk.flux_up, tp.flux_up),
                                (tk.flux_down, tp.flux_down)], tk.n_photons)
        z_vol = _net_cell_z(tk.volume_absorption, tp.volume_absorption)
        max_err = max(max_err, err)
        print(f"lw compare macro={mf} cdf_steps={steps} albedo={albedo} "
              f"roulette={rr}: kernel up/down/net per photon={rta_k} plain="
              f"{rta_p} gap={gap:.3e} pixel z_max={z_flux:.2f} net cell "
              f"z_max={z_vol:.2f} real collisions {tk.n_real}/{tp.n_real} "
              f"kernel {sk:.3f} s plain {sp:.3f} s", flush=True)
        assert rta_k[2] < 0, "no pre-credit landed"
        assert gap < RTA_TOL_KERNEL_VS_PLAIN, gap
        assert z_flux < 5.0 and z_vol < 5.0, (z_flux, z_vol)
        assert abs(tk.n_real - tp.n_real) <= (REAL_TOL_KERNEL_VS_PLAIN
                                              * tp.n_real), (tk.n_real,
                                                             tp.n_real)
    return max_err


def phase_lw_anchors(le, m, KernelConfig, run_batch, rng):
    """Emission anchors through run_batch on the card: the isothermal black
    box (an optically thick isothermal atmosphere over a black surface at
    its temperature radiates B_lambda(T) upward, within 5%:
    tests/test_pallas.py:1460-1500, the fresh hold) and the isothermal
    pre-credit balance (tests/test_spectral.py:126-148)."""
    import numpy as np

    def isothermal(nx, ny, nz, dx, dz, ext):
        grid = m.Grid.regular(nx, ny, nz, dx, dx, dz, device="cuda")
        temps = np.full((nx, ny, nz), 288.0)
        e = np.full((nx, ny, nz), ext)
        comp = m.OpticalComponent(
            "abs", e, np.zeros_like(e), np.zeros(e.shape, np.int32),
            m.PhaseFunctionTable([m.PhaseFunction.isotropic()], key=[1.0]))
        dom = m.build_domain(grid, [comp], temps=temps, n_cdf_steps=101,
                             compute_intensity_tables=True)
        w = m.weights.emission_weighting(
            grid, temps, m.weights.absorption_coefficient([comp], grid),
            288.0, 1.0, 10.0)
        return dom, w, m.illumination.emission(
            w.voxel_cdf, w.frac_atms_power, grid.shape, device="cuda")

    dom, w, source = isothermal(4, 4, 8, 0.25, 0.25, 6.0)
    t = run_batch(dom, m.Surface.lambertian(0.0), source,
                  rng.batch_seed(0, 2),
                  KernelConfig(n_lanes=1 << 13, photons_per_lane=8,
                               max_steps=4000, lw_mode=True),
                  intensity_config=le.IntensityConfig(
                      n_dirs=2, use_russian_roulette=False,
                      use_hybrid_phase=False),
                  intensity_dirs=le.make_intensity_directions(
                      [1.0, 0.6], [0.0, 90.0], device="cuda"))
    assert t.n_bad == 0 and t.n_photons == 8 << 13
    rad = [float(v) * w.flux for v in
           t.normalized(dom.grid).intensity.double().mean(dim=(0, 1))]
    b = m.planck.planck_radiance(10.0, 288.0)
    print(f"anchor isothermal black box: I={rad} Planck B={b:.6g}",
          flush=True)
    for got in rad:
        assert abs(got / b - 1.0) < 0.05, (got, b)

    dom, w, source = isothermal(2, 2, 4, 1.0, 0.5, 3.0)
    t = run_batch(dom, m.Surface.lambertian(0.0), source,
                  rng.batch_seed(1, 2),
                  KernelConfig(n_lanes=1 << 14, photons_per_lane=16,
                               max_steps=4000, lw_mode=True))
    n = t.n_photons
    net = float(t.volume_absorption.double().sum()) / n
    births = n - float(t.flux_up.double().sum()
                       + t.flux_down.double().sum()) - net * n
    f = source.atms_fraction
    sigma = (n * f * (1.0 - f)) ** 0.5
    print(f"anchor isothermal balance: net {net:.5f} per photon, "
          f"{births:.0f} atmospheric births against {n * f:.0f} expected",
          flush=True)
    assert t.n_bad == 0 and -0.2 < net < 0.005, net
    assert abs(births - n * f) < 5.0 * sigma + 1.0, (births, n * f)


def phase_lw_generic_deck(rk, ck, sk, tk, cli, write_lw_broadband_inputs):
    """run/broadband_lw.nml through the CLI on cuda on the inputs of
    mcbrat3d_tpu_torch/tools/lw_inputs.py: every bin built generically with
    the per-voxel source, only the record kernel launched (each launch
    with the emission refill), no plain step; means and profile against the
    JAX package's frozen values."""
    deck = (ROOT / "run" / "broadband_lw.nml").read_text()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            write_lw_broadband_inputs(".")
            gen_s = time.perf_counter() - t0
            out, seconds, launches = _run_cli_deck(
                cli, rk, deck, ck=ck, domain=None, sk=sk, tk=tk)
            for f in ("LW_flux.out", "LW_results.nc"):
                assert (tmp / f).stat().st_size > 0, f
            means, se, flux = _flux_file_means(tmp / "LW_flux.out")
            from scipy.io import netcdf_file
            with netcdf_file("LW_results.nc", "r", mmap=False) as nc:
                prof = [float(v) for v in nc.variables["absorptionProfile"][:]]
                prof_se = [float(v) for v in
                           nc.variables["absorptionProfile_StdErr"][:]]
        finally:
            os.chdir(cwd)
    n = out["total_photons"]
    transport_s = (out["elapsed_seconds"] - out["setup_seconds"]
                   - out["build_seconds"])
    print(f"LW generic deck: inputs written in {gen_s:.2f} s; {n} photons "
          f"in {out['n_batches']} batches, n_bad={out['n_bad']}, "
          f"up/down/net={means} +- {se}, total flux {flux!r}; CLI "
          f"{seconds:.2f} s (run {out['elapsed_seconds']} s: setup "
          f"{out['setup_seconds']} s before the first transport, later bins' "
          f"host builds {out['build_seconds']} s, transport and the rest "
          f"{transport_s:.3f} s), launches record/radiance/column/separable/"
          f"tiled/emission {launches}; JAX package {JAX_LW_GENERIC} +- "
          f"{JAX_LW_GENERIC_SE}, total flux {JAX_LW_GENERIC_TOTAL_FLUX!r}",
          flush=True)
    assert n == 8 * 1_048_576 and out["n_bad"] == 0, (n, out["n_bad"])
    assert launches[0] > 0 and launches[5] == launches[0], launches
    assert sum(launches[1:5]) == 0, launches
    assert abs(flux / JAX_LW_GENERIC_TOTAL_FLUX - 1.0) < 1e-8, flux
    worst = 0.0
    for got, got_se, want, want_se, name in (
            list(zip(means, se, JAX_LW_GENERIC, JAX_LW_GENERIC_SE,
                     ("up", "down", "net")))
            + list(zip(prof, prof_se, JAX_LW_GENERIC_PROFILE,
                       JAX_LW_GENERIC_PROFILE_SE,
                       (f"profile level {k}" for k in range(24))))):
        sigma = (got_se ** 2 + want_se ** 2) ** 0.5
        worst = max(worst, abs(got - want) / sigma)
        assert abs(got - want) < 4.5 * sigma, (name, got, want, 4.5 * sigma)
    print(f"LW generic deck: largest gap to the JAX package {worst:.2f} "
          "combined sigma", flush=True)
    return dict(launches=launches[0], lw_launches=launches[5],
                seconds=seconds, out=out, transport_s=transport_s)


def phase_lw_headline(rk, m, KernelConfig, rng):
    """bench.py:173-218's lw_emission_2comp (macro 8, albedo 0.05,
    lw_mode, 2^16 lanes x 256 photons) through run_batch_record_tallies,
    as run_batch runs it: the A/B of the refill schedule and JAX's
    geometry, the occupancy, and the first refill launch of a 2^20-photon
    batch kernel against plain twin, with its bound (the births' refill
    operations besides the steps'; ``_record_flux_timing``)."""
    dom, source = lw_emission_scene(m)
    cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=256,
                       max_steps=800_000, lw_mode=True)
    nx, ny, nz = dom.grid.shape
    n_cells = nx * ny * nz
    res = _record_flux_timing(
        rk, "LW emission headline", dom, m.Surface.lambertian(0.05), source,
        cfg, rng.batch_seed(0, 0),
        # 8-float records and the alias pair, read once
        4 * (8 + 2) * n_cells, 4 * (2 * nx * ny + n_cells),
        extra_ops=lambda t: (t.n_real * OPS_PER_COMPONENT_CHOICE
                             + _emission_birth_ops(t.n_photons,
                                                   source.atms_fraction)))
    t = res["tallies"]
    assert t.volume_absorption is not None and t.n_bad == 0
    assert _rta(t)[2] < 0, "no pre-credit landed"
    return res


def phase_radar_headline(rk, m, KernelConfig, rng):
    """bench.py:269-303's radar_scale (640 x 1 x 54, macro 8, albedo 0.1,
    the 3D tally, 2^16 lanes x 64 photons) through
    run_batch_record_tallies, as run_batch runs it: the occupancy and the
    A/B of the refill schedule and JAX's geometry (``_record_flux_timing``
    without the first launch; the bound of a refill launch reads the
    records once and writes the columns and the 3D tally once)."""
    cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=64,
                       max_steps=800_000, need_volume_absorption=True)
    dom = radar_scene(m)
    nx, ny, nz = dom.grid.shape
    return _record_flux_timing(
        rk, "radar_scale headline", dom, m.Surface.lambertian(0.1),
        m.illumination.directional(0.5, 0.0), cfg, rng.batch_seed(0, 0),
        4 * dom.cell_records.numel(), 4 * (2 * nx * ny + nx * ny * nz),
        first=False)


def vol_tally_occupancy(rk, m):
    """Blocks of 128 threads an SM (the occupancy query) of the record
    kernel's 3D-tally launches on the step cloud, bench.py:173-218's LW
    scene and radar_scale, with the shared tallies a launch takes (the
    whole tally, or the flux columns alone where that costs blocks) and
    with the whole tally."""
    src = m.illumination.directional(0.5, 0.0)
    res = {}
    for name, (dom, source, lw) in (
            ("step_cloud", (m.make_step_cloud(ssa=0.99, macro_factor=8,
                                              device="cuda"), src, False)),
            ("lw_emission_2comp", (*lw_emission_scene(m), True)),
            ("radar_scale", (radar_scene(m), src, False))):
        prm = rk.RecordParams.make(dom, m.Surface.lambertian(0.1), source,
                                   True, 1.0, True, None, None, lw)
        now = rk.occupancy(prm)
        whole = rk.occupancy(prm, 4 * prm.n_acc)
        res[name] = dict(blocks=now["blocks_per_sm"], smem=now["smem"],
                         blocks_whole=whole["blocks_per_sm"],
                         smem_whole=whole["smem"])
        print(f"occupancy {name} (3D tally of {prm.n_acc} floats): "
              f"{now['blocks_per_sm']} blocks of 128 an SM with "
              f"{now['smem']} B of shared tallies; "
              f"{whole['blocks_per_sm']} with the whole tally "
              f"({whole['smem']} B)", flush=True)
    return res


# ---------------------------------------------------------------------------
# K1-d: the uniform RPV surface and the per-pixel albedo (phases 2j, 3l, 3m)
# ---------------------------------------------------------------------------

# JAX's TestRPVSurface surface: rho0, k, theta
STEP_RPV = (0.25, 0.8, -0.15)
# run/step_cloud_radiance.nml's directions (thetaFill 0 60 30, phiFill 0 90
# 90), as the namelist readers expand them
STEP_DIRS6 = ([math.cos(math.radians(t)) for t in (0, 0, 30, 30, 60, 60)],
              [0.0, 90.0] * 3)
# The step cloud of run/step_cloud_mono.nml (make_step_cloud(ssa=0.99),
# beam mu0 0.5, azimuth 0, flux and column absorption) from the JAX
# package's XLA path on the CPU (tools/record_surface_reference.py, threefry
# streams, independent of the port's kernels), 64 batches of 262,144
# photons: R, T, A and the 32 columns of the normalized up flux, means and
# standard errors over batches. Over Surface.rpv(0.25, k=0.8, theta=-0.15)
# (path C, seed 13):
JAX_STEP_RPV = (0.5548040904, 0.396801698, 0.2285246335, 0.4788860083,
    0.4328253698, 0.4072273532, 0.3926951666, 0.385397308, 0.3817031202,
    0.3835380282, 0.3853358794, 0.3913214114, 0.399990839, 0.4083376722,
    0.4200860471, 0.4349788623, 0.4534259061, 0.4704761668, 0.4929157309,
    0.577363627, 0.6767813396, 0.7303882409, 0.7588680238, 0.7655394338,
    0.7651065197, 0.7532883612, 0.7411236707, 0.72614739, 0.7075767433,
    0.689791345, 0.6720519206, 0.654208472, 0.6347203581, 0.612429332,
    0.5692053298)
JAX_STEP_RPV_SE = (0.000101005, 0.000128088, 4.32599e-05, 0.000822806,
    0.000780117, 0.000803749, 0.0007319, 0.000799107, 0.000697661, 0.000740046,
    0.000792878, 0.00071502, 0.000674544, 0.00084854, 0.000819963, 0.000804723,
    0.000732102, 0.000960059, 0.000787375, 0.000938412, 0.00108701, 0.00100356,
    0.00103487, 0.00106446, 0.001142, 0.00102762, 0.000870869, 0.00106424,
    0.00111393, 0.0008516, 0.00100699, 0.00118493, 0.000984937, 0.000841025,
    0.00111147)
# over the 8 x 1 mosaic of albedos 0.05 / 0.65 (path D's flux run, seed 14):
JAX_STEP_PX = (0.5353621235, 0.3775510555, 0.2207555596, 0.4528737636,
    0.405301007, 0.3796834261, 0.3653869159, 0.3576658238, 0.3553606141,
    0.3543574032, 0.3577709771, 0.3653542674, 0.371983896, 0.3835303481,
    0.3991159298, 0.4116419158, 0.4309867341, 0.4537813049, 0.4753358946,
    0.5594248958, 0.6608677907, 0.7182696387, 0.7454574741, 0.7544366969,
    0.7533448068, 0.7411906328, 0.7289489713, 0.7113987356, 0.6953990934,
    0.6784997294, 0.6592855044, 0.6411125334, 0.6198636182, 0.5940501839,
    0.5499073975)
JAX_STEP_PX_SE = (8.81374e-05, 0.000131588, 3.64302e-05, 0.00077107,
    0.000866303, 0.000785496, 0.000722617, 0.000674013, 0.000792504,
    0.00073201, 0.000685901, 0.000496235, 0.000661395, 0.000716672,
    0.000785554, 0.000933109, 0.000842237, 0.000760165, 0.000830242,
    0.000985124, 0.00095312, 0.000969739, 0.00127832, 0.00106868, 0.00102268,
    0.00113601, 0.00109352, 0.00105975, 0.000833798, 0.00101053, 0.000972318,
    0.00104799, 0.000825164, 0.000850859, 0.000875573)
# path D's radiance run (the step cloud with its intensity tables and the
# deck's 7-degree hybrid row, Iwabuchi roulette, zetaMin 0.3; seed 15), 32
# batches of 65,536 photons: R, T, A and the 6 domain-mean radiances in
# the deck's direction order
JAX_STEP_PX_RAD = (0.5356444567, 0.3770696139, 0.2206059392, 0.1287399053,
    0.1286307992, 0.1643738611, 0.1355143601, 0.2947661414, 0.1582749038)
JAX_STEP_PX_RAD_SE = (0.000234413, 0.000352518, 0.000134839, 0.000179103,
    0.000189415, 0.000317488, 0.000269668, 0.000608822, 0.000402313)


def step_checker(np, nxs=8, lo=0.05, hi=0.65):
    """Path D's mosaic, JAX's TestPerPixelSurface._checker(8): nxs x 1
    albedos alternating 0.05 and 0.65 from 0.05 (4 columns a pixel on the
    step cloud), float32."""
    return np.where(np.arange(nxs) % 2 == 0, lo, hi).astype(
        np.float32).reshape(nxs, 1, 1)


def phase_record_surface_compare(rk, le, m, make_step_cloud,
                                 make_step_cloud_multi, KernelConfig, rng):
    """K1-d against the plain step on the card, same seeds and counter
    uniforms: the uniform RPV surface on the step cloud (path C's scene),
    on the 3-component step cloud and in lw_mode with bench.py:173-218's
    emission source; the per-pixel checker on the step cloud as a flux run
    and with the radiance deck's 6 directions (K2); and the 4,096-column
    cap, broken_cloud_scene(nx=64, ny=64, nz=7) over a 64 x 64 albedo
    grid. Every launch of a case takes its surface branch. K1's tolerances:
    equal photons, R/T/A within 2e-3, per-pixel fluxes (and per-cell net
    absorption) within z < 5, real collisions within 1e-4, which bounds the
    photons a last-bit difference parts (expf, logf and sqrtf of the RPV
    weight are the card's own in both, so none is expected); radiance means
    within 5e-3 and normalized pixels within 0.02 (phase 2b's). Returns the
    largest normalized per-pixel gap of the RPV and of the per-pixel
    cases."""
    import numpy as np

    rpv = m.Surface.rpv(*STEP_RPV)
    checker = m.Surface(params=step_checker(np))
    rs = np.random.RandomState(5)
    mosaic = m.Surface(params=(0.05 + 0.75 * rs.rand(64, 64, 1)).astype(
        np.float32))
    flux4 = dict(n_lanes=1 << 16, photons_per_lane=4, max_steps=800_000)
    # (name, scene, surface, branch, config)
    cases = [
        ("RPV, step cloud", "step", rpv, "rpv",
         dict(flux4, need_volume_absorption=False)),
        ("RPV, 3-component step cloud, macro 8", "multi3", rpv, "rpv",
         dict(flux4, need_volume_absorption=True)),
        ("RPV, lw_mode, per-voxel emission", "lw",
         m.Surface.rpv(0.05, STEP_RPV[1], STEP_RPV[2], temperature=290.0,
                       emissivity=0.95), "rpv", dict(flux4, lw_mode=True)),
        ("per-pixel checker, step cloud", "step", checker, "px",
         dict(flux4, need_volume_absorption=True)),
        ("per-pixel checker, 6 directions", "step_rad", checker, "px",
         dict(n_lanes=4096, photons_per_lane=4, max_steps=100_000,
              need_volume_absorption=False)),
        ("per-pixel 64 x 64, broken cloud 64 x 64 x 7", "cap", mosaic, "px",
         dict(flux4, need_volume_absorption=False)),
    ]
    dirs6 = None
    errs = {"rpv": 0.0, "px": 0.0}
    for i, (name, scene, sfc, branch, ckw) in enumerate(cases):
        src = m.illumination.directional(0.5, 0.0)
        icfg = None
        if scene == "step":
            dom = make_step_cloud(ssa=0.99, device="cuda")
        elif scene == "multi3":
            dom = make_step_cloud_multi(n_components=3, ssa=0.99,
                                        macro_factor=8, device="cuda")
        elif scene == "lw":
            dom, src = lw_emission_scene(m, 8)
        elif scene == "step_rad":
            dom = make_step_cloud(ssa=0.99, compute_intensity_tables=True,
                                  hybrid_width_deg=7.0, device="cuda")
            dirs6 = le.make_intensity_directions(*STEP_DIRS6, device="cuda")
            icfg = le.IntensityConfig(n_dirs=6, use_russian_roulette=True,
                                      zeta_min=0.3, use_hybrid_phase=True)
        else:
            grid, comps, _ = m.broken_cloud_scene(nx=64, ny=64, nz=7,
                                                  device="cuda")
            dom = m.build_domain(grid, comps, macro_factor=8,
                                 n_cdf_steps=201)
            assert dom.grid.nx * dom.grid.ny == 4096
        assert not rk.ineligibility_reasons(
            dom, sfc, src, ckw.get("lw_mode", False), False, 0, False)
        cfg = KernelConfig(**ckw)
        seed = rng.batch_seed(34, i)

        def run(launch=rk.record_launch):
            return rk.run_batch_record_tallies(
                dom, sfc, src, seed, cfg, launch=launch,
                intensity_config=icfg,
                intensity_dirs=dirs6 if icfg is not None else None)

        before = (rk.LAUNCHES, rk.RPV_LAUNCHES, rk.PX_LAUNCHES)
        tk, sk = _timed(run)
        launched = (rk.LAUNCHES - before[0], rk.RPV_LAUNCHES - before[1],
                    rk.PX_LAUNCHES - before[2])
        assert launched[0] > 0 and launched[0] == (
            launched[1] if branch == "rpv" else launched[2]), launched
        assert launched[2 if branch == "rpv" else 1] == 0, launched
        tp, sp = _timed(lambda: run(rk.record_launch_plain))
        n = tk.n_photons
        assert n == tp.n_photons == cfg.photons_per_batch, (n, tp.n_photons)
        assert tk.n_bad == 0 and tp.n_bad == 0, (tk.n_bad, tp.n_bad)
        rta_k, rta_p = _rta(tk), _rta(tp)
        gap = max(abs(a - b) for a, b in zip(rta_k, rta_p))
        z_max, err = _pixel_z([(tk.flux_up, tp.flux_up),
                               (tk.flux_down, tp.flux_down)], n)
        errs[branch] = max(errs[branch], err)
        line = (f"surface compare [{name}]: kernel R/T/A={rta_k} plain="
                f"{rta_p} gap={gap:.3e} pixel z_max={z_max:.2f} real "
                f"collisions {tk.n_real}/{tp.n_real}")
        if tk.volume_absorption is not None:
            z_vol = _net_cell_z(tk.volume_absorption, tp.volume_absorption)
            line += f" cell z_max={z_vol:.2f}"
            assert z_vol < 5.0, z_vol
        if icfg is not None:
            mean_k, mean_p = (t.normalized(dom.grid).intensity.double()
                              .mean(dim=(0, 1)) for t in (tk, tp))
            rgap = float(((mean_k - mean_p).abs() / mean_p.abs()).max())
            rz, rerr = _image_gap(tk.intensity, tp.intensity, n, n)
            rerr *= tk.intensity[..., 0].numel()
            errs[branch] = max(errs[branch], rerr)
            line += (f", radiance means {[round(float(v), 6) for v in mean_k]}"
                     f" gap {rgap:.2e} pixel gap {rerr:.2e} z_max {rz:.2f}, "
                     f"events {tk.n_le_events}/{tp.n_le_events}")
            assert rgap < RAD_REL_TOL_KERNEL_VS_PLAIN, rgap
            assert rerr < RAD_PIXEL_TOL_KERNEL_VS_PLAIN, rerr
            assert rz < 5.0, rz
        print(line + f"; {launched[0]} launches, kernel {sk:.3f} s plain "
              f"{sp:.3f} s", flush=True)
        assert gap < RTA_TOL_KERNEL_VS_PLAIN, gap
        assert z_max < 5.0, z_max
        assert abs(tk.n_real - tp.n_real) <= (REAL_TOL_KERNEL_VS_PLAIN
                                              * tp.n_real), (tk.n_real,
                                                             tp.n_real)
    print(f"surface compare: largest normalized pixel gap {errs['rpv']:.3e} "
          f"(RPV), {errs['px']:.3e} (per-pixel)", flush=True)
    return errs["rpv"], errs["px"]


def _step_row(res, radiance=False):
    """(means, standard errors) of R, T, A, then the 32 columns of the up
    flux or the domain-mean radiances."""
    import numpy as np

    keys = ["mean_flux_up", "mean_flux_down", "mean_flux_absorbed"]
    got = [float(res.mean[k]) for k in keys]
    se = [float(res.stderr[k]) for k in keys]
    extra = "mean_intensity" if radiance else "flux_up"
    got += np.asarray(res.mean[extra], np.float64).reshape(-1).tolist()
    se += np.asarray(res.stderr[extra], np.float64).reshape(-1).tolist()
    return got, se


def _record_flux_path_timing(rk, label, dom, sfc, src, KernelConfig, rng,
                             seed):
    """A K1-d flux path's times on one batch of 2^16 lanes x 16 photons
    (flux, column absorption) through ``_record_flux_timing``: the A/B of
    the refill schedule and JAX's geometry and the first refill launch
    kernel against plain twin, with its bound (the state read and written
    once, the records and the albedo per column read once, the tallies
    written once; 300 operations a live lane-step, the RPV weight's ~150
    per reflection not charged, as no launch counts its reflections)."""
    cfg = KernelConfig(n_lanes=1 << 16, photons_per_lane=16,
                       max_steps=400_000, need_volume_absorption=False)
    nxy = dom.grid.nx * dom.grid.ny
    res = _record_flux_timing(
        rk, label, dom, sfc, src, cfg, rng.batch_seed(seed, 0),
        4 * (dom.cell_records.numel() + nxy), 4 * 3 * nxy)
    assert res["tallies"].n_bad == 0
    return res


def phase_rpv_step_cloud(rk, ck, sk, tk, m, make_step_cloud, run_simulation,
                         SimulationConfig, KernelConfig, rng):
    """Path C through run_simulation: the step cloud of
    run/step_cloud_mono.nml over Surface.rpv(0.25, k=0.8, theta=-0.15),
    16 x 2^20 photons, iseed 10, flux and column absorption: the record
    kernel alone with the RPV branch on every launch, no plain step, n_bad
    0, R, T, A and the 32 columns of the up flux within 4.5 combined sigma
    of the JAX package's XLA path (tools/record_surface_reference.py rpv);
    then the RPV flux path's times (``_record_flux_path_timing``: the A/B
    against JAX's geometry and the first refill launch against the plain
    twin)."""
    dom = make_step_cloud(ssa=0.99, device="cuda")
    sfc = m.Surface.rpv(*STEP_RPV)
    src = m.illumination.directional(0.5, 0.0)
    res, sec, launches = _simulate(
        ck, rk, run_simulation, SimulationConfig, dom, sfc, src, sk, tk,
        n_lanes=1 << 17, max_steps=100_000, num_photons_per_batch=1 << 20,
        num_batches=16, iseed=10)
    assert launches[0] == launches[5] > 0, launches
    assert sum(launches[1:5]) + sum(launches[6:]) == 0, launches
    got, se = _step_row(res)
    names = ["R", "T", "A"] + [f"up {k}" for k in range(32)]
    worst = _within_sigma(got, se, JAX_STEP_RPV, JAX_STEP_RPV_SE, names)
    print(f"path C (step cloud over RPV, run_simulation): "
          f"{res.total_photons} photons in {sec:.2f} s, R/T/A {got[:3]} +- "
          f"{se[:3]}, launches (record, RPV) {launches[0]}, "
          f"{launches[5]}; largest gap to JAX's XLA path "
          f"{worst:.2f} combined sigma", flush=True)
    out = _record_flux_path_timing(rk, "RPV flux path", dom, sfc, src,
                                   KernelConfig, rng, 35)
    out.update(rpv_launches=launches[5], seconds=sec, worst=worst)
    return out


def phase_px_step_cloud(rk, ck, sk, tk, m, make_step_cloud, run_simulation,
                        SimulationConfig, KernelConfig, rng):
    """Path D through run_simulation: the step cloud over the 8 x 1
    albedo mosaic (0.05 / 0.65), a flux run (16 x 2^20 photons, iseed 10)
    and a radiance run with run/step_cloud_radiance.nml's 6 directions (8 x
    262,144 photons; the step cloud with its intensity tables and the 7
    degree hybrid row, Iwabuchi roulette, zetaMin 0.3): the record kernel
    alone with the per-pixel branch on every launch (and K2's local
    estimate on every launch of the radiance run), no plain step, n_bad 0,
    R, T, A and the up flux's 32 columns, or the 6 domain-mean radiances,
    within 4.5 combined sigma of the JAX package's XLA path
    (tools/record_surface_reference.py px, px_radiance); then the
    per-pixel flux path's times, as path C's."""
    import numpy as np

    sfc = m.Surface(params=step_checker(np))
    src = m.illumination.directional(0.5, 0.0)
    dom = make_step_cloud(ssa=0.99, device="cuda")
    res, sec, launches = _simulate(
        ck, rk, run_simulation, SimulationConfig, dom, sfc, src, sk, tk,
        n_lanes=1 << 17, max_steps=100_000, num_photons_per_batch=1 << 20,
        num_batches=16, iseed=10)
    assert launches[0] == launches[6] > 0, launches
    assert sum(launches[1:6]) + sum(launches[7:]) == 0, launches
    got, se = _step_row(res)
    names = ["R", "T", "A"] + [f"up {k}" for k in range(32)]
    worst = _within_sigma(got, se, JAX_STEP_PX, JAX_STEP_PX_SE, names)
    up = np.asarray(got[3:])
    bright = np.repeat(np.arange(8) % 2 == 1, 4)
    print(f"path D flux (step cloud over the mosaic, run_simulation): "
          f"{res.total_photons} photons in {sec:.2f} s, R/T/A {got[:3]} +- "
          f"{se[:3]}, up flux over bright/dark pixels "
          f"{up[bright].mean():.4f}/{up[~bright].mean():.4f}, launches "
          f"(record, per-pixel) {launches[0]}, {launches[6]}; largest gap to "
          f"JAX's XLA path {worst:.2f} combined "
          f"sigma", flush=True)
    assert up[bright].mean() > up[~bright].mean()
    dom_r = make_step_cloud(ssa=0.99, compute_intensity_tables=True,
                            hybrid_width_deg=7.0, device="cuda")
    res_r, sec_r, launches_r = _simulate(
        ck, rk, run_simulation, SimulationConfig, dom_r, sfc, src, sk, tk,
        n_lanes=1 << 17, max_steps=100_000, num_photons_per_batch=262144,
        num_batches=8, iseed=10,
        intensity_mus=list(STEP_DIRS6[0]), intensity_phis=list(STEP_DIRS6[1]),
        use_hybrid_phase_funs=True, hybrid_phase_fun_width=7.0,
        use_russian_roulette_intensity=True, zeta_min=0.3)
    assert launches_r[0] == launches_r[6] == launches_r[7] > 0, launches_r
    assert sum(launches_r[1:6]) + sum(launches_r[8:]) == 0, launches_r
    got_r, se_r = _step_row(res_r, radiance=True)
    worst_r = _within_sigma(got_r, se_r, JAX_STEP_PX_RAD,
                            JAX_STEP_PX_RAD_SE,
                            ["R", "T", "A"] + [f"radiance {d}"
                                               for d in range(6)])
    print(f"path D radiance (run_simulation, 6 directions): "
          f"{res_r.total_photons} photons in {sec_r:.2f} s, R/T/A and "
          f"radiances {[round(v, 6) for v in got_r]}, launches (record, "
          f"per-pixel, radiance) {launches_r[0]}, {launches_r[6]}, "
          f"{launches_r[7]}; largest gap to JAX's XLA path {worst_r:.2f} "
          f"combined sigma", flush=True)
    out = _record_flux_path_timing(rk, "per-pixel flux path", dom, sfc, src,
                                   KernelConfig, rng, 36)
    out.update(px_launches=launches[6] + launches_r[6], seconds=sec + sec_r,
               worst=max(worst, worst_r))
    return out


# ---------------------------------------------------------------------------
# The gather and tally probes P1-P5 (phase 5)
# ---------------------------------------------------------------------------

# Operations of one iteration of a lane, counted from
# csrc/probe_kernels.cu: a gather (the loop test and branch 2, the address
# 1, the load 1, the add to the sum 1, the perturbation's multiply,
# convert, add and and 4) and a tally body (the value's convert and
# multiply 2, its widening 1, the bin's address and shared atomic 2, the
# bin's read and narrowing 2, the add to the sum 1, the perturbation 4,
# the loop 2, the lane's share of zeroing 1,024 bins 1 and of the two
# barriers 1). Integer operations at the float32 rate.
OPS_PER_GATHER_ITERATION = 9
OPS_PER_TALLY_ITERATION = 16
# The variants the kernels line reports: P5's record gather (the one
# PyTorch call rec[idx] computes its whole function) and P4's value tally.
PROBE_LINE = {"probe_gather": "p5_records", "probe_tally": "p4_tally_full"}


def phase_probes(probes):
    """The probes' main path, ``python -m mcbrat3d_tpu_torch.tools.probes
    all`` (every P1-P5 variant at its TPU probe's shape through its
    kernel), with the launch counts set to 0 just before and read just
    after; then each variant's kernel against its plain twin on the same
    inputs (equal bit for bit: float32 reads, and tallies summed exactly
    in float64), the ns per iteration, the bytes a launch moves and the
    library call's ns; and, for the kernels line, the two representative
    variants' ms per launch, plain ms, bound and library ms (for the tally
    the loop of one index_add_ per iteration). Every time is device time:
    the calls are captured in one CUDA graph whose replay is timed
    (``probes.device_ms``), so the host's launch rate does not enter."""
    import torch

    buf = io.StringIO()
    probes.GATHER_LAUNCHES = probes.TALLY_LAUNCHES = 0
    with contextlib.redirect_stdout(buf):
        assert probes.main(["all"]) == 0
    launches = {"probe_gather": probes.GATHER_LAUNCHES,
                "probe_tally": probes.TALLY_LAUNCHES}
    print(buf.getvalue(), end="", flush=True)
    assert all(launches.values()), launches
    errs = {"probe_gather": 0.0, "probe_tally": 0.0}
    line = {}
    for name, v in probes.VARIANTS.items():
        entry = "probe_gather" if v.kernel == "gather" else "probe_tally"
        r = probes.measure(v)
        tab_np, idx_np = probes.probe_inputs(v)
        tab = torch.tensor(tab_np, device="cuda").reshape(-1)
        idx0 = torch.tensor(idx_np, device="cuda").reshape(-1)
        plain = probes.run_variant(v, tab, idx0, plain=True)
        err = float((r["out"] - plain).abs().max())
        assert torch.equal(r["out"], plain), (name, err)
        errs[entry] = max(errs[entry], err)
        ops = (OPS_PER_GATHER_ITERATION if v.kernel == "gather"
               else OPS_PER_TALLY_ITERATION) * r["lanes"] * r["inner"]
        t_bytes = r["bytes"] / H100_BYTES_PER_S
        t_ops = ops / H100_F32_OPS_PER_S
        bound = (1e3 * max(t_bytes, t_ops),
                 "bytes" if t_bytes > t_ops else "operations")
        lib = r["library_ns"]
        print(f"probe {name} ({v.source}): {r['lanes']} lanes x "
              f"{r['inner']} iterations, {r['ns_per_iter']:.3f} ns per "
              f"iteration (marginal over {probes.MARGINAL_FACTOR} x the "
              f"iterations where more than one), {r['ms']:.5f} ms a launch "
              f"(bound {bound[0]:.6f} "
              f"ms by {bound[1]}), {r['bytes']} bytes, library "
              + ("none" if lib is None else f"{lib:.3f} ns per iteration")
              + f", kernel = plain ({err:.1e})", flush=True)
        if PROBE_LINE[entry] == name:
            plain_ms = probes.device_ms(
                lambda: probes.run_variant(v, tab, idx0, plain=True),
                max(1, v.reps // 8))
            call = probes.library_call(v, tab, idx0)
            lib_ms = probes.device_ms(
                lambda: [call() for _ in range(r["inner"])], v.reps)
            line[entry] = dict(ms=r["ms"], plain_ms=plain_ms, bound=bound,
                               library_ms=lib_ms)
    for entry, d in line.items():
        d.update(launches=launches[entry], max_err=errs[entry])
    return line


def phase_sw_deck(rk, ck, sk, tk, cli, write_sw_broadband_inputs):
    """3n: run/broadband_sw.nml at full width through the CLI on cuda, on
    the inputs of mcbrat3d_tpu_torch/tools/sw_inputs.py (16 bins, 16 x
    262,144 photons): every bin on the record kernel (2 components, the
    directional beam), no batch on the wave kernel, no plain step, n_bad
    0, flux and netCDF files written; the incident flux equal to the JAX
    package's and the domain-mean fluxes within 4.5 combined sigma of its
    frozen values."""
    deck = (ROOT / "run" / "broadband_sw.nml").read_text()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            write_sw_broadband_inputs(".")
            gen_s = time.perf_counter() - t0
            out, seconds, launches = _run_cli_deck(
                cli, rk, deck, ck=ck, domain=None, sk=sk, tk=tk)
            for f in ("SW_flux.out", "SW_results.nc"):
                assert (tmp / f).stat().st_size > 0, f
            means, se, flux = _flux_file_means(tmp / "SW_flux.out")
            first = _sw_first_bin_launch(rk)
        finally:
            os.chdir(cwd)
    n, wave = out["total_photons"], out["launches"]["wave_kernel_batches"]
    transport_s = (out["elapsed_seconds"] - out["setup_seconds"]
                   - out["build_seconds"])
    print(f"SW deck: inputs written in {gen_s:.2f} s; {n} photons in "
          f"{out['n_batches']} batches, n_bad={out['n_bad']}, up/down/"
          f"absorbed={means} +- {se}, incident flux {flux!r}; CLI "
          f"{seconds:.2f} s (run {out['elapsed_seconds']} s: setup "
          f"{out['setup_seconds']} s before the first transport, later bins' "
          f"host builds {out['build_seconds']} s, transport and the rest "
          f"{transport_s:.3f} s), K1 launches {launches[0]}, launches "
          f"record/radiance/column/separable/tiled/emission {launches[:6]}, "
          f"wave-kernel batches {wave}; JAX package {JAX_SW} +- {JAX_SW_SE}, "
          f"incident flux {JAX_SW_TOTAL_FLUX!r}", flush=True)
    assert n == 16 * 262_144 and out["n_bad"] == 0, (n, out["n_bad"])
    assert wave == 0, wave
    assert launches[0] >= out["n_batches"] > 0, launches
    assert sum(launches[1:6]) == 0, launches
    assert abs(flux / JAX_SW_TOTAL_FLUX - 1.0) < 1e-12, flux
    worst = _within_sigma(means, se, JAX_SW, JAX_SW_SE,
                          ("up", "down", "absorbed"))
    return dict(launches=launches[0], seconds=seconds, out=out,
                transport_s=transport_s, worst=worst, first=first)


SW_FIRST_PHOTONS = 1 << 18


def _sw_first_bin_launch(rk):
    """The deck's first bin as run_broadband builds it (components_from_ssp,
    build_domain with the deck's 9,001 CDF steps; 2 components on 32^3
    cells), from the inputs in the current directory on cuda: the first
    refill launch of a SW_FIRST_PHOTONS-photon batch on the resident
    slots, K1 against its plain twin (``_first_launch``: equal photons,
    steps, lane-steps and n_bad, columns and the 3D field within
    RECORD_COLUMN_TOL_KERNEL_VS_PLAIN)."""
    from mcbrat3d_tpu_torch.core import rng
    from mcbrat3d_tpu_torch.domain.common import read_common
    from mcbrat3d_tpu_torch.domain.domain import build_domain
    from mcbrat3d_tpu_torch.domain.ssp import (components_from_ssp,
                                               read_ssp_table)
    from mcbrat3d_tpu_torch.driver import config
    from mcbrat3d_tpu_torch.driver.run import kernel_config_from
    from mcbrat3d_tpu_torch.physics.surface import Surface
    from mcbrat3d_tpu_torch.sources import illumination
    from mcbrat3d_tpu_torch.transport.integrator import select_kernel

    cfg = config.load_config("deck.nml")
    common = read_common(cfg.phys_domain_file, device="cuda")
    ssp = [read_ssp_table(f) for f in cfg.ssp_file_names if f]
    comps, albedo, lam_um = components_from_ssp(
        common, ssp, 0, setup=False, calc_rayleigh=cfg.calc_rayleigh)
    dom = build_domain(common.grid, comps, n_cdf_steps=cfg.n_phase_intervals,
                       temps=common.temps, macro_factor=cfg.macro_factor,
                       lambda_um=lam_um)
    sfc = Surface.lambertian(albedo, temperature=cfg.surface_temp,
                             emissivity=1.0 - albedo)
    src = illumination.directional(cfg.solar_mu, cfg.solar_azimuth)
    kcfg = kernel_config_from(cfg)
    assert select_kernel(dom, sfc, src, kcfg)[0] == "record"
    assert dom.n_components == 2, dom.n_components
    assert dom.tables.inverse.shape[1] == cfg.n_phase_intervals == 9001
    vol = (kcfg.need_volume_absorption or kcfg.need_absorption_profile
           or kcfg.lw_mode)
    prm = rk.RecordParams.make(dom, sfc, src, kcfg.use_russian_roulette,
                               kcfg.russian_roulette_weight, vol,
                               lw_mode=kcfg.lw_mode)
    slots = _occupancy_line("SW deck bin 0 (record_steps)", rk.occupancy(prm))
    seed = rng.batch_seed(cfg.iseed, 0)

    def run_one(launch):
        one = rk.RefillSchedule(rk.REFILL_STEPS, vol_tally=vol,
                                resident=slots)
        return rk.run_batch_record_tallies(
            dom, sfc, src, seed, kcfg, n_photons=SW_FIRST_PHOTONS,
            launch=launch or rk.record_launch, rcfg=one)

    run_one(None)  # warm-up
    res = _first_launch(rk, rk.record_launch_plain, run_one,
                        RECORD_COLUMN_TOL_KERNEL_VS_PLAIN)
    t = res.pop("tallies")
    print(f"SW deck bin 0 ({lam_um:.4g} um, {dom.tables.inverse.shape[0]} "
          f"phase rows of {dom.tables.inverse.shape[1]} steps), first refill "
          f"launch of {SW_FIRST_PHOTONS} photons: kernel "
          f"{res['kernel_ms_first']:.4f} ms, plain "
          f"{res['plain_ms_first']:.4f} ms, {t.n_photons} photons done, "
          f"n_bad {t.n_bad}", flush=True)
    return res


def _with_batches(text, n):
    return re.sub(r"numBatches = \d+", f"numBatches = {n}", text)


def _wave_deck(cli, rk, ck, sk, tk, text, n):
    """A deck that runs on the wave kernel, with ``n`` batches, through the
    CLI on cuda in the current directory (its domain file already there).
    Asserts no kernel launched, every batch on the wave kernel and n_bad
    0; returns the JSON line, the seconds, the flux file's means and
    errors, and the wave batches' steps and seconds (each batch timed
    between synchronizations of the card)."""
    import torch

    from mcbrat3d_tpu_torch.transport import integrator

    wave, steps, wave_s = integrator.run_wave_kernel, [], []

    def timed_wave(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = wave(*args, **kwargs)
        torch.cuda.synchronize()
        wave_s.append(time.perf_counter() - t0)
        steps.append(int(t.n_steps))
        return t

    integrator.run_wave_kernel = timed_wave
    try:
        out, seconds, launches = _run_cli_deck(
            cli, rk, _with_batches(text, n), ck=ck, domain=None, sk=sk,
            tk=tk, kernel=False)
    finally:
        integrator.run_wave_kernel = wave
    assert sum(launches) == 0, launches
    assert len(steps) == n, (len(steps), n)
    assert out["launches"]["wave_kernel_batches"] == n == out["n_batches"]
    assert out["n_bad"] == 0, out["n_bad"]
    path = re.search(r"outputFluxFile = '([^']+)'", text).group(1)
    means, se, _ = _flux_file_means(path)
    return out, seconds, list(means), list(se), sum(steps), sum(wave_s)


def phase_wave_kernel(rk, ck, sk, tk, cli, io_netcdf, build_domain, Surface,
                      illumination, config, integrator, rng):
    """3o: the wave kernel (plain PyTorch, the JAX package's XLA path) on
    the card. First one 2^20-photon batch of run/step_cloud_mono.nml's step
    cloud on the wave kernel and on K1 (median of 3) through run_batch,
    each timed around a synchronized call: the wave kernel's ms a step and
    photons/s against K1's. Then through the CLI: the deck with usePallas
    = 'off' at its grid and numPhotonsPerBatch (2^20), as many batches as
    that batch's time fits in WAVE_DECK_SECONDS (2-16); the step cloud with
    useRayTracing and numRecScatOrd = 3 ('auto': no kernel takes it), 2 x
    2^18 photons, with its auxhist01 file; run/step_cloud_radiance.nml
    with its one direction at mu 0.1 (below every kernel's mu floor), 2 x
    16,384 photons; each deck's wave steps and ms a step. No kernel
    launched, every batch on the wave kernel,
    n_bad 0, R, T, A (and the fluxes by order, the radiance) within 4.5
    combined sigma of the JAX package's frozen values."""
    import dataclasses

    import torch

    from mcbrat3d_tpu_torch.driver.run import kernel_config_from

    mono = (ROOT / "run" / "step_cloud_mono.nml").read_text()
    step_deck = mono.replace("&algorithms", "&algorithms\n  usePallas = 'off'")
    rt_deck = (mono.replace("useRayTracing = .false.",
                            "useRayTracing = .true.")
               .replace("numPhotonsPerBatch = 1048576",
                        "numPhotonsPerBatch = 262144")
               .replace("reportVolumeAbsorption = .true.",
                        "reportVolumeAbsorption = .true.\n  recScatOrd = "
                        ".true.\n  numRecScatOrd = 3\n  auxhist01_fluxFile "
                        "= 'StepCloud_aux.out'"))
    rad_deck = re.sub(r"  angleFill.*\n.*\n.*\n",
                      "  intensityMus = 0.1\n  intensityPhis = 0.\n",
                      (ROOT / "run" / "step_cloud_radiance.nml").read_text())
    rad_deck = (rad_deck.replace("numPhotonsPerBatch = 262144",
                                 "numPhotonsPerBatch = 16384")
                .replace("outputRadFile = 'StepCloud_radiance.out'",
                         "outputRadFile = 'StepCloud_radiance.out'\n  "
                         "outputFluxFile = 'StepCloud_rad_flux.out'"))
    assert "usePallas" in step_deck and "numRecScatOrd" in rt_deck
    assert "262144" in rt_deck and "16384" in rad_deck
    assert "intensityMus = 0.1" in rad_deck and "angleFill" not in rad_deck
    res = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                assert cli.main(["mkdomain", *STEP_CLOUD_DOMAIN]) == 0
            Path("deck.nml").write_text(step_deck)
            cfg = config.load_config("deck.nml")
            grid, comps, temps, attrs = io_netcdf.read_domain(
                "StepCloud.dom", device="cuda")
            dom = build_domain(grid, comps, n_cdf_steps=cfg.n_phase_intervals,
                               temps=temps, macro_factor=cfg.macro_factor)
            sfc = Surface.lambertian(attrs.get("surface_albedo", 0.0))
            src = illumination.directional(cfg.solar_mu, cfg.solar_azimuth)
            kcfg = kernel_config_from(cfg)
            n = cfg.num_photons_per_batch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wave = integrator.run_batch(dom, sfc, src, rng.batch_seed(5, 0),
                                        kcfg, n_photons=n,
                                        key=rng.batch_key(5, 0))
            torch.cuda.synchronize()
            wave_s = time.perf_counter() - t0
            k1_cfg = dataclasses.replace(kcfg, use_pallas="auto")
            k1_s = []
            for _ in range(3):
                rk.LAUNCHES = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                k1 = integrator.run_batch(dom, sfc, src, rng.batch_seed(5, 0),
                                          k1_cfg, n_photons=n)
                torch.cuda.synchronize()
                k1_s.append(time.perf_counter() - t0)
                assert rk.LAUNCHES > 0
            k1_s = sorted(k1_s)[1]
            ms_step = 1e3 * wave_s / wave.n_steps
            print(f"wave kernel on the card: one batch of {wave.n_photons} "
                  f"photons of the deck's step cloud, {wave.n_steps} steps, "
                  f"{wave.n_lane_steps} live lane-steps on {kcfg.n_lanes} "
                  f"lanes, {wave_s:.2f} s: {ms_step:.3f} ms a step, "
                  f"{wave.n_photons / wave_s:.4g} photons/s; K1 (run_batch "
                  f"'auto', median of 3) {k1_s * 1e3:.2f} ms, "
                  f"{k1.n_photons / k1_s:.4g} photons/s: the wave kernel "
                  f"{wave_s / k1_s:.1f}x slower", flush=True)
            assert wave.n_photons == k1.n_photons == n and wave.n_bad == 0
            n_step = max(2, min(16, int(WAVE_DECK_SECONDS / wave_s)))
            for name, text, nb in (("step", step_deck, n_step),
                                   ("rt", rt_deck, 2), ("rad", rad_deck, 2)):
                res[name] = _wave_deck(cli, rk, ck, sk, tk, text, nb)
            assert Path("StepCloud_aux.out").stat().st_size > 0
        finally:
            os.chdir(cwd)
    worst = 0.0
    for name, want, want_se, labels in (
            ("step", JAX_WAVE_STEP, JAX_WAVE_STEP_SE, ("R", "T", "A")),
            ("rt", JAX_WAVE_RT, JAX_WAVE_RT_SE,
             ("R", "T", "A", *(f"up order {k}" for k in range(4)),
              *(f"down order {k}" for k in range(4)))),
            ("rad", JAX_WAVE_RAD, JAX_WAVE_RAD_SE,
             ("R", "T", "A", "radiance mu 0.1"))):
        out, seconds, got, got_se, n_steps, wave_s = res[name]
        for key in ("mean_flux_up_by_order", "mean_flux_down_by_order",
                    "mean_intensity"):
            if key in out:
                got += out[key]
                got_se += out[key + "_stderr"]
        if name == "rt":
            # the down flux of order 0: the direct beam crosses the thick
            # half, optical depth >= 17.5 on every path, so 0 in JAX's
            # sample and at most a stray photon in the port's; not held
            got, got_se = got[:7] + got[8:], got_se[:7] + got_se[8:]
            want, want_se = want[:7] + want[8:], want_se[:7] + want_se[8:]
            labels = labels[:7] + labels[8:]
        print(f"wave deck {name}: {out['total_photons']} photons in "
              f"{out['n_batches']} batches, CLI {seconds:.2f} s, "
              f"{out['total_photons'] / seconds:.4g} photons/s; wave kernel "
              f"{n_steps} steps in {wave_s:.2f} s, "
              f"{1e3 * wave_s / n_steps:.3f} ms a step, "
              f"{out['total_photons'] / wave_s:.4g} photons/s; port {got} "
              f"+- {got_se}; JAX package {want} +- {want_se}", flush=True)
        worst = max(worst, _within_sigma(got, got_se, want, want_se, labels))
    return dict(ms_per_step=ms_step, photons_per_s=wave.n_photons / wave_s,
                k1_photons_per_s=k1.n_photons / k1_s, worst=worst,
                batches={k: v[0]["n_batches"] for k, v in res.items()},
                ms_per_step_by_deck={k: 1e3 * v[5] / v[4]
                                     for k, v in res.items()})


# The kernel-against-plain phases, one process each group, the groups
# about equal in time (one call's seconds of each phase on the H100: 2d
# 208; 2b 132, 2j 40, 2g 28, 2e 12; 2f 126, 2 84; 2h 148, 2i 90). 2k
# times its walks and stays in the main process.
COMPARE_WORKERS = (("2d",), ("2b", "2j", "2g", "2e", "2c"), ("2f", "2"),
                   ("2h", "2i"))


def _run_compare_workers(groups):
    """Run each group of phases in a process of its own (``chip_smoke.py
    --only GROUP --out-json``), all started together on the one card;
    print each process's output once all have ended, with its exit code
    and seconds; fail if any failed. Every process is stopped before
    this returns. Returns the phases' results, merged."""
    t0 = time.perf_counter()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    workers, results, failed = [], {}, []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for i, group in enumerate(groups):
                log, res = Path(tmp) / f"{i}.log", Path(tmp) / f"{i}.json"
                with open(log, "w") as f:
                    proc = subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()),
                         "--only", ",".join(group), "--out-json", str(res)],
                        stdout=f, stderr=subprocess.STDOUT, env=env)
                workers.append(dict(group=group, proc=proc, log=log, res=res,
                                    seconds=None))
            while any(w["seconds"] is None for w in workers):
                time.sleep(0.5)
                for w in workers:
                    if w["seconds"] is None and w["proc"].poll() is not None:
                        w["seconds"] = time.perf_counter() - t0
        finally:
            for w in workers:
                if w["proc"].poll() is None:
                    w["proc"].kill()
                    w["proc"].wait()
        for w in workers:
            name, rc = ",".join(w["group"]), w["proc"].returncode
            print(f"--- compare worker {name}: exit {rc}, "
                  f"{w['seconds']:.1f} s ---", flush=True)
            print(w["log"].read_text().rstrip(), flush=True)
            if rc != 0:
                failed.append(name)
            else:
                results.update(json.loads(w["res"].read_text()))
    print(f"compare workers {[','.join(g) for g in groups]}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    assert not failed, f"compare phases failed: {failed}"
    return results


PHASES = ("2", "2b", "2c", "2d", "2e", "2f", "2g", "2h", "2i", "2j", "2k",
          "3",
          "3b", "3c", "3d", "3e", "3f", "3g", "3h", "3i", "3j", "3k", "3l",
          "3m", "3n", "3o", "4", "4b", "4c", "4d", "4e", "4f", "4g", "4h",
          "4i", "5")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run after the build")
    ap.add_argument("--out-json", default=None,
                    help="write the phases' results to this file (a "
                         "compare worker)")
    opts = ap.parse_args(argv)
    selected = set(opts.only.split(","))
    if not selected <= set(PHASES):
        ap.error(f"phases are {PHASES}")
    only = set(selected)

    import types

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "mcbrat3d_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(mcbrat3d_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mcbrat3d_tpu_torch import _build
    from mcbrat3d_tpu_torch.core import planck, rng
    from mcbrat3d_tpu_torch.core.grid import Grid
    from mcbrat3d_tpu_torch.domain import io_netcdf
    from mcbrat3d_tpu_torch.domain.domain import (OpticalComponent,
                                                  build_domain)
    from mcbrat3d_tpu_torch.driver import cli, config
    from mcbrat3d_tpu_torch.driver.run import run_simulation
    from mcbrat3d_tpu_torch.physics.phase_function import (
        PhaseFunction, PhaseFunctionTable)
    from mcbrat3d_tpu_torch.physics.surface import Surface
    from mcbrat3d_tpu_torch.scenes.collection import (
        broken_cloud_scene, dense_cloud_scene, lw_flagship_scene,
        write_lw_flagship_inputs)
    from mcbrat3d_tpu_torch.scenes.plane_parallel import make_slab
    from mcbrat3d_tpu_torch.scenes.step_cloud import (
        make_step_cloud, make_step_cloud_multi, step_cloud_multi_scene)
    from mcbrat3d_tpu_torch.sources import illumination
    from mcbrat3d_tpu_torch.spectral import weights
    from mcbrat3d_tpu_torch.tools import probes
    from mcbrat3d_tpu_torch.tools.lw_inputs import write_lw_broadband_inputs
    from mcbrat3d_tpu_torch.tools.sw_inputs import write_sw_broadband_inputs
    from mcbrat3d_tpu_torch.transport import integrator
    from mcbrat3d_tpu_torch.transport import col_kernel as ck
    from mcbrat3d_tpu_torch.transport import local_estimate as le
    from mcbrat3d_tpu_torch.transport import record_kernel as rk
    from mcbrat3d_tpu_torch.transport import sep_kernel as sk
    from mcbrat3d_tpu_torch.transport import tile_kernel as tk
    from mcbrat3d_tpu_torch.transport.integrator import KernelConfig, run_batch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; card {card}", flush=True)
    t0 = time.perf_counter()
    _build.build_all(["record_kernel", "col_kernel", "sep_kernel",
                      "tile_kernel", "probe_kernels"])
    print(f"kernels built in {time.perf_counter() - t0:.2f} s (one nvcc "
          "each, started together)", flush=True)
    # record_steps<MACRO, VOL, ANALYTIC, LE>, record_walk,
    # col_steps<MACRO, ANALYTIC, VOL, RR, LE>, col_walk,
    # sep_steps<SRC, ANALYTIC, RR, LW>, tile_steps<NCOMP, ANALYTIC, RR>
    # in their mangled names, and the probes' three kernels
    patterns = {
        "record_kernel": (
            (r"record_stepsILb(\d)ELb(\d)ELb(\d)ELb(\d)E",
             "macro={} vol={} analytic={} LE={}"),
            (r"(record_walk)", "{}")),
        "col_kernel": (
            (r"col_stepsILb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E",
             "macro={} analytic={} vol={} rr={} LE={}"),
            (r"(col_walk)", "{}")),
        "sep_kernel": ((r"sep_stepsILi(\d)ELb(\d)ELb(\d)ELb(\d)E",
                        "src={} analytic={} rr={} lw={}"),),
        "tile_kernel": ((r"tile_stepsILi(\d)ELb(\d)ELb(\d)E",
                         "ncomp={} analytic={} rr={}"),),
        "probe_kernels": ((r"(gather_chain|tally_lane|tally_block)", "{}"),)}
    for lib, kinds in patterns.items():
        info = _build.BUILD_INFO[lib]
        print(f"{lib}: nvcc {info['seconds']:.2f} s", flush=True)
        name = ""
        for line in info["log"].splitlines():
            for pattern, fmt in kinds:
                flags = re.search(pattern, line)
                if flags:
                    name = fmt.format(*flags.groups())
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib} [{name}]:", line.strip())

    args = (rk, make_step_cloud, Surface, illumination, KernelConfig, rng)
    # what the emission phases build their scenes with
    m = types.SimpleNamespace(
        Grid=Grid, OpticalComponent=OpticalComponent,
        PhaseFunction=PhaseFunction, PhaseFunctionTable=PhaseFunctionTable,
        build_domain=build_domain, weights=weights,
        illumination=illumination, Surface=Surface, planck=planck,
        broken_cloud_scene=broken_cloud_scene,
        make_step_cloud=make_step_cloud)
    dirs6 = _deck_directions(config, le, "step_cloud_radiance.nml")
    marks = []

    def mark(phase):
        """Print the wall time of the phase run since the last mark."""
        now = time.perf_counter()
        if marks and marks[-1][0] in only:
            print(f"phase {marks[-1][0]}: {now - marks[-1][1]:.1f} s",
                  flush=True)
        marks.append((phase, now))

    out = {}
    groups = [tuple(p for p in g if p in only) for g in COMPARE_WORKERS]
    groups = [g for g in groups if g]
    if opts.out_json is None and len(groups) > 1:
        out.update(_run_compare_workers(groups))
        only -= {p for g in groups for p in g}
    mark("2")
    if "2" in only:
        out["max_err"], out["env_max_err"] = phase_compare(
            rk, make_step_cloud, make_step_cloud_multi, Surface,
            illumination, KernelConfig, rng, m)
    mark("2b")
    if "2b" in only:
        out["rad_max_err"] = phase_radiance_compare(
            rk, le, make_step_cloud, make_step_cloud_multi, make_slab,
            PhaseFunction, Surface, illumination, KernelConfig, rng, dirs6,
            m)
    mark("2c")
    if "2c" in only:
        phase_radiance_anchors(le, make_slab, Surface, illumination,
                               KernelConfig, run_batch, rng)
        phase_lw_anchors(le, m, KernelConfig, run_batch, rng)
    col_args = (ck, broken_cloud_scene, build_domain, Surface, illumination,
                KernelConfig, rng)
    mark("2d")
    if "2d" in only:
        out["col_max_err"] = phase_col_compare(*col_args)
    sep_args = (sk, lw_flagship_scene, build_domain, Surface, illumination,
                KernelConfig, rng)
    mark("2e")
    if "2e" in only:
        out["sep_max_err"] = phase_sep_compare(*sep_args)
    dense_args = (dense_cloud_scene, build_domain, OpticalComponent,
                  PhaseFunction, PhaseFunctionTable)
    mark("2f")
    if "2f" in only:
        out["tile_max_err"] = phase_tile_compare(tk, dense_args, Surface,
                                                 illumination, rng)
    mark("2g")
    if "2g" in only:
        out["lw_max_err"] = phase_lw_compare(rk, m, KernelConfig, rng)
    mark("2h")
    if "2h" in only:
        out["gas_max_err"], out["col_le_max_err"] = phase_col_le_compare(
            ck, le, m, KernelConfig, rng)
    mark("2i")
    if "2i" in only:
        out["em_max_err"], out["px_max_err"] = phase_col_em_px_compare(
            ck, le, m, KernelConfig, rng)
    mark("2j")
    if "2j" in only:
        out["rpv_max_err"], out["k1_px_max_err"] = \
            phase_record_surface_compare(rk, le, m, make_step_cloud,
                                         make_step_cloud_multi, KernelConfig,
                                         rng)
    mark("2k")
    if "2k" in only:
        out["walk"] = phase_walk_compare(ck, rk, le, m, KernelConfig, rng,
                                         config)
    mark("3")
    if "3" in only:
        out["launches"] = phase_main_path(rk, cli)
    mark("3b")
    if "3b" in only:
        out["rad_launches"], out["rec_walk_launches"] = \
            phase_radiance_deck(rk, cli)
    mark("3c")
    if "3c" in only:
        out["col_launches"] = phase_landsat_deck(ck, rk, cli)
    mark("3d")
    if "3d" in only:
        out["lw_deck"] = phase_lw_deck(sk, ck, rk, cli,
                                       write_lw_flagship_inputs)
    mark("3e")
    if "3e" in only:
        out["dense_deck"] = phase_dense_deck(tk, sk, ck, rk, cli, io_netcdf,
                                             dense_cloud_scene)
    mark("3f")
    if "3f" in only:
        out["multi_deck"] = phase_multi_deck(rk, ck, sk, tk, cli, io_netcdf,
                                             step_cloud_multi_scene)
    mark("3g")
    if "3g" in only:
        out["lw_generic_deck"] = phase_lw_generic_deck(
            rk, ck, sk, tk, cli, write_lw_broadband_inputs)
    mark("3h")
    if "3h" in only:
        out["col_le_deck"] = phase_landsat_radiance_deck(ck, rk, cli)
    mark("3i")
    if "3i" in only:
        out["gas"] = phase_gas(ck, rk, m, le, KernelConfig, run_batch, rng)
    mark("3j")
    if "3j" in only:
        out["lw_landsat"] = phase_lw_landsat(ck, rk, m, run_simulation,
                                             config.SimulationConfig)
    mark("3k")
    if "3k" in only:
        out["px_landsat"] = phase_px_landsat(
            ck, rk, le, m, run_simulation, config.SimulationConfig,
            KernelConfig, rng)
    mark("3l")
    if "3l" in only:
        out["rpv_step"] = phase_rpv_step_cloud(
            rk, ck, sk, tk, m, make_step_cloud, run_simulation,
            config.SimulationConfig, KernelConfig, rng)
    mark("3m")
    if "3m" in only:
        out["px_step"] = phase_px_step_cloud(
            rk, ck, sk, tk, m, make_step_cloud, run_simulation,
            config.SimulationConfig, KernelConfig, rng)
    mark("3n")
    if "3n" in only:
        out["sw_deck"] = phase_sw_deck(rk, ck, sk, tk, cli,
                                       write_sw_broadband_inputs)
    mark("3o")
    if "3o" in only:
        out["wave"] = phase_wave_kernel(
            rk, ck, sk, tk, cli, io_netcdf, build_domain, Surface,
            illumination, config, integrator, rng)
    mark("4")
    if "4" in only:
        out["head"] = phase_headline(*args)
    mark("4b")
    if "4b" in only:
        out["rad_head"] = phase_radiance_headline(
            rk, le, config, make_step_cloud, Surface, illumination,
            KernelConfig, rng)
    mark("4c")
    if "4c" in only:
        out["col_head"] = phase_col_headline(*col_args)
    mark("4d")
    if "4d" in only:
        out["sep_head"] = phase_sep_headline(*sep_args)
    mark("4e")
    if "4e" in only:
        out["tile_head"] = phase_tile_headline(
            tk, dense_cloud_scene, build_domain, Surface, illumination,
            KernelConfig, run_batch, rng)
    mark("4f")
    if "4f" in only:
        out["multi_head"] = phase_multi_headline(
            rk, make_step_cloud_multi, Surface, illumination, KernelConfig,
            rng)
    mark("4g")
    if "4g" in only:
        out["lw_head"] = phase_lw_headline(rk, m, KernelConfig, rng)
        out["radar_head"] = phase_radar_headline(rk, m, KernelConfig, rng)
        out["occupancy"] = vol_tally_occupancy(rk, m)
    mark("4h")
    if "4h" in only:
        out["col_le_head"] = phase_col_le_headline(
            ck, rk, le, m, KernelConfig, run_batch, rng)
    mark("4i")
    if "4i" in only:
        out["lw_landsat_head"] = phase_lw_landsat_headline(
            ck, rk, m, KernelConfig, run_batch, rng)
    mark("5")
    if "5" in only:
        out["probes"] = phase_probes(probes)
    mark(None)
    if opts.out_json is not None:
        Path(opts.out_json).write_text(json.dumps(out, default=float))
    if selected != set(PHASES):
        print(f"chip_smoke: phases {sorted(selected)} passed; no result "
              "lines for a partial run")
        return 0

    head, rad_head = out["head"], out["rad_head"]
    rad6, col_head = rad_head[(6, "kernel")], out["col_head"]
    sep_head = out["sep_head"]
    tile_head = out["tile_head"]
    tile_run = tile_head["refill"]  # run_batch's schedule
    multi_head = out["multi_head"]
    lw_head = out["lw_head"]
    # the walk kernels on their captured launches (phase 2k): K3-d's on
    # bench.py:547-573's, K2's on the radiance deck's 6 directions
    walk = out["walk"]
    col_walk = walk["K3-d, bench.py:547-573, 16 dirs"]
    rec_walk = walk["K2, radiance deck, 6 dirs"]
    col_walk_err = max(v["max_err"] for k, v in walk.items()
                       if k.startswith("K3-d"))
    rec_walk_err = max(v["max_err"] for k, v in walk.items()
                       if k.startswith("K2"))
    bounds = {
        # K1, K1-a/b, K1-c, K1-d: the first refill launch of a 2^20-photon
        # batch on the resident slots
        "record_kernel": head["bound_first"],
        "record_kernel_radiance": _bound(
            rad6["lane_steps"], rad6["launches"],
            OPS_PER_LANE_STEP["record_kernel"], rad6["n_lanes"], 40,
            rad6["table_bytes"], rad6["tally_bytes"],
            extra_ops=(rad6["march"] * OPS_PER_MARCH_STEP
                       + rad6["events"] * 6 * OPS_PER_K2_DIRECTION)),
        # K3 and K4: per launch of the refill schedule on the headline's
        # resident slots
        "col_kernel": col_head["bound"],
        "sep_kernel": sep_head["bound"],
        # per launch: the slots' state (7 floats, the tile id and the
        # quota) read and written once, the fields read once, the tallies
        # written once; the births' operations besides the steps'
        "tile_kernel": _bound(
            tile_run["lane_steps"], tile_run["passes"],
            OPS_PER_LANE_STEP["tile_kernel"], tile_head["n_slots"], 36,
            4 * tile_head["n_f"] * tile_head["n_cells"],
            4 * 3 * tile_head["nxy"],
            extra_ops=tile_run["n_photons"] * OPS_PER_TILE_BIRTH),
        "record_kernel_multi3": multi_head["bound_first"],
        "record_kernel_lw": lw_head["bound_first"],
        "col_kernel_radiance": out["col_le_head"]["bound"],
        "col_kernel_gas": out["gas"]["bound"],
        "col_kernel_lw": out["lw_landsat_head"]["bound"],
        "col_kernel_px": out["px_landsat"]["bound"],
        "record_kernel_rpv": out["rpv_step"]["bound_first"],
        "record_kernel_px": out["px_step"]["bound_first"],
        "col_walk": col_walk["bound"],
        "record_walk": rec_walk["bound"],
        "probe_gather": out["probes"]["probe_gather"]["bound"],
        "probe_tally": out["probes"]["probe_tally"]["bound"],
    }
    kernels = [{
        "name": "record_kernel",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/record_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_kernel.py:712",
        "launches": out["launches"],
        "max_abs_err": out["max_err"],
        "ms": head["kernel_ms_first"],
        "plain_ms": head["plain_ms_first"],
    }, {
        "name": "record_kernel_radiance",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/record_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_kernel.py:1515",
        "launches": out["rad_launches"],
        "max_abs_err": out["rad_max_err"],
        "ms": rad6["ms_per_launch"],
        "plain_ms": rad_head[(6, "plain")]["ms_per_launch"],
    }, {
        "name": "col_kernel",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/col_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_col.py:280",
        "launches": out["col_launches"],
        "max_abs_err": out["col_max_err"],
        "ms": col_head["kernel_ms_per_launch"],
        "plain_ms": col_head["plain_ms_first"],
    }, {
        "name": "sep_kernel",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/sep_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_sep.py:295",
        "launches": out["lw_deck"]["launches"],
        "max_abs_err": out["sep_max_err"],
        "ms": sep_head["kernel_ms_per_launch"],
        "plain_ms": sep_head["plain_ms_first"],
    }, {
        "name": "tile_kernel",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/tile_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_tile.py:335",
        "launches": out["dense_deck"]["launches"],
        "max_abs_err": out["tile_max_err"],
        "ms": tile_run["kernel_ms_per_pass"],
        "plain_ms": tile_head["plain_ms_first"],
    }, {
        # the same kernel on 2-3 component records and the other sources
        # (K1-a, K1-b): launches on the 3-component deck, times on
        # bench.py's multi_component_3_step_cloud
        "name": "record_kernel_multi3",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/record_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_kernel.py:1296",
        "launches": out["multi_deck"]["launches"],
        "max_abs_err": out["env_max_err"],
        "ms": multi_head["kernel_ms_first"],
        "plain_ms": multi_head["plain_ms_first"],
    }, {
        # the same kernel's emission refill and pre-credits (K1-c):
        # launches on run/broadband_lw.nml, times on bench.py's
        # lw_emission_2comp
        "name": "record_kernel_lw",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/record_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_kernel.py:897",
        "launches": out["lw_generic_deck"]["lw_launches"],
        "max_abs_err": out["lw_max_err"],
        "ms": lw_head["kernel_ms_first"],
        "plain_ms": lw_head["plain_ms_first"],
    }, {
        # the column kernel's local estimate (K3-d): launches on
        # run/landsat_radiance.nml, times on bench.py's
        # landsat_radiance_16dir
        "name": "col_kernel_radiance",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/col_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_col.py:745",
        "launches": out["col_le_deck"]["launches"],
        "max_abs_err": out["col_le_max_err"],
        "ms": out["col_le_head"]["kernel_ms_per_launch"],
        "plain_ms": out["col_le_head"]["plain_ms_per_launch"],
    }, {
        # the column kernel's gas template (K3-a): launches and times on
        # the full-width gas template (phase 3i)
        "name": "col_kernel_gas",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/col_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_col.py:507",
        "launches": out["gas"]["launches"],
        "max_abs_err": out["gas_max_err"],
        "ms": out["gas"]["kernel_ms_per_launch"],
        "plain_ms": out["gas"]["plain_ms_per_launch"],
    }, {
        # the column kernel's emission refill and pre-credits (K3-b):
        # launches on path A (phase 3j), times on its configuration (4i)
        "name": "col_kernel_lw",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/col_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_col.py:407",
        "launches": out["lw_landsat"]["lw_launches"],
        "max_abs_err": out["em_max_err"],
        "ms": out["lw_landsat_head"]["kernel_ms_per_launch"],
        "plain_ms": out["lw_landsat_head"]["plain_ms_per_launch"],
    }, {
        # the column kernel's per-pixel albedo (K3-c): launches on path B's
        # flux and radiance runs, times on its flux path (phase 3k)
        "name": "col_kernel_px",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/col_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_col.py:714",
        "launches": out["px_landsat"]["px_launches"],
        "max_abs_err": out["px_max_err"],
        "ms": out["px_landsat"]["kernel_ms_per_launch"],
        "plain_ms": out["px_landsat"]["plain_ms_per_launch"],
    }, {
        # the record kernel's uniform RPV surface (K1-d): launches and
        # times on path C (phase 3l)
        "name": "record_kernel_rpv",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/record_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_kernel.py:1436",
        "launches": out["rpv_step"]["rpv_launches"],
        "max_abs_err": out["rpv_max_err"],
        "ms": out["rpv_step"]["kernel_ms_first"],
        "plain_ms": out["rpv_step"]["plain_ms_first"],
    }, {
        # the record kernel's per-pixel albedo (K1-d): launches on path D's
        # flux and radiance runs, times on its flux path (phase 3m)
        "name": "record_kernel_px",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/record_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_kernel.py:1436",
        "launches": out["px_step"]["px_launches"],
        "max_abs_err": out["k1_px_max_err"],
        "ms": out["px_step"]["kernel_ms_first"],
        "plain_ms": out["px_step"]["plain_ms_first"],
    }, {
        # the column kernel's walk kernel (K3-d's estimates, one thread per
        # (event, direction) pair, launched after each radiance launch):
        # launches on run/landsat_radiance.nml, the time, the bound and the
        # plain twin on one launch's captured events of bench.py:547-573
        # (phase 2k)
        "name": "col_walk",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/col_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_col.py:745",
        "launches": out["col_le_deck"]["walk_launches"],
        "max_abs_err": col_walk_err,
        "ms": col_walk["ms"],
        "plain_ms": col_walk["plain_ms"],
    }, {
        # the record kernel's walk kernel (K2's estimates): launches on
        # run/step_cloud_radiance.nml, the rest on one launch's captured
        # events of the radiance deck's configuration (phase 2k)
        "name": "record_walk",
        "route": "cuda",
        "source": "mcbrat3d_tpu_torch/csrc/record_kernel.cu",
        "replaces": "mcbrat3d_tpu/transport/pallas_kernel.py:1515",
        "launches": out["rec_walk_launches"],
        "max_abs_err": rec_walk_err,
        "ms": rec_walk["ms"],
        "plain_ms": rec_walk["plain_ms"],
    }]
    for name, replaces in (
            ("probe_gather", "tools/probe_gather.py:39, "
             "tools/probe_gather2.py:114, tools/probe_gather3.py:191, "
             "native/pallas_gather_experiment.py:34"),
            ("probe_tally", "tools/probe_tally.py:178")):
        # the probes (phase 5): launches of the CLI's run of every variant,
        # times of the variant PROBE_LINE names
        p = out["probes"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mcbrat3d_tpu_torch/csrc/probe_kernels.cu",
            "replaces": replaces, "launches": p["launches"],
            "max_abs_err": p["max_err"], "ms": p["ms"],
            "plain_ms": p["plain_ms"], "library_ms": p["library_ms"]})
    for k in kernels:
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        # no single PyTorch call computes a transport step
        k.setdefault("library_ms", None)
    # K1's flux paths on JAX's geometry in the same call (the kernels line
    # gives their refill launches)
    k1 = {"record_kernel": head, "record_kernel_multi3": multi_head,
          "record_kernel_lw": lw_head, "record_kernel_rpv": out["rpv_step"],
          "record_kernel_px": out["px_step"]}
    print("K1 flux paths, kernel ms a launch (CUDA events) and launches a "
          "batch: " + "; ".join(
              f"{name} refill {r['kernel_ms_per_launch']:.4f} x "
              f"{r['launches_per_batch']:.1f}, JAX's geometry "
              f"{r['jax_kernel_ms_per_launch']:.4f} x "
              f"{r['jax_launches_per_batch']:.1f}"
              for name, r in k1.items()), flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
