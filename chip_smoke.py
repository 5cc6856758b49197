#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives pulseportraiture_tpu_torch end to end on the card and fails
(non-zero exit, no result line) when any phase fails:

1. card: the GPU's name and power limit (nvidia-smi);
2. build: every kernel compiled from this checkout's sources (nvcc,
   sm_90a, one object per source, built in parallel) into
   build/torch_kernels/;
3. kernels vs plain versions: B1 (fused DFT -> cross-spectrum) and B2
   (sub-byte decode -> DFT -> cross-spectrum) against their plain
   PyTorch versions on the card over directed sets of shapes, with the
   tolerance stated per case (B2's decoded samples exactly), each case
   through the arm the shape rule (ops.fused.fft_arm: the FFT arm for
   an nbin in [16, 8192] with no prime factor other than 2, 3 and 5 and
   K <= nbin/2 + 1, else the GEMM arm) or the case names: the FFT arm at
   nbin 16 ... 8192 and at the mixed-radix 1000, 1125, 1536 and 3072
   (B1's S0 and want_m2 forms and its spectrum launch alone in float32
   and float64; B2 2-bit and 4-bit at 1000 and 1536), the GEMM arm forced
   beside each 1000-bin case and at 2048, and by the rule at 1022 (K=100;
   K=512 with want_m2; a ragged 3 x 37; K=385; float64 fold), 1023 (odd:
   the float32 direct form), 1032 (per-element want_m2; B2 1-, 2- and
   4-bit, float64 fold), 12 (also at BIG_ROWS rows, past 65535 row
   blocks, B1 and B2) and 8200 bins, and its spectrum launch on baselined
   rows at 1022 and 8200 (folded, the float32 arm's form at even nbin;
   the DC harmonic's error logged apart).  Every float32
   case, of either arm, is held to the plain version evaluated in
   float64 on the same inputs (plain_oracle: the float32 plain version's
   own error can exceed the tolerance);
4. main path: a 64-subint 512-channel x 2048-bin archive with injected
   (phi, dDM) from a seeded generator and a .gmodel template, measured
   by ``python -m pulseportraiture_tpu_torch.cli.pptoas`` (run in this
   process, so the kernels' launch counters can be read), then by the
   GetTOAs library call for the fit time; every TOA must recover the
   injected phase to |dphi| < 1e-4 rot, every return code must be in
   {0, 1, 2}, and B1 must have been launched through its FFT arm and
   never its GEMM arm;
5. B1's, its GEMM arm's, its plain version's, a torch.matmul
   equivalent's and a cuFFT (torch.fft.rfft) equivalent's times at the
   main path's shapes, each output held to its tolerance again;
6. stream path: 8 archives of 64 x 512 x 2048 2-bit (NBIT=2) samples and
   the main path's int16 archive in one metafile, measured by
   ``pptoas --stream`` in this process; B2 and B1 must both have been
   launched through their FFT arms and never their GEMM arms, every TOA
   must recover the injection to 1e-4 rot, and every
   2-bit TOA must agree with GetTOAs on the same archive within 0.1
   sigma; B1 is held to its plain version at a full int16 bucket
   (256 x 512 x 2048, the largest shape the stream path gives it); then
   the campaign's TOAs/s, host -> device bytes and the device's idle
   share under the profiler;
7. B2's, its GEMM arm's, its plain version's and two torch
   equivalents' (the decode as torch ops, then torch.matmul or
   torch.fft.rfft) times at the stream path's bucket shape (256 x 512 x
   2048), each output held to its tolerance;
8. scattering path: 4 int16 and 4 2-bit (dithered) archives of 64 x 512
   x 2048 with (phi, dDM) and a scattering timescale of 20 us at 1500
   MHz (index -4) injected, measured by ``pptoas --stream --fit_scat
   --scat_guess auto`` in this process: one full 256-subint bucket per
   kind through the complex-free scatter lane; B1 must have been
   launched in its want_m2 form through its FFT arm only and B2 never;
   every TOA must recover the injected phase within 5 phi_err (and to
   1e-4 rot for int16 data), tau at 1500 MHz and alpha within 5 sigma,
   every return code in {0, 1, 2}; GetTOAs (the complex engine, in
   complex64) on one int16 archive must agree with the stream within
   0.1 sigma, 2 % in tau and 0.05 in alpha; then the campaign under the
   profiler (busy time, idle share, the Newton evaluator's share);
9. B1's want_m2 form, its GEMM arm, its plain version and the
   torch.matmul and cuFFT equivalents at the scattering bucket's shape
   (256 x 512 x 2048, K from the derived window), each output held to
   its tolerance;
10. spline path: a .spl template built from the .gmodel portrait at the
   main archive's 512 channels x 2048 bins (the port's pca in float64
   on the card, fit_spline_curve on the host), its evaluation timed,
   then ``pptoas -m model.spl`` on the main archive and ``pptoas
   --stream -m model.spl`` on the stream metafile: B1 (and B2 on the
   stream) through their FFT arms only, every TOA within 1e-4 rot of
   the injection and 0.1 sigma of the .gmodel run's TOA;
11. narrowband path (no kernel of the port runs on its fits; the tau
   seed of its scat_guess 'auto' runs B1's want_m2 form): ``pptoas
   --narrowband`` on the main archive (32768 per-channel TOAs), its
   pulls against the injection held to fixed bounds, cold and warm
   TOAs/s, the dense CCF's time and memory, the device's idle share;
   ``pptoas --stream --narrowband`` over the main archive and two 2-bit
   archives within 0.1 sigma of GetTOAs; and ``--narrowband --fit_scat
   --scat_guess auto`` on an 8-subint scattered archive, GetTOAs
   against the stream within 0.1 sigma and 2 % in tau;
12. zap path: one int16 and two dithered 2-bit archives of 16 subints at
   the main archive's widths with RFI from synth.inject_rfi (white tones on 8
   channels, two of them also structured, one burst); ``ppzap``
   model-less with --zap-device on and off (the same lists, every
   injected channel flagged, at most one channel per subint beyond what
   the cut flags on that subint's clean channels);
   ``stream_wideband_TOAs(zap_inline=True)`` with the counters set to 0
   just before it (B2 on the 2-bit bucket, B1 on the int16 one, FFT arms
   only; the inline cut's device time and host syncs per bucket), its
   cut counts equal to ppzap's, its TOAs within 1e-4 rot of the
   injection and 0.1 sigma of the ``zap_channels=`` run, B2 held to its
   plain version on the zapped bucket, warm TOAs/s with and without the
   cut; ``stream_narrowband_TOAs(zap_inline=True)`` emitting no TOA for
   a flagged channel; ``ppzap -m`` with the device lane on and off (the
   same lists) against ``stream_wideband_TOAs(postfit_cut=True)``, equal
   but for channels within 1e-4 of the cut;
13. align path: 4 int16 epochs of 32 x 512 x 2048 with their own
   injected phases and dDMs; ``ppalign -g 0.05 --niter 2`` (B1 through
   its FFT arm in every iteration, the window resolving from the
   Gaussian seed) and ``ppalign --niter 2 -s -N rms`` (the first archive
   as the seed), each with K and B1's launches per iteration and the
   wall by stage (load, template, phase guess, fit, accumulate,
   finalize, write); no archive skipped, each output with DM 0, dmc 1,
   unit weights and shape (1, 512, 2048), the -g average correlating
   with the clean .gmodel portrait > 0.95; align_archives with the
   card's float32 accumulate (under the profiler: busy time, idle
   share) against the host's float64 lane (corr > 0.99999, max |d| <
   0.02 max |avg|); B1 against its plain version at the align fit's
   shape; the accumulate's time against its byte bound; ``pptoas -m``
   the aligned archive on the main path's archive and ``pptoas
   --stream`` the same: TOAs a constant offset from the .gmodel run's
   plus a scatter below the bound PERF.md fixed, the stream within 0.1
   sigma, return codes in {0, 1, 2};
14. template path: an averaged archive (1 x 512 x 2048 at the noise of
   a 128-subint ppalign average) and a JOIN pair of 256-channel
   receivers (the second with an injected phase and dDM);
   ``ppgauss --niter 2 --fitloc`` on the batched LM lane, the serial
   lane (--gauss-device off) and the torch.func Jacobian (--lm-jacobian
   ad): the same ngauss and parameters within 1e-6 x their errors;
   ``ppgauss -M --fitloc`` recovering the injected JOIN (phase, dDM)
   within 5 sigma; ``ppspline`` (-N prof) and ``ppspline -s``; each with its
   wall by stage and, per LM call, iterations, nfev, host reads of the
   loop state and compaction classes; the built .gmodel and .spl
   correlating with the clean .gmodel portrait above the bound PERF.md
   fixed; ``pptoas -m`` the built .gmodel and .spl and ``pptoas
   --stream -m`` the .gmodel on the main path's archive: TOAs a constant
   offset from the .gmodel run's plus a scatter below the bound PERF.md
   fixed, B1 through its FFT arm only, the stream within 0.1 sigma,
   return codes in {0, 1, 2}; the first portrait fit under the profiler
   (busy, idle share, peak memory, the DGEMM and solve shares); and
   fit_gaussian_portrait on 64 channels on the card and on the CPU
   (float64 both) within 1e-6 x the errors, chi2 within 1e-9;
15. pta path: 8 averaged archives (1 x 512 x 2048, each of its own
   seeded Gaussian model, one of them with overlapping components, at
   the template path's noise) through ``ppfactory --max-ngauss 8
   --niter 1 --fitloc`` on the batched and the serial LM lane and
   ``--kind spline``: the same ngauss and LM convergence on both lanes
   for every job, every job's parameters within 1e-9 x their errors,
   every separated-component job's LM fits converged (the overlapping
   one's trials may cap: they did on the CPU at cut widths), every
   built template of the separated-component jobs correlating with its
   clean portrait > 0.9999, fewer LM calls batched than serial; a
   spin-coherent campaign of 10 epochs x 4 subints for
   pulsar A (isolated, int16) and pulsar B (ELL1, dithered 2-bit),
   timed by ``pptoas -m`` and ``pptoas --stream -m`` the factory's
   templates (B1 and B2 through their FFT arms only, each held to its
   plain version on the largest bucket the path gave it and on random
   data at that shape, return codes in {0, 1, 2}); ``pptime -j`` on
   both with F0 (and B's PB) perturbed: the JAX tests' gates on chi2,
   residuals, DMX, F0 and PB; fleet_gls_fit on 45 pulsars (A, B and 43
   synthetic campaigns of 120-121 epochs) on the batched, serial and
   host lanes: batched vs serial <= 1e-10, vs host <= 1e-8, fewer
   batched calls; and the batch-width probe of the fleet solve;
16. campaign path: stream_ipta_campaign over phase 15's pulsars A
   (int16) and B (dithered 2-bit) and pulsar C (10 epochs x 4 x 512 x
   2048 written with nbit=8, levels=4, dithered: bytes the transport
   codec packs to 2 bits), each with its factory .gmodel,
   nsub_batch=16, A and B timed by the campaign's fleet stage with
   phase 15's parfiles; run 1 traced with the codec on (the counters
   set to 0 just before it), run 2 untraced with it off, 4 alternating
   untraced / traced pairs with it on (what tracing costs): run 1's
   trace through the port's validate_trace and report (dispatches =
   nfit = copies, the
   copies' bytes = the results', codec engaged on C's dispatches only,
   seqs unique across the executors and paired with the drains, one
   timing_fit per solve, the counters last), C's shipped bytes below
   its logical bytes, run 1's logical = run 2's shipped, every
   pulsar's .tim identical between runs 1 and 2 and a lone
   stream_wideband_TOAs of it (or within a repeat of run 2's spread),
   B1 (on A's and C's unpacked bucket) and B2 (on B's) through their
   FFT arms only (held to their plain versions on a rerun's buckets),
   return codes in {0, 1, 2}, phase 15's timing gates, A within 0.1
   sigma of phase 15's
   ``pptoas -m``, C's residuals and DMX within 5 sigma of its
   injection; C alone with transport_compress='auto' (the cost model's
   decisions and learned link rate); ``pptoas --stream --telemetry
   --transport-compress on`` on C, then ``python -m
   pulseportraiture_tpu_torch.cli.pptrace report`` (exit 0);
17. serve path: phase 6's archives as three requests (R1 three 2-bit
   archives, R2 the other five, R3 the int16 archive) through the
   continuous-batching server: ``python -m
   pulseportraiture_tpu_torch.cli.ppserve -r requests.jsonl
   --nsub-batch 256 --max-wait-ms 2000 --telemetry t1.jsonl`` in this
   process (cold, traced, the counters set to 0 just before it), then a
   library ToaServer warmed from that trace serving them three times
   (the last pass ended by stop(drain=True), under the profiler), then
   ``ppserve -r`` in two fresh processes, without and with
   ``--warmup-manifest t1.jsonl``: every
   served .tim byte-identical to the one-shot stream_wideband_TOAs of
   its archives with the same nsub_batch, every TOA within 1e-4 rot of
   the injection, return codes in {0, 1, 2}, a bucket shared by two
   requests, no cold dispatch after the warm-up, every request
   resolved by the drain, B2 on the 2-bit buckets and B1 on the int16
   one through their FFT arms only, B2 held to its plain version on
   the first mixed bucket and B1 on R3's padded bucket; the served and
   one-shot warm TOAs/s, request latencies, the first dispatch's cost
   per shape with and without the warm-up, bytes to the card, the idle
   share and the host memory per pass;
18. router path: phase 17's three requests routed across a fleet of two
   warm servers on the card: ``pproute -r requests.jsonl -H a,b
   --telemetry`` over two in-process hosts behind TransportServers
   (traced, the counters set to 0 just before it), the codec lane
   (``--no-shared-fs --transport-compress on``), a failover (host A
   behind a KillableTransport, killed after its first placement),
   hedging (hedge_ms at half of round 1's p50), then two ``ppserve
   --listen 127.0.0.1:0 --warmup-manifest`` processes routed by
   ``pproute -H`` and by a router whose first host is killed by
   SIGKILL; every routed .tim byte-identical to its one-shot with no
   duplicated line, every TOA within 1e-4 rot of the injection, return
   codes in {0, 1, 2}, both hosts placed in round 1, route_failover in
   the failover rounds with every request resolved on the survivor,
   route_hedge in the hedging round, B2 on the 2-bit buckets and B1 on
   the int16 one through their FFT arms only (each held to its plain
   version on a round 1 bucket; the kernels line counts the in-process
   rounds' launches only), no replica left running;
   stream_ipta_campaign(router=) on phase 15's pulsars A and B equal to
   the server= run; ``ppfactory --result-cache on`` twice on two of
   phase 15's averages, the second run served 2/2 from the cache with
   the same bytes.  Printed: each host's share, the routed p50/p99, the
   routed TOAs/s beside phase 17's served and one-shot ones (two
   processes on one card measure how far their host work overlaps, not
   scale-out), the router's overhead per request, the result frames'
   bytes plain and zlib, the failover walls, hedges launched and won,
   each replica's start and warm-up wall and GPU memory, the factory
   cache's miss and hit walls;
19. ingest path: two corpora of 12 spin-coherent epochs x 8 subints x
   512 x 2048, 30 days apart (the JAX ingest bench's pulsar and events
   at NARCH = 12): event (dithered 2-bit, a 100 us achromatic step from
   epoch 6 and a 4e-3 pc/cc DM step from epoch 8) and clean (int16),
   both over a per-epoch DM wander; ``python -m
   pulseportraiture_tpu_torch.cli.ppwatch --drain -p --stable-ms 0
   --resolve-every 8`` over each in this process (the counters set to 0
   just before it): rc 0, the first glitch and the first dm_step alert
   within one day of their injected epochs and no alert before them on
   the event corpus (its later re-alerts of the persistent events
   printed: the reference semantics give the same on the same TOAs, a
   CPU test holds them equal), none on the clean corpus, at least one
   full incremental resolve, B2 (event) and B1 (clean) through their FFT
   arms only, each held to its plain version on a padded ingest bucket;
   a trickle (ppwatch on a worker thread, the archives copied in one at
   a time in two chunks: at least one 'truncated' deferral), a burst
   (all at once), three paths announced to a SocketSource and a
   queue_depth-1 server (at least one 'backpressure' deferral); every
   streamed .tim byte-identical to the one-shot stream_wideband_TOAs of
   its archives in admission order at ppwatch's nsub_batch; ``pptrace
   merge [--json]`` over phase 18's round 3 traces (each request once,
   with its host spans, its failover and its critical stage); ``ppmon
   --once --json`` against a router monitor and a host (exit 0, the
   fleet p99 present) and ``ppmon --once``.  Printed per round: the
   wall, discovery -> admission and admission -> TOA p50/p99, TOAs/s,
   the dispatches and the deferrals;
20. tune path: (a) profiling.profile_stages on the fast fit of the main
   path's archive (64 x 512 x 2048, float32, its window K): prefix
   ``cross_spectrum`` (the weights and B1), prefix ``prepare`` (all of
   prepare_portrait_fit_real), piece ``newton`` (the Newton loop on the
   prepared inputs), every stage cost finite and >= 0, B1 launched, the
   breakdown and attributed_frac printed; (b) ``pptoas --stream
   --autotune --tune-db tune.json --telemetry t1.jsonl`` over phase 6's
   2-bit archives and the int16 one (the sweep streams the first, a
   2-bit archive; the counters set to 0 just before it): one DB entry
   under 512x2048 whose fingerprint names the card and torch, 1
   tune_probe, 5 tune_sweep and 1 tune_apply (db_hit false), tuned_s <=
   default_s, the .tim byte-identical to the untuned run's; (c) the same
   command again: db_hit true, no tune_sweep, the same .tim; (d) a DB
   with the JAX package's CPU fingerprint: a warning, the defaults
   kept, rc 0, the same .tim; (e) a numerics sweep (tune_numerics on,
   the numerics tier alone): its DB entry not identity-preserving; (f)
   ``ppserve -r --tune-db tune.json --telemetry``: db_hit true in the
   server's trace, the server's stats() fingerprint equal to the DB's;
   (g) B1 (the campaign's int16 bucket) and B2 (the sweep's 2-bit
   bucket) through their FFT arms only and held to their plain versions
   at 1e-5 x max|ref|.  Printed: the sweep's wall, its winners and
   walls per knob, the warm run's wall, the stage attribution.  The
   numerics tier sweeps dft_precision too ('default': the matmul DFTs
   in TF32 on the card).
21. scale-out path (run after phase 16): two ranks over gloo, both on
   the one card, as two processes (``chip_smoke.scale_out_rank``;
   parallel.init_multihost(backend='gloo'): NCCL refuses two ranks on
   one GPU, so this shows the sharded code path on the card, neither
   NCCL nor a speed-up): fit_portrait_sharded_fast on a 2 x 1 mesh over
   the main path's 64 x 512 x 2048 float32 batch (32 subints a rank; B1
   launched by each rank through its FFT arm and held to its plain
   version on rank 0's bucket), its scattering branch on an 8-subint
   scattered int16 archive (B1's want_m2 form on each rank), one
   align_iteration_sharded over the align path's 4 x 32 x 512 x 2048
   epochs, each held to the same call at world size 1 in this process
   (phi, DM, tau, alpha within 1e-3 x their errors on each rank's
   slice; the template within 1e-5 x its max on the whole batch), the
   first 4 subints' phi within 1e-4 rot of the
   port's fit/reference_numpy; stream_ipta_campaign(shard=True) over
   phase 15's pulsars A (int16, B1) and B (2-bit, B2): the union of the
   ranks' .tim shards holds phase 16's run 1 lines (TOAs and DMs within
   0.01 sigma), the ranks' summaries equal, B1 and B2 launched by each
   rank through their FFT arms only (B2 held to its plain version on
   rank 0's bucket).  Printed: the backend and world size, the launches
   and walls per rank, each rank's peak memory.
23. non-power-of-two nbin (run before phase 22, which stays last): an
   int16 archive of 64 x 512 x 1000 (the FFT arm's mixed-radix plan, 5 5
   5 8) and two 2-bit archives at 1000 bins; ``pptoas`` on the int16
   archive at window K=384 and unwindowed (K = 501 through the kernels)
   and ``pptoas --stream`` over the three at K=384 (the counters set to
   0 just before each run): every TOA within 1e-4 rot of the injection,
   every B1 and B2 launch through the FFT arm and none through the GEMM
   arm; the C8 gate at 1000 bins (4 scattered subints alone vs as a
   batch through the fast, packed and scat_guess='auto' lanes at K=384
   and unwindowed, bit for bit); then timing rows, each with the kernel,
   its GEMM arm (and that arm's own three-product TF32 bound), its plain
   version, the torch.matmul and cuFFT equivalents and the bound: B1's S0
   form at 64 x 512 x {1000, 1536, 3072} at K=384 and nbin/2 + 1, its
   want_m2 form and B2 2-bit at 256 x 512 x 1536, K=384;
24. an nbin with a prime factor above 5 (run after phase 23, before
   phase 22): phase 23's runs at 1032 = 2^3 3 43 bins (an int16 archive
   of 64 x 512 x 1032 and two 2-bit archives; ``pptoas`` at K=384 and
   unwindowed, K=517, ``pptoas --stream`` at K=384, the C8 gate on 4
   scattered subints), every TOA within 1e-4 rot, every B1 and B2 launch
   through the GEMM arm (the float32 three-product TF32 tensor-core GEMM)
   and none through the FFT arm, the C8 runs bit for bit; then timing
   rows through the GEMM arm, each with its plain version, the
   torch.matmul and cuFFT equivalents, its byte bound, its
   three-product TF32 bound for the folded form it runs (and the
   direct form's FP32-FMA one beside it): B1's S0 form at 64 x 512 x
   1022 (2 7 73) at K=384 and 512, its want_m2 form at 256 x 512 x
   1022, K=384, and B2 2-bit at 256 x 512 x 1032, K=384;
22. batch invariance (ROADMAP C8), run last: 8 scattered int16
   subints of 512 x 2048 and their dithered 2-bit rows fitted as one
   batch and each alone, through the fast fit (B1), the packed 2-bit fit
   (B2) and the scattering fit with scat_guess='auto' (B1's want_m2
   form for the tau seed and the fit), with the template's window
   (K=384) and without one (every harmonic through the kernels, K =
   1025), then the complex engine and narrowband (their DFTs through
   the invariant matmul DFT): each subint alone gives the batch's bits
   in every result field (the counters set to 0 just before the fits;
   every kernel through its FFT arm, at both windows); B1, its want_m2
   form and B2 on 3 subints of 37 channels (an odd count) give each
   subint alone the batch's bits; ``pptoas --stream`` with no window
   over phase 6's 9 archives and over one 2-bit archive alone: its .tim
   lines byte-identical, every TOA within 1e-4 rot of the injection; a
   fresh process with PPT_COMPILE_CACHE at this process's build
   directory loads the kernels without nvcc; dft_precision 'high' and
   'default' (TF32 matmul DFTs) within 1e-3 x max|ref| of 'highest';
   B1 (S0 and want_m2) and B2 at K = 1025 held to their plain versions
   at 1e-5 x max|ref| and timed as in phases 5, 7 and 9 (the kernels
   line's "full_spectrum" records).

The line before the last is one JSON object listing each kernel with
its launches on its path, error, times, bound and arm; the last line is
``{"ok": true, "device": {...}}``.  Each phase prints its wall time.
Exits non-zero without a result when no CUDA device is available or the
package is missing.
"""

import contextlib
import io
import json
from collections import Counter
import math
import os
import runpy
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM3 bandwidth, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
# dense TF32 on the tensor cores (the float32 GEMM arm's three products)
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12

PAR = {"PSR": "J1744-1134", "RAJ": "17:44:29.4", "DECJ": "-11:34:54.6",
       "P0": 0.004074, "PEPOCH": 55000.0, "DM": 3.139}
NSUB, NCHAN, NBIN = 64, 512, 2048
PHI_INJ, DDM_INJ = 0.0123, 2.0e-4
SEED = 20261016
# the stream path: NARCH 2-bit archives beside the main path's archive,
# in buckets of the JAX package's default nsub_batch
NARCH, NOISE_2BIT, NSUB_BATCH = 8, 1.0, 256
# the scattering path: NARCH_SCAT int16 and NARCH_SCAT 2-bit (dithered)
# archives with the main path's injection plus a scattering timescale
# T_SCAT [s] at 1500 MHz and index ALPHA_INJ: one full bucket per kind
NARCH_SCAT, T_SCAT, ALPHA_INJ = 4, 2.0e-5, -4.0
NOISE_SCAT_I16, NOISE_SCAT_2BIT = 1.0, 0.5
# the spline path: the template keeps the fewest PCA components whose
# reconstruction holds the .gmodel portrait to SPL_RECON_RMS of its
# peak, and the largest smoothing factor of SPL_SFACS whose spline
# rebuilds it to SPL_RMS of its peak
SPL_RECON_RMS, SPL_RMS = 1e-6, 1e-4
SPL_SFACS = (1e-2, 1e-4, 1e-6, 1e-8, 1e-10)
# the narrowband path: bounds on the mean and standard deviation of the
# per-channel pulls on the main archive, fixed from a CPU run before the
# first chip run (PERF.md section 4), and the scattering run's depth
NB_PULL_MEAN, NB_PULL_STD = 0.05, (0.95, 1.06)
NSUB_NB_SCAT = 8
# a channel measures tau when its log10 error is below this [dex]
NB_TAU_MEASURED = 1.0
# the zap path: one int16 and NARCH_ZAP_2BIT 2-bit archives of NSUB_ZAP
# subints at the main archive's widths (depth cut from the stream path's
# 9 archives to 3, and from 64 subints to 16: the path's two ppzap -m
# runs and its archive writes are load- and write-bound), white RFI
# tones of ZAP_WHITE x the median channel noise on ZAP_TONES,
# ZAP_STRUCTURED of them also a structured ZAP_STRUCT x tone, and one
# broadband burst (subint, channels, strength)
NARCH_ZAP_2BIT, NSUB_ZAP = 2, 16
ZAP_TONES = (37, 101, 160, 222, 290, 333, 401, 470)
ZAP_STRUCTURED = (101, 333)
ZAP_WHITE, ZAP_STRUCT = 8.0, 60.0
ZAP_BURST = (1, (250, 251, 252, 253), 20.0)
# the align path: NARCH_ALIGN int16 epochs of NSUB_ALIGN subints at the
# main archive's widths (depth cut from its 64 subints), each with its
# own injected phase and dDM, at noise NOISE_ALIGN; ppalign's -g seed
# FWHM [rot] and iteration count; the bound on the scatter of
# TOA(aligned template) - TOA(.gmodel) about their mean offset, in units
# of the TOA error, fixed before the first chip run from a CPU rehearsal
# (tools/align_toa_scatter.py; PERF.md section 6)
NARCH_ALIGN, NSUB_ALIGN, NOISE_ALIGN = 4, 32, 1.0
ALIGN_PHASES = (0.0, 0.11, -0.07, 0.23)
ALIGN_DDMS = (0.0, 1e-4, 2e-4, -1e-4)
ALIGN_FWHM, ALIGN_NITER = 0.05, 2
ALIGN_TOA_SCATTER = 3.0
# the template path: an averaged archive of 1 subint at the main
# archive's widths with the white noise per bin of a 128-subint ppalign
# average of epochs at NOISE_ALIGN, and a JOIN pair of receivers of
# half its channels each (1100-1500 and 1500-1900 MHz, the second with
# an injected phase and dDM); ppgauss's --niter; the bounds on the
# built templates' correlation with the clean .gmodel portrait and on
# the scatter of TOA(built template) - TOA(.gmodel) about their mean
# offset [sigma], per template kind, fixed before the first chip run
# from a CPU rehearsal (tools/template_toa_scatter.py; PERF.md section 6)
NOISE_TEMPLATE = NOISE_ALIGN / math.sqrt(128)
JOIN_PHASE, JOIN_DDM = 0.05, 1e-4
TEMPLATE_NITER = 2
TEMPLATE_CORR = {"gmodel": 0.9999, "spl": 0.9999}
TEMPLATE_TOA_SCATTER = {"gmodel": 0.5, "spl": 3.0}
# the pta path: PTA_NFLEET averaged archives (1 subint at the main
# archive's widths, each of its own seeded Gaussian model, at
# NOISE_TEMPLATE) through ppfactory; pulsars A (isolated, the main PAR)
# and B (ELL1, PAR_B) timed over PTA_NEP spin-coherent epochs of
# PTA_NSUB subints at noise 1.0 with per-epoch dDMs of std PTA_DDM; the
# timing parfiles' F0 (both) and PB (B) perturbed; the fleet GLS at
# BASELINE config 5's pulsar count, PTA_NGLS, over PTA_GLS_NEP epochs
PTA_NFLEET, PTA_NEP, PTA_NSUB, PTA_DDM = 8, 10, 4, 3e-4
# the fleet job with overlapping components (default_test_model's), on
# which the factory's breadth-first scan can stop early (PERF.md section
# 7): held on its lanes, left out of the correlation gate
PTA_OVERLAP = PTA_NFLEET - 1
PAR_B = {"PSR": "J1012+5307", "RAJ": "10:12:33.4", "DECJ": "53:07:02.5",
         "P0": 0.004, "PEPOCH": 55000.0, "DM": 9.0233, "BINARY": "ELL1",
         "PB": 1.0, "A1": 0.05, "TASC": 55000.3, "EPS1": 2e-6,
         "EPS2": -1e-6}
PTA_F0_REL, PTA_DPB = 3e-12, 2e-9
# phase 16: the campaign's bucket size (each pulsar's 40 subints in
# three dispatches, 16 + 16 + 8, so copies overlap fits) and the
# untraced / traced pairs that time the trace
CAMPAIGN_BATCH, CAMPAIGN_PAIRS = 16, 4
PTA_NGLS, PTA_GLS_NEP, PTA_GLS_SPAN = 45, 120, 3650.0
# phase 17: the serve path's deadline [ms] (long enough that R1's and
# R2's 2-bit subints share a bucket while the archives load) and the
# 2-bit archives of its first request
SERVE_WAIT_MS, SERVE_SPLIT = 2000.0, 3
# phase 19, the ingest path: the JAX ingest bench's corpus at NARCH = 12
# (benchmarks/bench_ingest.py) at the chip's widths and noise:
# INGEST_NEP spin-coherent epochs of INGEST_NSUB subints of INGEST_TSUB
# s, INGEST_SPACING days apart, an achromatic INGEST_DT [s] step from
# epoch INGEST_GLITCH_I on and an INGEST_DDM DM step from epoch
# INGEST_DM_I on (the event corpus only), over a per-epoch DM wander of
# INGEST_WANDER x ((i mod 3) - 1); ppwatch's default bucket size; the
# trickle writer's pause between an archive's two chunks and between
# archives [s], and its poll and stability windows [ms]
INGEST_NEP, INGEST_NSUB, INGEST_TSUB, INGEST_SPACING = 12, 8, 60.0, 30.0
INGEST_GLITCH_I, INGEST_DM_I = 6, 8
INGEST_DT, INGEST_DDM, INGEST_WANDER = 100e-6, 4e-3, 2e-4
INGEST_NSUB_BATCH = 64
INGEST_PAUSE_S, INGEST_GAP_S = 0.3, 0.2
INGEST_POLL_MS, INGEST_STABLE_MS = 50.0, 200.0
PAR_INGEST = dict(PAR, PEPOCH=55100.0 + 0.5 * INGEST_SPACING
                  * (INGEST_NEP - 1))
# phase 21, the scale-out path: two gloo ranks on one card (NCCL refuses
# two ranks on one GPU); the scattering branch's subints, the subints
# held to the NumPy oracle, the ranks' time limit [s], and the bounds
# against world size 1 on the whole batch: phi, DM, tau and alpha within
# SCALE_TOL x their errors, the align template within SCALE_TEMPLATE_TOL
# x its max, the campaign's TOAs and DMs within SCALE_TIM_SIGMA x their
# errors; the meshes the sharded calls run on ((n_data, n_chan), the
# second with shard_channels=True)
SCALE_NSUB_SCAT, SCALE_NORACLE, SCALE_TIMEOUT = 8, 4, 300
SCALE_TOL = 1e-3
SCALE_TEMPLATE_TOL, SCALE_TIM_SIGMA = 1e-5, 0.01
SCALE_BATCH_KEYS = ("ports", "noise_stds", "chan_masks", "P_s", "nu_fit",
                    "theta0")
SCALE_MESHES = {"2x1": (2, 1), "1x2": (1, 2)}
SCALE_CALLS = ("fit", "scat", "align")
# phase 3's mixed-radix cases (nbin, dtype, K) and phase 23, the
# non-power-of-two nbin: the main path's 64 x 512 at MIXED_NBIN bins (5 5 5
# 8) through GetTOAs at window MIXED_K and unwindowed (K = 501), the stream
# over it and MIXED_NARCH 2-bit archives, the C8 gate on MIXED_C8_NSUB
# scattered subints; timing rows of B1's S0 form at 64 x 512 x
# MIXED_TIME_NBINS (K = MIXED_K and nbin / 2 + 1), of its want_m2 form and
# of B2 at a full bucket of MIXED_BUCKET_NBIN bins
MIXED_CASES = ((1536, "float32", 384), (1536, "float64", 769),
               (3072, "float32", 1537), (3072, "float64", 384),
               (1125, "float32", 563), (1125, "float64", 100))
MIXED_NBIN, MIXED_K, MIXED_NARCH, MIXED_C8_NSUB = 1000, 384, 2, 4
MIXED_TIME_NBINS, MIXED_BUCKET_NBIN = (1000, 1536, 3072), 1536
# phase 24, an nbin with a prime factor above 5: phase 23's runs at
# PRIME_NBIN = 2^3 3 43 bins (which packs at 1, 2 and 4 bits; 2 7 73 =
# 1022 carries no 2-bit row) through the GEMM arm (unwindowed K = 517);
# timing rows of B1's S0 form at 64 x 512 x PRIME_TIME_NBIN = 1022 at K =
# MIXED_K and 512 (every harmonic), its want_m2 form at a full bucket of
# 1022 bins and B2 2-bit at a full bucket of PRIME_NBIN bins, K = MIXED_K
PRIME_NBIN, PRIME_TIME_NBIN = 1032, 1022
# phase 3's GEMM-arm row count past 65535 blocks of 128 rows (and of 64)
BIG_ROWS = 65536 * 128 + 37


def log(msg):
    print(msg, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def median_ms(fn, n=20, warmup=3, reps=5):
    """Median over n samples of the device time per call: CUDA events
    around reps calls issued back to back, divided by reps, so that the
    host's time to issue a call overlaps the card's work on the one
    before (a lone call would also time the idle card waiting for its
    first launch)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def cross_spectrum_case(name, nb, nchan, nbin, K, dtype, fold=False,
                        want_m2=False, per_element=False, seed=0, arm=None,
                        block=None):
    """A B1 problem on the card; block: the plain version's channel tile
    (None: its default; one tile of every channel keeps the oracle of a
    case with millions of channels to a few launches)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if nb is None else (nb,)
    port = torch.randn(lead + (nchan, nbin), generator=g, device="cuda",
                       dtype=dtype)
    mshape = lead + (nchan, nbin) if per_element else (nchan, nbin)
    model = torch.randn(mshape, generator=g, device="cuda", dtype=dtype)
    w = torch.rand(lead + (nchan, K), generator=g, device="cuda",
                   dtype=dtype) + 0.5
    return dict(name=name, port=port, model=model, w=w, K=K, fold=fold,
                want_m2=want_m2, arm=arm, block=block)


def expect_arm(kernel, before, arm, name):
    """Raise unless the launches since ``before`` (a kernel_launches()
    snapshot) all went through ``arm``; return the arm."""
    from pulseportraiture_tpu_torch.ops import fused as F

    now = F.kernel_launches()
    d = {a: now[f"{kernel}.{a}"] - before[f"{kernel}.{a}"]
         for a in ("fft", "gemm")}
    other = "gemm" if arm == "fft" else "fft"
    if d[arm] < 1 or d[other]:
        raise AssertionError(f"{name}: {kernel} launches by arm {d}, "
                             f"expected the {arm} arm only")
    return arm


def case_arm(c, nbin):
    from pulseportraiture_tpu_torch.ops import fused as F

    return c["arm"] or ("fft" if F.fft_arm(nbin, c["K"]) else "gemm")


def plain_oracle(ref_fn, args, kw):
    """The plain version's outputs that a case is held to, and the
    float32 plain version's own outputs (None for float64 cases).  A
    float64 case is held to the plain version as it is.  A float32 case,
    of either arm, is held to the plain version on the same inputs
    evaluated in float64: the float32 plain version sums each harmonic
    over the row in order, and on baselined rows (a DC term of a few
    hundred) its DC harmonic errs by up to ~2e-5 x max|dr| at 2048 bins,
    more than the tolerance and ~200x the FFT's tree of sums; the GEMM
    arm's float32 sums its three TF32 products per 8 samples into an FP32
    accumulator, in another order than the plain version's."""
    import torch

    ref32 = ref_fn(*args, **kw)
    if ref32[0].dtype == torch.float64:
        return ref32, None
    up = tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
               else a for a in args)
    return ref_fn(*up, **kw), ref32


def upcast(ref, ref32):
    """True when plain_oracle evaluated the float32 case in float64."""
    return ref32 is not None and ref32 is not ref


def check_outputs(name, kernel, got, ref, ref32, parts):
    """Each output within 1e-5 (float32) or 1e-12 (float64) x its
    max|ref| of ref; raises otherwise.  Returns [(err, max|ref|, part)]
    and the log text (with the float32 plain version's own error against
    ref where the two differ)."""
    import torch

    rtol = 1e-5 if ref32 is not None else 1e-12
    worst, text = [], []
    for i, part in enumerate(parts):
        g, r = got[i], ref[i]
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name} {part}: shape {tuple(g.shape)} vs "
                                 f"{tuple(r.shape)} or non-finite")
        err = float((g.double() - r.double()).abs().max())
        scale = float(r.abs().max())
        if not err <= rtol * scale:
            raise AssertionError(
                f"{kernel} {name} {part}: max abs err {err:.3e} > {rtol:g} "
                f"x max|ref| {scale:.3e}")
        worst.append((err, scale, part))
        t = f"{part} {err:.3e} of {scale:.3e}"
        if upcast(ref, ref32):
            e32 = float((ref32[i].double() - r.double()).abs().max())
            t += f" (plain f32 {e32:.3e})"
        text.append(t)
    return worst, ", ".join(text)


def check_cross_spectrum_case(c):
    """B1 against its plain version (plain_oracle) on one case, through
    the arm the shape rule or the case names: each output within 1e-5
    (float32) or 1e-12 (float64) of its max|ref|; raises otherwise."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F

    args = (c["port"], c["model"], c["w"], c["K"])
    kw = dict(fold=c["fold"], want_m2=c["want_m2"])
    before = F.kernel_launches()
    got = F.fused_cross_spectrum_cuda(*args, arm=c["arm"], **kw)
    arm = expect_arm("fused_cross_spectrum", before,
                     case_arm(c, c["port"].shape[-1]), c["name"])
    ref, ref32 = plain_oracle(F.fused_cross_spectrum_ref, args,
                              dict(kw, block=c.get("block")))
    torch.cuda.synchronize()
    _, text = check_outputs(c["name"], "fused_cross_spectrum", got, ref,
                            ref32, ("Xr", "Xi", "o2"))
    log(f"kernel check ok: fused_cross_spectrum {c['name']} ({arm} arm; "
        f"tol {'1e-5' if ref32 is not None else '1e-12'} x max|ref| of the "
        f"plain version{' in float64' if upcast(ref, ref32) else ''};"
        f" max abs err {text})")


def check_fft_spectrum(name, rows, nbin, K, dtype, seed=0):
    """B1's FFT spectrum launch (ppt_fcs_fft_spectrum, the template's
    transform in every FFT-arm call) on ``rows`` random rows against the
    plain DFT (ops.fourier.rfft_mm) evaluated in float64: Re and Im
    within 1e-5 (float32) or 1e-12 (float64) x max|ref|; raises
    otherwise.  A check: it counts no launch."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.ops.fourier import (_dtype_str,
                                                        device_weights,
                                                        rfft_mm)

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, nbin), generator=g, device="cuda", dtype=dtype)
    tw, = device_weights("fft", x.device, nbin, _dtype_str(dtype))
    out = (torch.empty((rows, K), device="cuda", dtype=dtype),
           torch.empty((rows, K), device="cuda", dtype=dtype))
    sfx = "f32" if dtype == torch.float32 else "f64"
    F._check(getattr(F.build_kernels(), f"ppt_fcs_fft_spectrum_{sfx}")(
        x.data_ptr(), rows, nbin, tw.data_ptr(), K, out[0].data_ptr(),
        out[1].data_ptr(), torch.cuda.current_stream().cuda_stream), name)
    ref = rfft_mm(x.double(), nharm=K)
    ref32 = rfft_mm(x, nharm=K) if dtype == torch.float32 else None
    torch.cuda.synchronize()
    _, text = check_outputs(name, "fused_cross_spectrum spectrum", out, ref,
                            ref32, ("re", "im"))
    log(f"kernel check ok: fused_cross_spectrum FFT spectrum {name} (tol "
        f"{'1e-5' if ref32 is not None else '1e-12'} x max|ref| of the plain "
        f"DFT in float64; max abs err {text})")


def baselined_rows(rows, nbin, seed, noise=0.1):
    """rows float32 profiles as a baselined archive holds them: a pulse
    of peak 50 at phase 0.3 (width 0.02 rot) over an offset of 3 and
    white noise, minus each row's least-window mean (ops.noise's
    baseline), so the DC harmonic sums ~nbin values of one sign."""
    import torch
    from pulseportraiture_tpu_torch.ops.noise import min_window_baseline

    g = torch.Generator(device="cuda").manual_seed(seed)
    ph = torch.arange(nbin, device="cuda", dtype=torch.float64) / nbin
    x = (3.0 + 50.0 * torch.exp(-0.5 * ((ph - 0.3) / 0.02) ** 2)
         + noise * torch.randn((rows, nbin), generator=g, device="cuda",
                               dtype=torch.float64))
    return (x - min_window_baseline(x)[..., None]).float()


def gemm_spectrum_f32(x, K, fold):
    """The float32 GEMM arm's spectrum launch (ppt_fcs_spectrum_f32) on the
    rows x (R, nbin), in its folded or direct form: (Re, Im) (R, K).  A
    check: it counts no launch."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.ops.fourier import device_weights

    rows, nbin = x.shape
    hi, lo, sgn = device_weights("tf32x3", x.device, nbin, K, bool(fold))
    out = (torch.empty((rows, K), device="cuda"),
           torch.empty((rows, K), device="cuda"))
    F._check(F.build_kernels().ppt_fcs_spectrum_f32(
        x.data_ptr(), rows, nbin, hi.data_ptr(), lo.data_ptr(),
        sgn.data_ptr(), nbin // 2 - 1 if fold else nbin, K, int(fold),
        out[0].data_ptr(), out[1].data_ptr(),
        torch.cuda.current_stream().cuda_stream), "gemm_spectrum_f32")
    return out


def check_gemm_dc(name, rows, nbin, K, seed=0):
    """The float32 GEMM arm's spectrum launch (the three-product TF32 DFT)
    in the form the wrapper takes (folded at even nbin >= 8, else direct)
    on baselined rows against the plain DFT (ops.fourier.rfft_mm)
    evaluated in float64: Re and Im within 1e-5 x max|ref|; the DC
    harmonic's error logged apart from the others' (the tensor cores'
    sums of ~nbin values of one sign).  A check: it counts no launch.
    Returns the (DC, the rest's Re) errors / max|ref|."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.ops.fourier import rfft_mm

    if F.fft_arm(nbin, K):
        raise AssertionError(f"check_gemm_dc {name}: the rule takes the FFT "
                             "arm")
    x = baselined_rows(rows, nbin, seed)
    fold = nbin % 2 == 0 and nbin >= 8
    name = f"{name} {'folded' if fold else 'direct'}"
    out = gemm_spectrum_f32(x, K, fold)
    ref = rfft_mm(x.double(), nharm=K)
    ref32 = rfft_mm(x, nharm=K)
    torch.cuda.synchronize()
    _, text = check_outputs(f"GEMM spectrum baselined {name}",
                            "fused_cross_spectrum spectrum", out, ref, ref32,
                            ("re", "im"))
    scale = float(ref[0].abs().max())
    dc = float((out[0][:, 0].double() - ref[0][:, 0]).abs().max()) / scale
    rest = float((out[0][:, 1:].double() - ref[0][:, 1:]).abs().max()) / scale
    dc32 = float((ref32[0][:, 0].double() - ref[0][:, 0]).abs().max()) / scale
    log(f"kernel check ok: fused_cross_spectrum GEMM spectrum on baselined "
        f"rows {name} (tol 1e-5 x max|ref| of the plain DFT in float64; "
        f"max abs err {text}); DC harmonic {dc:.3e} x max|ref| (plain f32 "
        f"{dc32:.3e}), other harmonics' Re {rest:.3e}")
    return dc, rest


def _cross_epilogue(dr, di, mr, mi, w, want_m2):
    """(Xr, Xi, S0) or, with want_m2, (Xr, Xi, M2w) from the spectra."""
    import torch

    m2 = (mr * mr + mi * mi) * w
    return ((dr * mr + di * mi) * w, (di * mr - dr * mi) * w,
            m2 if want_m2 else torch.sum(m2, dim=-1))


def library_equivalent(port, model, w, K, W, want_m2=False):
    """One torch.matmul-based computation of the same function (the
    yardstick; the port never calls it)."""
    import torch

    D = torch.matmul(port, W)
    Mm = torch.matmul(model, W)
    return _cross_epilogue(D[..., :K], D[..., K:], Mm[..., :K],
                           Mm[..., K:], w, want_m2)


def cufft_equivalent(port, model, w, K, want_m2=False):
    """The same function with torch.fft.rfft (cuFFT) of data and
    template sliced to K and the same epilogue (the yardstick; the port
    never calls it)."""
    import torch

    D = torch.fft.rfft(port)[..., :K]
    Mm = torch.fft.rfft(model)[..., :K]
    return _cross_epilogue(D.real, D.imag, Mm.real, Mm.imag, w, want_m2)


def cross_spectrum_bound_ms(nb, nchan, nbin, K, itemsize, want_m2,
                            shared=True):
    """Least time for the function on this card: the larger of its
    bytes (port, model and per-element w read once, outputs written
    once) over HBM bandwidth and its fewest operations over the FP32
    (or FP64) peak.  The fewest operations giving the same outputs are a
    real FFT of every data and template row (2.5 nbin log2 nbin FLOPs
    each), not the kernel's matmul DFT, plus the epilogue."""
    rows = nb * nchan
    mrows = nchan if shared else rows
    flops = (2.5 * (rows + mrows) * nbin * math.log2(nbin)
             + 11.0 * rows * K)
    out = 2 * rows * K + (rows * K if want_m2 else rows)
    nbytes = itemsize * ((rows + mrows) * nbin + rows * K + out)
    peak = PEAK_FP32_FLOPS if itemsize == 4 else PEAK_FP64_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def decode_case(name, nb, nchan, nbin, K, dtype, code, fold=False,
                seed=0, arm=None, block=None):
    """A B2 problem on the card: random packed bytes (every sample value
    occurs), DAT_SCL in [0.5, 1.5), DAT_OFFS ~ N(0, 1), one shared
    template and per-element weights; block as cross_spectrum_case's."""
    import torch
    from pulseportraiture_tpu_torch.ops.decode import PACKED_BITS

    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if nb is None else (nb,)
    bpc = nbin * PACKED_BITS[code] // 8
    raw = torch.randint(0, 256, lead + (nchan, bpc), generator=g,
                        device="cuda", dtype=torch.uint8)
    scl = torch.rand(lead + (nchan,), generator=g, device="cuda",
                     dtype=dtype) + 0.5
    offs = torch.randn(lead + (nchan,), generator=g, device="cuda",
                       dtype=dtype)
    model = torch.randn((nchan, nbin), generator=g, device="cuda",
                        dtype=dtype)
    w = torch.rand(lead + (nchan, K), generator=g, device="cuda",
                   dtype=dtype) + 0.5
    return dict(name=name, raw=raw, scl=scl, offs=offs, model=model, w=w,
                K=K, code=code, nbin=nbin, fold=fold, arm=arm, block=block)


def check_decode_case(c):
    """B2 against its plain version (plain_oracle) on one case, through
    the arm the shape rule or the case names: each output within 1e-5
    (float32) or 1e-12 (float64) of its max|ref|, and the kernel's
    decoded samples equal to the plain decode's.  Returns the worst
    (err, max|ref|, output) of the five outputs."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.ops.decode import (PACKED_BITS,
                                                       affine_decode,
                                                       unpack_bitplanes)
    from pulseportraiture_tpu_torch.ops.noise import min_window_baseline

    args = (c["raw"], c["scl"], c["offs"], c["model"], c["w"], c["K"])
    kw = dict(code=c["code"], nbin=c["nbin"], fold=c["fold"])
    before = F.kernel_launches()
    got = F.fused_decode_cross_spectrum_cuda(*args, arm=c["arm"], **kw)
    arm = expect_arm("fused_decode_cross_spectrum", before,
                     case_arm(c, c["nbin"]), c["name"])
    ref, ref32 = plain_oracle(F.fused_decode_cross_spectrum_ref, args,
                              dict(kw, block=c.get("block")))
    torch.cuda.synchronize()
    worst, _ = check_outputs(c["name"], "fused_decode_cross_spectrum", got,
                             ref, ref32, ("Xr", "Xi", "S0", "pwr", "x0"))
    # the samples the kernel stages, against the plain decode with the
    # plain baseline: bit for bit
    nbin = c["nbin"]
    s = unpack_bitplanes(c["raw"], PACKED_BITS[c["code"]], nbin)
    x = affine_decode(s, c["scl"], c["offs"], c["w"].dtype)
    b = min_window_baseline(x)
    ref_x = x - b[..., None]
    got_x = F.decode_rows_cuda(c["raw"], c["scl"], c["offs"], b,
                               code=c["code"], nbin=nbin,
                               dtype=c["w"].dtype)
    torch.cuda.synchronize()
    if not torch.equal(got_x, ref_x):
        n = int((got_x != ref_x).sum())
        raise AssertionError(f"{c['name']}: {n} decoded samples differ "
                             "from the plain decode")
    err, scale, part = max(worst, key=lambda t: t[0] / max(t[1], 1e-300))
    log(f"kernel check ok: fused_decode_cross_spectrum {c['name']} ({arm} "
        f"arm; tol {'1e-5' if ref32 is not None else '1e-12'} x max|ref| of "
        f"the plain version{' in float64' if upcast(ref, ref32) else ''}"
        f"; worst {part} {err:.3e} of {scale:.3e}; decoded samples exact)")
    return err, scale, part


def decode_library_equivalent(raw, scl, offs, model, w, K, code, nbin,
                              W=None):
    """One torch computation of B2's function with library calls: the
    decode as torch ops, a torch.matmul DFT (against W) or, without W,
    a torch.fft.rfft of data and template, the epilogue and the Parseval
    rows (the yardstick; the port never calls it)."""
    import torch
    from pulseportraiture_tpu_torch.ops.decode import decode_stokes_I

    x = decode_stokes_I(raw.reshape(raw.shape[:-2] + (-1,)), scl, offs,
                        w.dtype, code=code, nbin=nbin)
    if W is None:
        Xr, Xi, S0 = cufft_equivalent(x, model, w, K)
    else:
        Xr, Xi, S0 = library_equivalent(x, model, w, K, W)
    x0 = x.sum(dim=-1)
    pwr = nbin * ((x - (x0 / nbin)[..., None]) ** 2).sum(dim=-1)
    sgn = torch.ones(nbin, device=x.device, dtype=x.dtype)
    sgn[1::2] = -1.0
    pwr = pwr + (x * sgn).sum(dim=-1) ** 2
    return Xr, Xi, S0, pwr, x0


def decode_bound_ms(nb, nchan, nbin, K, nbit, itemsize=4):
    """Least time for B2's function on this card: the larger of its
    bytes (packed rows, scl/offs, template and per-element w read once;
    Xr/Xi/S0/pwr/x0 written once) over HBM bandwidth and its fewest
    operations over the FP32 (or FP64) peak: a real FFT of every data
    and template row (2.5 nbin log2 nbin FLOPs each), the epilogue (11
    per output harmonic), and the decode, baseline and Parseval rows
    (about 10 per sample)."""
    rows = nb * nchan
    flops = (2.5 * (rows + nchan) * nbin * math.log2(nbin)
             + 11.0 * rows * K + 10.0 * rows * nbin)
    nbytes = (rows * nbin * nbit / 8 + itemsize * (
        2 * rows + nchan * nbin + rows * K + 2 * rows * K + 3 * rows))
    peak = PEAK_FP32_FLOPS if itemsize == 4 else PEAK_FP64_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_kernels():
    """Every kernel vs its plain version on the card over the directed
    set, each case through its expected arm; raises on the first
    disagreement."""
    import torch

    f32, f64 = torch.float32, torch.float64
    B1 = cross_spectrum_case
    cases = [
        # FFT arm: the production shape, the ends of the nbin range,
        # K = 1, K on no tile, K = nbin/2 + 1, odd row counts, both
        # model forms, want_m2, no batch axis, float32 and float64
        B1("production 64x512x2048 K=256", 64, 512, 2048, 256, f32),
        B1("single subint 512x2048 K=256", None, 512, 2048, 256, f32,
           seed=1),
        B1("ragged nchan=500", 2, 500, 2048, 256, f32, seed=2),
        B1("per-element models want_m2 2048 K=1025", 4, 512, 2048, 1025,
           f32, want_m2=True, per_element=True, seed=3),
        B1("nbin=16 K=9 111 rows", 3, 37, 16, 9, f32, seed=4),
        B1("nbin=8192 K=4097 66 rows", 2, 33, 8192, 4097, f32, seed=5),
        B1("nbin=128 K=1 13 rows", None, 13, 128, 1, f32, seed=6),
        B1("nbin=256 K=100 want_m2 per-element", 3, 37, 256, 100, f32,
           want_m2=True, per_element=True, seed=7),
        B1("f64 nbin=128 K=40", 3, 13, 128, 40, f64, seed=8),
        B1("f64 nbin=16 K=9 per-element want_m2", 3, 13, 16, 9, f64,
           want_m2=True, per_element=True, seed=9),
        B1("f64 nbin=2048 K=1025 26 rows", 2, 13, 2048, 1025, f64,
           seed=10),
        B1("f64 nbin=8192 K=1 5 rows", None, 5, 8192, 1, f64, seed=11),
        B1("f64 nbin=8192 K=4097 want_m2", 1, 7, 8192, 4097, f64,
           want_m2=True, seed=12),
        # the mixed-radix plan (5 5 5 8) by the rule at nbin=1000, each
        # with its GEMM-arm twin forced; the GEMM arm also forced at 2048
        # and by the rule at 1022 = 2 x 7 x 73
        B1("nbin=1000 K=100", 3, 37, 1000, 100, f32, seed=13),
        B1("GEMM arm forced nbin=1000 K=100", 3, 37, 1000, 100, f32,
           seed=13, arm="gemm"),
        B1("GEMM arm forced 2048 K=256", 4, 512, 2048, 256, f32, seed=14,
           arm="gemm"),
        B1("f64 nbin=1000 fold want_m2 per-element", 2, 13, 1000, 40, f64,
           fold=True, want_m2=True, per_element=True, seed=15),
        B1("GEMM arm forced f64 nbin=1000 fold want_m2 per-element", 2, 13,
           1000, 40, f64, fold=True, want_m2=True, per_element=True,
           seed=15, arm="gemm"),
        B1("GEMM arm nbin=1022 K=100", 2, 37, 1022, 100, f32, seed=16),
        # the float32 GEMM arm on the tensor cores (three TF32 products):
        # every harmonic with want_m2, ragged rows, K one past a harmonic
        # tile, the ends of the rule's nbin (below 16, above 8192), more
        # row blocks than a grid's y axis holds (65535: 64-row spectrum
        # and 128-row cross blocks), per-element models (the spectrum
        # launch over every row), and the float64 SIMT GEMM (the only
        # form that reads fold: float32 folds every even nbin) beside them
        B1("GEMM arm 4x512x1022 K=512 want_m2", 4, 512, 1022, 512, f32,
           want_m2=True, seed=17),
        B1("GEMM arm ragged 3x37x1022 K=384", 3, 37, 1022, 384, f32, seed=18),
        B1("GEMM arm 2x64x1022 K=385", 2, 64, 1022, 385, f32, seed=19),
        B1("GEMM arm nbin=12 K=7 111 rows", 3, 37, 12, 7, f32, seed=40),
        B1("GEMM arm nbin=8200 K=129 74 rows", 2, 37, 8200, 129, f32,
           seed=41),
        B1(f"GEMM arm {BIG_ROWS} rows per-element nbin=12 K=7", 1,
           BIG_ROWS, 12, 7, f32, per_element=True, seed=42,
           block=BIG_ROWS),
        B1("GEMM arm per-element want_m2 2x37x1032 K=300", 2, 37, 1032, 300,
           f32, want_m2=True, per_element=True, seed=43),
        B1("f64 GEMM arm fold nbin=1022 K=200", 2, 13, 1022, 200, f64,
           fold=True, seed=44),
        # an odd nbin (3 11 31): the float32 GEMM arm's direct form
        B1("GEMM arm direct nbin=1023 K=384", 4, 128, 1023, 384, f32,
           seed=51),
        B1("GEMM arm direct nbin=1023 K=512 want_m2 per-element", 2, 37,
           1023, 512, f32, want_m2=True, per_element=True, seed=52),
    ]
    # the mixed-radix plan at 1536 (3 8 8 8), 3072 (3 8 8 8 2) and the
    # odd 1125 (3 3 5 5 5): S0 and want_m2 in float32 and float64, at an
    # odd channel count (each subint padded to an even one)
    for i, (nbin, dt, K) in enumerate(MIXED_CASES):
        for m2 in (False, True):
            cases.append(B1(f"{'f64 ' if dt == 'float64' else ''}nbin={nbin} "
                            f"K={K}{' want_m2' if m2 else ''}", 2, 37, nbin,
                            K, getattr(torch, dt), want_m2=m2,
                            per_element=m2, seed=60 + 2 * i + m2))
    for c in cases:
        check_cross_spectrum_case(c)
    del cases
    # B1's FFT spectrum launch (the template's transform) alone at the
    # mixed lengths, every harmonic, an odd row count
    for i, (nbin, dt, _) in enumerate(MIXED_CASES):
        check_fft_spectrum(f"{'f64 ' if dt == 'float64' else ''}nbin={nbin} "
                           f"K={nbin // 2 + 1} 37 rows", 37, nbin,
                           nbin // 2 + 1, getattr(torch, dt), seed=80 + i)
    B2 = decode_case
    for c in (
            B2("2-bit 64x512x2048 K=256", NSUB, NCHAN, NBIN, 256, f32, "p2",
               seed=20),
            B2("1-bit 4x512x2048 K=256", 4, NCHAN, NBIN, 256, f32, "p1",
               seed=21),
            B2("4-bit 4x512x2048 K=1025", 4, NCHAN, NBIN, 1025, f32, "p4",
               seed=22),
            B2("ragged nchan=500 2-bit", 2, 500, NBIN, 256, f32, "p2",
               seed=23),
            B2("single subint 4-bit nbin=256 K=100 37 rows", None, 37, 256,
               100, f32, "p4", seed=24),
            B2("1-bit nbin=8192 K=4097 9 rows", 1, 9, 8192, 4097, f32, "p1",
               seed=25),
            B2("2-bit nbin=16 K=1 111 rows", 3, 37, 16, 1, f32, "p2",
               seed=26),
            B2("f64 1-bit nbin=128 K=40", 3, 13, 128, 40, f64, "p1",
               seed=27),
            B2("f64 4-bit nbin=16 K=9", 2, 13, 16, 9, f64, "p4", seed=28),
            B2("f64 2-bit nbin=8192 K=1", None, 5, 8192, 1, f64, "p2",
               seed=29),
            # the mixed-radix plan at nbin=1000 by the rule, each with its
            # GEMM-arm twin forced; the GEMM arm forced at 2048
            B2("2-bit nbin=1000 K=100", 2, 37, 1000, 100, f32, "p2",
               seed=30),
            B2("GEMM arm forced 2-bit nbin=1000 K=100", 2, 37, 1000, 100,
               f32, "p2", seed=30, arm="gemm"),
            B2("GEMM arm forced 2-bit 2048", 4, NCHAN, NBIN, 256, f32,
               "p2", seed=31, arm="gemm"),
            B2("f64 4-bit nbin=1000 fold", 2, 13, 1000, 40, f64, "p4",
               fold=True, seed=32),
            B2("GEMM arm forced f64 4-bit nbin=1000 fold", 2, 13, 1000, 40,
               f64, "p4", fold=True, seed=32, arm="gemm"),
            # 2-bit and 4-bit at 1000 and 1536 bins
            B2("2-bit 8x512x1000 K=384", 8, NCHAN, 1000, 384, f32, "p2",
               seed=33),
            B2("f64 4-bit nbin=1000 K=501 37 rows", 3, 37, 1000, 501, f64,
               "p4", seed=34),
            B2("f64 2-bit nbin=1536 K=769 37 rows", 3, 37, 1536, 769, f64,
               "p2", seed=35),
            B2("4-bit 8x512x1536 K=384", 8, NCHAN, 1536, 384, f32, "p4",
               seed=36),
            # the float32 GEMM arm at 1032 = 2^3 3 43 bins, which packs at
            # 1, 2 and 4 bits (1022 carries no 2-bit row)
            B2("GEMM arm 1-bit 4x512x1032 K=384", 4, NCHAN, 1032, 384, f32,
               "p1", seed=45),
            B2("GEMM arm 2-bit 8x512x1032 K=384", 8, NCHAN, 1032, 384, f32,
               "p2", seed=46),
            B2("GEMM arm 4-bit 4x512x1032 K=517", 4, NCHAN, 1032, 517, f32,
               "p4", seed=47),
            B2("f64 GEMM arm 2-bit fold 2x37x1032 K=100", 2, 37, 1032, 100,
               f64, "p2", fold=True, seed=48),
            # more row blocks than a grid's y axis holds (the template's
            # spectrum launch over every channel, then the cross launch)
            B2(f"GEMM arm 2-bit {BIG_ROWS} rows nbin=12 K=7", None,
               BIG_ROWS, 12, 7, f32, "p2", seed=53, block=BIG_ROWS)):
        check_decode_case(c)
    # the GEMM arm's DC harmonic on baselined rows, logged apart
    check_gemm_dc("64x512x1022 K=384", 64 * NCHAN, 1022, 384, seed=49)
    check_gemm_dc("4x512x8200 K=129", 4 * NCHAN, 8200, 129, seed=50)


def phase_timing(K_main, Ks=None):
    """B1 at the main path's shape (64 subints against one shared
    template, per-element weights) at the main path's harmonic window
    K_main and at the production K=256 of the directed set (or at the
    windows ``Ks``): time_cross_spectrum's checks and times of the
    kernel, its GEMM arm, its plain version and the torch.matmul and
    cuFFT equivalents (median of 20 samples).  The kernel must take its
    FFT arm.  Returns {K: record}."""
    records = {}
    for K in sorted(Ks or {256, K_main}):
        records[K] = time_cross_spectrum(NSUB, NCHAN, NBIN, K, seed=10 + K,
                                         n=20)
        if records[K]["arm"] != "fft":
            raise AssertionError(f"B1 at the main path's shape, K={K}: the "
                                 f"{records[K]['arm']} arm")
    return records


def expected_phase(nu):
    """Injected phase of the fake archive at frequency nu [MHz]: the
    achromatic injection plus the dispersive delay of DM + dDM at nu,
    minus the folding alignment at nu0 (the data are dispersed)."""
    from pulseportraiture_tpu_torch.config import Dconst

    P = PAR["P0"]
    e = (PHI_INJ + Dconst * (PAR["DM"] + DDM_INJ) * nu ** -2.0 / P
         - Dconst * PAR["DM"] * 1500.0 ** -2.0 / P)
    return (e + 0.5) % 1.0 - 0.5


def phase_main_path(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=NBIN):
    import numpy as np
    import torch
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.pipeline import GetTOAs
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    os.makedirs(WORK, exist_ok=True)
    gmodel = os.path.join(WORK, "model.gmodel")
    arch = os.path.join(WORK, "fake.fits")
    tim = os.path.join(WORK, "toas.tim")
    model = default_test_model(1500.0)
    write_gmodel(model, gmodel, quiet=True)
    t0 = time.perf_counter()
    make_fake_pulsar(model, PAR, outfile=arch, nsub=nsub, nchan=nchan,
                     nbin=nbin, nu0=1500.0, bw=800.0, tsub=60.0,
                     phase=PHI_INJ, dDM=DDM_INJ, start_MJD=MJD(55100, 0.1),
                     noise_stds=1.0, dedispersed=False, quiet=True,
                     rng=np.random.default_rng(SEED), device=device)
    log(f"archive {nsub}x{nchan}x{nbin} written in "
        f"{time.perf_counter() - t0:.2f} s")
    if os.path.exists(tim):
        os.remove(tim)

    # the CLI, exactly as `python -m ... cli.pptoas`, in this process
    cli_s, launches = run_cli(
        ["-d", arch, "-m", gmodel, "-o", tim, "--quiet", "--print_phase",
         "--quality_flags", "--device", device], "pptoas")
    log(f"main path (pptoas CLI): {cli_s:.3f} s wall incl. load and "
        f"first use, kernel launches {launches}")
    if launches["fused_cross_spectrum"] < 1:
        raise AssertionError("the main path never launched the "
                             "fused_cross_spectrum kernel")
    if device_type(device) == "cuda":
        fft_only(launches, ("fused_cross_spectrum",), "the main path")

    with open(tim) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    if len(lines) != nsub:
        raise AssertionError(f"{len(lines)} TOAs for {nsub} subints")
    worst = 0.0
    subints = set()
    for tok in lines:
        flags = dict(zip(tok[5::2], tok[6::2]))
        nu = float(tok[1])
        phi = float(flags["-phs"])
        d = abs((phi - expected_phase(nu) + 0.5) % 1.0 - 0.5)
        worst = max(worst, d)
        subints.add(int(flags["-subint"]))
        if not all(math.isfinite(float(x)) for x in (tok[3], phi,
                                                     flags["-pp_dm"])):
            raise AssertionError(f"non-finite TOA line {tok}")
    if subints != set(range(nsub)):
        raise AssertionError("missing subints in the .tim")
    if not worst < 1e-4:
        raise AssertionError(f"phase recovery |dphi| = {worst:.3e} rot "
                             f">= 1e-4")
    log(f"phase recovery: max |dphi| = {worst:.3e} rot over {nsub} TOAs "
        f"(limit 1e-4)")

    # the library call, warm: fit time, return codes, counters again
    F.reset_kernel_launches()
    gt = GetTOAs(arch, gmodel, quiet=True, device=device)
    t0 = time.perf_counter()
    gt.get_TOAs(quiet=True)
    sync(device)
    lib_s = time.perf_counter() - t0
    lib_launches = F.kernel_launches()["fused_cross_spectrum"]
    if lib_launches < 1:
        raise AssertionError("GetTOAs never launched the kernel")
    if device_type(device) == "cuda":
        fft_only(F.kernel_launches(), ("fused_cross_spectrum",), "GetTOAs")
    rcs = np.asarray(gt.rcs[0])[gt.ok_isubs[0]]
    if not np.all(np.isin(rcs, (0, 1, 2))):
        raise AssertionError(f"return codes {sorted(set(rcs.tolist()))}")
    fit_s = gt.fit_durations[0]
    nfev = np.asarray(gt.nfevals[0])[gt.ok_isubs[0]]
    log(f"main path (GetTOAs, warm): fit {fit_s:.4f} s for {nsub} TOAs = "
        f"{nsub / fit_s:.1f} TOAs/s (fit), {nsub / lib_s:.1f} TOAs/s "
        f"incl. load, {lib_s:.3f} s wall; nfeval max {int(nfev.max())} "
        f"median {float(np.median(nfev))}; return codes "
        f"{sorted(set(rcs.tolist()))}; kernel launches {lib_launches}")

    # cost of the Newton loop's one host sync per trip
    x = torch.zeros(8, device=device, dtype=torch.bool)
    sync(device)
    ts = []
    for _ in range(50):
        t0 = time.perf_counter()
        bool(x.any())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    log(f"newton loop: {int(nfev.max())} trips, host sync round trip "
        f"{ts[len(ts) // 2] * 1e6:.1f} us each (median of 50, idle card)")
    return launches["fused_cross_spectrum"]


def phase_fit_profile(arch, gmodel, device="cuda"):
    """Where the fit's time goes on device-resident inputs: the
    fit_portrait_batch_fast call GetTOAs makes, minus the host staging,
    timed by host clock around a synchronized call, and one call under
    torch.profiler for the device's busy time by kernel."""
    import numpy as np
    import torch
    from pulseportraiture_tpu_torch.fit import portrait as FP
    from pulseportraiture_tpu_torch.fit.portrait import (
        FitFlags, fit_portrait_batch_fast)
    from pulseportraiture_tpu_torch.pipeline.models import TemplateModel
    from pulseportraiture_tpu_torch.pipeline.toas import (
        load_for_toas, snr_weighted_nu_fit)

    d = load_for_toas(arch)
    ok = np.asarray(d.ok_isubs, int)
    freqs0 = np.asarray(d.freqs[0], float)
    masks = np.asarray(d.weights[ok] > 0.0, float)
    tmpl = TemplateModel(gmodel, device=device).portrait(
        freqs0, d.nbin, P=float(np.mean(d.Ps[ok])))
    theta0 = np.zeros((len(ok), 5))
    theta0[:, 1] = float(d.DM)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    args = (dev(d.subints[ok, 0]), np.asarray(tmpl, np.float32),
            dev(d.noise_stds[ok, 0]), dev(freqs0), dev(d.Ps[ok]),
            dev(snr_weighted_nu_fit(np.asarray(d.SNRs[ok, 0]) * masks,
                                    freqs0)))
    kw = dict(theta0=dev(theta0), fit_flags=FitFlags(True, True),
              chan_masks=dev(masks), device=device)
    K = FP.resolve_harmonic_window(None, args[1], d.nbin)
    log(f"main-path harmonic window K={K}")
    fit_portrait_batch_fast(*args, **kw)
    sync(device)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        r = fit_portrait_batch_fast(*args, **kw)
        sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    fit_ms = times[2] * 1e3
    log(f"fit on device-resident inputs ({len(ok)} subints): "
        f"{fit_ms:.2f} ms median of 5 = {len(ok) / times[2]:.0f} TOAs/s; "
        f"nfeval max {int(r.nfeval.max())}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit_portrait_batch_fast(*args, **kw)
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, rows = profile_rows(prof)
    log(f"profile: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"(idle share {1.0 - busy_ms / wall_ms:.3f}, profiler on)")
    for us, key, n in rows[:8]:
        log(f"  {us / 1e3:9.3f} ms  x{n:<4d} {key[:90]}")
    return K


def phase_decode_timing(K_main):
    """B2 at the directed production shape (64 x 512 x 2048, 2-bit) at
    the main path's K, then time_decode at the stream path's bucket shape
    (NSUB_BATCH x 512 x 2048, 2-bit, per-element weights) at K_main: the
    kernel (its FFT arm), its GEMM arm, its plain version and the two
    torch equivalents, each output held to 1e-5 x its max|ref| first.
    Returns the record."""
    import torch

    check_decode_case(decode_case(f"2-bit 64x512x2048 K={K_main}", NSUB,
                                  NCHAN, NBIN, K_main, torch.float32, "p2",
                                  seed=40))
    return time_decode(NSUB_BATCH, NCHAN, NBIN, K_main, seed=41)


def stream_archives(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=NBIN,
                    narch=NARCH, noise=NOISE_2BIT):
    """The stream path's campaign: narch 2-bit archives with the main
    path's injection (each its own epoch and noise draw) beside the main
    path's int16 archive, in one metafile.  Returns (metafile, 2-bit
    archive paths, int16 archive path, .gmodel path)."""
    import numpy as np
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    model = default_test_model(1500.0)
    files = []
    for i in range(narch):
        path = os.path.join(WORK, f"fake2bit-{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=nsub, nchan=nchan,
                         nbin=nbin, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=PHI_INJ, dDM=DDM_INJ,
                         start_MJD=MJD(55200 + i, 0.1), noise_stds=noise,
                         dedispersed=False, quiet=True,
                         rng=np.random.default_rng(SEED + 1 + i), nbit=2,
                         device=device)
        files.append(path)
    int16 = os.path.join(WORK, "fake.fits")
    meta = os.path.join(WORK, "stream_meta.txt")
    with open(meta, "w") as f:
        f.write("\n".join(files + [int16]) + "\n")
    return meta, files, int16, os.path.join(WORK, "model.gmodel")


def toa_sigma_offset(a, b):
    """|TOA(a) - TOA(b)| over a's TOA error, b referenced to a's
    frequency along b's own DM: TOA objects of one subint."""
    from pulseportraiture_tpu_torch.config import Dconst

    dt = ((b.MJD.day - a.MJD.day) + (b.MJD.frac - a.MJD.frac)) * 86400.0
    dt += Dconst * b.DM * (a.frequency ** -2.0 - b.frequency ** -2.0)
    return abs(dt) * 1e6 / a.TOA_error


def phase_stream(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=NBIN,
                 narch=NARCH, noise=NOISE_2BIT, nsub_batch=NSUB_BATCH,
                 K=None):
    """The stream path: ``pptoas --stream`` over the campaign, in this
    process, with the kernels' counters set to 0 just before it and read
    just after; then the 2-bit TOAs against GetTOAs, and the library
    call timed and profiled.  On a CUDA device B2 and B1 must both have
    been launched (the CPU runs their plain versions), and B1 is held to
    its plain version at a full int16 bucket (nsub_batch x nchan x nbin,
    per-element weights, the main path's harmonic window K): a bucket
    dispatches up to nsub_batch subints, so no B1 launch of this path is
    larger."""
    import torch
    from pulseportraiture_tpu_torch.pipeline import GetTOAs
    from pulseportraiture_tpu_torch.pipeline.stream import (
        stream_wideband_TOAs)

    t0 = time.perf_counter()
    meta, files, int16, gmodel = stream_archives(device, nsub, nchan, nbin,
                                                 narch, noise)
    log(f"stream archives: {narch} x {nsub}x{nchan}x{nbin} 2-bit written "
        f"in {time.perf_counter() - t0:.2f} s")
    tim = os.path.join(WORK, "stream.tim")
    if os.path.exists(tim):
        os.remove(tim)
    cli_s, launches = run_cli(
        ["--stream", "-d", meta, "-m", gmodel, "-o", tim, "--quiet",
         "--print_phase", "--quality_flags", "--device", device],
        "pptoas --stream")
    ntoa = (narch + 1) * nsub
    log(f"stream path (pptoas --stream): {ntoa} TOAs from {narch + 1} "
        f"archives in {cli_s:.3f} s wall incl. load and first use = "
        f"{ntoa / cli_s:.1f} TOAs/s, kernel launches {launches}")

    with open(tim) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    if len(lines) != ntoa:
        raise AssertionError(f"{len(lines)} stream TOAs for {ntoa} subints")
    worst = 0.0
    for tok in lines:
        flags = dict(zip(tok[5::2], tok[6::2]))
        phi = float(flags["-phs"])
        if not all(math.isfinite(float(x))
                   for x in (tok[3], phi, flags["-pp_dm"])):
            raise AssertionError(f"non-finite stream TOA line {tok}")
        worst = max(worst, abs((phi - expected_phase(float(tok[1])) + 0.5)
                               % 1.0 - 0.5))
    if not worst < 1e-4:
        raise AssertionError(f"stream phase recovery |dphi| = {worst:.3e} "
                             "rot >= 1e-4")
    log(f"stream phase recovery: max |dphi| = {worst:.3e} rot over {ntoa} "
        f"TOAs (limit 1e-4)")

    # the 2-bit TOAs against GetTOAs on the same archives
    t0 = time.perf_counter()
    res = stream_wideband_TOAs(meta, gmodel, nsub_batch=nsub_batch,
                               device=device, quiet=True)
    sync(device)
    lib_s = time.perf_counter() - t0
    gt = GetTOAs(files, gmodel, quiet=True, device=device)
    gt.get_TOAs(quiet=True, prefetch=True)
    ref = {(t.archive, t.flags["subint"]): t for t in gt.TOA_list}
    offs = [toa_sigma_offset(ref[(t.archive, t.flags["subint"])], t)
            for t in res.TOA_list if t.archive in files]
    if len(offs) != narch * nsub or not max(offs) <= 0.1:
        raise AssertionError(f"2-bit stream TOAs vs GetTOAs: {len(offs)} "
                             f"compared, max {max(offs):.3f} sigma (limit "
                             "0.1)")
    log(f"stream vs GetTOAs: max |dTOA| = {max(offs):.4f} sigma over "
        f"{len(offs)} 2-bit TOAs (limit 0.1)")
    log(f"stream path (library, warm): {len(res.TOA_list)} TOAs in "
        f"{lib_s:.3f} s = {len(res.TOA_list) / lib_s:.1f} TOAs/s; "
        f"{res.nfit} dispatches, h2d {res.h2d_bytes} bytes in "
        f"{res.h2d_duration:.3f} s (overlapped with fits "
        f"{res.h2d_overlap_duration:.3f} s), {res.fit_duration:.3f} s "
        f"blocked on the device; dispatches by bucket shape "
        f"{res.dispatch_shapes}")
    if device_type(device) == "cuda":
        fft_only(launches, ("fused_decode_cross_spectrum",
                            "fused_cross_spectrum"), "the stream path")
        check_cross_spectrum_case(cross_spectrum_case(
            f"full int16 bucket {nsub_batch}x{nchan}x{nbin} K={K}",
            nsub_batch, nchan, nbin, K, torch.float32, seed=12))
        stream_profile(meta, gmodel, device, nsub_batch)
    return launches


def stream_profile(meta, gmodel, device, nsub_batch):
    """The library stream call once more under torch.profiler: device
    busy time (kernels and copies, summed by name) against the wall."""
    from torch.profiler import ProfilerActivity, profile
    from pulseportraiture_tpu_torch.pipeline.stream import (
        stream_wideband_TOAs)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream_wideband_TOAs(meta, gmodel, nsub_batch=nsub_batch,
                             device=device, quiet=True)
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, rows = profile_rows(prof)
    log(f"stream profile: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
        f"wall (idle share {1.0 - busy_ms / wall_ms:.3f}, profiler on)")
    for us, key, n in rows[:14]:
        log(f"  {us / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")


def scatter_archives(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=NBIN,
                     narch=NARCH_SCAT):
    """The scattering path's campaign: narch int16 and narch 2-bit
    archives of nsub x nchan x nbin with the main path's (phi, dDM) and
    band plus T_SCAT at 1500 MHz with index ALPHA_INJ, each with its own
    epoch and seeded generator; the 2-bit ones quantized with dither.
    Returns (metafile, int16 paths, 2-bit paths, .gmodel path)."""
    import numpy as np
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    os.makedirs(WORK, exist_ok=True)
    model = default_test_model(1500.0)
    gmodel = os.path.join(WORK, "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    kinds = {16: [], 2: []}
    for nbit, base, noise in ((16, 55500, NOISE_SCAT_I16),
                              (2, 55600, NOISE_SCAT_2BIT)):
        for i in range(narch):
            path = os.path.join(WORK, f"scat{nbit}-{i}.fits")
            make_fake_pulsar(model, PAR, outfile=path, nsub=nsub,
                             nchan=nchan, nbin=nbin, nu0=1500.0, bw=800.0,
                             tsub=60.0, phase=PHI_INJ, dDM=DDM_INJ,
                             t_scat=T_SCAT, alpha=ALPHA_INJ,
                             start_MJD=MJD(base + i, 0.1), noise_stds=noise,
                             dedispersed=False, quiet=True,
                             rng=np.random.default_rng(SEED + base + i),
                             nbit=nbit, dither=nbit != 16, device=device)
            kinds[nbit].append(path)
    meta = os.path.join(WORK, "scatter_meta.txt")
    with open(meta, "w") as f:
        f.write("\n".join(kinds[16] + kinds[2]) + "\n")
    return meta, kinds[16], kinds[2], gmodel


def tau_at(flags, nu):
    """(tau [us] at nu [MHz], its sigma) from a TOA's -scat_* flags of a
    log10-tau fit, re-referenced from the fit's zero-covariance frequency
    along the fitted index; the sigma carries the index's error, which
    the flag's own error (at the zero-covariance frequency, where tau
    and alpha are uncorrelated) leaves out."""
    tau, nu0, a = flags["scat_time"], flags["scat_ref_freq"], \
        flags["scat_ind"]
    r = (nu / nu0) ** a
    s_tau0 = tau * math.log(10.0) * flags["log10_scat_time_err"]
    s = math.hypot(s_tau0 * r,
                   tau * r * math.log(nu / nu0) * flags["scat_ind_err"])
    return tau * r, s


def check_scatter_toa(t, nbit):
    """Injection recovery of one scattering TOA (flags as floats):
    |dphi| < 5 phi_err, and < 1e-4 rot for int16 data (the 2-bit
    data's phi_err floor, ~4e-5 rot, puts 1e-4 at ~2 sigma); tau at
    1500 MHz and alpha within 5 sigma.  Returns the pulls."""
    f = t.flags
    dphi = (f["phs"] - expected_phase(t.frequency) + 0.5) % 1.0 - 0.5
    tau, s_tau = tau_at(f, 1500.0)
    pulls = (dphi / f["phs_err"], (tau - T_SCAT * 1e6) / s_tau,
             (f["scat_ind"] - ALPHA_INJ) / f["scat_ind_err"])
    if not (all(math.isfinite(p) and abs(p) < 5.0 for p in pulls)
            and (nbit != 16 or abs(dphi) < 1e-4)):
        raise AssertionError(
            f"scattering TOA {t.archive} subint {f['subint']}: dphi "
            f"{dphi:.3e} rot, pulls (phi, tau@1500, alpha) "
            f"{tuple(round(p, 2) for p in pulls)}")
    return dphi, pulls


def phase_scatter(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=NBIN,
                  narch=NARCH_SCAT, nsub_batch=NSUB_BATCH):
    """The scattering path: ``pptoas --stream --fit_scat --scat_guess
    auto`` over narch int16 and narch 2-bit scattered archives, in this
    process, with the counters set to 0 just before it and read just
    after (on CUDA: B1 launched in its want_m2 form through the FFT arm
    only, B2 never); every TOA checked against the injection; the
    library call again (return codes, Newton trips) and under the
    profiler (busy time, idle share, the evaluator's share); GetTOAs on
    the first int16 archive (the complex engine) against the stream's
    TOAs.  Returns the counters of the CLI run."""
    import numpy as np
    from pulseportraiture_tpu_torch.fit import portrait as FP
    from pulseportraiture_tpu_torch.pipeline import GetTOAs
    from pulseportraiture_tpu_torch.pipeline import stream as S

    t0 = time.perf_counter()
    meta, i16, p2, gmodel = scatter_archives(device, nsub, nchan, nbin,
                                             narch)
    log(f"scattering archives: {narch} int16 + {narch} 2-bit x "
        f"{nsub}x{nchan}x{nbin}, t_scat {T_SCAT * 1e6:.1f} us at 1500 MHz, "
        f"alpha {ALPHA_INJ}, noise {NOISE_SCAT_I16} / {NOISE_SCAT_2BIT} "
        f"(2-bit dithered) written in {time.perf_counter() - t0:.2f} s")
    tim = os.path.join(WORK, "scatter.tim")
    if os.path.exists(tim):
        os.remove(tim)
    cli_s, launches = run_cli(
        ["--stream", "--fit_scat", "--scat_guess", "auto", "-d", meta,
         "-m", gmodel, "-o", tim, "--quiet", "--print_phase",
         "--quality_flags", "--device", device],
        "pptoas --stream --fit_scat")
    ntoa = 2 * narch * nsub
    log(f"scattering path (pptoas --stream --fit_scat): {ntoa} TOAs in "
        f"{cli_s:.3f} s wall incl. load and first use = {ntoa / cli_s:.1f} "
        f"TOAs/s, kernel launches {launches}")
    if device_type(device) == "cuda":
        fft_only(launches, ("fused_cross_spectrum",), "the scattering path")
        if launches["fused_cross_spectrum.m2"] != \
                launches["fused_cross_spectrum"]:
            raise AssertionError(
                f"the scattering path launched B1 {launches} times: not "
                "all in its want_m2 form")
        if launches["fused_decode_cross_spectrum"]:
            raise AssertionError("the scattering path launched B2")
    with open(tim) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    if len(lines) != ntoa:
        raise AssertionError(f"{len(lines)} scattering TOAs for {ntoa}")
    nfev_cli = [int(dict(zip(tok[5::2], tok[6::2]))["-nfev"])
                for tok in lines]

    # the library call, warm: every TOA against the injection, the
    # return codes, the Newton trips
    rcs = []
    orig = S._assemble_archive

    def assemble(m, results, *a, **k):
        rcs.extend(int(results[(m.iarch, int(i))]["return_code"])
                   for i in m.ok if (m.iarch, int(i)) in results)
        return orig(m, results, *a, **k)

    S._assemble_archive = assemble
    try:
        t0 = time.perf_counter()
        res = S.stream_wideband_TOAs(meta, gmodel, nsub_batch=nsub_batch,
                                     fit_scat=True, scat_guess="auto",
                                     print_phase=True, quality_flags=True,
                                     device=device, quiet=True)
        sync(device)
        lib_s = time.perf_counter() - t0
    finally:
        S._assemble_archive = orig
    if len(res.TOA_list) != ntoa or len(rcs) != ntoa:
        raise AssertionError(f"{len(res.TOA_list)} TOAs, {len(rcs)} return "
                             f"codes for {ntoa} subints")
    if not set(rcs) <= {0, 1, 2}:
        raise AssertionError(f"scattering return codes {sorted(set(rcs))}")
    worst = {16: [0.0, 0.0], 2: [0.0, 0.0]}
    for t in res.TOA_list:
        nbit = 16 if t.archive in i16 else 2
        dphi, pulls = check_scatter_toa(t, nbit)
        worst[nbit][0] = max(worst[nbit][0], abs(dphi))
        worst[nbit][1] = max(worst[nbit][1], max(abs(p) for p in pulls))
    nfev = np.asarray([t.flags["nfev"] for t in res.TOA_list])
    log(f"scattering recovery: int16 max |dphi| {worst[16][0]:.3e} rot "
        f"(limit 1e-4), 2-bit {worst[2][0]:.3e} rot; max |pull| over "
        f"(phi, tau@1500, alpha) int16 {worst[16][1]:.2f}, 2-bit "
        f"{worst[2][1]:.2f} (limit 5); return codes {sorted(set(rcs))}")
    log(f"scattering path (library, warm): {ntoa} TOAs in {lib_s:.3f} s = "
        f"{ntoa / lib_s:.1f} TOAs/s; {res.nfit} dispatches "
        f"{res.dispatch_shapes}, h2d {res.h2d_bytes} bytes in "
        f"{res.h2d_duration:.3f} s, {res.fit_duration:.3f} s blocked on the "
        f"device; Newton trips per fit max {int(nfev.max())} median "
        f"{float(np.median(nfev))} (plain loop; the compensated polish is "
        f"{'on' if FP.use_scatter_compensated() else 'off'}), CLI run "
        f"max {max(nfev_cli)}")

    # GetTOAs on the first int16 archive: the complex engine
    gt = GetTOAs(i16[0], gmodel, quiet=True, device=device)
    t0 = time.perf_counter()
    gt.get_TOAs(quiet=True, fit_scat=True, scat_guess="auto",
                print_phase=True)
    sync(device)
    gt_s = time.perf_counter() - t0
    ref = {t.flags["subint"]: t for t in gt.TOA_list}
    worst_s = worst_tau = worst_a = 0.0
    for t in res.TOA_list:
        if t.archive != i16[0]:
            continue
        r = ref[t.flags["subint"]]
        worst_s = max(worst_s, toa_sigma_offset(r, t))
        worst_tau = max(worst_tau, abs(tau_at(t.flags, 1500.0)[0]
                                       / tau_at(r.flags, 1500.0)[0] - 1.0))
        worst_a = max(worst_a, abs(t.flags["scat_ind"]
                                   - r.flags["scat_ind"]))
    rcs_gt = np.asarray(gt.rcs[0])[gt.ok_isubs[0]]
    if not (worst_s <= 0.1 and worst_tau <= 0.02 and worst_a <= 0.05
            and len(ref) == nsub and set(rcs_gt.tolist()) <= {0, 1, 2}):
        raise AssertionError(
            f"stream vs GetTOAs (complex engine): {worst_s:.3f} sigma "
            f"(limit 0.1), scat_time {worst_tau:.4f} (0.02), scat_ind "
            f"{worst_a:.4f} (0.05), {len(ref)} TOAs, return codes "
            f"{sorted(set(rcs_gt.tolist()))}")
    log(f"scattering stream vs GetTOAs (complex engine, "
        f"{'complex64' if device_type(device) == 'cuda' else 'complex128'})"
        f": max |dTOA| {worst_s:.4f} sigma (limit 0.1), scat_time at 1500 "
        f"MHz {worst_tau:.2e} (limit 0.02), scat_ind {worst_a:.2e} (limit "
        f"0.05) over {nsub} TOAs; GetTOAs fit {gt.fit_durations[0]:.4f} s, "
        f"{gt_s:.3f} s wall incl. load, nfeval max "
        f"{int(np.max(gt.nfevals[0]))}")
    if device_type(device) == "cuda":
        scatter_profile(meta, gmodel, device, nsub_batch)
    return launches


def scatter_profile(meta, gmodel, device, nsub_batch):
    """The scattering library call under torch.profiler: device busy time
    against the wall, the top device ops, the peak device memory, and
    the Newton evaluator's device time (CUDA events around each of its
    calls on the fit worker's stream; the profiler's CPU annotations do
    not reach that thread)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pulseportraiture_tpu_torch.fit import portrait as FP
    from pulseportraiture_tpu_torch.pipeline.stream import (
        stream_wideband_TOAs)

    orig = FP._cgh_scatter
    events = []

    def evaluator(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **k)
        end.record()
        events.append((start, end))
        return out

    FP._cgh_scatter = evaluator
    torch.cuda.reset_peak_memory_stats()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            stream_wideband_TOAs(meta, gmodel, nsub_batch=nsub_batch,
                                 fit_scat=True, scat_guess="auto",
                                 device=device, quiet=True)
            sync(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        FP._cgh_scatter = orig
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    evaluator_ms = sum(a.elapsed_time(b) for a, b in events)
    busy_ms, rows = profile_rows(prof)
    log(f"scattering profile: device busy {busy_ms:.3f} ms of {wall_ms:.3f} "
        f"ms wall (idle share {1.0 - busy_ms / wall_ms:.3f}, profiler on); "
        f"Newton evaluator (_cgh_scatter) {evaluator_ms:.3f} ms over "
        f"{len(events)} evaluations ({evaluator_ms / max(len(events), 1):.3f}"
        f" ms each) = {100.0 * evaluator_ms / busy_ms:.1f} % of the device "
        f"time; peak device memory {peak_gb:.2f} GB")
    for us, key, n in rows[:14]:
        log(f"  {us / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")


def phase_m2_timing(K):
    """B1's want_m2 form at the scattering bucket's shape (NSUB_BATCH x
    512 x 2048, one shared template, per-element weights, the derived
    window K, float32): time_cross_spectrum's checks and times (median of
    20 samples).  Returns the record."""
    return time_cross_spectrum(NSUB_BATCH, NCHAN, NBIN, K, want_m2=True,
                               seed=50, n=20)


def read_tim(path):
    """.tim lines -> {(archive, subint[, chan]): TOA record}: frequency,
    MJD day and fraction, error [us], DM (None without -pp_dm) and the
    flags as strings."""
    out = {}
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0] == "C":
                continue
            day, _, frac = tok[2].partition(".")
            flags = dict(zip(tok[5::2], tok[6::2]))
            key = (tok[0], int(flags["-subint"]))
            if "-chan" in flags:
                key += (int(flags["-chan"]),)
            out[key] = dict(
                freq=float(tok[1]), day=int(day), frac=float("0." + frac),
                err=float(tok[3]), flags=flags,
                DM=float(flags["-pp_dm"]) if "-pp_dm" in flags else None)
    return out


def tim_offset_us(a, b):
    """TOA(b) - TOA(a) [us] for two read_tim records of one subint (or
    channel); with DMs, b is referenced to a's frequency along b's own
    DM."""
    from pulseportraiture_tpu_torch.config import Dconst

    dt = ((b["day"] - a["day"]) + (b["frac"] - a["frac"])) * 86400.0
    if b["DM"] is not None:
        dt += Dconst * b["DM"] * (a["freq"] ** -2.0 - b["freq"] ** -2.0)
    return dt * 1e6


def tim_sigma_offset(a, b):
    """|TOA(a) - TOA(b)| over a's TOA error (tim_offset_us)."""
    return abs(tim_offset_us(a, b)) / a["err"]


def run_cli(args, label):
    """``python -m pulseportraiture_tpu_torch.cli.pptoas args`` in this
    process (so the kernels' counters can be read), with the counters
    set to 0 just before it; returns (wall seconds, counters after)."""
    return run_tool("pptoas", args, label)[:2]


def profile_rows(prof):
    """(device busy ms, rows (us, name, count) sorted by device time)
    from a torch.profiler run, over the device-side events only
    (kernels, copies, memsets): a CPU operator's self device time is
    the time of the kernels it launched, which are rows of their own."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        dt_us = getattr(e, "self_device_time_total", None)
        if dt_us is None:
            dt_us = getattr(e, "self_cuda_time_total", 0.0)
        if dt_us > 0:
            rows.append((dt_us, e.key, e.count))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows) / 1e3, rows


def build_spline_template(device, arch, gmodel, path):
    """A spline template of the .gmodel portrait at the archive's channel
    frequencies and bins: the port's pca in float64 on ``device``, the
    leading components (the fewest whose reconstruction holds the
    portrait to SPL_RECON_RMS of its peak), fit_spline_curve on the
    host with the largest sfac of SPL_SFACS whose rebuilt portrait
    holds it to SPL_RMS of its peak; written as .spl.  Returns
    (ncomp, sfac, rms / peak, seconds, channel frequencies)."""
    import numpy as np
    import torch
    from pulseportraiture_tpu_torch.io.psrfits import read_archive
    from pulseportraiture_tpu_torch.io.splmodel import (SplineModel,
                                                        write_spline_model)
    from pulseportraiture_tpu_torch.models import spline as SP
    from pulseportraiture_tpu_torch.pipeline.models import TemplateModel

    a = read_archive(arch, decode=False)
    freqs = np.asarray(a.freqs_table[0], float)
    order = np.argsort(freqs)
    t0 = time.perf_counter()
    port = torch.as_tensor(TemplateModel(gmodel, device=device).portrait(
        freqs, a.nbin), device=device)
    peak = float(torch.max(torch.abs(port)))
    eigval, eigvec = SP.pca(port)
    mean_prof = port.mean(dim=0)
    for ncomp in range(1, 17):
        rec = SP.reconstruct_portrait(port, mean_prof, eigvec[:, :ncomp])
        if float(torch.sqrt(torch.mean((rec - port) ** 2))) \
                < SPL_RECON_RMS * peak:
            break
    eigvec = eigvec[:, :ncomp]
    proj = ((port - mean_prof) @ eigvec).cpu().numpy()
    for sfac in SPL_SFACS:
        tck = SP.fit_spline_curve(proj[order], freqs[order], sfac=sfac)
        rebuilt = SP.gen_spline_portrait(mean_prof, freqs, eigvec, tck,
                                         device=device)
        rms = float(torch.sqrt(torch.mean((rebuilt - port) ** 2))) / peak
        if rms < SPL_RMS:
            break
    else:
        raise AssertionError(f"no sfac of {SPL_SFACS} rebuilds the "
                             f"template to {SPL_RMS} of its peak")
    write_spline_model(SplineModel(
        "default_test_model", PAR["PSR"], gmodel,
        mean_prof.cpu().numpy(), eigvec.cpu().numpy(), tck), path,
        quiet=True)
    sync(device)
    secs = time.perf_counter() - t0
    log(f"spline template: pca of the .gmodel portrait ({len(freqs)}x"
        f"{a.nbin}, float64 on {device_type(device)}), eigenvalues "
        f"{', '.join(f'{v:.3e}' for v in eigval[:5].tolist())}; ncomp "
        f"{ncomp}, sfac {sfac:g} ({len(tck[0])} knots), rebuilt rms "
        f"{rms:.3e} of the peak (limit {SPL_RMS:g}); built and written in "
        f"{secs:.3f} s")
    return ncomp, sfac, rms, secs, freqs


def time_spline_eval(path, freqs, nbin, device):
    """gen_spline_portrait of the template at the archive's layout:
    median of 20 host-clock samples of one synchronized call (on CUDA),
    or of 5 on the CPU."""
    from pulseportraiture_tpu_torch.io.splmodel import read_spline_model
    from pulseportraiture_tpu_torch.models.spline import gen_spline_portrait

    m = read_spline_model(path, quiet=True)
    n = 20 if device_type(device) == "cuda" else 5
    ts = []
    for _ in range(n + 2):
        t0 = time.perf_counter()
        gen_spline_portrait(m.mean_prof, freqs, m.eigvec, m.tck, nbin=nbin,
                            device=device)
        sync(device)
        ts.append(time.perf_counter() - t0)
    ts = sorted(ts[2:])
    return ts[len(ts) // 2] * 1e3


def phase_spline(device="cuda", nsub=NSUB, nbin=NBIN, narch=NARCH):
    """The spline path (phase 10): a .spl template built from the
    .gmodel portrait (build_spline_template), then ``pptoas -m
    model.spl`` on the main path's archive and ``pptoas --stream -m
    model.spl`` on the stream path's metafile, each in this process with
    the counters set to 0 just before it and read just after.  On CUDA
    B1 (both runs) and B2 (the stream) must have been launched through
    their FFT arms only.  Every TOA must recover the injection to 1e-4
    rot and lie within 0.1 sigma of the .gmodel run's TOA for the same
    subint (phases 4 and 6).  Returns the counters of both runs."""
    arch = os.path.join(WORK, "fake.fits")
    gmodel = os.path.join(WORK, "model.gmodel")
    meta = os.path.join(WORK, "stream_meta.txt")
    spl = os.path.join(WORK, "model.spl")
    ncomp, sfac, rms, build_s, freqs = build_spline_template(
        device, arch, gmodel, spl)
    eval_ms = time_spline_eval(spl, freqs, nbin, device)
    log(f"spline template evaluation (gen_spline_portrait "
        f"{len(freqs)}x{nbin}, float64): {eval_ms:.3f} ms median")
    out = {}
    for label, args, ref_tim in (
            ("main", ["-d", arch], os.path.join(WORK, "toas.tim")),
            ("stream", ["--stream", "-d", meta],
             os.path.join(WORK, "stream.tim"))):
        tim = os.path.join(WORK, f"spline_{label}.tim")
        if os.path.exists(tim):
            os.remove(tim)
        wall, launches = run_cli(
            args + ["-m", spl, "-o", tim, "--quiet", "--print_phase",
                    "--device", device], f"pptoas -m model.spl ({label})")
        got, ref = read_tim(tim), read_tim(ref_tim)
        ntoa = nsub * (1 if label == "main" else narch + 1)
        if len(got) != ntoa or set(got) != set(ref):
            raise AssertionError(f"spline {label}: {len(got)} TOAs for "
                                 f"{ntoa} subints")
        worst = max(abs((float(r["flags"]["-phs"])
                         - expected_phase(r["freq"]) + 0.5) % 1.0 - 0.5)
                    for r in got.values())
        offs = max(tim_sigma_offset(ref[k], got[k]) for k in got)
        cmd = "pptoas --stream" if label == "stream" else "pptoas"
        log(f"spline path ({label}, {cmd} -m model.spl): {ntoa} TOAs in {wall:.3f} s wall incl. load "
            f"and first use; max |dphi| {worst:.3e} rot (limit 1e-4); "
            f"max |TOA(.spl) - TOA(.gmodel)| {offs:.4f} sigma (limit 0.1); "
            f"kernel launches {launches}")
        if not (worst < 1e-4 and offs <= 0.1):
            raise AssertionError(f"spline {label}: |dphi| {worst:.3e}, "
                                 f"{offs:.3f} sigma from the .gmodel run")
        if device_type(device) == "cuda":
            fft_only(launches, ("fused_cross_spectrum",) + (
                ("fused_decode_cross_spectrum",) if label == "stream"
                else ()), f"the spline {label} path")
        out[label] = launches
    return out, dict(ncomp=ncomp, sfac=sfac, rms=rms, build_s=build_s,
                     eval_ms=eval_ms)


def pull_stats(tim):
    """(count, mean, standard deviation) of the narrowband pulls
    (phs - injected phase at the channel frequency) / phs_err."""
    import numpy as np

    pulls = np.asarray([
        ((float(r["flags"]["-phs"]) - expected_phase(r["freq"]) + 0.5)
         % 1.0 - 0.5) / float(r["flags"]["-phs_err"])
        for r in read_tim(tim).values()])
    if not np.all(np.isfinite(pulls)):
        raise AssertionError("non-finite narrowband pulls")
    return len(pulls), float(pulls.mean()), float(pulls.std())


def time_ccf(device, nb, nchan, nbin, oversamp=8):
    """The phase-shift fit's dense CCF (irfft to nbin * oversamp lags and
    the first maximum) at the GetTOAs narrowband shape, float32 on the
    card: median CUDA-event time, and the whole fit_phase_shift_batch
    call's time and peak device memory on device-resident inputs."""
    import torch
    from pulseportraiture_tpu_torch.fit.phase_shift import \
        fit_phase_shift_batch

    g = torch.Generator(device=device).manual_seed(SEED)
    data = torch.randn((nb, nchan, nbin), generator=g, device=device)
    model = torch.randn((nchan, nbin), generator=g, device=device)
    noise = torch.ones((nb, nchan), device=device)
    x = torch.fft.rfft(data) * torch.conj(torch.fft.rfft(model))
    nlag = nbin * oversamp

    def ccf():
        return torch.argmax(torch.fft.irfft(x, n=nlag) * nlag, dim=-1)

    ccf_ms = median_ms(ccf, n=10, reps=2)
    fit_ms = median_ms(lambda: fit_phase_shift_batch(data, model, noise,
                                                     device=device),
                       n=5, reps=1)
    del x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fit_phase_shift_batch(data, model, noise, device=device)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"narrowband CCF ({nb}x{nchan} rows, {nlag} lags, float32): "
        f"irfft + argmax {ccf_ms:.3f} ms (CUDA events, median); the whole "
        f"fit_phase_shift_batch {fit_ms:.3f} ms, its peak device memory "
        f"above its inputs {peak_gb:.2f} GB")
    return ccf_ms, fit_ms, peak_gb


def nb_scatter_archive(device, nsub, nchan=NCHAN, nbin=NBIN):
    """Phase 11's scattering archive: phase 8's first int16 archive's
    injection, noise and generator, at nsub subints."""
    import numpy as np
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    path = os.path.join(WORK, f"nb_scat16-{nsub}.fits")
    make_fake_pulsar(default_test_model(1500.0), PAR, outfile=path,
                     nsub=nsub, nchan=nchan, nbin=nbin, nu0=1500.0,
                     bw=800.0, tsub=60.0, phase=PHI_INJ, dDM=DDM_INJ,
                     t_scat=T_SCAT, alpha=ALPHA_INJ,
                     start_MJD=MJD(55500, 0.1), noise_stds=NOISE_SCAT_I16,
                     dedispersed=False, quiet=True,
                     rng=np.random.default_rng(SEED + 55500), nbit=16,
                     device=device)
    return path


def phase_narrowband(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=NBIN,
                     nsub_scat=NSUB_NB_SCAT):
    """The narrowband path (phase 11), every run with the counters set to
    0 just before it (no kernel of the port runs on its fits, as no
    Pallas kernel does in the JAX package; since PR 18 the scat_guess
    'auto' tau seed of 3. runs B1's want_m2 form):
    1. ``pptoas --narrowband`` on the main path's archive (one TOA per
       channel), cold; the library call warm and under the profiler;
       the pulls held to NB_PULL_MEAN / NB_PULL_STD; the dense CCF timed;
    2. ``pptoas --stream --narrowband`` on the main archive and two of
       the stream path's 2-bit archives, every TOA within 0.1 sigma of
       GetTOAs' on the same archive;
    3. ``pptoas --narrowband --fit_scat --scat_guess auto`` through
       GetTOAs and through the stream on an nsub_scat-subint scattered
       archive: within 0.1 sigma in phase and 2 % in tau.
    Returns {run: counters}."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from pulseportraiture_tpu_torch.pipeline import GetTOAs

    arch = os.path.join(WORK, "fake.fits")
    gmodel = os.path.join(WORK, "model.gmodel")
    launches = {}
    # 1. GetTOAs, full width
    tim = os.path.join(WORK, "nb.tim")
    if os.path.exists(tim):
        os.remove(tim)
    wall, launches["gettoas"] = run_cli(
        ["--narrowband", "-d", arch, "-m", gmodel, "-o", tim, "--quiet",
         "--print_phase", "--device", device], "pptoas --narrowband")
    n, mean, std = pull_stats(tim)
    log(f"narrowband path (pptoas --narrowband): {n} TOAs in {wall:.3f} s "
        f"wall incl. load and first use = {n / wall:.1f} TOAs/s; pulls "
        f"(phs - injection) / phs_err: mean {mean:.4f} (limit "
        f"|mean| < {NB_PULL_MEAN}), standard deviation {std:.4f} (limit "
        f"{NB_PULL_STD[0]}-{NB_PULL_STD[1]}); kernel launches "
        f"{launches['gettoas']}")
    if not (n == nsub * nchan and abs(mean) < NB_PULL_MEAN
            and NB_PULL_STD[0] < std < NB_PULL_STD[1]):
        raise AssertionError(f"narrowband pulls: {n} TOAs, mean {mean:.4f},"
                             f" std {std:.4f}")
    gt = GetTOAs(arch, gmodel, quiet=True, device=device)
    t0 = time.perf_counter()
    gt.get_narrowband_TOAs(quiet=True, print_phase=True)
    sync(device)
    warm = time.perf_counter() - t0
    log(f"narrowband path (GetTOAs, warm): {len(gt.TOA_list)} TOAs in "
        f"{warm:.3f} s = {len(gt.TOA_list) / warm:.1f} TOAs/s incl. load")
    if device_type(device) == "cuda":
        time_ccf(device, nsub, nchan, nbin)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            GetTOAs(arch, gmodel, quiet=True,
                    device=device).get_narrowband_TOAs(quiet=True)
            sync(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, rows = profile_rows(prof)
        log(f"narrowband profile (GetTOAs, warm): device busy {busy_ms:.3f} "
            f"ms of {wall_ms:.3f} ms wall (idle share "
            f"{1.0 - busy_ms / wall_ms:.3f}, profiler on)")
        for us, key, cnt in rows[:10]:
            log(f"  {us / 1e3:9.3f} ms  x{cnt:<5d} {key[:90]}")
    # 2. the stream, depth cut to the int16 archive and two 2-bit ones
    two_bit = [os.path.join(WORK, f"fake2bit-{i}.fits") for i in range(2)]
    meta = os.path.join(WORK, "nb_meta.txt")
    with open(meta, "w") as f:
        f.write("\n".join([arch] + two_bit) + "\n")
    stim = os.path.join(WORK, "nb_stream.tim")
    if os.path.exists(stim):
        os.remove(stim)
    wall, launches["stream"] = run_cli(
        ["--stream", "--narrowband", "-d", meta, "-m", gmodel, "-o", stim,
         "--quiet", "--print_phase", "--device", device],
        "pptoas --stream --narrowband")
    got = read_tim(stim)
    # GetTOAs' TOAs of the same archives: the main one's from run 1
    meta2 = os.path.join(WORK, "nb_meta_2bit.txt")
    with open(meta2, "w") as f:
        f.write("\n".join(two_bit) + "\n")
    ref_tim = os.path.join(WORK, "nb_2bit.tim")
    if os.path.exists(ref_tim):
        os.remove(ref_tim)
    run_cli(["--narrowband", "-d", meta2, "-m", gmodel, "-o", ref_tim,
             "--quiet", "--print_phase", "--device", device],
            "pptoas --narrowband (2-bit archives)")
    ref = {**read_tim(tim), **read_tim(ref_tim)}
    if set(got) != set(ref) or not got:
        raise AssertionError(f"narrowband stream: {len(got)} TOAs, GetTOAs "
                             f"{len(ref)}")
    offs = max(tim_sigma_offset(ref[k], got[k]) for k in got)
    from pulseportraiture_tpu_torch.pipeline.stream import \
        stream_narrowband_TOAs

    t0 = time.perf_counter()
    res = stream_narrowband_TOAs(meta, gmodel, device=device, quiet=True)
    sync(device)
    warm = time.perf_counter() - t0
    log(f"narrowband stream (pptoas --stream --narrowband, 3 archives): "
        f"{len(got)} TOAs in {wall:.3f} s wall cold = {len(got) / wall:.1f} "
        f"TOAs/s; warm library call {warm:.3f} s = "
        f"{len(res.TOA_list) / warm:.1f} TOAs/s, {res.nfit} dispatches "
        f"{res.dispatch_shapes}, h2d {res.h2d_bytes} bytes; max |TOA(stream)"
        f" - TOA(GetTOAs)| {offs:.4f} sigma (limit 0.1); kernel launches "
        f"{launches['stream']}")
    if not offs <= 0.1:
        raise AssertionError(f"narrowband stream vs GetTOAs: {offs:.3f} "
                             "sigma")
    # 3. scattering, depth cut to nsub_scat subints
    sarch = nb_scatter_archive(device, nsub_scat, nchan=nchan, nbin=nbin)
    tims = {}
    for label, extra in (("gettoas", []), ("stream", ["--stream"])):
        tims[label] = os.path.join(WORK, f"nb_scat_{label}.tim")
        if os.path.exists(tims[label]):
            os.remove(tims[label])
        wall, launches[f"scat_{label}"] = run_cli(
            extra + ["--narrowband", "--fit_scat", "--scat_guess", "auto",
                     "-d", sarch, "-m", gmodel, "-o", tims[label], "--quiet",
                     "--print_phase", "--device", device],
            f"pptoas {' '.join(extra)} --narrowband --fit_scat")
        log(f"narrowband scattering ({label}): {nsub_scat} subints, "
            f"{len(read_tim(tims[label]))} single-channel fits in "
            f"{wall:.3f} s wall incl. load = "
            f"{len(read_tim(tims[label])) / wall:.1f} TOAs/s")
    ref, got = read_tim(tims["gettoas"]), read_tim(tims["stream"])
    if set(got) != set(ref) or not got:
        raise AssertionError("narrowband scattering: TOA sets differ")
    offs = max(tim_sigma_offset(ref[k], got[k]) for k in got)
    # tau within 2 % where a channel measures it (its log10 error below
    # NB_TAU_MEASURED dex); at the top of the band a single channel does
    # not constrain tau, and there the two float32 fits stop at
    # different points of a flat objective (printed, not held)
    rows = np.asarray([[float(got[k]["flags"]["-scat_time"]),
                        float(ref[k]["flags"]["-scat_time"]),
                        float(ref[k]["flags"]["-log10_scat_time_err"])]
                       for k in got])
    dtau = np.abs(rows[:, 0] / rows[:, 1] - 1.0)
    dsig = np.abs(np.log10(rows[:, 0] / rows[:, 1])) / rows[:, 2]
    measured = rows[:, 2] < NB_TAU_MEASURED
    worst_tau = float(np.max(dtau[measured], initial=0.0))
    worst_sig = float(np.max(dsig))
    log(f"narrowband scattering stream vs GetTOAs: max |dTOA| {offs:.4f} "
        f"sigma (limit 0.1); tau measured (log10 error < "
        f"{NB_TAU_MEASURED} dex) in {int(measured.sum())} of {len(got)} "
        f"channels, max |d tau / tau| there {worst_tau:.2e} (limit 0.02), "
        f"{int((dtau > 0.02).sum())} channels beyond 2 % overall; max "
        f"|d log10 tau| {worst_sig:.4f} of its error")
    if not (offs <= 0.1 and worst_tau <= 0.02 and measured.any()):
        raise AssertionError(f"narrowband scattering: {offs:.3f} sigma, "
                             f"tau {worst_tau:.3e} where measured")
    return launches


def zap_archives(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=NBIN):
    """The zap path's campaign: one int16 and NARCH_ZAP_2BIT dithered
    2-bit archives with the main path's injection (each its own epoch
    and noise draw), RFI injected by synth.inject_rfi: white tones on
    ZAP_TONES (ZAP_WHITE x the median channel noise), ZAP_STRUCTURED of
    them also structured (ZAP_STRUCT x), and one burst (ZAP_BURST).  The
    injector writes 16 bits, so the 2-bit archives are re-quantized
    after it with io.psrfits.write_archive_file(nbit=2, dither=rng).
    Returns (metafile, [int16, 2-bit...], .gmodel, {path: zap_truth})."""
    import numpy as np
    from pulseportraiture_tpu_torch.io.psrfits import (read_archive,
                                                       write_archive_file)
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  inject_rfi,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    model = default_test_model(1500.0)
    files, truths = [], {}
    white_only = [c for c in ZAP_TONES if c not in ZAP_STRUCTURED]
    for i in range(1 + NARCH_ZAP_2BIT):
        nbit = 16 if i == 0 else 2
        path = os.path.join(WORK, f"zap-{nbit}bit-{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=nsub, nchan=nchan,
                         nbin=nbin, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=PHI_INJ, dDM=DDM_INJ,
                         start_MJD=MJD(55300 + i, 0.1), noise_stds=1.0,
                         dedispersed=False, quiet=True,
                         rng=np.random.default_rng(SEED + 50 + i),
                         device=device)
        a = inject_rfi(path, tone_channels=white_only, tone_white=ZAP_WHITE,
                       rng=SEED + 60 + i)
        b = inject_rfi(path, tone_channels=ZAP_STRUCTURED,
                       tone_white=ZAP_WHITE, tone_structured=ZAP_STRUCT,
                       bursts=[ZAP_BURST], rng=SEED + 70 + i)
        if nbit == 2:
            write_archive_file(path, read_archive(path), nbit=2,
                               dither=np.random.default_rng(SEED + 80 + i))
        truths[path] = [sorted(set(x) | set(y))
                        for x, y in zip(a.zap_truth, b.zap_truth)]
        files.append(path)
    meta = os.path.join(WORK, "zap_meta.txt")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    return meta, files, os.path.join(WORK, "model.gmodel"), truths


def run_ppzap(args, label):
    """``python -m pulseportraiture_tpu_torch.cli.ppzap args --modify -o
    file`` in this process; returns (wall seconds, {archive: [subint]
    [channels]} parsed from the paz commands, the command file's text)."""
    out = os.path.join(WORK, "paz.sh")
    argv = sys.argv
    sys.argv = ["ppzap"] + list(args) + ["--modify", "-o", out, "--quiet"]
    t0 = time.perf_counter()
    try:
        runpy.run_module("pulseportraiture_tpu_torch.cli.ppzap",
                         run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise RuntimeError(f"{label} exited with {e.code!r}")
    finally:
        sys.argv = argv
    wall = time.perf_counter() - t0
    lists = {}
    with open(out) as f:
        text = f.read()
    for line in text.splitlines():
        tok = line.split()  # paz -m -I -z <chan> -w <subint> <archive>
        lists.setdefault(tok[-1], {}).setdefault(int(tok[6]), []).append(
            int(tok[4]))
    return wall, lists, text


def postfit_margins(rchi2, snr, snr_tot, okc, SNR_threshold=8.0,
                    rchi2_threshold=1.3):
    """Per channel, the relative distance of its reduced chi^2 to the
    post-fit cut's final chi^2 threshold and of its S/N to the S/N
    floor, whichever is smaller (quality.postfit.postfit_cut_np's rounds,
    keeping the thresholds)."""
    import numpy as np

    nsub, nchan = rchi2.shape
    nchx = np.maximum(okc.sum(axis=1), 1.0)
    floor = np.where(np.isfinite(snr_tot),
                     np.sqrt(np.maximum(snr_tot, 0.0) ** 2 / nchx),
                     SNR_threshold)
    floor = np.minimum(SNR_threshold, floor)
    out = np.full((nsub, nchan), np.inf)
    for i in range(nsub):
        oi = np.flatnonzero(okc[i])
        if not oi.size:
            continue
        bad = np.zeros(nchan, bool)
        cut = rchi2_threshold
        for _ in range(8):
            new_bad = okc[i] & ((rchi2[i] > cut) | (snr[i] < floor[i]))
            if np.array_equal(new_bad, bad):
                break
            bad = new_bad
            good = oi[~bad[oi]]
            if not good.size:
                break
            cut = max(rchi2_threshold, float(np.median(rchi2[i, good])) * 3)
        with np.errstate(divide="ignore", invalid="ignore"):
            out[i] = np.minimum(np.abs(rchi2[i] / cut - 1.0),
                                np.abs(snr[i] / floor[i] - 1.0))
    return out


def cut_profile(cut, args):
    """One bucket's inline cut again, warm, under torch.profiler: the
    device time of its kernels against its CUDA-event span and its host
    wall (the cut launches ~20 small kernels a pass)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cut(*args)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        a.record()
        cut(*args)
        b.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, rows = profile_rows(prof)
    log(f"zap path inline cut alone (warm, {tuple(args[0].shape)} noise "
        f"rows): kernels {busy_ms:.3f} ms of a {a.elapsed_time(b):.3f} ms "
        f"event span, {wall_ms:.3f} ms host wall, {sum(r[2] for r in rows)}"
        f" device ops (profiler on); top: "
        + "; ".join(f"{us / 1e3:.3f} ms x{n} {key[:40]}"
                    for us, key, n in rows[:4]))


def phase_zap(device="cuda", nsub=NSUB_ZAP, nchan=NCHAN, nbin=NBIN,
              nsub_batch=NSUB_BATCH):
    """The zap path (phase 12) on an int16 and two 2-bit archives with
    RFI (zap_archives):
    1. ``ppzap`` model-less with --zap-device on and off: the same
       lists; every injected white channel flagged, and per subint at
       most one channel more than the same cut flags on that subint's
       clean channels alone;
    2. ``stream_wideband_TOAs(zap_inline=True)``, the counters set to 0
       just before it and read just after (on CUDA: B2 on the 2-bit
       bucket and B1 on the int16 bucket, FFT arms only), the inline
       cut's device time (CUDA events on the fit worker's stream) and
       host syncs per bucket; its per-archive cut counts equal to the
       model-less lists', every TOA within 1e-4 rot of the injection
       with return codes in {0, 1, 2}, and within 0.1 sigma of the run
       with ``zap_channels=`` those lists; B2 held to its plain version
       on the zapped 2-bit bucket; warm TOAs/s with and without the cut;
    3. ``stream_narrowband_TOAs(zap_inline=True)`` on the int16 archive:
       no TOA for a flagged channel;
    4. ``ppzap -m`` (GetTOAs + get_channels_to_zap) with the device lane
       on and off: the same lists; ``stream_wideband_TOAs(postfit_cut=
       True).postfit_zaps`` equal to them except channels whose reduced
       chi^2 or S/N lies within 1e-4 (relative) of the cut.
    Returns the counters of run 2."""
    import numpy as np
    import torch
    from pulseportraiture_tpu_torch.io.psrfits import load_data
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.pipeline import stream as S
    from pulseportraiture_tpu_torch.quality import excision as E
    from pulseportraiture_tpu_torch.quality import postfit as Q

    cuda = device_type(device) == "cuda"
    t0 = time.perf_counter()
    meta, files, gmodel, truths = zap_archives(device, nsub, nchan, nbin)
    log(f"zap archives: 1 int16 + {NARCH_ZAP_2BIT} 2-bit (dithered) x "
        f"{nsub}x{nchan}x{nbin}, white tones x{ZAP_WHITE} on {ZAP_TONES} "
        f"(structured x{ZAP_STRUCT} on {ZAP_STRUCTURED}), burst {ZAP_BURST}"
        f", written in {time.perf_counter() - t0:.2f} s")

    # 1. model-less ppzap, the torch lane on and off
    wall_on, zl_on, text_on = run_ppzap(
        ["-d", meta, "--device", device, "--zap-device", "on"], "ppzap")
    wall_off, zl_off, text_off = run_ppzap(
        ["-d", meta, "--device", device, "--zap-device", "off"], "ppzap")
    if text_on != text_off:
        raise AssertionError("ppzap --zap-device on and off flagged "
                             "different channels")
    lists = {f: [sorted(zl_on.get(f, {}).get(s, [])) for s in range(nsub)]
             for f in files}
    extras, worst_excess = [], 0
    for f in files:
        d = load_data(f, dedisperse=False, dededisperse=True, pscrunch=True,
                      quiet=True)
        noise = d.noise_stds[:, 0]
        for s in range(nsub):
            truth, got = set(truths[f][s]), set(lists[f][s])
            if not truth <= got:
                raise AssertionError(f"ppzap missed injected channels "
                                     f"{sorted(truth - got)} of {f} subint "
                                     f"{s}")
            clean = d.weights[s] > 0
            clean[sorted(truth)] = False
            k, _ = E.zap_keep_np(noise[s][None], clean[None], 3.0)
            null = int(clean.sum() - k.sum())
            extras.append(len(got - truth))
            worst_excess = max(worst_excess, len(got - truth) - null)
    if worst_excess > 1:
        raise AssertionError(f"ppzap flagged {worst_excess} channels more "
                             "than the cut flags on a subint's clean "
                             "channels (limit 1)")
    log(f"zap path (ppzap, model-less): {sum(map(len, truths[files[0]]))} "
        f"injected (subint, channel) cells per archive all flagged; "
        f"--zap-device on {wall_on:.3f} s, off {wall_off:.3f} s wall incl. "
        f"load, same lists; extra channels per subint "
        f"{np.bincount(extras).tolist()} (count of subints with 0, 1, ...)"
        f"; at most {worst_excess} more than the cut flags on the clean "
        f"channels alone (limit 1)")

    # 2. the inline cut through the stream, instrumented
    nzap, rcs = {}, []
    orig_assemble = S._assemble_archive

    def assemble(m, results, *a, **k):
        rows = [results[(m.iarch, int(i))] for i in m.ok
                if (m.iarch, int(i)) in results]
        if rows and "nzap" in rows[0]:
            nzap[m.datafile] = sum(int(r["nzap"]) for r in rows)
        rcs.extend(int(r["return_code"]) for r in rows)
        return orig_assemble(m, results, *a, **k)

    orig_cut, orig_b2 = E.zap_keep_mask, F.fused_decode_cross_spectrum
    events, b2_args, cut_args = [], [], []

    def cut(*a, **k):
        if not cut_args:
            cut_args.append((a[0].clone(), a[1].clone()) + tuple(a[2:]))
        if not cuda:
            return orig_cut(*a, **k)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig_cut(*a, **k)
        end.record()
        events.append((start, end))
        return out

    def b2(raw, scl, offs, model, w, nharm, **k):
        if not b2_args:
            b2_args.append(dict(raw=raw.clone(), scl=scl.clone(),
                                offs=offs.clone(), model=model.clone(),
                                w=w.clone(), K=nharm, **k))
        return orig_b2(raw, scl, offs, model, w, nharm, **k)

    S._assemble_archive, E.zap_keep_mask = assemble, cut
    F.fused_decode_cross_spectrum = b2
    E.reset_zap_stats()
    F.reset_kernel_launches()
    try:
        t0 = time.perf_counter()
        inline = S.stream_wideband_TOAs(meta, gmodel, nsub_batch=nsub_batch,
                                        zap_inline=True, print_phase=True,
                                        device=device, quiet=True)
        sync(device)
        inline_s = time.perf_counter() - t0
        launches = F.kernel_launches()
    finally:
        S._assemble_archive, E.zap_keep_mask = orig_assemble, orig_cut
        F.fused_decode_cross_spectrum = orig_b2
    stats = E.zap_stats()
    ntoa = len(files) * nsub
    log(f"zap path (stream_wideband_TOAs zap_inline, first use): {ntoa} "
        f"TOAs in {inline_s:.3f} s wall; kernel launches {launches}")
    counts = {f: sum(map(len, lists[f])) for f in files}
    if nzap != counts:
        raise AssertionError(f"inline cut counts {nzap} != ppzap's {counts}")
    if len(inline.TOA_list) != ntoa or not set(rcs) <= {0, 1, 2}:
        raise AssertionError(f"{len(inline.TOA_list)} inline TOAs for "
                             f"{ntoa}; return codes {sorted(set(rcs))}")
    worst = max(abs((t.flags["phs"] - expected_phase(t.frequency) + 0.5)
                    % 1.0 - 0.5) for t in inline.TOA_list)
    if not worst < 1e-4:
        raise AssertionError(f"zap path phase recovery |dphi| = "
                             f"{worst:.3e} rot >= 1e-4")
    if cuda:
        fft_only(launches, ("fused_decode_cross_spectrum",
                            "fused_cross_spectrum"), "the zap path")
        dev_ms = [a.elapsed_time(b) for a, b in events]
        log(f"zap path inline cut: {stats['calls']} buckets, device "
            f"{', '.join(f'{x:.3f}' for x in dev_ms)} ms per bucket (CUDA "
            f"events on the fit worker's stream: the span from the cut's "
            f"first kernel to its last), {stats['passes']} passes, "
            f"{stats['syncs']} host syncs "
            f"({stats['syncs'] / stats['calls']:.1f} per bucket, an exit "
            f"test every {E.ZAP_CHECK_EVERY} passes)")
        cut_profile(orig_cut, cut_args[0])
    log(f"zap path inline: per-archive cut counts {list(nzap.values())} "
        f"equal ppzap's; max |dphi| {worst:.3e} rot over {ntoa} TOAs "
        f"(limit 1e-4); return codes {sorted(set(rcs))}")

    t0 = time.perf_counter()
    offline = S.stream_wideband_TOAs(meta, gmodel, nsub_batch=nsub_batch,
                                     zap_channels=lists, device=device,
                                     quiet=True)
    sync(device)
    offline_s = time.perf_counter() - t0
    ref = {(t.archive, t.flags["subint"]): t for t in offline.TOA_list}
    offs = [toa_sigma_offset(ref[(t.archive, t.flags["subint"])], t)
            for t in inline.TOA_list]
    if len(offs) != ntoa or not max(offs) <= 0.1:
        raise AssertionError(f"inline vs zap_channels: {len(offs)} TOAs, "
                             f"max {max(offs):.3f} sigma (limit 0.1)")
    timed = {"without the cut": [], "zap_inline": []}
    for label in ("without the cut", "zap_inline", "zap_inline",
                  "without the cut"):
        t0 = time.perf_counter()
        S.stream_wideband_TOAs(meta, gmodel, nsub_batch=nsub_batch,
                               device=device, quiet=True,
                               zap_inline=label == "zap_inline")
        sync(device)
        timed[label].append(time.perf_counter() - t0)
    log(f"zap path inline vs zap_channels= (offline lists, {offline_s:.3f} "
        f"s): max |dTOA| {max(offs):.4f} sigma over {ntoa} TOAs (limit 0.1)"
        f"; warm stream (host clock, runs in the order without, with, "
        f"with, without) "
        + ", ".join(f"{k} " + " / ".join(f"{ntoa / v:.1f}" for v in ts)
                    + " TOAs/s" for k, ts in timed.items()))
    if cuda:
        check_decode_case(dict(b2_args[0], name="zapped 2-bit bucket "
                               f"{tuple(b2_args[0]['raw'].shape)}",
                               arm=None))
        w = b2_args[0]["w"]
        dead = int(((w == 0).all(dim=-1)).sum())
        log(f"zap path B2 bucket: {dead} zero-weight (subint, channel) "
            f"rows reach B2 (zapped or weight-0), its bytes unchanged")

    # 3. the narrowband stream's inline cut on the int16 archive
    t0 = time.perf_counter()
    nb = S.stream_narrowband_TOAs(files[0], gmodel, device=device,
                                  quiet=True, zap_inline=True)
    sync(device)
    got = {(t.flags["subint"], t.flags["chan"]) for t in nb.TOA_list}
    d = load_data(files[0], pscrunch=True, quiet=True)
    want = {(s, c) for s in range(nsub) for c in d.ok_ichans[s]
            if c not in lists[files[0]][s]}
    if got != want:
        raise AssertionError(f"narrowband inline: {len(got)} TOAs, "
                             f"{len(got - want)} unexpected, "
                             f"{len(want - got)} missing")
    log(f"zap path narrowband (zap_inline): {len(got)} TOAs in "
        f"{time.perf_counter() - t0:.3f} s, none for the "
        f"{counts[files[0]]} flagged channels")

    # 4. the model-based cut: ppzap -m, the device lane on and off
    captured = []
    orig_np = Q.postfit_cut_np

    def capture(*a, **k):
        captured.append(tuple(np.array(x) for x in a[:4]))
        return orig_np(*a, **k)

    Q.postfit_cut_np = capture
    try:
        wall_off, pl_off, text_off = run_ppzap(
            ["-d", meta, "-m", gmodel, "--device", device, "--zap-device",
             "off"], "ppzap -m")
    finally:
        Q.postfit_cut_np = orig_np
    wall_on, pl_on, text_on = run_ppzap(
        ["-d", meta, "-m", gmodel, "--device", device, "--zap-device", "on"],
        "ppzap -m")
    if text_on != text_off:
        raise AssertionError("ppzap -m --zap-device on and off flagged "
                             "different channels")
    t0 = time.perf_counter()
    pf = S.stream_wideband_TOAs(meta, gmodel, nsub_batch=nsub_batch,
                                postfit_cut=True, device=device, quiet=True)
    sync(device)
    pf_s = time.perf_counter() - t0
    n_flag = n_diff = n_border = 0
    for f, (rchi2, snr, snr_tot, okc) in zip(files, captured):
        margin = postfit_margins(rchi2, snr, snr_tot, okc)
        for s in range(nsub):
            a = set(pl_on.get(f, {}).get(s, []))
            b = set(pf.postfit_zaps[f].get(s, []))
            n_flag += len(a)
            for c in a ^ b:
                n_diff += 1
                if not margin[s, c] < 1e-4:
                    raise AssertionError(
                        f"postfit_cut vs ppzap -m: {f} subint {s} channel "
                        f"{c} differs {margin[s, c]:.2e} from the cut "
                        "(limit 1e-4)")
                n_border += 1
    log(f"zap path model-based (ppzap -m): {n_flag} (subint, channel) "
        f"cells flagged, --zap-device on {wall_on:.3f} s, off "
        f"{wall_off:.3f} s wall, same lists; stream postfit_cut "
        f"({pf_s:.3f} s) differs in {n_diff} cells, {n_border} of them "
        f"within 1e-4 of the cut (allowed)")
    return launches


def align_epochs(device="cuda", nsub=NSUB_ALIGN, nchan=NCHAN, nbin=NBIN):
    """The align path's epochs: NARCH_ALIGN int16 archives of the .gmodel
    at the main archive's widths, each with its own injected phase
    (ALIGN_PHASES) and dDM (ALIGN_DDMS), epoch and noise draw (noise
    NOISE_ALIGN).  Returns (metafile, files)."""
    import numpy as np
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    model = default_test_model(1500.0)
    files = []
    for i in range(NARCH_ALIGN):
        path = os.path.join(WORK, f"epoch-{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=nsub, nchan=nchan,
                         nbin=nbin, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=ALIGN_PHASES[i], dDM=ALIGN_DDMS[i],
                         start_MJD=MJD(55400 + i, 0.1),
                         noise_stds=NOISE_ALIGN,
                         dedispersed=False, quiet=True,
                         rng=np.random.default_rng(SEED + 90 + i),
                         device=device)
        files.append(path)
    meta = os.path.join(WORK, "align_meta.txt")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    return meta, files


def run_ppalign(args, label):
    """``python -m pulseportraiture_tpu_torch.cli.ppalign args`` in this
    process, with the counters set to 0 just before it; returns (wall
    seconds, counters after, pipeline.align.align_stats())."""
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.pipeline.align import align_stats

    F.reset_kernel_launches()
    argv = sys.argv
    sys.argv = ["ppalign"] + list(args)
    t0 = time.perf_counter()
    try:
        runpy.run_module("pulseportraiture_tpu_torch.cli.ppalign",
                         run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise RuntimeError(f"{label} exited with {e.code!r}")
    finally:
        sys.argv = argv
    sync(args[args.index("--device") + 1])
    return time.perf_counter() - t0, F.kernel_launches(), align_stats()


def align_walls(stats):
    return ", ".join(f"{k} {v:.3f}" for k, v in stats["walls"].items())


def check_aligned_archive(path, nchan, nbin):
    """ppalign's output read back: DM 0, dmc 1, unit weights, one subint
    of one polarization at the epochs' widths; returns the portrait."""
    import numpy as np
    from pulseportraiture_tpu_torch.io.psrfits import load_data

    d = load_data(path, quiet=True)
    if not (d.DM == 0.0 and d.dmc and np.all(d.weights == 1.0)
            and d.subints.shape == (1, 1, nchan, nbin)
            and np.all(np.isfinite(d.subints))):
        raise AssertionError(
            f"{path}: DM {d.DM}, dmc {d.dmc}, weights "
            f"{np.unique(d.weights).tolist()}, shape {d.subints.shape}")
    return d.subints[0, 0], np.asarray(d.freqs[0])


def clean_correlation(avg, freqs, device, scale=None, model=None):
    """tests/test_pipeline_align.py's recovery statistic: the per-channel
    correlation of the average with the clean .gmodel portrait (of
    ``model``, default_test_model unless given), maximised over one
    common lag, and the residual rms at that lag; scale, when given, is
    applied to the clean portrait first."""
    import numpy as np
    from pulseportraiture_tpu_torch.io.gmodel import gen_gmodel_portrait
    from pulseportraiture_tpu_torch.synth import default_test_model

    nbin = avg.shape[-1]
    clean = gen_gmodel_portrait(model or default_test_model(1500.0),
                                np.arange(nbin), freqs, P=PAR["P0"],
                                device=device)
    if scale is not None:
        clean = scale(clean)
    a = avg - avg.mean(axis=1, keepdims=True)
    c = clean - clean.mean(axis=1, keepdims=True)
    ccf = np.fft.irfft(np.fft.rfft(a, axis=1).conj()
                       * np.fft.rfft(c, axis=1), n=nbin, axis=1).sum(axis=0)
    corr = ccf.max() / np.sqrt((a ** 2).sum() * (c ** 2).sum())
    resid = np.sqrt(((a - np.roll(c, np.argmax(ccf), axis=1)) ** 2).mean())
    return float(corr), float(resid)


def align_iterations(stats, label, cuda, from_first):
    """Log K and B1's launches per iteration of a ppalign run; on CUDA
    B1 must have run through its FFT arm only, and with from_first in
    every iteration.  Returns B1's launches over the run."""
    total = 0
    for i, it in enumerate(stats["iterations"]):
        n = it["launches"]
        log(f"align path ({label}) iteration {i + 1}: K = {it['K']}, "
            f"{it['archives']} archives, B1 launches "
            f"{n['fused_cross_spectrum.fft']} FFT arm, "
            f"{n['fused_cross_spectrum.gemm']} GEMM arm")
        if cuda and from_first:
            fft_only(n, ("fused_cross_spectrum",),
                     f"{label} iteration {i + 1}")
        elif cuda and n["fused_cross_spectrum.gemm"]:
            raise AssertionError(f"{label}: iteration {i + 1} launched B1 "
                                 "through its GEMM arm")
        total += n["fused_cross_spectrum"]
    return total


def time_accumulate(nsub, nchan, nbin):
    """One align_accumulate_archive call at the align path's archive
    shape ((nsub, 1, nchan, nbin) float32 on the card: one chunk),
    CUDA events (median_ms), against its bound: the cube and the fit
    leaves read once and the three accumulators written once at
    PEAK_HBM_BYTES, or the rfft's 2.5 n log2 n and the rotation's and
    weighted sum's operations at PEAK_FP32_FLOPS, whichever is larger."""
    import torch
    from pulseportraiture_tpu_torch.parallel.batch import (
        align_accumulate_archive, align_accumulator_init)

    f32 = torch.float32
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g,
                                           device="cuda", dtype=f32)

    cube = torch.randn((nsub, 1, nchan, nbin), generator=g, device="cuda",
                       dtype=f32)
    leaves = (rand(nsub, lo=-0.5, hi=0.5), rand(nsub, lo=3.0, hi=3.3),
              rand(nsub, lo=1300.0, hi=1600.0), rand(nsub, lo=0.004,
                                                     hi=0.0041),
              torch.linspace(1100.0, 1900.0, nchan, device="cuda"),
              rand(nsub, nchan, lo=0.5, hi=2.0),
              (rand(nsub, nchan) > 0.05).to(f32), rand(nsub, nchan, hi=2.0))
    acc = align_accumulator_init(1, nchan, nbin, f32, "cuda")
    ms = median_ms(lambda: align_accumulate_archive(acc, cube, *leaves))
    nharm = nbin // 2 + 1
    nbytes = 4 * (cube.numel() + sum(x.numel() for x in leaves)
                  + sum(a.numel() for a in acc))
    flops = nsub * nchan * (2.5 * nbin * math.log2(nbin) + 12.0 * nharm)
    by_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    bound, by = ((by_bytes, "bytes") if by_bytes >= by_ops
                 else (by_ops, "operations"))
    return ms, bound, by


def phase_align(device="cuda", nsub=NSUB_ALIGN, nchan=NCHAN, nbin=NBIN):
    """The align path (phase 13) on NARCH_ALIGN epochs (align_epochs):
    1. ``ppalign -g ALIGN_FWHM --niter ALIGN_NITER`` (the Gaussian seed
       resolves a harmonic window, so B1 runs from iteration 1) and
    2. ``ppalign --niter ALIGN_NITER -s -N rms`` (the first archive as
       the seed), each in this process with the counters set to 0 just
       before it: K and B1's launches per iteration (FFT arm only on
       CUDA, every iteration of run 1), the wall by stage, no archive
       skipped, each output with DM 0, dmc 1, unit weights and shape
       (1, nchan, nbin); run 1's average correlates with the clean
       .gmodel portrait > 0.95 over one common lag;
    3. align_archives(niter=1) with the card's accumulate (float32 on
       CUDA; under the profiler: busy time and idle share of the
       iteration) and with the host lane (float64 on the CPU): corr >
       0.99999 and max |d| < 0.02 max |avg|; B1 against its plain
       version at the align fit's shape; the accumulate's time against
       its bound;
    4. ``pptoas -m`` run 1's output on the main path's archive and 5.
       ``pptoas --stream`` the same: every TOA minus the .gmodel run's
       TOA (phase 4) is one offset plus a scatter below
       ALIGN_TOA_SCATTER sigma, the stream within 0.1 sigma of pptoas,
       return codes in {0, 1, 2} (GetTOAs).
    Returns B1's launches in runs 1 and 2."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pulseportraiture_tpu_torch.pipeline import GetTOAs
    from pulseportraiture_tpu_torch.pipeline.align import (
        align_archives, align_stats, gaussian_seed_portrait)

    cuda = device_type(device) == "cuda"
    t0 = time.perf_counter()
    meta, files = align_epochs(device, nsub, nchan, nbin)
    log(f"align epochs: {NARCH_ALIGN} int16 x {nsub}x{nchan}x{nbin}, "
        f"phases {ALIGN_PHASES} rot, dDM {ALIGN_DDMS}, written in "
        f"{time.perf_counter() - t0:.2f} s")

    # 1-2. the CLI
    b1 = 0
    outs = {}
    for label, extra, from_first in (
            ("ppalign -g", ["-g", str(ALIGN_FWHM)], True),
            ("ppalign -s -N rms", ["-s", "-N", "rms"], False)):
        out = os.path.join(WORK, f"aligned-{len(outs)}.fits")
        wall, launches, stats = run_ppalign(
            ["-M", meta, "-o", out, "--niter", str(ALIGN_NITER),
             "--device", device] + extra, label)
        if stats["skipped"]:
            raise AssertionError(f"{label} skipped {stats['skipped']}")
        n = align_iterations(stats, label, cuda, from_first)
        if n != launches["fused_cross_spectrum"]:
            raise AssertionError(f"{label}: {n} B1 launches by iteration, "
                                 f"{launches['fused_cross_spectrum']} in "
                                 "all")
        if launches["fused_decode_cross_spectrum"]:
            raise AssertionError(f"{label} launched B2")
        b1 += n
        avg, freqs = check_aligned_archive(out, nchan, nbin)
        outs[label] = out
        log(f"align path ({label} --niter {ALIGN_NITER}): {wall:.3f} s "
            f"wall; by stage [s]: {align_walls(stats)}; no archive "
            f"skipped; output DM 0, dmc 1, unit weights, (1, {nchan}, "
            f"{nbin})")
        if "-s" in extra:
            check_aligned_archive(out[:-len(".fits")] + ".sm.fits", nchan,
                                  nbin)
        else:
            K1 = stats["iterations"][0]["K"]
            corr, resid = clean_correlation(avg, freqs, device)
            expect = NOISE_ALIGN / math.sqrt(NARCH_ALIGN * nsub)
            log(f"align path ({label}): correlation with the clean "
                f".gmodel portrait {corr:.6f} (limit 0.95), residual rms "
                f"{resid:.4f} at the best lag (white noise of "
                f"{NARCH_ALIGN * nsub} subints averaged: {expect:.4f})")
            if not corr > 0.95:
                raise AssertionError(f"{label}: correlation {corr:.4f}")

    # 3. the library call, the card's accumulate (under the profiler on
    # CUDA: one iteration's busy time and idle share) against the host's
    seed = gaussian_seed_portrait(nchan, nbin, ALIGN_FWHM, device=device)
    lanes = {}
    for lane in (True, False):
        kw = dict(niter=1, quiet=True, align_device=lane, device=device,
                  outfile=os.path.join(WORK, f"lane-{int(lane)}.fits"))
        prof = None
        t0 = time.perf_counter()
        if lane and cuda:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                lanes[lane] = align_archives(meta, seed, **kw)
        else:
            lanes[lane] = align_archives(meta, seed, **kw)
        wall = time.perf_counter() - t0
        log(f"align path (align_archives niter=1, "
            f"{'card' if lane else 'host'} accumulate"
            f"{', profiler on' if prof is not None else ''}): {wall:.3f} s "
            f"wall; by stage [s]: {align_walls(align_stats())}")
        if prof is not None:
            busy_ms, rows = profile_rows(prof)
            log(f"align profile (one iteration, card lane): device busy "
                f"{busy_ms:.3f} ms of {wall * 1e3:.3f} ms wall (idle share "
                f"{1.0 - busy_ms / (wall * 1e3):.3f})")
            for us, key, cnt in rows[:10]:
                log(f"  {us / 1e3:9.3f} ms  x{cnt:<5d} {key[:90]}")
    card, host = lanes[True], lanes[False]
    corr = float(np.corrcoef((card - card.mean()).ravel(),
                             (host - host.mean()).ravel())[0, 1])
    dmax = float(np.abs(card - host).max() / np.abs(host).max())
    log(f"align path: card lane vs host lane corr {corr:.8f} (limit "
        f"0.99999), max |d| {dmax:.3e} x max|avg| (limit 0.02)")
    if not (corr > 0.99999 and dmax < 0.02):
        raise AssertionError(f"card vs host lane: corr {corr}, {dmax}")
    if cuda:
        check_cross_spectrum_case(cross_spectrum_case(
            f"align fit {nsub}x{nchan}x{nbin} K={K1}", nsub, nchan, nbin,
            K1, torch.float32, seed=40))
        ms, bound, by = time_accumulate(nsub, nchan, nbin)
        log(f"timing align accumulate ({nsub}x1x{nchan}x{nbin} float32, "
            f"one chunk; rfft, rotation, weighted sum): {ms:.4f} ms "
            f"median, bound {bound:.4f} ms ({by}), "
            f"{100.0 * bound / ms:.1f} % of its bound")

    # 4-5. pptoas with the aligned template, on the main path's archive
    arch = os.path.join(WORK, "fake.fits")
    main_meta = os.path.join(WORK, "align_main_meta.txt")
    with open(main_meta, "w") as f:
        f.write(arch + "\n")
    tmpl = outs["ppalign -g"]
    ref = read_tim(os.path.join(WORK, "toas.tim"))
    got = {}
    for label, args in (("pptoas", ["-d", arch]),
                        ("pptoas --stream", ["--stream", "-d", main_meta])):
        tim = os.path.join(WORK, f"align_{len(got)}.tim")
        if os.path.exists(tim):
            os.remove(tim)
        wall, launches = run_cli(args + ["-m", tmpl, "-o", tim, "--quiet",
                                          "--device", device],
                                 f"{label} -m aligned")
        got[label] = read_tim(tim)
        if set(got[label]) != set(ref):
            raise AssertionError(f"{label} -m aligned: TOAs for "
                                 f"{sorted(got[label])[:3]}...")
        log(f"align path ({label} -m aligned.fits): {len(got[label])} TOAs "
            f"in {wall:.3f} s wall incl. load; kernel launches {launches}")
    al = got["pptoas"]
    d = np.array([tim_offset_us(ref[k], al[k]) for k in sorted(ref)])
    err = np.array([al[k]["err"] for k in sorted(ref)])
    scatter = np.abs(d - d.mean()) / err
    stream_off = max(tim_sigma_offset(al[k], got["pptoas --stream"][k])
                     for k in al)
    gt = GetTOAs(arch, tmpl, quiet=True, device=device)
    gt.get_TOAs(quiet=True)
    rcs = np.asarray(gt.rcs[0])[gt.ok_isubs[0]]
    log(f"align path (TOA(aligned) - TOA(.gmodel)): offset "
        f"{d.mean():.4f} us, scatter about it rms "
        f"{float(np.sqrt(np.mean(scatter ** 2))):.4f}, max "
        f"{float(scatter.max()):.4f} sigma (limit {ALIGN_TOA_SCATTER}); "
        f"stream vs pptoas max {stream_off:.4f} sigma (limit 0.1); "
        f"return codes {sorted(set(rcs.tolist()))}")
    if not (scatter.max() < ALIGN_TOA_SCATTER and stream_off <= 0.1
            and np.all(np.isin(rcs, (0, 1, 2)))):
        raise AssertionError(f"pptoas -m aligned: scatter "
                             f"{scatter.max():.3f} sigma, stream "
                             f"{stream_off:.3f} sigma, rcs {set(rcs)}")
    return b1


def template_archives(device="cuda", nchan=NCHAN, nbin=NBIN):
    """The template path's inputs, from seeded generators: avg.fits, 1
    subint x nchan x nbin of the .gmodel, dedispersed, at
    NOISE_TEMPLATE; and join.meta, two receivers of 1 x nchan/2 x nbin
    (1100-1500 and 1500-1900 MHz) at the same noise, the second with
    JOIN_PHASE and JOIN_DDM injected.  Returns (avg, join metafile)."""
    import numpy as np
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    model = default_test_model(1500.0)
    avg = os.path.join(WORK, "avg.fits")
    make_fake_pulsar(model, PAR, outfile=avg, nsub=1, nchan=nchan,
                     nbin=nbin, nu0=1500.0, bw=800.0, tsub=3840.0,
                     start_MJD=MJD(55500, 0.1), noise_stds=NOISE_TEMPLATE,
                     dedispersed=True, quiet=True,
                     rng=np.random.default_rng(SEED + 140), device=device)
    rcvrs = []
    for i, (nu0, phase, dDM) in enumerate(((1300.0, 0.0, 0.0),
                                           (1700.0, JOIN_PHASE, JOIN_DDM))):
        path = os.path.join(WORK, f"rcvr-{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=1,
                         nchan=nchan // 2, nbin=nbin, nu0=nu0, bw=400.0,
                         tsub=3840.0, phase=phase, dDM=dDM,
                         start_MJD=MJD(55500, 0.1),
                         noise_stds=NOISE_TEMPLATE, dedispersed=False,
                         quiet=True, rng=np.random.default_rng(SEED + 141 + i),
                         device=device)
        rcvrs.append(path)
    meta = os.path.join(WORK, "join.meta")
    with open(meta, "w") as f:
        f.write("\n".join(rcvrs) + "\n")
    return avg, meta


def run_template_cli(tool, args, label):
    """``python -m pulseportraiture_tpu_torch.cli.<tool> args`` in this
    process, with the kernel counters, the stage walls and the LM
    records set to 0 just before it; returns (wall seconds, counters,
    walls by stage, LM records, the DataPortrait the run built, whose
    fitted values the check reads at full precision: the .gmodel prints
    8 decimals)."""
    from pulseportraiture_tpu_torch.fit.lm import lm_stats
    from pulseportraiture_tpu_torch.pipeline import portrait as PP

    with spy_instances(PP.DataPortrait) as made:
        wall, launches, _ = run_tool(tool, args, label)
    return wall, launches, PP.template_stats(), lm_stats(), made[-1]


@contextlib.contextmanager
def spy_instances(cls):
    """Collect the instances of ``cls`` built inside the block."""
    made = []
    init = cls.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    cls.__init__ = spy
    try:
        yield made
    finally:
        cls.__init__ = init


def log_template_run(label, wall, walls, lms, path="template"):
    """The wall by stage and, per LM call, its iterations, nfev, host
    reads of the loop state and compaction classes."""
    log(f"{path} path ({label}): {wall:.3f} s wall; by stage [s]: "
        + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    calls = {}
    for st in lms:
        calls.setdefault(st["B"], []).append(st)
    for B, sts in calls.items():
        log(f"  LM calls at B={B}: {len(sts)}, iterations "
            f"{[st['it'] for st in sts]}, nfev {[st['nfev'] for st in sts]}"
            f", host reads {[st['host_reads'] for st in sts]}"
            + (f", classes {[st['classes'] for st in sts]}" if B > 1
               else ""))


def built_correlation(kind, path, freqs, nbin, device, model=None):
    """A built template's portrait at the main archive's frequencies, its
    correlation with the clean .gmodel portrait over one common lag
    (clean_correlation, each channel of both scaled to unit rms first:
    the fit takes a scale per channel, and ppspline's default -N prof
    normalizes every channel) and whether it is finite."""
    import numpy as np
    from pulseportraiture_tpu_torch.io.gmodel import (gen_gmodel_portrait,
                                                      read_gmodel)
    from pulseportraiture_tpu_torch.io.splmodel import read_spline_model

    if kind == "gmodel":
        port = gen_gmodel_portrait(read_gmodel(path, quiet=True),
                                   np.arange(nbin), freqs, P=PAR["P0"],
                                   device=device)
    else:
        port = read_spline_model(path, quiet=True).portrait(
            freqs, nbin, device=device)
    port = np.asarray(port)
    finite = bool(np.all(np.isfinite(port)))
    corr, _ = clean_correlation(unit_rms_rows(port), freqs, device,
                                scale=unit_rms_rows, model=model)
    return corr, finite


def unit_rms_rows(port):
    """Each row of a portrait less its mean, over its rms."""
    import numpy as np

    a = port - port.mean(axis=1, keepdims=True)
    return a / np.maximum(np.sqrt((a ** 2).mean(axis=1, keepdims=True)),
                          1e-300)


def template_fit_inputs(avg, device):
    """The first portrait fit of ``ppgauss -d avg --fitloc``: the data,
    errors, flags and seed of its iteration 0 (the breadth-first profile
    trials on ``device``, the batched lane on CUDA)."""
    import numpy as np
    from pulseportraiture_tpu_torch.pipeline.gauss import (
        GaussPortrait, portrait_fit_flags, profile_to_portrait_params)

    dp = GaussPortrait(avg, quiet=True, device=device)
    profile, nu_ref = dp.select_ref_profile()
    dp.auto_fit_profile(profile)
    okc = dp.ok_ichans
    errs = np.where(dp.noise_stds > 0, dp.noise_stds,
                    np.median(dp.noise_stds[okc]))
    return dict(data=dp.port[okc], x0=profile_to_portrait_params(
                    dp.init_params),
                errs=errs[okc], flags=portrait_fit_flags(dp.ngauss,
                                                         fixloc=False),
                freqs=dp.freqsxs[0], nu_ref=nu_ref, P=float(dp.Ps[0]))


def profile_portrait_fit(inp, device):
    """The first portrait fit under torch.profiler: device busy time,
    idle share, top rows, peak memory, the LM's record, and the share of
    the device time in the Jacobian products (DGEMM) and the small
    batched solves.  The profiler's own host cost stretches the wall, so
    the idle share is also given against the wall of the same call
    without it (host clock, synchronized)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pulseportraiture_tpu_torch.config import scattering_alpha
    from pulseportraiture_tpu_torch.fit.gauss import fit_gaussian_portrait
    from pulseportraiture_tpu_torch.fit.lm import lm_stats, reset_lm_stats

    def fit():
        return fit_gaussian_portrait(
            inp["data"], inp["x0"], scattering_alpha, inp["errs"],
            inp["flags"], 0, inp["freqs"], inp["nu_ref"], P=inp["P"],
            device=device)

    fit()  # first use
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_lm_stats()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy_ms, rows = profile_rows(prof)
    st = lm_stats()[-1]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gemm = sum(r[0] for r in rows if "gemm" in r[1].lower()) / 1e3
    solve = sum(r[0] for r in rows if any(
        w in r[1].lower() for w in ("getr", "getf", "trsm", "solve",
                                    "lu_", "pivot", "laswp"))) / 1e3
    log(f"template profile (the first portrait fit, {inp['data'].shape[0]}"
        f"x{inp['data'].shape[1]}, {len(inp['x0']) + 1} parameters, "
        f"float64): device busy {busy_ms:.3f} ms of {wall * 1e3:.3f} ms wall "
        f"(idle share {1.0 - busy_ms / (wall * 1e3):.3f}; without the "
        f"profiler the call takes {plain_wall * 1e3:.3f} ms, idle share "
        f"{1.0 - busy_ms / (plain_wall * 1e3):.3f}); {st['it']} "
        f"iterations, nfev {st['nfev']}, {st['host_reads']} host reads; "
        f"peak memory {peak:.2f} GiB; DGEMM {gemm:.3f} ms "
        f"({100 * gemm / busy_ms:.1f} %), batched solves {solve:.3f} ms "
        f"({100 * solve / busy_ms:.1f} %)")
    for us, key, cnt in rows[:10]:
        log(f"  {us / 1e3:9.3f} ms  x{cnt:<5d} {key[:90]}")


def card_vs_cpu_fit(inp, device, nchan=64):
    """fit_gaussian_portrait on the first nchan channels on ``device``
    and on the CPU (float64 both) from the same start: every parameter
    within 1e-6 x its error, chi2 within 1e-9 relative."""
    import numpy as np
    from pulseportraiture_tpu_torch.config import scattering_alpha
    from pulseportraiture_tpu_torch.fit.gauss import fit_gaussian_portrait

    out = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        out[dev] = fit_gaussian_portrait(
            inp["data"][:nchan], inp["x0"], scattering_alpha,
            inp["errs"][:nchan], inp["flags"], 0, inp["freqs"][:nchan],
            inp["nu_ref"], P=inp["P"], device=dev)
        out[dev]["wall"] = time.perf_counter() - t0
    a, b = out[device], out["cpu"]
    err = np.where(b.fit_errs > 0, b.fit_errs, np.inf)
    dist = float(np.max(np.abs(a.fitted_params - b.fitted_params) / err))
    dchi = abs(a.chi2 - b.chi2) / b.chi2
    log(f"template path (fit_gaussian_portrait, first {nchan} channels, "
        f"{device_type(device)} vs cpu, float64): nfev {a.nfev} / {b.nfev}, "
        f"max |dparam| {dist:.3e} x err (limit 1e-6), chi2 rel. diff "
        f"{dchi:.3e} (limit 1e-9); walls {a.wall:.3f} / {b.wall:.3f} s")
    if not (dist <= 1e-6 and dchi <= 1e-9):
        raise AssertionError(f"card vs cpu portrait fit: {dist:.3e} x err, "
                             f"chi2 {dchi:.3e}")


def phase_template(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=NBIN):
    """The template path (phase 14): avg.fits and join.meta from
    template_archives, then
    1-3. ``ppgauss -d avg.fits --niter TEMPLATE_NITER --fitloc -e`` on
       the batched lane (gauss_device auto, on for CUDA), with
       ``--gauss-device off`` (the serial lane) and with ``--lm-jacobian
       ad`` (torch.func): the same ngauss, every parameter of runs 2 and
       3 within 1e-6 x its error of run 1's; run 1's portrait at the main
       archive's frequencies correlates with the clean .gmodel portrait
       above TEMPLATE_CORR;
    4. ``ppgauss -M join.meta --niter 1 --fitloc`` (the .gmodel's loc
       evolution is not zero, so a fit without it moves the JOIN dDM by
       15 sigma, in the JAX package as in the port): the second
       receiver's (phase, dDM) within 5 sigma of the injection, in the
       JAX package's convention (the phase at the model's nu_ref);
    5. ``ppspline -d avg.fits`` (-N prof) and ``ppspline -s``: ncomp >=
       0, finite, correlation above TEMPLATE_CORR;
    6. ``pptoas -m`` run 1's .gmodel and run 5's .spl on the main path's
       archive and ``pptoas --stream -m`` the .gmodel: TOAs a constant
       offset from the true .gmodel run's (phase 4) plus a scatter below
       TEMPLATE_TOA_SCATTER[kind] sigma, the stream within 0.1 sigma, B1
       through its FFT arm only, return codes in {0, 1, 2};
    7. the first portrait fit under the profiler (busy, idle share, peak
       memory) and fit_gaussian_portrait on 64 channels on the card and
       on the CPU.
    Every CLI run runs in this process with the counters set to 0 just
    before it.  Returns B1's launches over the pptoas runs of step 6."""
    import numpy as np
    from pulseportraiture_tpu_torch.config import Dconst
    from pulseportraiture_tpu_torch.pipeline import GetTOAs

    cuda = device_type(device) == "cuda"
    t0 = time.perf_counter()
    avg, join = template_archives(device, nchan, nbin)
    log(f"template archives: avg.fits 1x{nchan}x{nbin} at noise "
        f"{NOISE_TEMPLATE:.4f}, join.meta 2 x 1x{nchan // 2}x{nbin} "
        f"(second: phase {JOIN_PHASE}, dDM {JOIN_DDM}), written in "
        f"{time.perf_counter() - t0:.2f} s")
    P = PAR["P0"]

    # 1-3. ppgauss, three lanes
    runs, dps = {}, {}
    for label, extra in (("batched", []),
                         ("serial", ["--gauss-device", "off"]),
                         ("ad", ["--lm-jacobian", "ad"])):
        out = os.path.join(WORK, f"a-{label}.gmodel")
        wall, _, walls, lms, dp = run_template_cli(
            "ppgauss", ["-d", avg, "--niter", str(TEMPLATE_NITER),
                        "--fitloc", "-o", out, "-e", out + "_errs",
                        "--device", device] + extra,
            f"ppgauss ({label})")
        log_template_run(f"ppgauss --niter {TEMPLATE_NITER} --fitloc, "
                         f"{label} lane", wall, walls, lms)
        runs[label], dps[label] = out, dp
    from pulseportraiture_tpu_torch import config as cfg

    cfg.lm_jacobian = "auto"  # --lm-jacobian set it for this process
    d1 = dps["batched"]
    e1 = np.where(d1.fit_errs > 0, d1.fit_errs, np.inf)
    worst = 0.0
    for label in ("serial", "ad"):
        d = dps[label]
        if d.ngauss != d1.ngauss:
            raise AssertionError(f"ppgauss {label}: ngauss {d.ngauss}, "
                                 f"batched {d1.ngauss}")
        worst = max(worst, float(np.max(np.abs(d.fitted_params
                                               - d1.fitted_params) / e1)))
    margin = d1.trials.red_chi2s
    log(f"template path (ppgauss lanes): ngauss {d1.ngauss} on all three "
        f"(trial reduced chi2 {', '.join(f'{r:.4f}' for r in margin)}; "
        f"converged {d1.trials.success.tolist()}); largest |param - "
        f"batched| {worst:.3e} x err (limit 1e-6); iterations "
        f"{[(it['nfev'], it['converged']) for it in d1.iterations]}")
    if not worst <= 1e-6:
        raise AssertionError(f"ppgauss lanes differ by {worst:.3e} x err")
    from pulseportraiture_tpu_torch.io.psrfits import read_archive

    freqs = np.asarray(read_archive(os.path.join(WORK, "fake.fits"),
                                    decode=False).freqs_table[0], float)
    corr, finite = built_correlation("gmodel", runs["batched"], freqs, nbin,
                                     device)
    log(f"template path (a.gmodel): correlation with the clean .gmodel "
        f"portrait {corr:.8f}, 1 - corr {1.0 - corr:.3e} (limit "
        f"{TEMPLATE_CORR['gmodel']})")
    if not (corr > TEMPLATE_CORR["gmodel"] and finite):
        raise AssertionError(f"a.gmodel: correlation {corr}, finite "
                             f"{finite}")

    # 4. the JOIN fit
    jout = os.path.join(WORK, "j.gmodel")
    wall, _, walls, lms, jdp = run_template_cli(
        "ppgauss", ["-M", join, "--niter", "1", "--fitloc", "-o", jout,
                    "-e", jout + "_errs", "--device", device], "ppgauss -M")
    log_template_run("ppgauss -M join.meta --niter 1 --fitloc", wall, walls,
                     lms)
    phi, ddm = jdp.join_params[2], jdp.join_params[3]
    sphi, sddm = jdp.join_fit_errs[2], jdp.join_fit_errs[3]
    # the JAX package's convention: the JOIN phase is the receiver's
    # delay at the model's nu_ref, so the injected dDM (referenced to
    # infinite frequency once the header DM is removed) adds to it
    phi_inj = JOIN_PHASE + Dconst * JOIN_DDM * jdp.nu_ref ** -2.0 / P
    log(f"template path (JOIN): second receiver phase {phi:.7f} +/- "
        f"{sphi:.2e} rot (injected {phi_inj:.7f} at nu_ref "
        f"{jdp.nu_ref:.2f} MHz, {abs(phi - phi_inj) / sphi:.2f} sigma), "
        f"dDM {ddm:.3e} +/- {sddm:.1e} (injected {JOIN_DDM}, "
        f"{abs(ddm - JOIN_DDM) / sddm:.2f} sigma; limit 5 sigma)")
    if not (abs(phi - phi_inj) < 5 * sphi
            and abs(ddm - JOIN_DDM) < 5 * sddm):
        raise AssertionError(f"JOIN recovery: phase {phi}, dDM {ddm}")

    # 5. ppspline
    spls = {}
    for label, extra in (("-N prof", []), ("-s", ["-s"])):
        out = os.path.join(WORK, "a.spl" if not extra else "s.spl")
        wall, _, walls, lms, sdp = run_template_cli(
            "ppspline", ["-d", avg, "-o", out, "--quiet", "--device",
                         device] + extra, f"ppspline {label}")
        from pulseportraiture_tpu_torch.io.splmodel import read_spline_model

        ncomp = read_spline_model(out, quiet=True).ncomp
        if ncomp != sdp.ncomp:
            raise AssertionError(f"{out}: ncomp {ncomp}, built {sdp.ncomp}")
        corr, finite = built_correlation("spl", out, freqs, nbin, device)
        log_template_run(f"ppspline {label}", wall, walls, lms)
        log(f"template path (ppspline {label}): ncomp {ncomp}; correlation "
            f"with the clean .gmodel portrait {corr:.8f}, 1 - corr "
            f"{1.0 - corr:.3e} (limit {TEMPLATE_CORR['spl']}); finite "
            f"{finite}")
        if not (ncomp >= 0 and finite and corr > TEMPLATE_CORR["spl"]):
            raise AssertionError(f"ppspline {label}: ncomp {ncomp}, corr "
                                 f"{corr}, finite {finite}")
        spls[label] = out

    # 6. pptoas with the built templates, on the main path's archive
    arch = os.path.join(WORK, "fake.fits")
    main_meta = os.path.join(WORK, "template_main_meta.txt")
    with open(main_meta, "w") as f:
        f.write(arch + "\n")
    ref = read_tim(os.path.join(WORK, "toas.tim"))
    b1 = 0
    got = {}
    for label, kind, tmpl, args in (
            ("pptoas -m a.gmodel", "gmodel", runs["batched"], ["-d", arch]),
            ("pptoas -m a.spl", "spl", spls["-N prof"], ["-d", arch]),
            ("pptoas --stream -m a.gmodel", "gmodel", runs["batched"],
             ["--stream", "-d", main_meta])):
        tim = os.path.join(WORK, f"template_{len(got)}.tim")
        if os.path.exists(tim):
            os.remove(tim)
        wall, launches = run_cli(args + ["-m", tmpl, "-o", tim, "--quiet",
                                          "--device", device], label)
        if cuda:
            fft_only(launches, ("fused_cross_spectrum",), label)
        b1 += launches["fused_cross_spectrum"]
        got[label] = read_tim(tim)
        if set(got[label]) != set(ref):
            raise AssertionError(f"{label}: TOAs for "
                                 f"{sorted(got[label])[:3]}...")
        t = got[label]
        d = np.array([tim_offset_us(ref[k], t[k]) for k in sorted(ref)])
        err = np.array([t[k]["err"] for k in sorted(ref)])
        scatter = np.abs(d - d.mean()) / err
        log(f"template path ({label}): {len(t)} TOAs in {wall:.3f} s wall "
            f"incl. load; TOA(built) - TOA(.gmodel) offset {d.mean():.4f} "
            f"us, scatter about it rms "
            f"{float(np.sqrt(np.mean(scatter ** 2))):.4f}, max "
            f"{float(scatter.max()):.4f} sigma (limit "
            f"{TEMPLATE_TOA_SCATTER[kind]}); kernel launches {launches}")
        if not scatter.max() < TEMPLATE_TOA_SCATTER[kind]:
            raise AssertionError(f"{label}: scatter {scatter.max():.3f} "
                                 "sigma")
    a = got["pptoas -m a.gmodel"]
    stream_off = max(tim_sigma_offset(a[k],
                                      got["pptoas --stream -m a.gmodel"][k])
                     for k in a)
    gt = GetTOAs(arch, runs["batched"], quiet=True, device=device)
    gt.get_TOAs(quiet=True)
    rcs = np.asarray(gt.rcs[0])[gt.ok_isubs[0]]
    log(f"template path: stream vs pptoas with a.gmodel max "
        f"{stream_off:.4f} sigma (limit 0.1); return codes "
        f"{sorted(set(rcs.tolist()))}")
    if not (stream_off <= 0.1 and np.all(np.isin(rcs, (0, 1, 2)))):
        raise AssertionError(f"a.gmodel: stream {stream_off:.3f} sigma, "
                             f"rcs {set(rcs)}")

    # 7. the first portrait fit under the profiler; card vs CPU
    inp = template_fit_inputs(avg, device)
    if cuda:
        profile_portrait_fit(inp, device)
    card_vs_cpu_fit(inp, device)
    return b1


def pta_models(n):
    """Phase 15's fleet models, from a seeded generator: 1-3 components
    (cycling 2, 3, 1), 0.12 rot apart with a random start and jitter,
    widths 0.012-0.035 rot, amplitudes 3-10, and their own evolution
    (index 0 is pulsar A's, 1 pulsar B's).  Separated components: the
    factory's breadth-first trials seed each trial by matching pursuit,
    and on overlapping components a g+1 trial can land in a worse
    minimum than g and stop the scan early, in the JAX package as in
    the port (PERF.md section 7).  Index PTA_OVERLAP is that case,
    default_test_model's three overlapping components: its lanes are
    held, its correlation is not."""
    import numpy as np
    from pulseportraiture_tpu_torch.models.gaussian import GaussianModel
    from pulseportraiture_tpu_torch.synth import default_test_model

    rng = np.random.default_rng(SEED + 150)
    out = []
    for i in range(n):
        ng = (2, 3, 1)[i % 3]
        if i == PTA_OVERLAP:
            m = default_test_model()
            m.name = f"PTA_{i}"
            out.append(m)
            continue
        out.append(GaussianModel(
            name=f"PTA_{i}", code="000", nu_ref=1500.0, dc=0.0, tau=0.0,
            alpha=-4.0,
            locs=rng.uniform(0.3, 0.4) + 0.12 * np.arange(ng)
            + rng.uniform(-0.01, 0.01, ng),
            wids=rng.uniform(0.012, 0.035, ng),
            amps=rng.uniform(3.0, 10.0, ng),
            mlocs=rng.uniform(-0.004, 0.004, ng),
            mwids=rng.uniform(-0.25, 0.25, ng),
            mamps=rng.uniform(-1.8, -0.6, ng)))
    return out


def pta_pars(n):
    """The fleet's true parfiles: A the main PAR, B PAR_B, the others
    isolated at periods 2-9 ms."""
    pars = [dict(PAR), dict(PAR_B)]
    for i in range(2, n):
        pars.append({"PSR": f"J{1000 + 37 * i:04d}+0000", "P0":
                     0.002 + 0.001 * i, "PEPOCH": 55000.0,
                     "DM": 5.0 + 3.0 * i})
    return pars


def pta_fleet(device="cuda", nchan=NCHAN, nbin=NBIN, n=PTA_NFLEET):
    """The factory's inputs: n averaged archives, 1 subint x nchan x
    nbin each, of pta_models at NOISE_TEMPLATE, dedispersed; returns
    (fleet metafile, archive paths, models)."""
    import numpy as np
    from pulseportraiture_tpu_torch.synth import make_fake_pulsar
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    models, pars, files = pta_models(n), pta_pars(n), []
    for i, (model, par) in enumerate(zip(models, pars)):
        name = "A" if i == 0 else "B" if i == 1 else f"P{i}"
        path = os.path.join(WORK, f"pta-{name}.fits")
        make_fake_pulsar(model, par, outfile=path, nsub=1, nchan=nchan,
                         nbin=nbin, nu0=1500.0, bw=800.0, tsub=3840.0,
                         start_MJD=MJD(55500, 0.1),
                         noise_stds=NOISE_TEMPLATE, dedispersed=True,
                         quiet=True, rng=np.random.default_rng(SEED + 160 + i),
                         device=device)
        files.append(path)
    meta = os.path.join(WORK, "fleet.txt")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    return meta, files, models


def pta_campaign(model, par, name, nbit, device="cuda", nchan=NCHAN,
                 nbin=NBIN, nsub=PTA_NSUB, nep=PTA_NEP, levels=None):
    """One pulsar's spin-coherent campaign: nep epochs of nsub subints
    of 1800 s, 60 days apart at fractional days that walk B's orbit, at
    noise 1.0 with per-epoch dDMs of std PTA_DDM, written with nbit and
    levels (dithered below 16 bits); returns (metafile, paths, injected
    dDMs).  The spacing
    and the subint length set the F0 error: with 30 days and 600 s,
    B's F0 error beside its five orbital elements is 0.5-0.7 % of the
    injected offset at these widths (a design-matrix computation), too
    close to the 1 % gate; with these, 0.1-0.2 %."""
    import numpy as np
    from pulseportraiture_tpu_torch.synth import make_fake_pulsar
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    rng = np.random.default_rng(SEED + 170 + nbit)
    ddms = PTA_DDM * rng.standard_normal(nep)
    files = []
    for k in range(nep):
        path = os.path.join(WORK, f"pta-{name}-{k:02d}.fits")
        make_fake_pulsar(model, par, outfile=path, nsub=nsub, nchan=nchan,
                         nbin=nbin, nu0=1500.0, bw=800.0, tsub=1800.0,
                         dDM=float(ddms[k]),
                         start_MJD=MJD(55100 + 60 * k, (0.2 + 0.137 * k) % 1),
                         noise_stds=1.0, dedispersed=False, quiet=True,
                         rng=rng, spin_coherent=True, nbit=nbit,
                         levels=levels, dither=nbit < 16, device=device)
        files.append(path)
    meta = os.path.join(WORK, f"pta-{name}.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    return meta, files, ddms


def timing_par(par):
    """A timing parfile from a true one: F0 instead of P0, perturbed by
    PTA_F0_REL; a binary's PB by PTA_DPB."""
    out = {k: v for k, v in par.items() if k != "P0"}
    out["F0"] = repr((1.0 / par["P0"]) * (1.0 + PTA_F0_REL))
    if "PB" in par:
        out["PB"] = repr(par["PB"] + PTA_DPB)
    return out


def run_tool(tool, args, label, spy=()):
    """``python -m pulseportraiture_tpu_torch.cli.<tool> args`` in this
    process with the kernel counters, stage walls and LM records set to
    0 just before it; spy: (module, function name) pairs whose return
    values are collected.  Returns (wall seconds, counters, returns by
    name)."""
    import importlib

    from pulseportraiture_tpu_torch.fit.lm import reset_lm_stats
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.pipeline import portrait as PP

    got, saved = {}, []
    for modname, name in spy:
        mod = importlib.import_module(modname)
        fn = getattr(mod, name)

        def wrap(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            got.setdefault(_name, []).append(out)
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, wrap)
    F.reset_kernel_launches()
    PP.reset_template_stats()
    reset_lm_stats()
    argv = sys.argv
    sys.argv = [tool] + list(args)
    t0 = time.perf_counter()
    try:
        runpy.run_module(f"pulseportraiture_tpu_torch.cli.{tool}",
                         run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise RuntimeError(f"{label} exited with {e.code!r}")
    finally:
        sys.argv = argv
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    if "--device" in args:
        sync(args[args.index("--device") + 1])
    return time.perf_counter() - t0, F.kernel_launches(), got


def factory_run(meta, outdir, extra, label, device):
    """One ppfactory run: wall, LM calls and buckets, walls by stage, LM
    records, peak memory; returns (results, DataPortraits, LM calls)."""
    import torch
    from pulseportraiture_tpu_torch.fit.lm import lm_stats
    from pulseportraiture_tpu_torch.pipeline import portrait as PP
    from pulseportraiture_tpu_torch.pipeline.factory import factory_stats

    cuda = device_type(device) == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with spy_instances(PP.DataPortrait) as made:
        wall, _, got = run_tool(
            "ppfactory", ["-M", meta, "-O", outdir, "--max-ngauss", "8",
                          "--niter", "1", "--fitloc", "--device", device]
            + extra, f"ppfactory {label}",
            spy=[("pulseportraiture_tpu_torch.pipeline.factory",
                  "build_templates")])
    st = factory_stats()
    walls, lms = PP.template_stats(), lm_stats()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
            else float("nan"))
    log(f"pta path (ppfactory {label}): {wall:.3f} s wall, {st['lm_calls']}"
        f" LM calls over {len(st['buckets'])} buckets (stage, (nbin[, "
        f"nchan class], ngauss class[, code]), rows, padded rows) "
        f"{st['buckets']}; peak memory {peak:.2f} GiB")
    log_template_run(f"ppfactory {label}", wall, walls, lms, path="pta")
    return got["build_templates"][-1], made, st["lm_calls"]


def pta_factory(meta, files, models, device, nchan, nbin):
    """Step 1 of phase 15: the factory's three runs and their checks;
    returns the batched run's .gmodel paths."""
    import numpy as np

    out = {}
    for label, sub, extra in (
            ("gauss, batched", "tmpl", ["--gauss-device", "on"]),
            ("gauss, serial", "tmpl-serial", ["--gauss-device", "off"]),
            ("spline, batched", "tmpl-spline",
             ["--kind", "spline", "--gauss-device", "on"])):
        out[label] = factory_run(meta, os.path.join(WORK, sub), extra,
                                 label, device)
    (rb, db, nb), (rs, ds, ns) = out["gauss, batched"], out["gauss, serial"]
    worst, rows, ncmp = 0.0, [], 0
    for a, b, pa, pb in zip(rb, rs, db, ds):
        if a.ngauss != b.ngauss or a.fit_converged != b.fit_converged:
            raise AssertionError(
                f"{a.datafile}: ngauss {a.ngauss} batched, {b.ngauss} "
                f"serial; LM converged {a.fit_converged} batched, "
                f"{b.fit_converged} serial")
        err = np.where(pa.fit_errs > 0, pa.fit_errs, np.inf)
        d = float(np.max(np.abs(pa.fitted_params - pb.fitted_params)
                         / err))
        worst, ncmp = max(worst, d), ncmp + a.fit_converged
        rows.append(f"{os.path.basename(a.datafile)}: ngauss {a.ngauss}, "
                    f"iters {a.iters}/{b.iters}, converged "
                    f"{a.converged}/{b.converged}, LM converged "
                    f"{a.fit_converged}, {d:.2e} x err")
    sep = [i for i in range(len(files)) if i != PTA_OVERLAP]
    sep_conv = all(rb[i].fit_converged for i in sep)
    log("pta path (factory lanes): " + "; ".join(rows)
        + f"; largest |batched - serial| {worst:.3e} x err over the "
        f"{len(rb)} jobs (limit 1e-9); {ncmp} of them with every LM fit "
        f"converged (every separated-component job must be: {sep_conv}); "
        f"LM calls batched {nb}, serial {ns}")
    if not (worst <= 1e-9 and len(rb) == len(files) and sep_conv
            and nb < ns):
        raise AssertionError(f"factory lanes: {worst:.3e} x err over "
                             f"{len(rb)} jobs, {ncmp} converged, separated "
                             f"jobs all "
                             f"converged {sep_conv}, LM calls {nb} batched "
                             f"vs {ns} serial")
    from pulseportraiture_tpu_torch.io.psrfits import read_archive

    freqs = np.asarray(read_archive(files[0], decode=False).freqs_table[0],
                       float)
    for label, kind in (("gauss, batched", "gmodel"),
                        ("gauss, serial", "gmodel"),
                        ("spline, batched", "spl")):
        corrs = []
        for i, (r, model) in enumerate(zip(out[label][0], models)):
            corr, finite = built_correlation(kind, r.outfile, freqs, nbin,
                                             device, model=model)
            if not (finite and (i == PTA_OVERLAP
                                or corr > TEMPLATE_CORR[kind])):
                raise AssertionError(f"{r.outfile}: correlation {corr}, "
                                     f"finite {finite}")
            corrs.append(1.0 - corr)
        log(f"pta path ({label} templates): 1 - corr with the clean "
            f"portraits {', '.join(f'{c:.2e}' for c in corrs)} (limit "
            f"{1.0 - TEMPLATE_CORR[kind]:.0e}; job {PTA_OVERLAP}, "
            f"overlapping components, not held)")
    return [r.outfile for r in rb]


@contextlib.contextmanager
def capture_largest(name, last=False):
    """Inside the block, keep a copy of the inputs of the call to
    ``ops.fused.<name>`` whose first tensor is the largest (the first
    such call, or with last=True the last): [(args, kwargs)], empty if
    it was not called.  The call itself, and its launch count, are
    unchanged."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F

    kept = []
    orig = getattr(F, name)

    def spy(*a, **k):
        n = a[0].numel()
        if not kept or n > kept[0][0][0].numel() or (
                last and n == kept[0][0][0].numel()):
            kept[:] = [(tuple(x.clone() if torch.is_tensor(x) else x
                              for x in a), dict(k))]
        return orig(*a, **k)

    setattr(F, name, spy)
    try:
        yield kept
    finally:
        setattr(F, name, orig)


def check_pta_kernels(b1_call, b2_call):
    """B1 and B2 against their plain versions at the pta path's shapes:
    on the inputs of the largest bucket each got on the path, and on
    random data of that shape and K (check_cross_spectrum_case,
    check_decode_case: 1e-5 x max|ref| in float32)."""
    import torch

    (port, model, w, K), k = b1_call[0][0][:4], b1_call[0][1]
    shape = tuple(port.shape)
    check_cross_spectrum_case(dict(
        name=f"pta A bucket {shape} K={K}", port=port, model=model, w=w,
        K=K, fold=k.get("fold"), want_m2=k.get("want_m2", False), arm=None))
    check_cross_spectrum_case(cross_spectrum_case(
        f"pta A shape {shape} K={K} random", shape[0], shape[1], shape[2],
        K, port.dtype, seed=50))
    (raw, scl, offs, model, w, K), k = b2_call[0]
    shape = tuple(raw.shape)
    check_decode_case(dict(
        name=f"pta B stream bucket {shape} K={K}", raw=raw, scl=scl,
        offs=offs, model=model, w=w, K=K, code=k["code"], nbin=k["nbin"],
        fold=k.get("fold"), arm=None))
    check_decode_case(decode_case(
        f"pta B shape {shape[:2]}x{k['nbin']} {k['code']} K={K} random",
        shape[0], shape[1], k["nbin"], K, w.dtype, k["code"], seed=51))
    del b1_call[:], b2_call[:]
    torch.cuda.empty_cache()


def pta_toas(args, label, device):
    """pptoas on a campaign in this process, the GetTOAs objects it made
    spied; returns (wall, counters, GetTOAs objects)."""
    from pulseportraiture_tpu_torch.pipeline.toas import GetTOAs

    with spy_instances(GetTOAs) as made:
        wall, launches, _ = run_tool("pptoas", args + ["--quiet",
                                                       "--device", device],
                                     label)
    return wall, launches, made


def fleet_delta(a, b):
    """tests/test_timing_binary.py's fleet distance: the largest
    |a - b| / max(|b|, err) over every pulsar's parameters and DMX."""
    worst = 0.0
    for name in a.pulsars:
        ra, rc = a.results[name], b.results[name]
        pairs = [(ra.params[k], rc.params[k], ra.param_errs[k])
                 for k in ra.params]
        pairs += list(zip(ra.dmx, rc.dmx, ra.dmx_errs))
        for va, vc, err in pairs:
            worst = max(worst, abs(va - vc)
                        / max(abs(vc), float(err), 1e-300))
    return worst


def gls_fleet(n, nep, span):
    """benchmarks/bench_gls._fleet's recipe for n synthetic pulsars: an
    ELL1 / BT / isolated mix with F0 (and PB) truths off the nominal
    parfile, nep or nep + 1 epochs of 2 TOAs over span days."""
    from pulseportraiture_tpu_torch.synth import fake_timing_campaign

    jobs = []
    for i in range(n):
        par = {"PSR": f"B{i:03d}", "F0": str(180.0 + 17.3 * i),
               "PEPOCH": "55500", "DM": str(8.0 + 1.5 * i)}
        kind = i % 3
        if kind == 0:
            par.update({"BINARY": "ELL1", "PB": str(0.4 + 0.07 * i),
                        "A1": str(0.04 + 0.005 * i), "TASC": "55499.13",
                        "EPS1": "1.5e-6", "EPS2": "-6e-7"})
        elif kind == 1:
            par.update({"BINARY": "BT", "PB": str(0.9 + 0.05 * i),
                        "A1": str(0.3 + 0.02 * i), "T0": "55499.4",
                        "ECC": "0.12", "OM": str(20.0 + 10.0 * i)})
        truth = {"F0": float(par["F0"]) * (1.0 + 1e-13)}
        if kind != 2:
            truth["PB"] = float(par["PB"]) + 2e-9
        toas, _ = fake_timing_campaign(
            par, truth=truth, n_epochs=nep + (i % 2), toas_per_epoch=2,
            span_days=span, toa_err_us=0.1, dmx=2e-4, rng=400 + i)
        jobs.append((par["PSR"], toas, par))
    return jobs


def check_pad_systems(device):
    """The fleet solve on an all-zero pad system and a zero pad column:
    finite, and exactly zero where padded."""
    import torch
    from pulseportraiture_tpu_torch.timing.fleet import _solve_program

    g = torch.Generator().manual_seed(SEED)
    A = torch.zeros(4, 64, 16, dtype=torch.float64)
    A[:3, :40, :12] = torch.randn(3, 40, 12, generator=g,
                                  dtype=torch.float64)
    r = torch.zeros(4, 64, dtype=torch.float64)
    r[:3, :40] = torch.randn(3, 40, generator=g, dtype=torch.float64)
    x, perr, post, chi2 = (v.cpu() for v in _solve_program(
        A.to(device), r.to(device)))
    ok = all(bool(torch.isfinite(v).all()) for v in (x, perr, post, chi2))
    zero = (not x[3].any() and not perr[3].any() and not post[3].any()
            and not x[:, 12:].any() and not perr[:, 12:].any())
    log(f"pta path (fleet pad systems, {device_type(device)}): finite "
        f"{ok}, pad system and pad columns exactly zero {zero}")
    if not (ok and zero):
        raise AssertionError("the fleet solve's pad systems are not finite "
                             "zeros")


def _einsum_solve(A, r):
    """timing.fleet._solve_program with its three matrix-vector products
    as einsum (the batch-width probe's foil)."""
    import torch

    col = torch.sqrt(torch.sum(A * A, dim=-2))
    col = torch.where(col > 0, col, torch.ones_like(col))
    An = A / col[..., None, :]
    G = An.transpose(-1, -2) @ An
    p = G.shape[-1]
    N = torch.linalg.pinv(G, rtol=10.0 * p * torch.finfo(G.dtype).eps)
    xn = torch.einsum("bpq,bq->bp", N, torch.einsum("bmp,bm->bp", An, r))
    post = r - torch.einsum("bmp,bp->bm", An, xn)
    return xn / col, post


def batch_width_probe(device, B=64, m=512, p=128, rows=8):
    """The fleet solve's rows at batch width B against the same rows
    solved alone (B = 1), on random ill-conditioned systems at the
    decade fleet's largest bucket shape (two nearly collinear columns,
    scales over 12 decades): the largest |x_B - x_1| / max|x| and
    |post_B - post_1| / max|post| for _solve_program and for the einsum
    form.  _solve_program's rows are held to 1e-10 (the fleet gate);
    the einsum form's are printed, as the reason for the design."""
    import torch
    from pulseportraiture_tpu_torch.timing.fleet import _solve_program

    g = torch.Generator().manual_seed(SEED + 180)
    A = torch.randn(B, m, p, generator=g, dtype=torch.float64)
    A[..., 1] = A[..., 0] + 1e-4 * A[..., 1]
    A = A * 10.0 ** (12.0 * torch.rand(B, 1, p, generator=g,
                                       dtype=torch.float64) - 6.0)
    r = torch.randn(B, m, generator=g, dtype=torch.float64)
    A, r = A.to(device), r.to(device)
    out = {}
    for label, fn in (("solve", lambda a, b: _solve_program(a, b)[::2]),
                      ("einsum", _einsum_solve)):
        full = fn(A, r)
        d = [0.0, 0.0]
        for i in range(rows):
            one = fn(A[i:i + 1], r[i:i + 1])
            for j in range(2):
                d[j] = max(d[j], float((full[j][i] - one[j][0]).abs().max()
                                       / full[j][i].abs().max()))
        out[label] = d
    log(f"pta fleet GLS batch-width probe ({device_type(device)}, {rows} "
        f"rows of B={B} x {m}x{p} vs B=1): _solve_program x "
        f"{out['solve'][0]:.3e}, post {out['solve'][1]:.3e} (limit 1e-10);"
        f" the einsum form x {out['einsum'][0]:.3e}, post "
        f"{out['einsum'][1]:.3e} (not held)")
    if not max(out["solve"]) <= 1e-10:
        raise AssertionError(f"the fleet solve depends on the batch width: "
                             f"{out['solve']}")


def phase_pta(device="cuda", nchan=NCHAN, nbin=NBIN, nsub=PTA_NSUB,
              nep=PTA_NEP, ngls=PTA_NGLS, gls_nep=PTA_GLS_NEP):
    """The pta path (phase 15): the factory builds every template of a
    fleet, pptoas / pptoas --stream time pulsars A and B with theirs,
    pptime fits their timing solutions, and the fleet GLS runs at
    BASELINE config 5's pulsar count.
    1. ``ppfactory`` (pta_factory) on PTA_NFLEET averaged archives;
    2. A's campaign (int16) through ``pptoas -m`` (B1) and B's (2-bit,
       dithered) through ``pptoas --stream -m`` (B2), each with its
       factory .gmodel: FFT arms only, each kernel held to its plain
       version on the path's largest bucket (check_pta_kernels), return
       codes in {0, 1, 2} (B's read from GetTOAs on the same archives);
    3. ``pptime -j jobs.txt --gls-device on`` with timing_par's
       parfiles: tests/test_timing.py's and test_timing_binary.py's
       gates (red chi2 in (0.3, 3), every residual < 5 sigma, every DMX
       within max(4 sigma, 3e-5) of its injection, dF0 to 1 %, dPB
       within 5 sigma);
    4. fleet_gls_fit on A, B and ngls - 2 gls_fleet pulsars on the
       batched, serial and host lanes: batched vs serial <= 1e-10, vs
       host <= 1e-8 (test_timing_binary.py's gates), fewer batched
       calls than the serial lane's ngls; the pad systems checked and
       the batch-width probe.
    Every CLI run runs in this process with the counters set to 0 just
    before it.  Returns the B1 and B2 launches of step 2 and what phase
    16 reuses: the campaigns' metafiles, injected dDMs and parfiles, the
    factory's templates and models, and A's pptoas -m .tim."""
    import numpy as np
    from pulseportraiture_tpu_torch.timing import fleet as FL

    cuda = device_type(device) == "cuda"
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    meta, files, models = pta_fleet(device, nchan, nbin)
    log(f"pta fleet: {len(files)} averaged archives 1x{nchan}x{nbin} at "
        f"noise {NOISE_TEMPLATE:.4f} written in "
        f"{time.perf_counter() - t0:.2f} s")
    tmpl = pta_factory(meta, files, models, device, nchan, nbin)

    # 2. the campaigns, timed with the factory's templates
    t0 = time.perf_counter()
    metaA, filesA, ddmA = pta_campaign(models[0], PAR, "A", 16, device,
                                       nchan, nbin, nsub, nep)
    metaB, filesB, ddmB = pta_campaign(models[1], PAR_B, "B", 2, device,
                                       nchan, nbin, nsub, nep)
    log(f"pta campaigns: 2 x {nep} epochs x {nsub}x{nchan}x{nbin} (A int16,"
        f" B dithered 2-bit) written in {time.perf_counter() - t0:.2f} s")
    tims = {n: os.path.join(WORK, f"pta-{n}.tim") for n in "AB"}
    for t in tims.values():
        if os.path.exists(t):
            os.remove(t)
    with capture_largest("fused_cross_spectrum") as b1_call:
        wA, lA, gtA = pta_toas(["-d", metaA, "-m", tmpl[0], "-o",
                                tims["A"]], "pptoas (A)", device)
    with capture_largest("fused_decode_cross_spectrum") as b2_call:
        wB, lB, _ = pta_toas(["--stream", "-d", metaB, "-m", tmpl[1], "-o",
                              tims["B"]], "pptoas --stream (B)", device)
    from pulseportraiture_tpu_torch.pipeline import GetTOAs

    gtB = GetTOAs(filesB, tmpl[1], quiet=True, device=device)
    gtB.get_TOAs(quiet=True)
    rcs = np.concatenate([np.asarray(g.rcs[i])[g.ok_isubs[i]]
                          for g in (gtA[-1], gtB)
                          for i in range(len(g.rcs))])
    log(f"pta path (pptoas -m A.gmodel): {nep * nsub} TOAs in {wA:.3f} s, "
        f"kernel launches {lA}; (pptoas --stream -m B.gmodel): {wB:.3f} s, "
        f"kernel launches {lB}; return codes {sorted(set(rcs.tolist()))}")
    if cuda:
        fft_only(lA, ("fused_cross_spectrum",), "pptoas (A)")
        fft_only(lB, ("fused_decode_cross_spectrum",), "pptoas --stream (B)")
        if lB["fused_cross_spectrum.gemm"]:
            raise AssertionError("pptoas --stream (B) launched B1's GEMM arm")
        check_pta_kernels(b1_call, b2_call)
    if not np.all(np.isin(rcs, (0, 1, 2))):
        raise AssertionError(f"return codes {sorted(set(rcs.tolist()))}")

    # 3. pptime on A and B
    from pulseportraiture_tpu_torch.io.psrfits import parse_parfile

    jobs_txt = os.path.join(WORK, "jobs.txt")
    with open(jobs_txt, "w") as f:
        for n, par in (("A", PAR), ("B", PAR_B)):
            pf = os.path.join(WORK, f"pta-{n}.par")
            with open(pf, "w") as g:
                g.write("".join(f"{k} {v}\n"
                                for k, v in timing_par(par).items()))
            f.write(f"{n} {tims[n]} {pf}\n")
    wall, _, got = run_tool(
        "pptime", ["-j", jobs_txt, "--gls-device", "on", "--quiet",
                   "--device", device], "pptime",
        spy=[("pulseportraiture_tpu_torch.timing.fleet", "fleet_gls_fit")])
    fit = got["fleet_gls_fit"][-1]
    for n, par, ddms in (("A", PAR, ddmA), ("B", PAR_B, ddmB)):
        check_timing_solution(fit.results[n], par, ddms,
                              f"pta path (pptime {n})")
    log(f"pta path (pptime -j, {fit.n_dispatches} solve calls): "
        f"{wall:.3f} s wall")

    # 4. the fleet GLS at BASELINE config 5's pulsar count
    t0 = time.perf_counter()
    jobs = [FL.TimingJob(n, tims[n], parse_parfile(
        os.path.join(WORK, f"pta-{n}.par"))) for n in "AB"]
    jobs += [FL.TimingJob(*j) for j in gls_fleet(ngls - 2, gls_nep,
                                                 PTA_GLS_SPAN)]
    log(f"pta fleet GLS: {len(jobs)} pulsars ({sum(len(j.toas) for j in jobs)}"
        f" TOAs) made in {time.perf_counter() - t0:.2f} s")
    lanes = {}
    for label, kw in (("batched", dict(gls_device=True)),
                      ("serial", dict(gls_device=True, batched=False)),
                      ("host", dict(gls_device=False))):
        lanes[label] = FL.fleet_gls_fit(jobs, device=device, **kw)
        st = FL.fleet_stats()
        solves = st["solves"]
        log(f"pta fleet GLS ({label}): {lanes[label].n_dispatches} solve "
            f"calls in {lanes[label].wall_s:.3f} s wall, linearization "
            f"{st['linearize_s']:.3f} s (host), solves "
            f"{sum(s['wall_s'] for s in solves):.3f} s"
            + ("; buckets " + ", ".join(
                f"{s['bucket']} B={s['B']} ({s['rows']} real)"
                + (f" {s['ms']:.3f} ms (CUDA events)" if "ms" in s else "")
                for s in solves) if label == "batched" else ""))
    dser = fleet_delta(lanes["batched"], lanes["serial"])
    dhost = fleet_delta(lanes["batched"], lanes["host"])
    nb, ns = lanes["batched"].n_dispatches, lanes["serial"].n_dispatches
    log(f"pta fleet GLS: batched vs serial {dser:.3e} (limit 1e-10), vs "
        f"host {dhost:.3e} (limit 1e-8); calls batched {nb}, serial {ns}")
    if not (dser <= 1e-10 and dhost <= 1e-8 and nb < ns == len(jobs)):
        raise AssertionError(f"fleet GLS: {dser:.3e} / {dhost:.3e}, calls "
                             f"{nb} / {ns}")
    check_pad_systems(device)
    batch_width_probe(device)
    ctx = dict(tmpl=tmpl, models=models, meta={"A": metaA, "B": metaB},
               averages=files,
               ddms={"A": ddmA, "B": ddmB},
               par={n: os.path.join(WORK, f"pta-{n}.par") for n in "AB"},
               true_par={"A": PAR, "B": PAR_B}, tim_A=tims["A"])
    return lA, lB, ctx


def campaign_tims(outdir, names):
    """{pulsar: read_tim of outdir/<pulsar>.tim}."""
    return {n: read_tim(os.path.join(outdir, f"{n}.tim")) for n in names}


def tims_spread(a, b):
    """The largest TOA or DM difference between two {pulsar: read_tim}
    sets, in units of a's errors (0.0 when every line is identical);
    raises when their lines differ in number or keys."""
    worst = 0.0
    for n in a:
        if set(a[n]) != set(b[n]):
            raise AssertionError(f"{n}: the two .tim files hold different "
                                 "TOAs")
        for key, ra in a[n].items():
            rb = b[n][key]
            if ra == rb:
                continue
            worst = max(worst, tim_sigma_offset(ra, rb))
            if ra["DM"] is not None:
                worst = max(worst, abs(rb["DM"] - ra["DM"])
                            / float(ra["flags"]["-pp_dme"]))
            worst = max(worst, 1e-300)
    return worst


def campaign_run(jobs, outdir, device, nsub_batch, compress, telemetry=None,
                 timing_pars=None, rcs=None):
    """One stream_ipta_campaign with config.transport_compress set to
    ``compress`` for the call; rcs (a list) collects every subint's
    return code.  Returns (result, wall seconds)."""
    from pulseportraiture_tpu_torch import config as cfg
    from pulseportraiture_tpu_torch.pipeline import stream as S
    from pulseportraiture_tpu_torch.pipeline.ipta import stream_ipta_campaign

    saved, orig = cfg.transport_compress, S._assemble_archive

    def assemble(m, results, *a, **k):
        rcs.extend(int(results[(m.iarch, int(i))]["return_code"])
                   for i in m.ok if (m.iarch, int(i)) in results)
        return orig(m, results, *a, **k)

    cfg.transport_compress = compress
    if rcs is not None:
        S._assemble_archive = assemble
    try:
        t0 = time.perf_counter()
        res = stream_ipta_campaign(
            jobs, outdir=outdir, nsub_batch=nsub_batch, quiet=True,
            telemetry=telemetry, timing_pars=timing_pars,
            timing_kwargs={"gls_device": True}, device=device)
        sync(device)
        wall = time.perf_counter() - t0
    finally:
        cfg.transport_compress = saved
        S._assemble_archive = orig
    return res, wall


def check_campaign_trace(trace, res, names, c_name):
    """Phase 16's trace gates (module docstring); returns the report's
    summary and its devices / queue-depth / link text."""
    import io

    from pulseportraiture_tpu_torch import telemetry as T

    _, events = T.validate_trace(trace)
    buf = io.StringIO()
    summary = T.report(trace, file=buf)
    seqs = [e["seq"] for e in events if e["type"] == "dispatch"]
    drains = sorted(e["seq"] for e in events if e["type"] == "drain")
    shipped = sum(res.per_pulsar[n].h2d_bytes for n in names)
    n_tfit = sum(1 for e in events if e["type"] == "timing_fit")
    engaged = summary["codec_decisions"].get("engaged", 0)
    checks = {
        "dispatches = nfit": summary["total_dispatches"] == res.nfit,
        "n_h2d = dispatches": summary["n_h2d"] == res.nfit,
        "h2d bytes = results'": summary["h2d_bytes"] == shipped,
        "engaged = C's dispatches": engaged == res.per_pulsar[c_name].nfit,
        "seqs unique": len(set(seqs)) == len(seqs) == res.nfit,
        "drain seqs = dispatch seqs": drains == sorted(seqs),
        "timing_fit = solves": n_tfit == res.timing.n_dispatches,
        "counters last": events[-1]["type"] == "counters",
    }
    text = buf.getvalue().splitlines()
    keep = []
    for head in ("-- devices --", "-- queue depth", "-- h2d link"):
        i = next(i for i, ln in enumerate(text) if ln.startswith(head))
        j = next((k for k in range(i + 1, len(text))
                  if text[k].startswith("--") or not text[k].strip()),
                 len(text))
        keep += text[i:j]
    log("campaign path (trace report): " + " | ".join(
        ln.strip() for ln in keep))
    bad = [k for k, ok in checks.items() if not ok]
    log(f"campaign path (trace gates): {len(events)} events, "
        f"{res.nfit} dispatches, {summary['n_h2d']} copies, "
        f"{summary['h2d_bytes']} bytes shipped of "
        f"{summary['h2d_bytes_logical']} logical, codec decisions "
        f"{summary['codec_decisions']}, {n_tfit} timing_fit events for "
        f"{res.timing.n_dispatches} solves; failed: {bad or 'none'}")
    if bad:
        raise AssertionError(f"campaign trace gates failed: {bad}")
    return summary


def phase_campaign(ctx, device="cuda", nchan=NCHAN, nbin=NBIN,
                   nsub=PTA_NSUB, nep=PTA_NEP, nsub_batch=CAMPAIGN_BATCH):
    """The campaign path (phase 16): stream_ipta_campaign over phase 15's
    pulsars A (int16) and B (dithered 2-bit) and pulsar C (nep epochs of
    nsub x nchan x nbin written with nbit=8, levels=4, dithered: bytes the
    transport codec packs to 2 bits), each with its factory .gmodel, A and
    B timed by the campaign's fleet stage with phase 15's parfiles.
    1. run 2 (untraced, codec off), a warm-up (untraced, codec on), run 1
       (traced, codec on; the launch counters set to 0 just before it),
       CAMPAIGN_PAIRS alternating untraced / traced codec-on pairs (the
       tracing cost, medians):
       run 1's trace through the port's validate_trace and report
       (check_campaign_trace); C's shipped bytes below its logical
       bytes, run 1's logical bytes = run 2's shipped bytes; every
       pulsar's .tim identical between runs 1 and 2 (or, if they differ,
       within the spread of a repeat of run 2); B1 and B2 through their
       FFT arms only, held to their plain versions on the largest bucket
       each got in one more untraced codec-on run (B1: A's and C's, B2:
       B's); return codes in {0, 1, 2};
       the timing stage held to phase 15's gates;
    2. each pulsar alone through stream_wideband_TOAs under the same rule
       as 1; A within 0.1 sigma of phase 15's pptoas -m; C against its
       true parfile (fleet_gls_fit, F0 held): residuals < 5 sigma, DMX
       within 5 sigma of the injection;
    3. run 3: C alone with transport_compress='auto' (traced): the cost
       model's decisions on this card's link and the link rate it
       learned;
    4. ``pptoas --stream --telemetry t.jsonl --transport-compress on`` on
       C's metafile, then ``python -m pulseportraiture_tpu_torch.cli
       .pptrace report t.jsonl`` (exit 0).
    Returns the kernel launches of run 1."""
    import io

    import numpy as np
    from pulseportraiture_tpu_torch import config as cfg
    from pulseportraiture_tpu_torch.io.blockcodec import CostModel
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.pipeline.ipta import IPTAJob
    from pulseportraiture_tpu_torch.pipeline.stream import \
        stream_wideband_TOAs
    from pulseportraiture_tpu_torch.telemetry import load_trace, report
    from pulseportraiture_tpu_torch.timing import fleet as FL

    cuda = device_type(device) == "cuda"
    t0 = time.perf_counter()
    c_par = pta_pars(3)[2]
    metaC, filesC, ddmC = pta_campaign(ctx["models"][2], c_par, "C", 8,
                                       device, nchan, nbin, nsub, nep,
                                       levels=4)
    log(f"campaign C: {nep} epochs x {nsub}x{nchan}x{nbin} (nbit 8, 4 "
        f"levels, dithered) written in {time.perf_counter() - t0:.2f} s")
    metas = dict(ctx["meta"], C=metaC)
    tmpl = {"A": ctx["tmpl"][0], "B": ctx["tmpl"][1], "C": ctx["tmpl"][2]}
    names = ("A", "B", "C")
    jobs = [IPTAJob(n, metas[n], tmpl[n]) for n in names]
    tpars = {n: ctx["par"][n] for n in ("A", "B")}
    out = {k: os.path.join(WORK, f"campaign-{k}")
           for k in ("1", "1b", "1c", "k", "2", "2r", "lone", "3")}
    trace = os.path.join(WORK, "campaign.jsonl")

    # 1. run 2, one untraced codec-on run (so that run 1 is warm: the
    # codec's first unpack and its new pinned-buffer sizes), run 1
    r2, w2 = campaign_run(jobs, out["2"], device, nsub_batch, False,
                          timing_pars=tpars)
    campaign_run(jobs, out["1b"], device, nsub_batch, True,
                 timing_pars=tpars)
    rcs = []
    F.reset_kernel_launches()
    r1, w1 = campaign_run(jobs, out["1"], device, nsub_batch, True,
                          telemetry=trace, timing_pars=tpars, rcs=rcs)
    launches = F.kernel_launches()
    # what tracing costs: CAMPAIGN_PAIRS alternating untraced / traced
    # codec-on runs (one pair's two walls differ by the host clock's
    # spread as much as by the trace)
    walls = {"untraced": [], "traced": []}
    for i in range(CAMPAIGN_PAIRS):
        for label in ("untraced", "traced") if i % 2 == 0 else (
                "traced", "untraced"):
            tr = (os.path.join(WORK, f"campaign-pair{i}.jsonl")
                  if label == "traced" else None)
            walls[label].append(campaign_run(
                jobs, out["1c"], device, nsub_batch, True, telemetry=tr,
                timing_pars=tpars)[1])
    # the kernels' inputs, from one more untraced codec-on run (the
    # copies would weigh on run 1's wall): B1's first full bucket is
    # A's, its last C's (the pulsars run in order); nested spies on one
    # function each see every call
    with capture_largest("fused_cross_spectrum") as b1_a, \
            capture_largest("fused_cross_spectrum", last=True) as b1_c, \
            capture_largest("fused_decode_cross_spectrum") as b2_b:
        campaign_run(jobs, out["k"], device, nsub_batch, True)
    ntoa = len(names) * nep * nsub
    med = {k: float(np.median(v)) for k, v in walls.items()}
    txt = {k: ", ".join(f"{w:.3f}" for w in v) for k, v in walls.items()}
    log(f"campaign path (run 2, untraced, codec off): {len(r2.TOA_list)} "
        f"TOAs in {w2:.3f} s; (run 1, traced, codec on): "
        f"{len(r1.TOA_list)} TOAs, {r1.nfit} dispatches in {w1:.3f} s, "
        f"kernel launches {launches}; {CAMPAIGN_PAIRS} alternating pairs, "
        f"codec on: untraced {txt['untraced']} s, traced {txt['traced']} s; "
        f"tracing cost (medians) {med['traced'] - med['untraced']:+.3f} s "
        f"({100 * (med['traced'] / med['untraced'] - 1):+.1f} %)")
    if not (len(r1.TOA_list) == len(r2.TOA_list) == ntoa == len(rcs)):
        raise AssertionError(f"{len(r1.TOA_list)} / {len(r2.TOA_list)} "
                             f"TOAs, {len(rcs)} return codes for {ntoa}")
    if not np.all(np.isin(rcs, (0, 1, 2))):
        raise AssertionError(f"return codes {sorted(set(rcs))}")
    if cuda:
        fft_only(launches, ("fused_cross_spectrum",
                            "fused_decode_cross_spectrum"), "campaign")
    check_campaign_trace(trace, r1, names, "C")
    pc = r1.per_pulsar["C"]
    logical = {n: r1.per_pulsar[n].h2d_bytes_logical for n in names}
    shipped2 = {n: r2.per_pulsar[n].h2d_bytes for n in names}
    log(f"campaign path (codec): C shipped {pc.h2d_bytes} of "
        f"{pc.h2d_bytes_logical} logical bytes "
        f"({pc.h2d_bytes_logical / pc.h2d_bytes:.3f}x) in "
        f"{pc.codec_duration:.3f} s of probe+encode; run 1 logical "
        f"{logical}, run 2 shipped {shipped2}")
    if not (pc.h2d_bytes < pc.h2d_bytes_logical and logical == shipped2):
        raise AssertionError("codec byte accounting")
    t1, t2 = campaign_tims(out["1"], names), campaign_tims(out["2"], names)
    spread = tims_spread(t1, t2)
    limit = 0.0
    if spread:
        campaign_run(jobs, out["2r"], device, nsub_batch, False,
                     timing_pars=tpars)
        limit = tims_spread(t2, campaign_tims(out["2r"], names))
    log(f"campaign path (.tim, runs 1 vs 2: tracing and codec on vs "
        f"off): largest difference {spread:.3e} sigma (limit {limit:.3e}, "
        "the spread of a repeat of run 2; 0 = identical lines)")
    if spread > limit:
        raise AssertionError(f"runs 1 and 2 differ by {spread} sigma")
    for n in ("A", "B"):
        check_timing_solution(r1.timing.results[n], ctx["true_par"][n],
                              ctx["ddms"][n], f"campaign path (timing {n})")
    if cuda:
        check_campaign_kernels(b1_a, b1_c, b2_b)

    # 2. each pulsar alone; A against phase 15's GetTOAs; C's injection
    os.makedirs(out["lone"], exist_ok=True)
    t0 = time.perf_counter()
    for n in names:
        path = os.path.join(out["lone"], f"{n}.tim")
        stream_wideband_TOAs(metas[n], tmpl[n], nsub_batch=nsub_batch,
                             quiet=True, tim_out=path, device=device)
    lone = campaign_tims(out["lone"], names)
    d_lone = tims_spread(t1, lone)
    ref_a = read_tim(ctx["tim_A"])
    d_a = max(tim_sigma_offset(ref_a[k], t1["A"][k]) for k in ref_a)
    cfit = FL.fleet_gls_fit([FL.TimingJob("C", os.path.join(
        out["1"], "C.tim"), dict(c_par))], fit_f0=False, device=device)
    rc_ = cfit.results["C"]
    pulls = np.abs(rc_.time_resids_us) / rc_.toa_errs_us
    dmx_pull = np.abs(rc_.dmx - ddmC) / rc_.dmx_errs
    log(f"campaign path (lone runs, {time.perf_counter() - t0:.3f} s): "
        f"largest difference from the campaign {d_lone:.3e} sigma (limit "
        f"{limit:.3e}); A vs phase 15's pptoas -m {d_a:.4f} sigma (limit "
        f"0.1); C against its true parfile: max |resid| "
        f"{pulls.max():.2f} sigma, max |DMX - dDM| {dmx_pull.max():.2f} "
        f"sigma (limits 5)")
    if not (d_lone <= limit and d_a <= 0.1 and pulls.max() < 5.0
            and dmx_pull.max() < 5.0):
        raise AssertionError("campaign path: lone runs, A or C")

    # 3. C alone, 'auto'
    trace3 = os.path.join(WORK, "campaign-auto.jsonl")
    _, w3 = campaign_run([jobs[2]], out["3"], device, nsub_batch, "auto",
                         telemetry=trace3)
    # the pipeline's cost model, replayed from its own h2d_done records
    cm = CostModel()
    for e in load_trace(trace3)[1]:
        if e["type"] == "h2d_done":
            cm.observe_link(e["bytes"], e["h2d_s"])
    s3 = report(trace3, file=io.StringIO())
    link = cm.link_bps / 1e9 if cm.link_bps else float("nan")
    log(f"campaign path (run 3, C alone, transport_compress='auto'): "
        f"{w3:.3f} s, decisions {s3['codec_decisions']}, shipped "
        f"{s3['h2d_bytes']} of {s3['h2d_bytes_logical']} logical bytes; "
        f"the cost model's learned link rate {link:.3f} GB/s (copy wall "
        "incl. stacking and pinning), codec rate seed "
        f"{CostModel.CODEC_BPS_SEED / 1e9:.3f} GB/s")

    # 4. the CLI and pptrace
    tcli = os.path.join(WORK, "campaign-cli.jsonl")
    timc = os.path.join(WORK, "campaign-cli.tim")
    if os.path.exists(timc):
        os.remove(timc)
    saved = cfg.transport_compress
    try:
        wc, lc, _ = run_tool("pptoas", [
            "--stream", "-d", metaC, "-m", tmpl["C"], "-o", timc,
            "--telemetry", tcli, "--transport-compress", "on", "--quiet",
            "--device", device], "pptoas --stream --telemetry (C)")
    finally:
        cfg.transport_compress = saved
    r = subprocess.run([sys.executable, "-m",
                        "pulseportraiture_tpu_torch.cli.pptrace", "report",
                        tcli], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    link_lines = [ln.strip() for ln in r.stdout.splitlines()
                  if "compression" in ln or "decisions" in ln]
    log(f"campaign path (pptoas --stream --telemetry --transport-compress "
        f"on, C): {wc:.3f} s, kernel launches {lc}; pptrace report exit "
        f"{r.returncode}: {' | '.join(link_lines)}")
    if r.returncode != 0:
        raise AssertionError(f"pptrace report failed: {r.stderr[-2000:]}")
    # the CLI's default nsub_batch puts C in one bucket: held to 0.1
    # sigma, not to identity
    d_cli = tims_spread({"C": t1["C"]}, {"C": read_tim(timc)})
    log(f"campaign path (pptoas --stream C vs the campaign's C): "
        f"{d_cli:.3e} sigma (limit 0.1)")
    if d_cli > 0.1:
        raise AssertionError(f"pptoas --stream C vs the campaign: {d_cli}")
    return launches


def check_campaign_kernels(b1_a, b1_c, b2_b):
    """B1 on A's and on C's (unpacked) largest bucket and B2 on B's,
    each against its plain version (check_cross_spectrum_case,
    check_decode_case: phase 15's tolerances)."""
    import torch

    for label, call in (("A", b1_a), ("C unpacked", b1_c)):
        (port, model, w, K), k = call[0][0][:4], call[0][1]
        check_cross_spectrum_case(dict(
            name=f"campaign {label} bucket {tuple(port.shape)} K={K}",
            port=port, model=model, w=w, K=K, fold=k.get("fold"),
            want_m2=k.get("want_m2", False), arm=None))
    (raw, scl, offs, model, w, K), k = b2_b[0]
    check_decode_case(dict(
        name=f"campaign B bucket {tuple(raw.shape)} K={K}", raw=raw,
        scl=scl, offs=offs, model=model, w=w, K=K, code=k["code"],
        nbin=k["nbin"], fold=k.get("fold"), arm=None))
    del b1_a[:], b1_c[:], b2_b[:]
    torch.cuda.empty_cache()


def check_timing_solution(r, par, ddms, label):
    """Phase 15's timing gates on one pulsar's solution (timing_par's
    parfile: F0, and a binary's PB, perturbed): red chi2 in (0.3, 3),
    every residual < 5 sigma, every DMX within max(4 sigma, 3e-5) of its
    injected dDM, dF0 within 1 %, dPB within 5 sigma."""
    import numpy as np

    f0 = 1.0 / par["P0"]
    dF0 = -f0 * PTA_F0_REL
    pulls = np.abs(r.time_resids_us) / r.toa_errs_us
    dmx_off = np.abs(r.dmx - ddms)
    dmx_lim = np.maximum(4.0 * r.dmx_errs, 3e-5)
    f0_rel = abs(r.params["F0"] / dF0 - 1.0)
    line = (f"{label}: {len(r.time_resids_us)} TOAs, red chi2 "
            f"{r.red_chi2:.3f} (limit (0.3, 3)), wrms {r.wrms_us:.4f} us, "
            f"max |resid| {pulls.max():.2f} sigma (limit 5), max |DMX - "
            f"dDM| / limit {float(np.max(dmx_off / dmx_lim)):.3f}, dF0 "
            f"{r.params['F0']:.4e} +/- {r.param_errs['F0']:.2e} (injected "
            f"{dF0:.4e}, off {100 * f0_rel:.3f} %, limit 1 %)")
    ok = (0.3 < r.red_chi2 < 3.0 and pulls.max() < 5.0
          and np.all(dmx_off <= dmx_lim) and f0_rel <= 0.01)
    if "PB" in par:
        dpb = abs(r.params["PB"] + PTA_DPB) / r.param_errs["PB"]
        line += (f", dPB {r.params['PB']:.3e} +/- {r.param_errs['PB']:.1e}"
                 f" (injected {-PTA_DPB:.1e}, {dpb:.2f} sigma, limit 5)")
        ok = ok and dpb < 5.0
    log(line)
    if not ok:
        raise AssertionError(line)


@contextlib.contextmanager
def capture_calls(name):
    """Inside the block, keep a copy of the inputs of every call to
    ``ops.fused.<name>``, in call order: [(args, kwargs)].  The calls
    themselves, and their launch counts, are unchanged."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F

    kept = []
    orig = getattr(F, name)

    def spy(*a, **k):
        kept.append((tuple(x.clone() if torch.is_tensor(x) else x
                           for x in a), dict(k)))
        return orig(*a, **k)

    setattr(F, name, spy)
    try:
        yield kept
    finally:
        setattr(F, name, orig)


@contextlib.contextmanager
def collect_return_codes(rcs):
    """Inside the block, every assembled archive's subint return codes
    are appended to ``rcs`` (the stream lane's _assemble_archive)."""
    from pulseportraiture_tpu_torch.pipeline import stream as S

    orig = S._assemble_archive

    def assemble(m, results, *a, **k):
        rcs.extend(int(results[(m.iarch, int(i))]["return_code"])
                   for i in m.ok if (m.iarch, int(i)) in results)
        return orig(m, results, *a, **k)

    S._assemble_archive = assemble
    try:
        yield rcs
    finally:
        S._assemble_archive = orig


def served_phase_recovery(tim):
    """Largest |dphi| [rot] of a .tim's TOAs against the injection (the
    -phs flag of print_phase) and its TOA count; raises on a non-finite
    line."""
    worst, n = 0.0, 0
    for rec in read_tim(tim).values():
        phi = float(rec["flags"]["-phs"])
        if not all(math.isfinite(x) for x in (rec["err"], phi, rec["DM"])):
            raise AssertionError(f"non-finite TOA line in {tim}")
        worst = max(worst, abs((phi - expected_phase(rec["freq"]) + 0.5)
                               % 1.0 - 0.5))
        n += 1
    return worst, n


def serve_dispatches(trace):
    """Per dispatch of a serve trace, in seq order: (seq, shape, cold,
    worker seconds (dispatch -> dispatched: the copy, and the fit
    worker's enqueue), drain wait seconds, requests)."""
    from pulseportraiture_tpu_torch.telemetry import load_trace

    events = load_trace(trace)[1]
    by = {}
    for e in events:
        if e["type"] in ("dispatch", "dispatched", "drain",
                         "batch_coalesce"):
            by.setdefault(e["seq"], {})[e["type"]] = e
    out = []
    for seq in sorted(by):
        r = by[seq]
        if "dispatch" not in r:
            continue
        d = r["dispatch"]
        out.append((seq, d["shape"], bool(d["cold"]),
                    r["dispatched"]["t"] - d["t"], r["drain"]["wait_s"],
                    tuple(r["batch_coalesce"]["requests"])))
    return out


def request_latencies(trace, suffix):
    """(p50, p99, mean queue wait, mean serve) [s] of the requests of
    one pass (names ending in ``suffix``) from its request_done events."""
    import numpy as np
    from pulseportraiture_tpu_torch.telemetry import load_trace

    done = [e for e in load_trace(trace)[1] if e["type"] == "request_done"
            and e["req"].endswith(suffix)]
    walls = np.asarray([e["wall_s"] for e in done])
    queues = np.asarray([e["queue_s"] for e in done])
    return (float(np.percentile(walls, 50)), float(np.percentile(walls, 99)),
            float(queues.mean()), float((walls - queues).mean()))


def host_memory():
    """(resident set bytes of this process, pinned host bytes the
    caching host allocator holds or None where torch does not report
    it)."""
    import torch

    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    stats = getattr(torch.cuda, "host_memory_stats", None)
    pinned = None
    if stats is not None:
        try:
            st = stats()
            pinned = st.get("reserved_bytes.current",
                            st.get("allocated_bytes.current"))
        except RuntimeError:
            pinned = None
    return rss, pinned


def phase_serve(device="cuda", nsub=NSUB, narch=NARCH,
                nsub_batch=NSUB_BATCH, max_wait_ms=SERVE_WAIT_MS):
    """The serve path (phase 17), on phase 6's archives and .gmodel:
    R1 = the first SERVE_SPLIT 2-bit archives, R2 = the other 2-bit
    archives, R3 = the main path's int16 archive (a partial bucket the
    deadline flushes), each with print_phase.
    0. the one-shot stream_wideband_TOAs of each request's archives with
       the same nsub_batch (the byte-identity references and their
       dispatches), and of all of them (the one-shot warm TOAs/s);
    1. round 1, cold and traced: ``ppserve -r requests.jsonl`` in this
       process with the counters set to 0 just before it (the three
       requests submitted at once): every .tim byte-identical to its
       one-shot reference, every TOA within 1e-4 rot of the injection,
       every return code in {0, 1, 2}, a bucket that coalesced >= 2
       requests, B2 on the 2-bit buckets and B1 on the int16 one through
       their FFT arms only, B2 held to its plain version on the first
       mixed bucket and B1 on R3's padded bucket;
    2. round 2: a library ToaServer warmed from round 1's trace serves
       the three requests three times: pass 1 with no cold dispatch,
       pass 2 timed (served TOAs/s, latencies, bytes to the card), pass
       3 under the profiler and ended by stop(drain=True) right after
       its submits (every request resolved by the drain); every .tim
       byte-identical to its reference;
    3. round 3, the cold start of a process: ``ppserve -r`` in two fresh
       processes, without and with ``--warmup-manifest`` round 1's
       trace: every .tim byte-identical to its reference, no cold
       dispatch after the warm-up.
    Prints the first dispatch's cost per shape in rounds 1 and 3 (cold)
    and after the warm-ups against round 2's warm pass, the warm-ups'
    wall per shape, and this process's host memory after each pass.
    Returns round 1's kernel launches and what phase 18 reuses: the
    requests, their one-shot references, the request file, round 1's
    trace (the warm-up manifest), and the served and one-shot warm
    TOAs/s."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pulseportraiture_tpu_torch.pipeline.stream import \
        stream_wideband_TOAs
    from pulseportraiture_tpu_torch.serve import ToaServer
    from pulseportraiture_tpu_torch.telemetry import (load_trace, report,
                                                      validate_trace)

    cuda = device_type(device) == "cuda"
    files = [os.path.join(WORK, f"fake2bit-{i}.fits") for i in range(narch)]
    int16 = os.path.join(WORK, "fake.fits")
    gmodel = os.path.join(WORK, "model.gmodel")
    split = min(SERVE_SPLIT, narch - 1)
    reqs = [("R1", files[:split]), ("R2", files[split:]), ("R3", [int16])]
    ntoa = (narch + 1) * nsub
    sdir = os.path.join(WORK, "serve")
    shutil.rmtree(sdir, ignore_errors=True)
    os.makedirs(sdir)

    # 0. the one-shot references
    one, one_nfit = {}, 0
    for name, fs in reqs:
        one[name] = os.path.join(sdir, f"{name}-one.tim")
        one_nfit += stream_wideband_TOAs(
            fs, gmodel, nsub_batch=nsub_batch, tim_out=one[name],
            quiet=True, print_phase=True, device=device).nfit
    t0 = time.perf_counter()
    r_all = stream_wideband_TOAs(files + [int16], gmodel,
                                 nsub_batch=nsub_batch, quiet=True,
                                 print_phase=True, device=device)
    sync(device)
    one_s = time.perf_counter() - t0

    def check_tims(outdir, suffix=""):
        worst = 0.0
        for name, _ in reqs:
            path = os.path.join(outdir, f"{name}{suffix}.tim")
            with open(path, "rb") as a, open(one[name], "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"served {path} differs from the "
                                         f"one-shot {one[name]}")
            w, n = served_phase_recovery(path)
            if not w < 1e-4:
                raise AssertionError(f"{path}: |dphi| = {w:.3e} rot")
            worst = max(worst, w)
        return worst

    # 1. round 1: the CLI, cold and traced
    rq = os.path.join(sdir, "requests.jsonl")
    with open(rq, "w") as f:
        for name, fs in reqs:
            f.write(json.dumps({"name": name, "datafiles": fs,
                                "modelfile": gmodel,
                                "options": {"print_phase": True}}) + "\n")
    t1 = os.path.join(sdir, "t1.jsonl")
    rcs = []
    with collect_return_codes(rcs), \
            capture_calls("fused_decode_cross_spectrum") as b2, \
            capture_calls("fused_cross_spectrum") as b1:
        w1, launches, _ = run_tool("ppserve", [
            "-r", rq, "-O", os.path.join(sdir, "r1"), "--nsub-batch",
            str(nsub_batch), "--max-wait-ms", str(max_wait_ms),
            "--telemetry", t1, "--quiet", "--device", device],
            "ppserve -r")
    worst = check_tims(os.path.join(sdir, "r1"))
    if len(rcs) != ntoa or not np.all(np.isin(rcs, (0, 1, 2))):
        raise AssertionError(f"serve path: {len(rcs)} return codes for "
                             f"{ntoa} TOAs, values {sorted(set(rcs))}")
    validate_trace(t1)
    s1 = report(t1, file=io.StringIO())
    d1 = serve_dispatches(t1)
    mixed = max(len(d[5]) for d in d1)
    log(f"serve path (round 1, ppserve -r, cold, traced): "
        f"{s1['n_requests']} requests, {ntoa} TOAs in {w1:.3f} s wall "
        f"(incl. loads and the {max_wait_ms:.0f} ms deadline); "
        f"{len(d1)} dispatches (one-shot runs: {one_nfit}), batch "
        f"occupancy {s1['batch_occupancy']:.3f}, largest coalesce "
        f"{mixed} requests; max |dphi| {worst:.3e} rot; every .tim "
        f"byte-identical to its one-shot; kernel launches {launches}")
    if mixed < 2:
        raise AssertionError("serve path: no bucket coalesced two requests")
    if cuda:
        fft_only(launches, ("fused_decode_cross_spectrum",
                            "fused_cross_spectrum"), "the serve path")
        p2 = [d for d in d1 if ":raw:p2:" in d[1]]
        k = next(i for i, d in enumerate(p2) if len(d[5]) >= 2)
        if len(b2) != len(p2):
            raise AssertionError(f"{len(b2)} B2 calls for {len(p2)} 2-bit "
                                 "dispatches")
        (raw, scl, offs, model, w, K), kw = b2[k]
        check_decode_case(dict(
            name=f"serve mixed bucket {tuple(raw.shape)} K={K}", raw=raw,
            scl=scl, offs=offs, model=model, w=w, K=K, code=kw["code"],
            nbin=kw["nbin"], fold=kw.get("fold"), arm=None))
        (port, model, w, K), kw = b1[0][0][:4], b1[0][1]
        check_cross_spectrum_case(dict(
            name=f"serve R3 padded bucket {tuple(port.shape)} K={K}",
            port=port, model=model, w=w, K=K, fold=kw.get("fold"),
            want_m2=kw.get("want_m2", False), arm=None))
    del b1[:], b2[:]
    if cuda:
        torch.cuda.empty_cache()

    # 2. round 2: the library server, warmed from round 1's trace
    t2 = os.path.join(sdir, "t2.jsonl")
    tw = time.perf_counter()
    srv = ToaServer(nsub_batch=nsub_batch, max_wait_ms=max_wait_ms,
                    telemetry=t2, warmup_manifest=t1, warmup_model=gmodel,
                    device=device).start()
    warm_s = time.perf_counter() - tw
    walls, h2d, mem = {}, {}, {}
    handles = []
    for p in (1, 2, 3):
        outdir = os.path.join(sdir, f"r2-{p}")
        os.makedirs(outdir, exist_ok=True)
        prof = (profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                if p == 3 else contextlib.nullcontext())
        b0 = srv._ex.h2d_bytes
        with prof:
            t0 = time.perf_counter()
            handles = [srv.submit(fs, gmodel, name=f"{name}-{p}",
                                  tim_out=os.path.join(outdir,
                                                       f"{name}.tim"),
                                  print_phase=True) for name, fs in reqs]
            if p == 3:
                srv.stop(drain=True)
                if not all(h.done() for h in handles):
                    raise AssertionError("stop() left a request unresolved")
            res = [h.result(600) for h in handles]
            sync(device)
            walls[p] = time.perf_counter() - t0
        h2d[p] = srv._ex.h2d_bytes - b0
        mem[p] = host_memory()
        if sum(len(r.TOA_list) for r in res) != ntoa:
            raise AssertionError(f"serve path pass {p}: TOA count")
        check_tims(outdir)
    validate_trace(t2)
    d2 = serve_dispatches(t2)
    cold2 = [d for d in d2 if d[2]]
    warmups = [e for e in load_trace(t2)[1]
               if e["type"] == "warmup_compile"]
    lat = request_latencies(t2, "-2")
    busy_ms, rows = profile_rows(prof)
    log(f"serve path (round 2, library ToaServer warmed from round 1's "
        f"trace): warm-up {warm_s:.3f} s, {len(warmups)} (shape x device) "
        f"dispatch(es) {[(e['shape'], e['compile_s']) for e in warmups]}; "
        f"pass 1 {walls[1]:.3f} s with {len(cold2)} cold dispatch(es); "
        f"pass 2 (warm) {ntoa} TOAs in {walls[2]:.3f} s = "
        f"{ntoa / walls[2]:.1f} TOAs/s served vs one-shot warm "
        f"{len(r_all.TOA_list) / one_s:.1f} TOAs/s ({one_s:.3f} s, "
        f"{r_all.nfit} dispatches); pass 2 requests p50 {lat[0]:.3f} s "
        f"p99 {lat[1]:.3f} s, mean queue wait {lat[2]:.3f} s vs serve "
        f"{lat[3]:.3f} s; h2d {h2d[2]} bytes (one-shot "
        f"{r_all.h2d_bytes}); pass 3 (stop(drain=True) after the "
        f"submits, profiler on) {walls[3]:.3f} s, device busy "
        f"{busy_ms:.3f} ms (idle share "
        f"{1.0 - busy_ms / (walls[3] * 1e3):.3f})")
    for us, key, n in rows[:8]:
        log(f"  {us / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")
    log("serve path (host memory after passes 1, 2, 3: resident bytes, "
        f"pinned bytes held): {[mem[p] for p in (1, 2, 3)]}")
    if cold2:
        raise AssertionError(f"serve path: {len(cold2)} cold dispatch(es) "
                             "after the warm-up")

    # 3. the cold start of a process: ppserve -r in fresh processes
    fresh = {}
    for tag, extra in (("cold", []), ("warm", [
            "--warmup-manifest", t1, "--warmup-model", gmodel])):
        tr = os.path.join(sdir, f"t3-{tag}.jsonl")
        outdir = os.path.join(sdir, f"r3-{tag}")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "pulseportraiture_tpu_torch.cli.ppserve",
             "-r", rq, "-O", outdir, "--nsub-batch", str(nsub_batch),
             "--max-wait-ms", str(max_wait_ms), "--telemetry", tr,
             "--quiet", "--device", device] + extra, cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        if r.returncode:
            raise AssertionError(f"ppserve -r ({tag}, a fresh process) "
                                 f"exited {r.returncode}: {r.stderr[-2000:]}")
        check_tims(outdir)
        validate_trace(tr)
        fresh[tag] = (time.perf_counter() - t0, serve_dispatches(tr), [
            (e["shape"], e["compile_s"]) for e in load_trace(tr)[1]
            if e["type"] == "warmup_compile"])
    if any(d[2] for d in fresh["warm"][1]):
        raise AssertionError("serve path: a cold dispatch after the "
                             "warm-up in a fresh process")
    log(f"serve path (round 3, ppserve -r in fresh processes): without a "
        f"warm-up {fresh['cold'][0]:.3f} s, with --warmup-manifest "
        f"{fresh['warm'][0]:.3f} s (warm-up {fresh['warm'][2]}); every "
        ".tim byte-identical to its one-shot")
    # the first dispatch's cost per shape (worker: dispatch -> dispatched;
    # wait: the drain's), against round 2's warm pass
    for shape in sorted({d[1] for d in d1}):
        def first(ds, pred=lambda d: True):
            d = next(d for d in ds if d[1] == shape and pred(d))
            return f"{d[3]:.4f} + {d[4]:.4f} s (cold {d[2]})"

        warm = [d for d in d2 if d[1] == shape and d[5][0].endswith("-2")]
        log(f"serve path (first dispatch, {shape}, worker + drain wait): "
            f"fresh process {first(fresh['cold'][1])}, after its warm-up "
            f"{first(fresh['warm'][1])}; round 1 {first(d1)}, round 2 "
            f"after the warm-up "
            f"{first(d2, lambda d: d[5][0].endswith('-1'))}; round 2 "
            f"warm pass average {np.mean([d[3] for d in warm]):.4f} + "
            f"{np.mean([d[4] for d in warm]):.4f} s over {len(warm)}")
    ctx = dict(reqs=reqs, one=one, rq=rq, t1=t1, gmodel=gmodel, ntoa=ntoa,
               nsub_batch=nsub_batch, max_wait_ms=max_wait_ms,
               served_tps=ntoa / walls[2],
               one_tps=len(r_all.TOA_list) / one_s)
    return launches, ctx


def check_routed_tims(outdir, one, names=None):
    """Every routed ``<name>.tim`` of ``outdir`` byte-identical to its
    one-shot reference, with no duplicated line, and every TOA within
    1e-4 rot of the injection; returns the largest |dphi|."""
    worst = 0.0
    for name in (names or one):
        path = os.path.join(outdir, f"{name}.tim")
        with open(path, "rb") as a, open(one[name], "rb") as b:
            got = a.read()
            if got != b.read():
                raise AssertionError(f"routed {path} differs from the "
                                     f"one-shot {one[name]}")
        lines = [ln for ln in got.decode().splitlines() if ln.strip()]
        if len(lines) != len(set(lines)):
            raise AssertionError(f"{path}: a duplicated line")
        w, _ = served_phase_recovery(path)
        if not w < 1e-4:
            raise AssertionError(f"{path}: |dphi| = {w:.3e} rot")
        worst = max(worst, w)
    return worst


def route_report(trace):
    """(summary, the router section's latency line) of a router trace."""
    from pulseportraiture_tpu_torch.telemetry import report, validate_trace

    validate_trace(trace)
    buf = io.StringIO()
    summary = report(trace, file=buf)
    lat = next((ln.strip() for ln in buf.getvalue().splitlines()
                if "routed latency" in ln), "no routed latency line")
    return summary, lat


def route_events(trace, typ):
    from pulseportraiture_tpu_torch.telemetry import load_trace

    return [e for e in load_trace(trace)[1] if e["type"] == typ]


def wait_idle(servers, timeout=300.0):
    """Wait until no request is live on any of ``servers`` (a failover's
    zombie attempt or a hedge's loser finishing)."""
    t_end = time.monotonic() + timeout
    while any(s.stats()["n_live"] for s in servers):
        if time.monotonic() > t_end:
            raise AssertionError("a server stayed busy after its round")
        time.sleep(0.05)


def check_failover(trace, survivor, label):
    """A failover round's gates: at least one route_failover, every
    request resolved without error on the survivor (or collected from
    its durable .tim); returns the failover events."""
    fo = route_events(trace, "route_failover")
    done = route_events(trace, "route_done")
    bad = [e for e in done if e["error"] or e["host"] not in (
        survivor, None) or (e["host"] is None
                            and e.get("failover") != "collected")]
    if not fo or bad:
        raise AssertionError(f"{label}: {len(fo)} route_failover events, "
                             f"unresolved on the survivor: {bad}")
    return fo


def read_listen_line(proc, timeout):
    """The ``ppserve: listening on HOST:PORT`` line of a replica, or
    raise when it does not come within ``timeout`` seconds."""
    import select

    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if ready:
            line = proc.stdout.readline()
            if line.startswith("ppserve: listening on "):
                return line.split()[3]
            if not line and proc.poll() is not None:
                break
    raise AssertionError(f"replica {proc.pid} printed no listening line "
                         f"(exit {proc.poll()})")


def gpu_memory_by_pid(pids):
    """{pid: 'used_memory'} from nvidia-smi --query-compute-apps (pids
    the card reports; a container's pid namespace may hide them)."""
    try:
        r = subprocess.run(["nvidia-smi",
                            "--query-compute-apps=pid,used_memory",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except OSError:
        return {}
    out = {}
    for ln in r.stdout.splitlines():
        parts = [x.strip() for x in ln.split(",")]
        if len(parts) == 2 and parts[0].isdigit() and int(parts[0]) in pids:
            out[int(parts[0])] = parts[1]
    return out


def phase_router(sctx, pctx, device="cuda", replica_prelude=None,
                 replica_timeout=300.0):
    """The router path (phase 18), on phase 17's requests (R1, R2 2-bit,
    R3 int16), one-shot references, request file and trace (the warm-up
    manifest), and phase 15's pulsars A and B with their factory
    templates and two of its averages.
    1. round 1: two library ToaServers on the card (phase 17's
       nsub_batch and deadline, warmed from its trace), each behind a
       TransportServer on 127.0.0.1:0, and ``pproute -r requests.jsonl
       -H a,b --telemetry`` in this process, the counters set to 0 just
       before it: requests on both hosts, B2 on the 2-bit buckets and
       B1 on the int16 one through their FFT arms only, each held to its
       plain version on one routed bucket;
    2. round 2, the codec lane: ``pproute --no-shared-fs
       --transport-compress on``: the router writes every .tim; the
       result frames' bytes, plain and zlib;
    3. round 3, failover in process: host A behind a KillableTransport,
       killed once its first request is placed; every request resolves
       on B (route_failover);
    4. round 4, hedging: hedge_ms at half of round 1's p50 (route_hedge);
    5. round 5, a fleet of processes: two ``python -m
       pulseportraiture_tpu_torch.cli.ppserve --listen 127.0.0.1:0
       --warmup-manifest`` replicas on the card, ``pproute -H`` over
       them, then a library router over them with the replica that took
       the first request killed by SIGKILL; every request resolves on
       the survivor; the survivor stopped by SIGTERM (drain, exit 0), and
       no replica left running;
    6. stream_ipta_campaign(router=) over round 1's fleet on pulsars A
       and B against a server= campaign on the same jobs: per-pulsar
       .tim equal; ``ppfactory --result-cache on`` twice on two
       averages: the second run serves 2/2 from the cache, the same
       bytes.
    Every routed .tim of rounds 1-5 is byte-identical to its one-shot
    reference with no duplicated line, every TOA within 1e-4 rot of the
    injection; the return codes of the in-process rounds in {0, 1, 2}.
    replica_prelude: Python run in each replica before the CLI (the CPU
    rehearsal forces the card's routes there).  Returns the B1 and B2
    launches of rounds 1-4 (the in-process rounds; the replicas'
    launches are their own processes') and what phase 19 merges: round
    3's router trace and the two in-process hosts' traces."""
    import signal

    import numpy as np
    import torch
    from pulseportraiture_tpu_torch import config as cfg
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.pipeline.ipta import (IPTAJob,
                                                          stream_ipta_campaign)
    from pulseportraiture_tpu_torch.serve import (InProcTransport,
                                                  KillableTransport,
                                                  SocketTransport,
                                                  ToaRouter, ToaServer,
                                                  TransportServer)
    from pulseportraiture_tpu_torch.serve import transport as TTR
    from pulseportraiture_tpu_torch.telemetry import load_trace

    cuda = device_type(device) == "cuda"
    reqs, one, rq, t1 = sctx["reqs"], sctx["one"], sctx["rq"], sctx["t1"]
    gmodel, ntoa = sctx["gmodel"], sctx["ntoa"]
    nb, wait_ms = sctx["nsub_batch"], sctx["max_wait_ms"]
    names = [n for n, _ in reqs]
    rdir = os.path.join(WORK, "router")
    shutil.rmtree(rdir, ignore_errors=True)
    os.makedirs(rdir)
    kernels = ("fused_decode_cross_spectrum", "fused_cross_spectrum")
    totals = {k: 0 for k in kernels}

    def count(launches, label):
        if cuda:
            fft_only(launches, kernels, f"the router path ({label})")
        for k in kernels:
            totals[k] += launches[k]

    # the two in-process hosts, warmed from phase 17's trace
    t0 = time.perf_counter()
    straces = [os.path.join(rdir, f"s{i}.jsonl") for i in range(2)]
    servers = [ToaServer(nsub_batch=nb, max_wait_ms=wait_ms, telemetry=tr,
                         warmup_manifest=t1, warmup_model=gmodel,
                         device=device).start() for tr in straces]
    listeners = [TransportServer(s, host="127.0.0.1", port=0).start()
                 for s in servers]
    hosts = [ls.label for ls in listeners]
    log(f"router path: 2 warm in-process hosts {hosts} up in "
        f"{time.perf_counter() - t0:.3f} s")
    procs = []
    try:
        # 1. round 1: pproute over sockets, traced
        r1 = os.path.join(rdir, "r1.jsonl")
        rcs = []
        with collect_return_codes(rcs), \
                capture_calls("fused_decode_cross_spectrum") as b2, \
                capture_calls("fused_cross_spectrum") as b1:
            w1, launches, _ = run_tool("pproute", [
                "-r", rq, "-O", os.path.join(rdir, "r1"), "-H",
                ",".join(hosts), "--telemetry", r1, "--quiet", "--device",
                device], "pproute (round 1)")
        worst = check_routed_tims(os.path.join(rdir, "r1"), one)
        if len(rcs) != ntoa or not np.all(np.isin(rcs, (0, 1, 2))):
            raise AssertionError(f"router path: {len(rcs)} return codes for "
                                 f"{ntoa} TOAs, values {sorted(set(rcs))}")
        s1, lat1 = route_report(r1)
        subs = route_events(r1, "route_submit")
        placed = {}
        for e in subs:
            d = placed.setdefault(e["host"], [0, 0, []])
            d[0] += 1
            d[1] += e["n_archives"]
            d[2].append(e["req"])
        walls = {e["req"]: e["wall_s"] for e in route_events(r1, "route_done")}
        host_wall = {}
        for tr in straces:
            for e in load_trace(tr)[1]:
                if e["type"] == "request_done" and e["req"] in walls:
                    host_wall.setdefault(e["req"], e["wall_s"])
        over = [walls[n] - host_wall[n] for n in names]
        p50 = float(np.percentile(list(walls.values()), 50))
        log(f"router path (round 1, pproute -H over 2 in-process hosts, "
            f"traced): {len(subs)} requests, {ntoa} TOAs in {w1:.3f} s = "
            f"{ntoa / w1:.1f} routed TOAs/s (phase 17 on these archives: "
            f"served {sctx['served_tps']:.1f}, one-shot warm "
            f"{sctx['one_tps']:.1f} TOAs/s; two processes' loads overlap on "
            f"one card, not a scale-out figure); host shares (requests, "
            f"archives, names) {placed}; {lat1}; router overhead (route_done "
            f"wall - the host's request_done wall) {[round(x, 4) for x in over]}"
            f" s; max |dphi| {worst:.3e} rot; kernel launches {launches}")
        if len(placed) != 2:
            raise AssertionError(f"router path: round 1 placed on "
                                 f"{sorted(placed)} only")
        count(launches, "round 1")
        if cuda:
            p2 = [c for c in b2 if c[1].get("code") == "p2"]
            (raw, scl, offs, model, w, K), kw = p2[0]
            check_decode_case(dict(
                name=f"router round 1 bucket {tuple(raw.shape)} K={K}",
                raw=raw, scl=scl, offs=offs, model=model, w=w, K=K,
                code=kw["code"], nbin=kw["nbin"], fold=kw.get("fold"),
                arm=None))
            (port, model, w, K), kw = b1[0][0][:4], b1[0][1]
            check_cross_spectrum_case(dict(
                name=f"router round 1 int16 bucket {tuple(port.shape)} "
                     f"K={K}", port=port, model=model, w=w, K=K,
                fold=kw.get("fold"), want_m2=kw.get("want_m2", False),
                arm=None))
        del b1[:], b2[:]
        wait_idle(servers)

        # 2. round 2: the codec lane, frames compressed
        frames = []
        orig_send = TTR._send_frame

        def spy(sock, obj):
            if isinstance(obj, dict) and "result" in obj:
                import zlib

                body = json.dumps(obj, separators=(",", ":")).encode()
                frames.append((len(obj["result"]["order"]), len(body),
                               len(zlib.compress(body, 1))))
            return orig_send(sock, obj)

        saved = cfg.transport_compress
        TTR._send_frame = spy
        try:
            w2, launches, _ = run_tool("pproute", [
                "-r", rq, "-O", os.path.join(rdir, "r2"), "-H",
                ",".join(hosts), "--no-shared-fs", "--transport-compress",
                "on", "--quiet", "--device", device], "pproute (round 2)")
        finally:
            TTR._send_frame = orig_send
            cfg.transport_compress = saved
        check_routed_tims(os.path.join(rdir, "r2"), one)
        log(f"router path (round 2, pproute --no-shared-fs "
            f"--transport-compress on): {w2:.3f} s; every .tim written by "
            f"the router, byte-identical; result frames (archives, plain "
            f"bytes, zlib bytes; zlib sent from {TTR.COMPRESS_MIN_FRAME} "
            f"bytes) {frames}; kernel launches {launches}")
        count(launches, "round 2")
        wait_idle(servers)

        # 3. round 3: failover in process
        r3 = os.path.join(rdir, "r3.jsonl")
        ka = KillableTransport(SocketTransport(hosts[0]))
        router = ToaRouter([ka, SocketTransport(hosts[1])], telemetry=r3)
        F.reset_kernel_launches()
        out3 = os.path.join(rdir, "r3")
        os.makedirs(out3)
        try:
            hs = [router.submit(reqs[0][1], gmodel, name=reqs[0][0],
                                tim_out=os.path.join(out3,
                                                     f"{reqs[0][0]}.tim"),
                                print_phase=True)]
            if hs[0].host.label != hosts[0]:
                raise AssertionError(f"round 3: {reqs[0][0]} placed on "
                                     f"{hs[0].host.label}, not host A")
            t_kill = time.perf_counter()
            ka.kill()
            hs += [router.submit(fs, gmodel, name=name,
                                 tim_out=os.path.join(out3, f"{name}.tim"),
                                 print_phase=True) for name, fs in reqs[1:]]
            for h in hs:
                h.result(600)
            w_fail = time.perf_counter() - t_kill
        finally:
            router.close()
        wait_idle(servers)  # the killed attempt, a zombie, rewrites alike
        sync(device)
        launches = F.kernel_launches()
        check_routed_tims(out3, one)
        fo = check_failover(r3, hosts[1], "round 3")
        log(f"router path (round 3, host A killed after its first "
            f"placement): failover wall (kill -> last request resolved) "
            f"{w_fail:.3f} s; failovers {[(e['req'], e['action']) for e in fo]}"
            f"; every request resolved on {hosts[1]}, byte-identical; "
            f"kernel launches {launches}")
        count(launches, "round 3")

        # 4. round 4: hedging below round 1's p50
        r4 = os.path.join(rdir, "r4.jsonl")
        hedge_ms = 0.5 * p50 * 1e3
        router = ToaRouter([SocketTransport(h) for h in hosts],
                           hedge_ms=hedge_ms, telemetry=r4)
        F.reset_kernel_launches()
        t0 = time.perf_counter()
        out4 = os.path.join(rdir, "r4")
        os.makedirs(out4)
        try:
            for h in [router.submit(fs, gmodel, name=name,
                                    tim_out=os.path.join(out4, f"{name}.tim"),
                                    print_phase=True) for name, fs in reqs]:
                h.result(600)
            w4 = time.perf_counter() - t0
            t_end = time.monotonic() + 300
            while router._orphans and time.monotonic() < t_end:
                time.sleep(0.05)  # the losers reaped
        finally:
            router.close()
        wait_idle(servers)
        sync(device)
        launches = F.kernel_launches()
        check_routed_tims(out4, one)
        hedges = route_events(r4, "route_hedge")
        done = {e["req"]: e for e in route_events(r4, "route_done")}
        won = [e["req"] for e in hedges if done[e["req"]]["host"] == e["host"]]
        log(f"router path (round 4, hedge_ms {hedge_ms:.1f}): {w4:.3f} s; "
            f"{len(hedges)} hedges launched, {len(won)} won by the hedge "
            f"{won}; every .tim router-written, byte-identical; kernel "
            f"launches {launches}")
        if not hedges:
            raise AssertionError("router path: round 4 launched no hedge")
        count(launches, "round 4")

        # 6a. the campaign over round 1's fleet against server=
        jobs = [IPTAJob(n, pctx["meta"][n], pctx["tmpl"][i])
                for i, n in enumerate(("A", "B"))]
        router = ToaRouter([SocketTransport(h) for h in hosts])
        t0 = time.perf_counter()
        try:
            res_r = stream_ipta_campaign(
                jobs, outdir=os.path.join(rdir, "camp-router"), quiet=True,
                router=router, device=device)
            wr = time.perf_counter() - t0
            camp_placed = {k: v["n_requests"]
                           for k, v in router.stats().items()}
        finally:
            router.close()
        t0 = time.perf_counter()
        stream_ipta_campaign(jobs, outdir=os.path.join(rdir, "camp-server"),
                             quiet=True, server=servers[0], device=device)
        ws = time.perf_counter() - t0
        for n in ("A", "B"):
            a = os.path.join(rdir, "camp-router", f"{n}.tim")
            with open(a, "rb") as fa, open(os.path.join(
                    rdir, "camp-server", f"{n}.tim"), "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f"campaign {n}: router= and "
                                         "server= .tim differ")
        log(f"router path (stream_ipta_campaign(router=) on A and B): "
            f"{len(res_r.TOA_list)} TOAs in {wr:.3f} s (server= {ws:.3f} s),"
            f" placed {camp_placed}; per-pulsar .tim equal to the server= "
            "run's")
    finally:
        for ls in listeners:
            ls.close()
        for s in servers:
            s.stop(drain=True)
    if cuda:
        torch.cuda.empty_cache()

    # 5. round 5: a fleet of processes on the card
    cmd = [sys.executable, "-m", "pulseportraiture_tpu_torch.cli.ppserve"]
    if replica_prelude is not None:
        cmd = [sys.executable, "-c", replica_prelude + "\n"
               "import runpy, sys\nsys.argv = ['ppserve'] + sys.argv[1:]\n"
               "runpy.run_module('pulseportraiture_tpu_torch.cli.ppserve',"
               " run_name='__main__')"]
    ptraces = [os.path.join(rdir, f"p{i}.jsonl") for i in range(2)]
    try:
        # one after the other, so that the card's free memory before and
        # after each start is that replica's footprint
        addrs, up, used = [], [], []
        for i in range(2):
            free0 = torch.cuda.mem_get_info()[0] if cuda else 0
            err = open(os.path.join(rdir, f"p{i}.err"), "w")
            t0 = time.perf_counter()
            procs.append(subprocess.Popen(
                cmd + ["--listen", "127.0.0.1:0", "--warmup-manifest", t1,
                       "--warmup-model", gmodel, "--nsub-batch", str(nb),
                       "--max-wait-ms", str(wait_ms), "--telemetry",
                       ptraces[i], "--device", device, "--quiet"], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=err, text=True))
            err.close()
            addrs.append(read_listen_line(procs[-1], replica_timeout))
            up.append(time.perf_counter() - t0)
            used.append(free0 - torch.cuda.mem_get_info()[0] if cuda else 0)
        mem = gpu_memory_by_pid({p.pid for p in procs})
        log(f"router path (round 5): replicas {addrs} (pids "
            f"{[p.pid for p in procs]}) listening {[round(x, 3) for x in up]}"
            f" s after their start, warm-ups included; card memory taken by "
            f"each (free memory before - after its start) "
            f"{[round(u / 2 ** 30, 3) for u in used]} GiB; nvidia-smi by pid "
            f"{mem or 'reports none of these pids'}")
        r5 = os.path.join(rdir, "r5.jsonl")
        w5, _, _ = run_tool("pproute", [
            "-r", rq, "-O", os.path.join(rdir, "r5"), "-H", ",".join(addrs),
            "--telemetry", r5, "--quiet", "--device", device],
            "pproute (round 5)")
        check_routed_tims(os.path.join(rdir, "r5"), one)
        s5, lat5 = route_report(r5)
        log(f"router path (round 5, pproute -H over 2 replica processes): "
            f"{ntoa} TOAs in {w5:.3f} s = {ntoa / w5:.1f} routed TOAs/s; "
            f"archives by host {s5['router_host_counts']}; {lat5}")
        # the kill: SIGKILL the replica that took the first request
        r5k = os.path.join(rdir, "r5k.jsonl")
        out5 = os.path.join(rdir, "r5k")
        os.makedirs(out5)
        router = ToaRouter(list(addrs), telemetry=r5k)
        try:
            hs = [router.submit(reqs[0][1], gmodel, name=reqs[0][0],
                                tim_out=os.path.join(out5,
                                                     f"{reqs[0][0]}.tim"),
                                print_phase=True)]
            victim = addrs.index(hs[0].host.label)
            t_kill = time.perf_counter()
            os.kill(procs[victim].pid, signal.SIGKILL)
            procs[victim].wait(60)
            hs += [router.submit(fs, gmodel, name=name,
                                 tim_out=os.path.join(out5, f"{name}.tim"),
                                 print_phase=True) for name, fs in reqs[1:]]
            for h in hs:
                h.result(600)
            w_fail5 = time.perf_counter() - t_kill
            states = {k: v["state"] for k, v in router.stats().items()}
        finally:
            router.close()
        survivor = addrs[1 - victim]
        check_routed_tims(out5, one)
        fo5 = check_failover(r5k, survivor, "round 5")
        procs[1 - victim].send_signal(signal.SIGTERM)
        rc_surv = procs[1 - victim].wait(120)
        warm = {}
        for i, tr in enumerate(ptraces):
            try:
                warm[addrs[i]] = [(e["shape"], e["compile_s"])
                                  for e in load_trace(tr)[1]
                                  if e["type"] == "warmup_compile"]
            except (OSError, ValueError) as e:  # the killed one's tail
                warm[addrs[i]] = f"trace unreadable ({e})"

        log(f"router path (round 5, replica {addrs[victim]} SIGKILLed after "
            f"its first placement): failover wall {w_fail5:.3f} s; failovers "
            f"{[(e['req'], e['action']) for e in fo5]}; states {states}; "
            f"every request resolved on {survivor}, byte-identical; the "
            f"survivor drained and exited {rc_surv} on SIGTERM; warm-ups "
            f"(shape, s) {warm}")
        if rc_surv != 0:
            raise AssertionError(f"replica {survivor} exited {rc_surv}")
    finally:
        left = [p for p in procs if p.poll() is None]
        for p in left:
            p.kill()
            p.wait(30)
        for p in procs:
            if p.stdout is not None:
                p.stdout.close()
    if left:
        raise AssertionError(f"router path: {len(left)} replica process(es) "
                             "were still running at the end")
    log(f"router path: no replica left running ({len(procs)} started)")

    # 6b. the factory's result cache
    meta = os.path.join(rdir, "factory.txt")
    with open(meta, "w") as f:
        f.write("\n".join(pctx["averages"][:2]) + "\n")
    saved = (cfg.result_cache, cfg.cache_dir, cfg.cache_max_mb)
    fwalls, served = [], []
    try:
        for run in (1, 2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                w, _, _ = run_tool("ppfactory", [
                    "-M", meta, "-O", os.path.join(rdir, f"factory{run}"),
                    "--max-ngauss", "2", "--niter", "0", "--result-cache",
                    "on", "--cache-dir", os.path.join(rdir, "store"),
                    "--device", device, "--verbose"], f"ppfactory (run {run})")
            fwalls.append(w)
            served.append(next(ln for ln in buf.getvalue().splitlines()
                               if "served from the result cache" in ln))
    finally:
        cfg.result_cache, cfg.cache_dir, cfg.cache_max_mb = saved
    for f in pctx["averages"][:2]:
        b = os.path.basename(f) + ".gmodel"
        with open(os.path.join(rdir, "factory1", b), "rb") as fa, \
                open(os.path.join(rdir, "factory2", b), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"ppfactory cache: {b} differs")
    log(f"router path (ppfactory --result-cache on, 2 averages): miss "
        f"{fwalls[0]:.3f} s ({served[0]}), hit {fwalls[1]:.3f} s "
        f"({served[1]}); the same bytes")
    if "2/2" not in served[1]:
        raise AssertionError(f"ppfactory cache: {served[1]}")
    return totals, {"r3": r3, "hosts": straces}


def ingest_corpus(kind, folder, gmodel, device, nchan, nbin, nsub, nep):
    """One corpus of phase 19 in ``folder``, each archive with its .done
    sentinel: 'event' (dithered 2-bit, the glitch and the DM step) or
    'clean' (int16, no event), both with the DM wander; returns the
    archives in name order."""
    from pulseportraiture_tpu_torch.synth import make_fake_pulsar
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    event = kind == "event"
    os.makedirs(folder)
    files = []
    for i in range(nep):
        path = os.path.join(folder, f"ep{i:03d}.fits")
        phase = 0.017 + (INGEST_DT / PAR_INGEST["P0"]
                         if event and i >= INGEST_GLITCH_I else 0.0)
        ddm = INGEST_WANDER * ((i % 3) - 1) + (
            INGEST_DDM if event and i >= INGEST_DM_I else 0.0)
        make_fake_pulsar(gmodel, PAR_INGEST, outfile=path, nsub=nsub,
                         nchan=nchan, nbin=nbin, nu0=1500.0, bw=800.0,
                         tsub=INGEST_TSUB, phase=phase, dDM=ddm,
                         start_MJD=MJD(int(55100 + INGEST_SPACING * i), 0.2),
                         noise_stds=NOISE_2BIT, dedispersed=False,
                         quiet=True, rng=SEED + 190 + i, spin_coherent=True,
                         nbit=2 if event else 16, dither=event, device=device)
        open(path + ".done", "w").close()
        files.append(path)
    return files


def ppwatch_thread(argv):
    """ppwatch.main(argv) on a worker thread, as a library caller runs it
    (its signal handlers are skipped off the main thread); returns (the
    thread, a list that receives its return value or exception)."""
    import threading

    from pulseportraiture_tpu_torch.cli import ppwatch

    out = []

    def run():
        try:
            out.append(ppwatch.main(argv))
        except BaseException as e:  # re-raised by join_ppwatch
            out.append(e)

    th = threading.Thread(target=run, name="ppwatch", daemon=True)
    th.start()
    return th, out


def join_ppwatch(th, out, label, timeout=600.0):
    th.join(timeout)
    if th.is_alive():
        raise AssertionError(f"{label}: ppwatch still running after "
                             f"{timeout:.0f} s")
    if isinstance(out[0], BaseException):
        raise out[0]
    if out[0] != 0:
        raise AssertionError(f"{label}: ppwatch returned {out[0]!r}")


def ingest_stats(trace, tim):
    """A ppwatch trace's figures: (report summary, admission -> TOA
    latencies [s] in admission order (request_done - ingest_admit),
    TOAs/s from the first admission to the last request_done, the
    dispatches as (seq, real rows, requests)).  The .tim gives the TOA
    count."""
    import numpy as np
    from pulseportraiture_tpu_torch.telemetry import (load_trace, report,
                                                      validate_trace)

    validate_trace(trace)
    summary = report(trace, file=io.StringIO())
    events = load_trace(trace)[1]
    admits = [e for e in events if e["type"] == "ingest_admit"]
    done = {e["req"]: e["t"] for e in events if e["type"] == "request_done"}
    lats = np.asarray([done[f"ingest{i}"] - ev["t"]
                       for i, ev in enumerate(admits)])
    with open(tim) as f:
        ntoa = sum(1 for ln in f if ln.strip() and not ln.startswith("C "))
    span = max(done.values()) - min(ev["t"] for ev in admits)
    disp = [(e["seq"], e["rows"], e["n_requests"])
            for e in events if e["type"] == "batch_coalesce"]
    return summary, lats, ntoa / span, disp


def latency_text(summary, lats):
    import numpy as np

    return (f"{summary['n_ingest_admit']} admitted, discovery -> admission "
            f"p50 {summary['ingest_p50_s']:.3f} s, p99 "
            f"{summary['ingest_p99_s']:.3f} s; admission -> TOA p50 "
            f"{np.percentile(lats, 50):.3f} s, p99 "
            f"{np.percentile(lats, 99):.3f} s")


def admitted_files(trace):
    """The archives a ppwatch trace admitted, in admission order (the
    order the streamed .tim follows)."""
    from pulseportraiture_tpu_torch.telemetry import load_trace

    return [e["datafile"] for e in load_trace(trace)[1]
            if e["type"] == "ingest_admit"]


def phase_ingest(rctx, device="cuda", nchan=NCHAN, nbin=NBIN,
                 nsub=INGEST_NSUB, nep=INGEST_NEP,
                 nsub_batch=INGEST_NSUB_BATCH):
    """The ingest path (phase 19): two corpora of ``nep`` epochs
    (ingest_corpus), the default_test_model .gmodel and PAR_INGEST's
    parfile; every streamed .tim is held BYTE-identical to the one-shot
    stream_wideband_TOAs of the same files at ppwatch's nsub_batch.
    1. drain: ``python -m pulseportraiture_tpu_torch.cli.ppwatch -w
       event/ -m model.gmodel -p pulsar.par --drain --stable-ms 0
       --resolve-every 8 --telemetry`` in this process, the counters set
       to 0 just before it: rc 0, exactly one glitch and one dm_step
       alert, each within one day of its injected epoch's MJD, at least
       one full incremental resolve (the drift gate at 1e-10), B2
       through its FFT arm only and held to its plain version on an
       ingest bucket; then the clean corpus the same way: zero alerts,
       B1 through its FFT arm only and held to its plain version;
    2. trickle: ppwatch on a worker thread over an empty folder
       (--stable-ms INGEST_STABLE_MS, no sentinels) while a writer
       thread copies the event archives in one at a time, each in two
       chunks INGEST_PAUSE_S apart: at least one 'truncated' skip;
    3. burst, announce, backpressure: the 12 archives dropped at once
       into a watched folder; 3 paths announced (ingest.announce) to a
       SocketSource of an IngestDriver; a folder of the 12 through an
       IngestDriver on a ToaServer with queue_depth 1: at least one
       'backpressure' skip;
    4. the operator's tools: ``pptrace merge`` (text and --json) over
       phase 18's round 3 traces (rctx; None, in a CPU rehearsal, leaves
       this out): each round 3 request exactly once, with its host
       spans, its failover and its critical stage; a ToaServer behind a
       TransportServer and a ToaRouter over it behind a monitor
       TransportServer serve one clean archive, then ``ppmon --once
       --json`` against both endpoints (exit 0, the fleet p99 present)
       and ``ppmon --once``.
    Prints each round's wall, the admitted count, discovery -> admission
    and admission -> TOA p50/p99, TOAs/s and the dispatches (real rows,
    requests).  Returns the kernels' launches over the phase."""
    import threading

    import torch
    from pulseportraiture_tpu_torch import config as cfg
    from pulseportraiture_tpu_torch.ingest import (IngestDriver,
                                                   SocketSource,
                                                   WatchFolderSource,
                                                   announce)
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.pipeline.stream import \
        stream_wideband_TOAs
    from pulseportraiture_tpu_torch.serve import (SocketTransport, ToaRouter,
                                                  ToaServer, TransportServer)
    from pulseportraiture_tpu_torch.synth import default_test_model
    from pulseportraiture_tpu_torch.telemetry import load_trace

    cuda = device_type(device) == "cuda"
    idir = os.path.join(WORK, "ingest")
    shutil.rmtree(idir, ignore_errors=True)
    os.makedirs(idir)
    kernels = ("fused_decode_cross_spectrum", "fused_cross_spectrum")
    totals = {k: 0 for k in kernels}

    def count(launches):
        for k in kernels:
            totals[k] += launches[k]
        return {k: launches[k] for k in launches if k.startswith("fused")}

    def check_oneshot(tim, files, label, n):
        """The streamed .tim byte-identical to the one-shot stream of the
        admitted archives in admission order (name order unless a
        deferral reordered them); returns whether it was name order."""
        if len(files) != n:
            raise AssertionError(f"ingest path ({label}): {len(files)} "
                                 f"archives admitted, not {n}")
        ref = os.path.join(idir, f"{label}-one.tim")
        stream_wideband_TOAs(files, gmodel, nsub_batch=nsub_batch,
                             tim_out=ref, quiet=True, device=device)
        with open(tim, "rb") as a, open(ref, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"ingest path ({label}): {tim} "
                                     f"differs from the one-shot {ref}")
        return [os.path.basename(f) for f in files] == sorted(
            os.path.basename(f) for f in files)

    t0 = time.perf_counter()
    gmodel = os.path.join(idir, "model.gmodel")
    write_gmodel(default_test_model(1500.0), gmodel, quiet=True)
    par = os.path.join(idir, "pulsar.par")
    with open(par, "w") as f:
        for k, v in PAR_INGEST.items():
            f.write(f"{k} {v}\n")
    corpus = {kind: ingest_corpus(kind, os.path.join(idir, kind), gmodel,
                                  device, nchan, nbin, nsub, nep)
              for kind in ("event", "clean")}
    sync(device)
    log(f"ingest path: 2 corpora of {nep} epochs x {nsub} x {nchan} x "
        f"{nbin} written in {time.perf_counter() - t0:.3f} s")
    truth = {"glitch": 55100 + INGEST_SPACING * INGEST_GLITCH_I + 0.2,
             "dm_step": 55100 + INGEST_SPACING * INGEST_DM_I + 0.2}

    # 1. drain, the event corpus then the clean one
    for kind, kern in (("event", "fused_decode_cross_spectrum"),
                       ("clean", "fused_cross_spectrum")):
        tim = os.path.join(idir, f"{kind}.tim")
        trace = os.path.join(idir, f"{kind}.jsonl")
        with capture_largest(kern) as big:
            wall, launches, _ = run_tool("ppwatch", [
                "-w", os.path.join(idir, kind), "-m", gmodel, "-t", tim,
                "-p", par, "--drain", "--stable-ms", "0", "--resolve-every",
                "8", "--nsub-batch", str(nsub_batch), "--telemetry", trace,
                "--quiet", "--device", device], f"ppwatch --drain ({kind})")
        summary, lats, tps, disp = ingest_stats(trace, tim)
        check_oneshot(tim, admitted_files(trace), kind, nep)
        alerts = [e for e in load_trace(trace)[1] if e["type"] == "alert"]
        found = [(e["kind"], round(e["mjd"], 4), round(e["score"], 1))
                 for e in alerts]
        log(f"ingest path (drain, {kind}, ppwatch --drain -p): "
            f"{wall:.3f} s; {latency_text(summary, lats)}; {tps:.1f} TOAs/s"
            f"; dispatches (seq, real rows, requests) {disp}; "
            f"{summary['incremental_resolves']} full incremental "
            f"resolves; alerts (kind, MJD, score) {found}; the .tim "
            f"byte-identical to the one-shot; kernel launches "
            f"{count(launches)}")
        if summary["n_ingest_admit"] != nep or not \
                summary["incremental_resolves"]:
            raise AssertionError(
                f"ingest path ({kind}): {summary['n_ingest_admit']} "
                f"admissions, {summary['incremental_resolves']} resolves")
        if kind == "event":
            # the first alert of each kind localizes its injected event;
            # the monitor's later re-alerts of a persistent event are
            # the reference semantics' (PERF.md, ROADMAP C)
            first = {}
            for e in alerts:
                first.setdefault(e["kind"], e)
            early = [e for e in alerts
                     if e["mjd"] < min(truth.values()) - 1.0]
            if set(first) != set(truth) or early or any(
                    abs(first[k]["mjd"] - truth[k]) > 1.0 for k in truth):
                raise AssertionError(f"ingest path (event): alerts {found}"
                                     f" against the injected {truth}")
            log(f"ingest path (event): first glitch and dm_step alerts "
                f"{[(k, round(first[k]['mjd'] - truth[k], 5)) for k in truth]}"
                f" days from their injected epochs; {len(alerts) - 2} "
                f"re-alerts of the persistent events after them")
        elif alerts:
            raise AssertionError(f"ingest path (clean): alerts {found}")
        if cuda:
            fft_only(launches, (kern,), f"the ingest path ({kind})")
            other = [k for k in kernels if k != kern][0]
            if launches[f"{other}.gemm"]:
                raise AssertionError(f"ingest path ({kind}): {other}'s "
                                     "GEMM arm launched")
            if kind == "event":
                (raw, scl, offs, model, w, K), kw = big[0]
                check_decode_case(dict(
                    name=f"ingest bucket {tuple(raw.shape)} K={K}",
                    raw=raw, scl=scl, offs=offs, model=model, w=w, K=K,
                    code=kw["code"], nbin=kw["nbin"], fold=kw.get("fold"),
                    arm=None))
            else:
                (port, model, w, K), kw = big[0][0][:4], big[0][1]
                check_cross_spectrum_case(dict(
                    name=f"ingest int16 bucket {tuple(port.shape)} K={K}",
                    port=port, model=model, w=w, K=K, fold=kw.get("fold"),
                    want_m2=kw.get("want_m2", False), arm=None))
        del big[:]

    def watched(label, feed, extra=()):
        """ppwatch on a worker thread over an empty folder that ``feed``
        fills; returns (folder, .tim, trace, wall)."""
        folder = os.path.join(idir, label)
        os.makedirs(folder)
        tim = os.path.join(idir, f"{label}.tim")
        trace = os.path.join(idir, f"{label}.jsonl")
        F.reset_kernel_launches()
        t0 = time.perf_counter()
        th, out = ppwatch_thread([
            "-w", folder, "-m", gmodel, "-t", tim, "--drain",
            "--idle-polls", "40", "--poll-ms", str(INGEST_POLL_MS),
            "--nsub-batch", str(nsub_batch), "--telemetry", trace,
            "--quiet", "--device", device] + list(extra))
        writer = threading.Thread(target=feed, args=(folder,), daemon=True)
        writer.start()
        writer.join(600)
        join_ppwatch(th, out, f"ppwatch ({label})")
        sync(device)
        return folder, tim, trace, time.perf_counter() - t0

    # 2. trickle: one archive at a time, each in two chunks
    def trickle(folder):
        for src in corpus["event"]:
            with open(src, "rb") as f:
                data = f.read()
            dst = os.path.join(folder, os.path.basename(src))
            with open(dst, "wb") as f:
                f.write(data[:len(data) // 2])
            time.sleep(INGEST_PAUSE_S)
            with open(dst, "ab") as f:
                f.write(data[len(data) // 2:])
            time.sleep(INGEST_GAP_S)

    folder, tim, trace, wall = watched(
        "trickle", trickle, ["--stable-ms", str(INGEST_STABLE_MS)])
    launches = F.kernel_launches()
    summary, lats, tps, disp = ingest_stats(trace, tim)
    check_oneshot(tim, admitted_files(trace), "trickle", nep)
    skips = [e["reason"] for e in load_trace(trace)[1]
             if e["type"] == "ingest_skip"]
    log(f"ingest path (trickle, {nep} archives {INGEST_PAUSE_S + INGEST_GAP_S}"
        f" s apart, two chunks each, --stable-ms {INGEST_STABLE_MS:.0f}, "
        f"--poll-ms {INGEST_POLL_MS:.0f}, deadline "
        f"{cfg.serve_max_wait_ms:.0f} ms): {wall:.3f} s; "
        f"{latency_text(summary, lats)}; {tps:.1f} TOAs/s; skips "
        f"{ {r: skips.count(r) for r in set(skips)} }; {len(disp)} "
        f"dispatches (seq, real rows, requests) {disp}; the .tim "
        f"byte-identical to the one-shot; kernel launches {count(launches)}")
    if "truncated" not in skips or summary["n_ingest_admit"] != nep:
        raise AssertionError(f"ingest path (trickle): skips {skips}, "
                             f"{summary['n_ingest_admit']} admitted")

    # 3a. burst: all at once, with sentinels
    def burst(folder):
        time.sleep(0.5)
        for src in corpus["event"]:
            dst = os.path.join(folder, os.path.basename(src))
            shutil.copyfile(src, dst + ".part")
            os.replace(dst + ".part", dst)
        for src in corpus["event"]:
            open(os.path.join(folder, os.path.basename(src)) + ".done",
                 "w").close()

    folder, tim, trace, wall = watched("burst", burst, ["--stable-ms", "0"])
    launches = F.kernel_launches()
    summary, lats, tps, disp = ingest_stats(trace, tim)
    check_oneshot(tim, admitted_files(trace), "burst", nep)
    log(f"ingest path (burst, {nep} archives dropped at once): {wall:.3f} s;"
        f" {latency_text(summary, lats)}; {tps:.1f} TOAs/s; {len(disp)} "
        f"dispatches (seq, real rows, requests) {disp}; the .tim "
        f"byte-identical to the one-shot; kernel launches {count(launches)}")

    # 3b. announce, then backpressure, through the library on one server
    strace = os.path.join(idir, "library.jsonl")
    server = ToaServer(nsub_batch=nsub_batch, queue_depth=1,
                       telemetry=strace, device=device).start()
    try:
        F.reset_kernel_launches()
        tim = os.path.join(idir, "announce.tim")
        with SocketSource() as src:
            drv = IngestDriver(server, gmodel, [src], tim_out=tim,
                               tracer=server.tracer, quiet=True)
            stop = threading.Event()
            th = threading.Thread(target=drv.run, kwargs=dict(
                stop=stop, poll_ms=INGEST_POLL_MS), daemon=True)
            th.start()
            t0 = time.perf_counter()
            n = announce(src.endpoint, corpus["clean"][:3])
            t_end = time.monotonic() + 600
            while drv.stats()["completed"] < 3 and time.monotonic() < t_end:
                time.sleep(0.01)
            wall = time.perf_counter() - t0
            stop.set()
            th.join(600)
        st = drv.stats()
        launches = count(F.kernel_launches())
        check_oneshot(tim, admitted_files(strace), "announce", 3)
        log(f"ingest path (announce): {n} paths acknowledged, {st} in "
            f"{wall:.3f} s; the .tim byte-identical to the one-shot; "
            f"kernel launches {launches}")
        if st["completed"] != 3 or st["errors"]:
            raise AssertionError(f"ingest path (announce): {st}")

        F.reset_kernel_launches()
        n_before = len(admitted_files(strace))
        folder = os.path.join(idir, "backpressure")
        os.makedirs(folder)
        for src in corpus["event"]:
            dst = os.path.join(folder, os.path.basename(src))
            shutil.copyfile(src, dst)
            open(dst + ".done", "w").close()
        tim = os.path.join(idir, "backpressure.tim")
        drv = IngestDriver(server, gmodel,
                           [WatchFolderSource(folder, stable_ms=0)],
                           tim_out=tim, tracer=server.tracer, quiet=True)
        t0 = time.perf_counter()
        drv.run(idle_polls=5, poll_ms=INGEST_POLL_MS)
        wall = time.perf_counter() - t0
        st = drv.stats()
    finally:
        server.stop(drain=True)
    sync(device)
    launches = count(F.kernel_launches())
    files = admitted_files(strace)[n_before:]
    in_order = check_oneshot(tim, files, "backpressure", nep)
    bp = [e for e in load_trace(strace)[1] if e["type"] == "ingest_skip"
          and e["reason"] == "backpressure" and e["datafile"] in files]
    log(f"ingest path (backpressure, queue_depth 1): {st} in {wall:.3f} s; "
        f"{len(bp)} 'backpressure' skips; admitted in name order "
        f"{in_order}; the .tim byte-identical to the one-shot of the "
        f"admitted order; kernel launches {launches}")
    if not bp or st["completed"] != nep:
        raise AssertionError(f"ingest path (backpressure): {st}, "
                             f"{len(bp)} backpressure skips")

    # 4a. pptrace merge over phase 18's round 3
    if rctx is not None:
        from pulseportraiture_tpu_torch.telemetry import main as pptrace

        paths = [rctx["r3"]] + list(rctx["hosts"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pptrace(["merge"] + paths)
        text = buf.getvalue().splitlines()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pptrace(["merge", "--json"] + paths)
        merged = json.loads(buf.getvalue())
        subs = {e["trace_id"]: e["req"]
                for e in load_trace(rctx["r3"])[1]
                if e["type"] == "route_submit"}
        fo = {e["trace_id"] for e in load_trace(rctx["r3"])[1]
              if e["type"] == "route_failover"}
        named = [r for r in merged["requests"].values() if r["req"]]
        bad = [r["req"] for r in named if r["trace_id"] not in subs
               or not r["n_host_spans"] or r["critical"] is None
               or (r["trace_id"] in fo) != bool(r["failovers"])]
        if sorted(r["req"] for r in named) != sorted(set(subs.values())) \
                or bad or not fo:
            raise AssertionError(f"pptrace merge: {len(named)} requests "
                                 f"named for {sorted(subs.values())}; "
                                 f"failing {bad}; {len(fo)} failovers")
        rows = [(r["req"], r["n_host_spans"], len(r["failovers"]),
                 r["critical"], r["segments"]) for r in named]
        log(f"ingest path (pptrace merge over phase 18's round 3: "
            f"{text[0]}): {merged['n_requests']} trace ids, round 3's "
            f"{len(named)} requests each once with (host spans, failovers, "
            f"critical stage, segments) {rows}")

    # 4b. ppmon against a host and a router monitor
    F.reset_kernel_launches()
    server = ToaServer(nsub_batch=nsub_batch, device=device).start()
    listener = TransportServer(server, host="127.0.0.1", port=0).start()
    router = monitor = None
    try:
        router = ToaRouter([SocketTransport(listener.label)])
        router.submit(corpus["clean"][:1], gmodel,
                      tim_out=os.path.join(idir, "mon.tim")).result(600)
        sync(device)
        launches = count(F.kernel_launches())
        monitor = TransportServer(router, host="127.0.0.1", port=0).start()
        replies = {}
        for ep, argv in (("fleet", [monitor.label, "--once", "--json"]),
                         ("host", [listener.label, "--once", "--json"]),
                         ("text", [monitor.label, "--once"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                run_tool("ppmon", argv, f"ppmon {ep}")
            replies[ep] = buf.getvalue()
    finally:
        if monitor is not None:
            monitor.close()
        if router is not None:
            router.close()
        listener.close()
        server.stop(drain=True)
    fleet = json.loads(replies["fleet"])
    host = json.loads(replies["host"])
    if fleet["fleet"]["p99_s"] is None or "ppmon: fleet" not in \
            replies["text"] or not host["metrics_enabled"]:
        raise AssertionError(f"ppmon: {replies}")
    log(f"ingest path (ppmon --once --json, exit 0): fleet p50 "
        f"{fleet['fleet']['p50_s']} s, p99 {fleet['fleet']['p99_s']} s, "
        f"states {fleet['fleet']['states']}; host queue "
        f"{host['queue_len']}, requests "
        f"{host['metrics']['counters'].get('requests_total')}; the text "
        f"view's first line {replies['text'].splitlines()[0]!r}; kernel "
        f"launches {launches}")
    if cuda:
        torch.cuda.empty_cache()
    return totals


def tune_attribution(device="cuda", nchan=NCHAN, nbin=NBIN):
    """Phase 20 (a): profiling.profile_stages on the fast fit of the
    main path's archive (its first 64 subints; float32, the derived
    window K, B1 on CUDA).  The Newton loop reads its convergence on the
    host once per trip, so its slope is wall time, host work included.
    Returns (Attribution, B1 launches during it)."""
    import numpy as np
    import torch
    from pulseportraiture_tpu_torch.fit import portrait as FP
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.pipeline.models import TemplateModel
    from pulseportraiture_tpu_torch.pipeline.toas import (
        load_for_toas, snr_weighted_nu_fit)
    from pulseportraiture_tpu_torch.profiling import Stage, profile_stages

    d = load_for_toas(os.path.join(WORK, "fake.fits"))
    ok = np.asarray(d.ok_isubs, int)[:NSUB]
    freqs0 = np.asarray(d.freqs[0], float)
    masks = np.asarray(d.weights[ok] > 0.0, float)
    tmpl = TemplateModel(os.path.join(WORK, "model.gmodel"),
                         device=device).portrait(
        freqs0, d.nbin, P=float(np.mean(d.Ps[ok])))
    theta0 = np.zeros((len(ok), 5))
    theta0[:, 1] = float(d.DM)
    args, bounds, common = FP._stage_fast(
        np.asarray(d.subints[ok, 0], np.float32),
        np.asarray(tmpl, np.float32),
        np.asarray(d.noise_stds[ok, 0], np.float32), freqs0,
        np.asarray(d.Ps[ok]),
        snr_weighted_nu_fit(np.asarray(d.SNRs[ok, 0]) * masks, freqs0),
        None, theta0, FP.FitFlags(True, True), masks, 40, None, None,
        device)
    ports, model, noise, cmask, freqs, P, nu_fit, nu_out, th0 = args
    K = common["nharm_eff"]
    x_bf16 = FP.use_bf16_cross_spectrum()
    x_dtype = torch.bfloat16 if x_bf16 else None
    model = model.to(ports.dtype)

    def weights():
        return FP.make_weights(noise, nbin, cmask, dtype=ports.dtype,
                               nharm=K)

    def prepare():
        return FP.prepare_portrait_fit_real(
            ports, model, weights(), freqs, P, nu_fit, th0,
            seed_derotate=common["seed_derotate"], x_dtype=x_dtype,
            nharm_eff=K, dft_fold=common["dft_fold"],
            fit_fused=common["fit_fused"])

    Xr, Xi, S0, Sd, th_seed = prepare()

    def cross_spectrum():
        return F.fused_cross_spectrum(
            ports, model, weights()[..., :K].contiguous(), K,
            fold=common["dft_fold"])[0]

    def newton():
        return FP._fit_portrait_core_real(
            Xr, Xi, S0, Sd, freqs, P, nu_fit, nu_out, th_seed,
            fit_flags=common["fit_flags"], max_iter=common["max_iter"],
            nharm_total=nbin // 2 + 1).phi

    def full():
        return FP.fast_fit_batched(*args, bounds, x_bf16=x_bf16,
                                   **common).phi

    F.reset_kernel_launches()
    att = profile_stages(full, [
        Stage("cross_spectrum", cross_spectrum),
        Stage("prepare", prepare, pick=lambda r: r[0]),
        Stage("newton", newton, kind="piece")])
    b1 = F.kernel_launches()["fused_cross_spectrum"]
    log(f"tune path (a) stage attribution, fast fit {tuple(ports.shape)} "
        f"K={K} {str(ports.dtype).split('.')[-1]} (fused "
        f"{common['fit_fused']}): {json.dumps(att.breakdown_ms(ndigits=4))}"
        f"; attributed_frac {att.attributed_frac:.4f}; single call "
        f"{att.single_s * 1e3:.3f} ms; B1 launches {b1}")
    for st in att.stages:
        if not (math.isfinite(st.cost_s) and st.cost_s >= 0.0):
            raise AssertionError(f"stage {st.name}: cost {st.cost_s!r}")
    if device_type(device) == "cuda" and b1 < 1:
        raise AssertionError("the attribution launched no B1")
    return att, b1


def tune_events(trace):
    """The tune_* events of a JSONL trace."""
    with open(trace) as f:
        evs = [json.loads(ln) for ln in f if ln.strip()]
    return [e for e in evs if e.get("type", "").startswith("tune_")]


def phase_tune(device="cuda", nchan=NCHAN, nbin=NBIN):
    """The tune path (phase 20; module docstring): the stage attribution,
    then pptoas --autotune / --tune-db on phase 6's campaign (its
    metafile, .gmodel and archives), a numerics sweep, ppserve --tune-db.
    Returns the kernels' launches of run (b), the sweep and its
    campaign."""
    import warnings

    import torch
    from pulseportraiture_tpu_torch import config
    from pulseportraiture_tpu_torch import serve as SV
    from pulseportraiture_tpu_torch.tune import (IDENTITY_TIER,
                                                 NUMERICS_TIER, TuningStore,
                                                 ensure_tuned,
                                                 shape_class_for)

    tune_attribution(device, nchan, nbin)
    tdir = os.path.join(WORK, "tune")
    shutil.rmtree(tdir, ignore_errors=True)
    os.makedirs(tdir)
    meta = os.path.join(WORK, "stream_meta.txt")
    gmodel = os.path.join(WORK, "model.gmodel")
    with open(meta) as f:
        files = [ln.strip() for ln in f if ln.strip()]
    shape = shape_class_for(nchan, nbin)
    names = [k.name for k in IDENTITY_TIER + NUMERICS_TIER]
    defaults = {k: getattr(config, k) for k in names}
    base = ["--stream", "-d", meta, "-m", gmodel, "--quiet",
            "--device", device]

    def reset():
        for k, v in defaults.items():
            setattr(config, k, v)
        config.tune_db, config.autotune, config.tune_numerics = \
            None, False, False

    def campaign(tag, extra):
        reset()
        tim = os.path.join(tdir, f"{tag}.tim")
        wall, launches, _ = run_tool("pptoas", base + ["-o", tim] + extra,
                                     f"pptoas --stream {tag}")
        with open(tim, "rb") as f:
            return wall, launches, f.read()

    db = os.path.join(tdir, "tune.json")
    w0, _, ref = campaign("untuned", [])
    log(f"tune path: untuned pptoas --stream {w0:.3f} s, "
        f"{ref.count(b' -pp_dme ')} TOAs")

    # (b) the first sweep, the counters set to 0 just before it
    t1 = os.path.join(tdir, "t1.jsonl")
    with capture_largest("fused_decode_cross_spectrum") as b2_call, \
            capture_largest("fused_cross_spectrum", last=True) as b1_call:
        w1, launches, tim1 = campaign(
            "sweep", ["--autotune", "--tune-db", db, "--telemetry", t1])
    evs = tune_events(t1)
    kinds = [e["type"] for e in evs]
    with open(db) as f:
        doc = json.load(f)
    ent = doc["entries"].get(shape)
    fp = doc["fingerprint"]
    for e in evs:
        if e["type"] == "tune_sweep":
            log(f"  sweep {e['knob']}: default {e['default']}, winner "
                f"{e['winner']}, {e['n_candidates']} candidates, "
                f"{e['n_rejected']} rejected by the byte gate, default "
                f"{e['default_s']:.6f} s, best {e['best_s']:.6f} s")
    log(f"tune path (b) pptoas --stream --autotune: {w1:.3f} s wall "
        f"(sweep and campaign); DB {json.dumps(doc)}; launches "
        f"{launches}")
    if list(doc["entries"]) != [shape] or ent is None:
        raise AssertionError(f"tune DB entries {list(doc['entries'])}, "
                             f"expected one under {shape}")
    kind = (torch.cuda.get_device_name(0)
            if device_type(device) == "cuda" else "cpu")
    want = f"{device_type(device)}:{kind}:torch-{torch.__version__}"
    if fp != want:
        raise AssertionError(f"tune DB fingerprint {fp!r}, expected {want!r}")
    if (kinds.count("tune_probe"), kinds.count("tune_sweep"),
            kinds.count("tune_apply")) != (1, len(IDENTITY_TIER), 1) or \
            evs[-1]["db_hit"] is not False:
        raise AssertionError(f"sweep trace tune events {kinds}")
    if not ent["tuned_s"] <= ent["default_s"]:
        raise AssertionError(f"tuned_s {ent['tuned_s']} > default_s "
                             f"{ent['default_s']}")
    if tim1 != ref:
        raise AssertionError("the tuned .tim differs from the untuned run's")

    # (c) the warm DB
    t2 = os.path.join(tdir, "t2.jsonl")
    w2, _, tim2 = campaign(
        "warm", ["--autotune", "--tune-db", db, "--telemetry", t2])
    evs2 = tune_events(t2)
    applied = [e for e in evs2 if e["type"] == "tune_apply"]
    if any(e["type"] == "tune_sweep" for e in evs2) or \
            [e["db_hit"] for e in applied] != [True] or tim2 != ref:
        raise AssertionError(f"warm run: tune events "
                             f"{[e['type'] for e in evs2]}, db_hit "
                             f"{[e['db_hit'] for e in applied]}, .tim "
                             f"identical {tim2 == ref}")
    log(f"tune path (c) warm DB: {w2:.3f} s wall (the sweep's run "
        f"{w1:.3f} s, untuned {w0:.3f} s), applied {applied[0]['knobs']}, "
        "no tune_sweep, .tim byte-identical")

    # (d) a DB with the JAX package's CPU fingerprint
    foreign = os.path.join(tdir, "jax.json")
    with open(foreign, "w") as f:
        json.dump({"version": 1, "fingerprint": "cpu:cpu:jax-0.4.35",
                   "entries": {shape: {"knobs": {
                       "stream_pipeline_depth": 1, "fused_block": 8}}}}, f)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        w3, _, tim3 = campaign("foreign", ["--tune-db", foreign])
        moved = {k: getattr(config, k) for k in names
                 if getattr(config, k) != defaults[k]}
    said = [str(w.message) for w in caught
            if "measured on backend" in str(w.message)]
    if not said or moved or tim3 != ref:
        raise AssertionError(f"foreign DB: warnings {said}, knobs moved "
                             f"{moved}, .tim identical {tim3 == ref}")
    log(f"tune path (d) foreign DB: warned ({said[0][:100]}...), defaults "
        f"kept, {w3:.3f} s, .tim byte-identical")

    # (e) a numerics sweep: the numerics tier alone (imported here: the
    # runs above execute the CLI module afresh through runpy)
    from pulseportraiture_tpu_torch.cli import pptoas as PT

    reset()
    config.tune_numerics = True
    run_fn, nshape = PT._tune_workload(
        PT.build_parser().parse_args(base + ["-o", os.devnull]))
    ndb = os.path.join(tdir, "numerics.json")
    t0 = time.perf_counter()
    try:
        won = ensure_tuned(run_fn, nshape, db_path=ndb,
                           knobs=NUMERICS_TIER, apply=False, device=device)
    finally:
        reset()
    nent = TuningStore(ndb, device=device).get(nshape)
    if nent is None or nent.get("identity_preserving") is not False:
        raise AssertionError(f"numerics sweep DB entry {nent}")
    log(f"tune path (e) numerics sweep: {time.perf_counter() - t0:.3f} s, "
        f"winners {won}, entry {json.dumps(nent)}")

    # (f) the server on the stored DB (stats() read as it stops)
    req = os.path.join(tdir, "requests.jsonl")
    with open(req, "w") as f:
        f.write(json.dumps({"name": "T", "datafiles": [files[0], files[-1]],
                            "modelfile": gmodel}) + "\n")
    tserve = os.path.join(tdir, "serve.jsonl")
    orig, stats = SV.ToaServer, []

    class StatServer(orig):
        def stop(self, *a, **k):
            if not stats:
                stats.append(self.stats())
            return super().stop(*a, **k)

    SV.ToaServer = StatServer
    try:
        reset()
        w4, _, _ = run_tool("ppserve", [
            "-r", req, "-O", os.path.join(tdir, "served"), "--tune-db", db,
            "--telemetry", tserve, "--max-wait-ms", "200", "--quiet",
            "--device", device], "ppserve -r --tune-db")
    finally:
        SV.ToaServer = orig
        reset()
    served = [e for e in tune_events(tserve) if e["type"] == "tune_apply"]
    cap = stats[0]["capability"] if stats else {}
    if [e["db_hit"] for e in served] != [True] or \
            cap.get("fingerprint") != fp:
        raise AssertionError(f"ppserve --tune-db: tune_apply {served}, "
                             f"stats fingerprint {cap.get('fingerprint')!r} "
                             f"vs the DB's {fp!r}")
    log(f"tune path (f) ppserve -r --tune-db: {w4:.3f} s, applied "
        f"{served[0]['knobs']}, capability {json.dumps(cap)}")

    # (g) the kernels on the path
    if device_type(device) == "cuda":
        fft_only(launches, ("fused_decode_cross_spectrum",
                            "fused_cross_spectrum"), "the tune path")
        (port, model, w, K), k = b1_call[0][0][:4], b1_call[0][1]
        check_cross_spectrum_case(dict(
            name=f"tune campaign int16 bucket {tuple(port.shape)} K={K}",
            port=port, model=model, w=w, K=K, fold=k.get("fold"),
            want_m2=k.get("want_m2", False), arm=None))
        (raw, scl, offs, model, w, K), k = b2_call[0]
        check_decode_case(dict(
            name=f"tune sweep 2-bit bucket {tuple(raw.shape)} K={K}",
            raw=raw, scl=scl, offs=offs, model=model, w=w, K=K,
            code=k["code"], nbin=k["nbin"], fold=k.get("fold"), arm=None))
        del b1_call[:], b2_call[:]
        torch.cuda.empty_cache()
    return launches


def scale_dir():
    """Phase 21's directory: its inputs, the ranks' logs and results."""
    return os.path.join(WORK, "scale_out")


def scale_out_inputs(ctx, device, nsub_scat=SCALE_NSUB_SCAT, nchan=NCHAN,
                     nbin=NBIN):
    """Phase 21's inputs, written to scale_dir() for the ranks: the main
    path's batch (fake.fits, the fit GetTOAs makes: float32, the .gmodel
    portrait, DM seeded), an int16 archive of nsub_scat subints like the
    scattering path's (log10 tau seeded at half the injection, alpha at
    -4),
    the align path's epochs dedispersed (one batch of NARCH_ALIGN x
    NSUB_ALIGN subints, the .gmodel portrait as the template) and phase
    15's pulsars A and B as campaign jobs.  Returns {name: inputs}."""
    import numpy as np
    from pulseportraiture_tpu_torch.io.psrfits import load_data
    from pulseportraiture_tpu_torch.pipeline.models import TemplateModel
    from pulseportraiture_tpu_torch.pipeline.toas import (
        load_for_toas, snr_weighted_nu_fit)
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    gmodel = os.path.join(WORK, "model.gmodel")

    def fit_batch(d, ok, scat=False):
        freqs0 = np.asarray(d.freqs[0], float)
        masks = np.asarray(d.weights[ok] > 0.0, np.float32)
        P = np.asarray(d.Ps[ok], float)
        theta0 = np.zeros((len(ok), 5))
        theta0[:, 1] = float(d.DM)
        if scat:
            theta0[:, 3] = math.log10(0.5 * T_SCAT / float(np.mean(P)))
            theta0[:, 4] = -4.0
        return dict(
            ports=np.asarray(d.subints[ok, 0], np.float32),
            models=np.asarray(TemplateModel(gmodel, device=device).portrait(
                freqs0, d.nbin, P=float(np.mean(P))), np.float32),
            noise_stds=np.asarray(d.noise_stds[ok, 0], np.float32),
            freqs=freqs0.astype(np.float32), P_s=P.astype(np.float32),
            nu_fit=snr_weighted_nu_fit(np.asarray(d.SNRs[ok, 0]) * masks,
                                       freqs0).astype(np.float32),
            theta0=theta0.astype(np.float32), chan_masks=masks)

    d = load_for_toas(os.path.join(WORK, "fake.fits"))
    fit = fit_batch(d, np.asarray(d.ok_isubs, int))
    path = os.path.join(WORK, "scale-scat.fits")
    make_fake_pulsar(default_test_model(1500.0), PAR, outfile=path,
                     nsub=nsub_scat, nchan=nchan, nbin=nbin, nu0=1500.0,
                     bw=800.0, tsub=60.0, phase=PHI_INJ, dDM=DDM_INJ,
                     t_scat=T_SCAT, alpha=ALPHA_INJ,
                     start_MJD=MJD(55700, 0.1), noise_stds=NOISE_SCAT_I16,
                     dedispersed=False, quiet=True,
                     rng=np.random.default_rng(SEED + 200), device=device)
    d = load_for_toas(path)
    scat = fit_batch(d, np.asarray(d.ok_isubs, int), scat=True)
    parts = [load_data(os.path.join(WORK, f"epoch-{i}.fits"),
                       dedisperse=True, pscrunch=True, flux_prof=False,
                       refresh_arch=False, return_arch=False, quiet=True)
             for i in range(NARCH_ALIGN)]
    freqs0 = np.asarray(parts[0].freqs[0], float)
    P = np.concatenate([np.asarray(p.Ps, float) for p in parts])
    align = dict(
        ports=np.concatenate([np.asarray(p.subints[:, 0], np.float32)
                              for p in parts]),
        model=np.asarray(TemplateModel(gmodel, device=device).portrait(
            freqs0, parts[0].nbin, P=float(np.mean(P))), np.float32),
        noise_stds=np.concatenate([np.asarray(p.noise_stds[:, 0],
                                              np.float32) for p in parts]),
        chan_masks=np.concatenate([np.asarray(p.weights > 0.0, np.float32)
                                   for p in parts]),
        freqs=freqs0.astype(np.float32), P_s=P.astype(np.float32))
    os.makedirs(scale_dir(), exist_ok=True)
    for name, arrays in (("fit", fit), ("scat", scat), ("align", align)):
        np.savez(os.path.join(scale_dir(), f"{name}.npz"), **arrays)
    jobs = {n: [ctx["meta"][n], ctx["tmpl"][i]]
            for i, n in enumerate(("A", "B"))}
    with open(os.path.join(scale_dir(), "jobs.json"), "w") as f:
        json.dump(jobs, f)
    return dict(fit=fit, scat=scat, align=align, jobs=jobs)


def scale_out_call(name, mesh, inp, device, shard_channels=False):
    """One of phase 21's sharded calls on ``mesh`` with inputs ``inp``
    (scale_out_inputs): 'fit', the fast fit of the main batch; 'scat',
    the scattering branch (phi, DM, tau, alpha free, log10 tau); 'align',
    one align iteration.  Returns (result, wall s)."""
    from pulseportraiture_tpu_torch import parallel
    from pulseportraiture_tpu_torch.fit.portrait import FitFlags

    t0 = time.perf_counter()
    if name == "align":
        r = parallel.align_iteration_sharded(
            mesh, device=device, shard_channels=shard_channels, **inp)
    else:
        kw = (dict(fit_flags=FitFlags(True, True, False, True, True),
                   log10_tau=True, max_iter=60) if name == "scat"
              else dict(fit_flags=FitFlags(True, True)))
        r = parallel.fit_portrait_sharded_fast(
            mesh, device=device, shard_channels=shard_channels, **inp, **kw)
    sync(device)
    return r, time.perf_counter() - t0


def _fit_record(r):
    """The compared fields of a FitResult, as lists."""
    return {k: getattr(r, k).double().cpu().tolist()
            for k in ("phi", "phi_err", "DM", "DM_err", "nu_DM", "tau",
                      "tau_err", "alpha", "alpha_err", "return_code")}


def scale_out_rank(rank, port, device="cuda", work=None, polarity=None):
    """One rank of phase 21, started by phase_scale_out as ``python -c``
    in the repo root: a gloo process group of 2 (init_multihost with
    backend='gloo'), then for each mesh of SCALE_MESHES (2 x 1: the batch
    over 'data'; 1 x 2 with shard_channels=True: the channels over
    'chan') each of scale_out_call's calls with the counters set to 0
    just before it and read just after, and the peak device memory of
    the mesh's calls; then stream_ipta_campaign(shard=True) over pulsars
    A and B the same way.  On CUDA every rank records the shape of B1's
    largest bucket of each call at 1 x 2 (its channel block), and rank 0
    holds B1 to its plain version on the fit's bucket at 2 x 1, on the
    three calls' buckets at 1 x 2 (both forms), and B2 on the
    campaign's.  work: the parent's WORK; polarity: the parent's
    device.KNOB_POLARITY, so the ranks take the routes of the
    world-size-1 calls they are held to.  Writes
    scale_dir()/rank<rank>.json and the templates align<mesh><rank>.npy."""
    global WORK
    import numpy as np
    import torch
    import torch.distributed as dist
    from pulseportraiture_tpu_torch import parallel
    from pulseportraiture_tpu_torch.device import KNOB_POLARITY
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.pipeline.ipta import (
        IPTAJob, stream_ipta_campaign)

    WORK = work or WORK
    KNOB_POLARITY.update(polarity or {})
    cuda = device_type(device) == "cuda"
    check = cuda and rank == 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    if cuda:
        F.build_kernels()
    parallel.init_multihost(f"127.0.0.1:{port}", num_processes=2,
                            process_id=rank, backend="gloo", device=device,
                            timeout=SCALE_TIMEOUT)
    rec = dict(rank=rank, backend=dist.get_backend(),
               world=parallel.process_count(), coords={},
               device=str(device), start_s=time.perf_counter() - t_start,
               launches={}, wall_s={}, b1_rows={}, peak={})
    inputs = {}
    for name in SCALE_CALLS:
        with np.load(os.path.join(scale_dir(), f"{name}.npz")) as z:
            inputs[name] = {k: z[k] for k in z.files}
    for tag, (nd, nc) in SCALE_MESHES.items():
        mesh = parallel.make_mesh(n_data=nd, n_chan=nc, devices=[device])
        rec["coords"][tag] = list(mesh.coords)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        for name in SCALE_CALLS:
            key = name if tag == "2x1" else f"{name}_{tag}"
            spy = capture_largest("fused_cross_spectrum") if cuda and (
                nc > 1 or (check and name == "fit")) \
                else contextlib.nullcontext([])
            with spy as b1:
                F.reset_kernel_launches()
                r, rec["wall_s"][key] = scale_out_call(
                    name, mesh, inputs[name], device, shard_channels=nc > 1)
                rec["launches"][key] = F.kernel_launches()
            if name == "align":
                np.save(os.path.join(scale_dir(), f"align{tag}{rank}.npy"),
                        r[0].cpu().numpy())
                r = r[1]
            rec[key] = _fit_record(r)
            if b1:
                (port_, model, w, K), k = b1[0][0][:4], b1[0][1]
                rec["b1_rows"][key] = list(port_.shape)
                if check:
                    check_cross_spectrum_case(dict(
                        name=f"scale-out rank 0 {key} bucket "
                             f"{tuple(port_.shape)} K={K}", port=port_,
                        model=model, w=w, K=K, fold=k.get("fold"),
                        want_m2=k.get("want_m2", False), arm=None))
                del b1[:]
        if cuda:
            rec["peak"][tag] = [torch.cuda.max_memory_allocated(),
                                torch.cuda.max_memory_reserved()]
    with open(os.path.join(scale_dir(), "jobs.json")) as f:
        jobs = [IPTAJob(n, meta, tmpl) for n, (meta, tmpl)
                in json.load(f).items()]
    spy = capture_largest("fused_decode_cross_spectrum") if check \
        else contextlib.nullcontext([])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with spy as b2:
        F.reset_kernel_launches()
        t0 = time.perf_counter()
        res = stream_ipta_campaign(
            jobs, outdir=os.path.join(scale_dir(), "campaign"), shard=True,
            nsub_batch=CAMPAIGN_BATCH, quiet=True, device=device)
        sync(device)
        rec["wall_s"]["campaign"] = time.perf_counter() - t0
        rec["launches"]["campaign"] = F.kernel_launches()
    if b2:
        (raw, scl, offs, model, w, K), k = b2[0]
        check_decode_case(dict(
            name=f"scale-out rank 0 campaign bucket {tuple(raw.shape)} "
                 f"K={K}", raw=raw, scl=scl, offs=offs, model=model, w=w,
            K=K, code=k["code"], nbin=k["nbin"], fold=k.get("fold"),
            arm=None))
        del b2[:]
    rec["summary"] = {n: [m.tolist(), e.tolist()]
                      for n, (m, e) in res.DeltaDM_summary.items()}
    rec["ntoa"] = len(res.TOA_list)
    if cuda:
        rec["peak"]["campaign"] = [torch.cuda.max_memory_allocated(),
                                   torch.cuda.max_memory_reserved()]
    rec["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(scale_dir(), f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def _wrap(x):
    return (x + 0.5) % 1.0 - 0.5


def _rows(inp, sl):
    """A phase 21 call's inputs on the subints ``sl`` (the shared
    template and freqs whole)."""
    return {k: v[sl] if k in SCALE_BATCH_KEYS else v for k, v in inp.items()}


def scale_out_compare(label, got, ref, fields, tol):
    """The largest |got - ref| / ref's error over ``fields`` of two fit
    records (_fit_record; phases wrapped), and the failure (a message,
    or None within ``tol`` and with equal return codes)."""
    import numpy as np

    worst = {}
    for k in fields:
        d = np.asarray(got[k]) - np.asarray(ref[k])
        if k == "phi":
            d = _wrap(d)
        worst[k] = float(np.max(np.abs(d) / np.asarray(ref[k + "_err"])))
    if got["return_code"] != ref["return_code"] or not all(
            v <= tol for v in worst.values()):
        return worst, (f"scale-out {label}: 2 ranks vs world size 1 on the "
                       f"whole batch differ by {worst} x the errors (limit "
                       f"{tol}) or in return codes")
    return worst, None


def scale_out_batch_invariance(inp, ref, device):
    """ROADMAP C8's gate: each of the scattering branch's subints fitted
    alone at world size 1 against the same subint in ``ref``, the batch
    of all of them (scale_out_call 'scat': B1's want_m2 form, the
    harmonic window): every FitResult field bit for bit, else raise.
    Returns the walls of the single fits [s]."""
    import torch
    from pulseportraiture_tpu_torch import parallel

    mesh1 = parallel.make_mesh(devices=[device])
    walls = []
    for i in range(len(inp["ports"])):
        one, wall = scale_out_call("scat", mesh1, _rows(inp, slice(i, i + 1)),
                                   device)
        walls.append(wall)
        diff = [k for k in ref._fields
                if not torch.equal(getattr(one, k)[0], getattr(ref, k)[i])]
        if diff:
            raise AssertionError(
                f"scale-out C8 gate: scattering subint {i} fitted alone "
                f"differs from the batch of {len(inp['ports'])} in {diff}")
    return walls


def phase_scale_out(ctx, device="cuda", nsub_scat=SCALE_NSUB_SCAT,
                    noracle=SCALE_NORACLE, nchan=NCHAN, nbin=NBIN):
    """The scale-out path (phase 21): two ranks over gloo, both on one
    card, as two processes (scale_out_rank; NCCL refuses two ranks on one
    GPU), over scale_out_inputs, on a 2 x 1 mesh (the batch over 'data')
    and then a 1 x 2 mesh with shard_channels=True (each rank fits its
    256 of the 512 channels, the chi^2 channel sums combined over
    'chan'):
    1. fit_portrait_sharded_fast over the main path's 64 x 512 x 2048
       float32 batch: B1 launched by each rank, phi / DM within SCALE_TOL
       x their errors of the same call at world size 1 in this process on
       the whole batch (run while the ranks work), the first ``noracle``
       subints' phi within 1e-4 rot of the port's fit/reference_numpy
       (float64, on the host, re-referenced to the fit's nu_DM along its
       own DM);
    2. the scattering branch on nsub_scat subints: B1's want_m2 form
       launched by each rank, phi / DM / tau / alpha as 1; and ROADMAP
       C8's gate in this process (scale_out_batch_invariance): each
       subint fitted alone gives the batch's bits;
    3. one align_iteration_sharded over the align path's 4 x 32 x 512 x
       2048 epochs: the template within SCALE_TEMPLATE_TOL x its max of
       world size 1's, phi / DM as 1;
    at 1 x 2, B1 (both forms; the align's fit takes the S0 form at every
    harmonic) on each rank's channel block (64, 8 and 128 x 256 rows),
    rank 0's held to its plain version;
    4. stream_ipta_campaign(shard=True) over phase 15's pulsars A (int16,
       B1) and B (2-bit, B2): the union of the ranks' .tim shards holds
       phase 16's run 1 lines (the same keys, TOAs and DMs within
       SCALE_TIM_SIGMA), the ranks' summaries equal, B1 and B2 launched
       by each rank through their FFT arms only.
    Prints each rank's peak memory per mesh.  Shows the sharded code path
    on the card, not NCCL and not a speed-up.  Returns the ranks'
    launches, summed over the calls and the ranks."""
    import numpy as np
    import torch
    from pulseportraiture_tpu_torch import parallel
    from pulseportraiture_tpu_torch.config import Dconst
    from pulseportraiture_tpu_torch.device import KNOB_POLARITY
    from pulseportraiture_tpu_torch.fit.reference_numpy import \
        fit_portrait_numpy

    cuda = device_type(device) == "cuda"
    shutil.rmtree(scale_dir(), ignore_errors=True)
    t0 = time.perf_counter()
    inp = scale_out_inputs(ctx, device, nsub_scat, nchan, nbin)
    log(f"scale-out inputs: fit {inp['fit']['ports'].shape}, scattering "
        f"{inp['scat']['ports'].shape}, align "
        f"{inp['align']['ports'].shape} float32, campaign A and B, in "
        f"{time.perf_counter() - t0:.2f} s")
    if cuda:
        torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    logs = [open(os.path.join(scale_dir(), f"rank{r}.log"), "w")
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as C; C.scale_out_rank("
         f"{r}, {port}, {str(device)!r}, {WORK!r}, {dict(KNOB_POLARITY)!r})"],
        cwd=ROOT,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    t_spawn = time.perf_counter()
    try:
        # world size 1 on the whole batch, C8's gate and the oracle in
        # this process while the ranks run
        mesh1 = parallel.make_mesh(devices=[device])
        whole = {n: scale_out_call(n, mesh1, inp[n], device)
                 for n in SCALE_CALLS}
        ref_t = whole["align"][0][0]
        c8_walls = scale_out_batch_invariance(inp["scat"],
                                              whole["scat"][0], device)
        t1 = time.perf_counter()
        f = inp["fit"]
        r1 = whole["fit"][0]
        oracle = []
        for i in range(noracle):
            o = fit_portrait_numpy(
                f["ports"][i].astype(float), f["models"].astype(float),
                np.where(f["chan_masks"][i] > 0, f["noise_stds"][i], 0.0),
                f["freqs"].astype(float), float(f["P_s"][i]),
                float(f["nu_fit"][i]), DM0=float(f["theta0"][i, 1]))
            nu = float(r1.nu_DM[i])
            oracle.append((o["phi"] + Dconst * o["DM"] / float(f["P_s"][i])
                           * (nu ** -2.0 - float(f["nu_fit"][i]) ** -2.0),
                           o["DM"]))
        oracle_s = time.perf_counter() - t1
        for p in procs:
            p.wait(timeout=max(SCALE_TIMEOUT - (time.perf_counter()
                                                - t_spawn), 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"scale-out: the ranks did not finish within "
                             f"{SCALE_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    ranks_s = time.perf_counter() - t_spawn
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(scale_dir(), f"rank{r}.log")) as fh:
                tail = fh.read()[-4000:]
            raise AssertionError(f"scale-out rank {r} exited "
                                 f"{p.returncode}:\n{tail}")
    recs = []
    for r in range(2):
        with open(os.path.join(scale_dir(), f"rank{r}.json")) as fh:
            recs.append(json.load(fh))
    starts = ", ".join(f"{rec['start_s']:.2f}" for rec in recs)
    log(f"scale-out path: {recs[0]['world']} ranks over "
        f"{recs[0]['backend']}, both on {device} of one card, mesh coords "
        f"{[rec['coords'] for rec in recs]} (this shows the sharded code "
        "path on the card, neither NCCL nor a speed-up); the ranks took "
        f"{ranks_s:.2f} s from spawn, {starts} s of it to start, load the "
        "kernels and join the group")
    if not all(rec["backend"] == "gloo" and rec["world"] == 2
               for rec in recs):
        raise AssertionError("scale-out: not two gloo ranks")
    keys = [n if tag == "2x1" else f"{n}_{tag}" for tag in SCALE_MESHES
            for n in SCALE_CALLS]
    for key in keys:
        if recs[0][key] != recs[1][key]:
            raise AssertionError(f"scale-out {key}: the ranks' gathered "
                                 "results differ")

    # 1-3: the sharded calls on both meshes against world size 1 on the
    # whole batch
    fields = {"fit": ("phi", "DM"), "scat": ("phi", "DM", "tau", "alpha"),
              "align": ("phi", "DM")}
    # (every value is logged below before a failure raises)
    worst, d_t, failures = {}, {}, []
    t1 = ref_t.cpu().numpy()
    for key in keys:
        name, tag = key.split("_")[0], ("1x2" if "_" in key else "2x1")
        ref = whole[name][0][1] if name == "align" else whole[name][0]
        worst[key], bad = scale_out_compare(
            key, recs[0][key], _fit_record(ref), fields[name], SCALE_TOL)
        failures += [bad] if bad else []
        if name == "align":
            d_t[tag] = max(float(np.max(np.abs(np.load(os.path.join(
                scale_dir(), f"align{tag}{r}.npy")) - t1)))
                for r in range(2)) / float(np.max(np.abs(t1)))
            if not d_t[tag] <= SCALE_TEMPLATE_TOL:
                failures.append(
                    f"scale-out align ({tag}): the ranks' template is "
                    f"{d_t[tag]:.3e} x max from world size 1's (limit "
                    f"{SCALE_TEMPLATE_TOL})")
    phi2 = np.asarray(recs[0]["fit"]["phi"])
    d_or = [abs(_wrap(o[0] - phi2[i])) for i, o in enumerate(oracle)]
    if not max(d_or) < 1e-4:
        failures.append(f"scale-out: |dphi| against fit_portrait_numpy "
                        f"{max(d_or):.3e} rot (limit 1e-4)")
    launches = {}
    for rec in recs:
        for name, la in rec["launches"].items():
            for k, v in la.items():
                launches.setdefault(name, {}).setdefault(k, 0)
                launches[name][k] += v
        if cuda:
            for key in ("fit", "fit_1x2", "align", "align_1x2"):
                fft_only(rec["launches"][key], ("fused_cross_spectrum",),
                         f"scale-out {key} (rank {rec['rank']})")
            fft_only(rec["launches"]["campaign"],
                     ("fused_cross_spectrum", "fused_decode_cross_spectrum"),
                     f"scale-out campaign (rank {rec['rank']})")
            for key in ("scat", "scat_1x2"):
                if rec["launches"][key]["fused_cross_spectrum.m2"] < 1:
                    raise AssertionError(f"scale-out {key} (rank "
                                         f"{rec['rank']}): no want_m2 "
                                         "launch")
            # B1 on the rank's channel block at 1 x 2
            for key in ("fit_1x2", "scat_1x2", "align_1x2"):
                n = key.split("_")[0]
                want = [len(inp[n]["ports"]), nchan // 2, nbin]
                if rec["b1_rows"].get(key) != want:
                    raise AssertionError(
                        f"scale-out {key} (rank {rec['rank']}): B1's largest "
                        f"bucket {rec['b1_rows'].get(key)}, expected the "
                        f"rank's channel block {want}")
    walls = {n: ", ".join(f"{rec['wall_s'][n]:.2f}" for rec in recs)
             for n in recs[0]["wall_s"]}
    w1 = {n: whole[n][1] for n in whole}
    per_rank = {n: [rec["launches"][n]["fused_cross_spectrum"]
                    for rec in recs] for n in keys + ["campaign"]}
    m2 = {n: [rec["launches"][n]["fused_cross_spectrum.m2"] for rec in recs]
          for n in keys}
    rows = {n: recs[0]["b1_rows"].get(n) for n in keys}
    log(f"scale-out fit ({len(phi2)} subints): 2 x 1 ({len(phi2) // 2} "
        f"a rank) B1 launches per rank {per_rank['fit']}, walls "
        f"{walls['fit']} s; 1 x 2 (the channels split, B1 on {rows['fit_1x2']}"
        f" rows) B1 launches {per_rank['fit_1x2']}, walls "
        f"{walls['fit_1x2']} s (world size 1 {w1['fit']:.2f} s); largest "
        f"|2 ranks - world size 1| on the whole batch {worst['fit']} (2 x "
        f"1), {worst['fit_1x2']} (1 x 2) x the errors (limit {SCALE_TOL}); "
        f"phi of {len(d_or)} subints against fit_portrait_numpy (float64, "
        f"{oracle_s:.2f} s on the host): max |dphi| {max(d_or):.3e} rot "
        "(limit 1e-4)")
    log(f"scale-out scattering branch ({nsub_scat} subints): B1 want_m2 "
        f"launches per rank {m2['scat']} (2 x 1), {m2['scat_1x2']} (1 x 2, "
        f"{rows['scat_1x2']} rows), walls {walls['scat']} / "
        f"{walls['scat_1x2']} s (world size 1 {w1['scat']:.2f} s); "
        f"largest difference on the whole batch {worst['scat']} (2 x 1), "
        f"{worst['scat_1x2']} (1 x 2) x the errors; C8 gate: each subint "
        f"fitted alone gives the batch's bits in every field "
        f"({sum(c8_walls):.2f} s for the {len(c8_walls)} single fits)")
    log(f"scale-out align ({inp['align']['ports'].shape[0]} subints): "
        f"template {d_t['2x1']:.3e} (2 x 1), {d_t['1x2']:.3e} (1 x 2) x max "
        f"from world size 1's (limit {SCALE_TEMPLATE_TOL}), fits "
        f"{worst['align']} (2 x 1), {worst['align_1x2']} (1 x 2) x the "
        f"errors; B1 launches per rank {per_rank['align']} (2 x 1), "
        f"{per_rank['align_1x2']} (1 x 2, {rows['align_1x2']} rows); walls "
        f"{walls['align']} / {walls['align_1x2']} s (world size 1 "
        f"{w1['align']:.2f} s)")
    if failures:
        raise AssertionError("; ".join(failures))

    # 4: the sharded campaign against phase 16's run 1
    names = list(inp["jobs"])
    one = campaign_tims(os.path.join(WORK, "campaign-1"), names)
    union = {n: {} for n in names}
    for n in names:
        for r in range(2):
            union[n].update(read_tim(os.path.join(
                scale_dir(), "campaign", f"{n}.p{r}.tim")))
    same = sum(union[n][k] == v for n in names for k, v in one[n].items()
               if k in union[n])
    spread = tims_spread(one, union)
    if recs[0]["summary"] != recs[1]["summary"]:
        raise AssertionError("scale-out campaign: the ranks' summaries "
                             "differ")
    nsum = {n: len(recs[0]["summary"][n][0]) for n in names}
    narch = {}
    for n in names:
        with open(inp["jobs"][n][0]) as fh:
            narch[n] = sum(1 for ln in fh if ln.strip())
    ntoa = sum(len(v) for v in one.values())
    b2 = [rec["launches"]["campaign"]["fused_decode_cross_spectrum"]
          for rec in recs]
    log(f"scale-out campaign (stream_ipta_campaign shard=True, A int16 + B "
        f"2-bit): {sum(rec['ntoa'] for rec in recs)} TOAs over the ranks "
        f"({[rec['ntoa'] for rec in recs]}), walls {walls['campaign']} s; "
        f"B1 launches per rank {per_rank['campaign']}, B2 {b2}; the .tim "
        f"union holds phase 16's {ntoa} lines, {same} of them identical, "
        f"largest difference {spread:.3e} sigma (limit "
        f"{SCALE_TIM_SIGMA}); each rank's summary {nsum} archives, equal")
    if not (spread <= SCALE_TIM_SIGMA and sum(rec["ntoa"] for rec in recs)
            == ntoa and all(nsum[n] == narch[n] for n in names)):
        raise AssertionError("scale-out campaign: .tim union or summary")
    if cuda:
        parent = torch.cuda.memory_reserved()
        log("scale-out memory: peak allocated / reserved per rank, "
            + "; ".join(f"{tag}: " + ", ".join(
                f"{rec['peak'][tag][0] / 2**30:.2f} / "
                f"{rec['peak'][tag][1] / 2**30:.2f} GiB" for rec in recs)
                for tag in list(SCALE_MESHES) + ["campaign"])
            + f"; this process holds {parent / 2**30:.2f} GiB reserved")
    total = {k: sum(launches[n].get(k, 0) for n in launches)
             for k in ("fused_cross_spectrum", "fused_decode_cross_spectrum",
                       "fused_cross_spectrum.m2")}
    log(f"scale-out launches over both ranks: {launches}")
    return total


# ---------------------------------------------------------------------------
# phase 22: a subint's fit does not depend on its bucket (ROADMAP C8)

C8_NSUB = 8
C8_LANES = ("fast", "packed", "scat_auto")
# lanes with no harmonic window: the complex engine and narrowband
C8_FULL_LANES = ("complex", "narrowband")
C8_BATCH_KEYS = ("ports", "noise_stds", "P", "nu_fit", "theta0",
                 "chan_masks", "raw", "scl", "offs")


def pack_2bit(ports, rng):
    """Float rows (..., nbin) as dithered 4-level samples, packed four to
    a byte, the first sample in the most significant bits (the PSRFITS
    convention): (raw uint8 (..., nbin / 4), scl, offs (...)), decoding
    to s scl + offs ~ the rows."""
    import numpy as np

    x = np.asarray(ports, np.float64)
    mu = x.mean(-1)
    step = x.std(-1)
    z = (x - mu[..., None]) / step[..., None]
    s = np.clip(np.floor(z + 2.0 + rng.uniform(-0.5, 0.5, x.shape)), 0,
                3).astype(np.uint8)
    b = s.reshape(s.shape[:-1] + (-1, 4))
    raw = (b[..., 0] << 6) | (b[..., 1] << 4) | (b[..., 2] << 2) | b[..., 3]
    return (raw.astype(np.uint8), step.astype(np.float32),
            (mu - 1.5 * step).astype(np.float32))


def c8_inputs(device="cuda", nsub=C8_NSUB, nchan=NCHAN, nbin=NBIN,
              work=None):
    """The C8 gate's subints: an int16 archive of nsub x nchan x nbin
    with the scattering path's injection (phase 21's scattering archive),
    loaded as GetTOAs loads it (float32, the .gmodel portrait, DM and
    log10 tau seeded), plus its rows as dithered packed 2-bit samples.
    Returns (inputs, the template's derived harmonic window)."""
    import numpy as np
    from pulseportraiture_tpu_torch.fit.portrait import \
        resolve_harmonic_window
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.pipeline.models import TemplateModel
    from pulseportraiture_tpu_torch.pipeline.toas import (
        load_for_toas, snr_weighted_nu_fit)
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    work = work or os.path.join(WORK, "c8")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "scat.fits")
    gmodel = os.path.join(work, "model.gmodel")
    model = default_test_model(1500.0)
    write_gmodel(model, gmodel, quiet=True)
    make_fake_pulsar(model, PAR, outfile=path, nsub=nsub, nchan=nchan,
                     nbin=nbin, nu0=1500.0, bw=800.0, tsub=60.0,
                     phase=PHI_INJ, dDM=DDM_INJ, t_scat=T_SCAT,
                     alpha=ALPHA_INJ, start_MJD=MJD(55700, 0.1),
                     noise_stds=NOISE_SCAT_I16, dedispersed=False,
                     quiet=True, rng=np.random.default_rng(SEED + 200),
                     device=device)
    d = load_for_toas(path)
    ok = np.asarray(d.ok_isubs, int)
    freqs = np.asarray(d.freqs[0], float)
    P = np.asarray(d.Ps[ok], float)
    masks = np.asarray(d.weights[ok] > 0.0, np.float32)
    theta0 = np.zeros((len(ok), 5))
    theta0[:, 1] = float(d.DM)
    theta0[:, 3] = math.log10(0.5 * T_SCAT / float(np.mean(P)))
    theta0[:, 4] = -4.0
    mp = np.asarray(TemplateModel(gmodel, device=device).portrait(
        freqs, d.nbin, P=float(np.mean(P))), np.float32)
    ports = np.asarray(d.subints[ok, 0], np.float32)
    raw, scl, offs = pack_2bit(ports, np.random.default_rng(SEED + 201))
    inp = dict(ports=ports, models=mp,
               noise_stds=np.asarray(d.noise_stds[ok, 0], np.float32),
               freqs=freqs.astype(np.float32), P=P.astype(np.float32),
               nu_fit=snr_weighted_nu_fit(np.asarray(d.SNRs[ok, 0]) * masks,
                                          freqs).astype(np.float32),
               theta0=theta0.astype(np.float32), chan_masks=masks,
               raw=raw, scl=scl, offs=offs)
    return inp, resolve_harmonic_window("auto", mp, nbin)


def c8_fit(lane, inp, sl, K, device):
    """One lane's fit of the subints ``sl`` of c8_inputs, through the
    entry points the pipelines call, on the harmonic window K (None: no
    window, which on CUDA is every harmonic through the fused kernels,
    fit.portrait.full_spectrum_window):

    - 'fast': fit_portrait_batch_fast, (phi, DM) free (B1's S0 form);
    - 'packed': fast_fit_batched_packed on the 2-bit rows (B2; no
      window: K = nbin / 2 + 1, as the stream's raw lane resolves it);
    - 'scat_auto': the stream raw lane's scat_guess='auto': the tau seed
      estimate_tau_batch (B1's want_m2 form at every harmonic on CUDA),
      then fit_portrait_batch_fast with (phi, DM, tau, alpha) free, log10
      tau (B1's want_m2 form);
    - 'complex': the complex engine, fit_portrait_batch, (phi, DM) free
      (complex64 on CUDA; spectra and CCF seed through the invariant
      matmul DFT, ops.fourier.rfft_c_rows), K unused;
    - 'narrowband': fit_phase_shift_batch, every channel's profile (its
      spectra and dense CCF the same way), K unused."""
    import torch
    from pulseportraiture_tpu_torch.fit.phase_shift import \
        fit_phase_shift_batch
    from pulseportraiture_tpu_torch.fit.portrait import (
        FitFlags, estimate_tau_batch, fast_fit_batched_packed,
        fit_portrait_batch, fit_portrait_batch_fast)

    a = {k: torch.as_tensor(v[sl] if k in C8_BATCH_KEYS else v).to(device)
         for k, v in inp.items()}
    nbin = a["ports"].shape[-1]
    window = False if K is None else K
    if lane == "complex":
        return fit_portrait_batch(
            a["ports"], a["models"], a["noise_stds"], a["freqs"], a["P"],
            a["nu_fit"], theta0=a["theta0"] * torch.tensor(
                [0.0, 1.0, 0.0, 0.0, 0.0], device=device),
            chan_masks=a["chan_masks"], fit_flags=FitFlags(True, True),
            device=device)
    if lane == "narrowband":
        return fit_phase_shift_batch(a["ports"], a["models"],
                                     a["noise_stds"], device=device)
    if lane == "fast":
        return fit_portrait_batch_fast(
            a["ports"], a["models"], a["noise_stds"], a["freqs"], a["P"],
            a["nu_fit"], theta0=a["theta0"] * torch.tensor(
                [0.0, 1.0, 0.0, 0.0, 0.0], device=device),
            chan_masks=a["chan_masks"], fit_flags=FitFlags(True, True),
            max_iter=40, harmonic_window=window, device=device)
    if lane == "packed":
        nb = a["raw"].shape[0]
        return fast_fit_batched_packed(
            a["raw"].contiguous(), a["scl"], a["offs"], a["models"],
            a["noise_stds"], a["chan_masks"], a["freqs"], a["P"],
            a["nu_fit"], torch.full((nb,), -1.0, device=device),
            a["theta0"] * torch.tensor([0.0, 1.0, 0.0, 0.0, 0.0],
                                       device=device),
            raw_code="p2", nbin=nbin, fit_flags=FitFlags(True, True),
            max_iter=40, nharm_eff=K or nbin // 2 + 1)
    tau0 = estimate_tau_batch(a["ports"], a["models"], a["noise_stds"],
                              a["chan_masks"])
    theta0 = a["theta0"].clone()
    theta0[:, 3] = torch.log10(torch.clamp(tau0, min=1e-12))
    return fit_portrait_batch_fast(
        a["ports"], a["models"], a["noise_stds"], a["freqs"], a["P"],
        a["nu_fit"], theta0=theta0, chan_masks=a["chan_masks"],
        fit_flags=FitFlags(True, True, False, True, True), log10_tau=True,
        max_iter=60, harmonic_window=window, device=device)


def _kernel_windows():
    """Wrap the fused kernels' CUDA entry points to record the harmonic
    count of every launch: returns (records, restore)."""
    from pulseportraiture_tpu_torch.ops import fused as F

    seen = []
    orig = (F.fused_cross_spectrum_cuda, F.fused_decode_cross_spectrum_cuda)

    def b1(port, model, w, nharm, *a, **kw):
        seen.append(("B1.m2" if kw.get("want_m2") else "B1", int(nharm)))
        return orig[0](port, model, w, nharm, *a, **kw)

    def b2(raw, scl, offs, model, w, nharm, *a, **kw):
        seen.append(("B2", int(nharm)))
        return orig[1](raw, scl, offs, model, w, nharm, *a, **kw)

    F.fused_cross_spectrum_cuda, F.fused_decode_cross_spectrum_cuda = b1, b2

    def restore():
        F.fused_cross_spectrum_cuda, F.fused_decode_cross_spectrum_cuda = orig
    return seen, restore


def kernel_rows_invariance(device="cuda", nsub=3, nchan=37, nbin=NBIN):
    """B1 (S0, want_m2) and B2 at K = nbin / 2 + 1 on nsub random subints
    of an odd channel count (the FFT arm's row pairs would cross the
    subints: ops.fused._odd_batch pads each with a zero channel): each
    subint alone gives the batch's bits in every output, else raise."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F

    K = nbin // 2 + 1
    g = torch.Generator().manual_seed(SEED + 301)
    port = torch.randn(nsub, nchan, nbin, generator=g).to(device)
    model = torch.randn(nchan, nbin, generator=g).to(device)
    w = torch.rand(nsub, nchan, K, generator=g).to(device)
    raw = torch.randint(0, 256, (nsub, nchan, nbin // 4), generator=g,
                        dtype=torch.uint8).to(device)
    scl = (torch.rand(nsub, nchan, generator=g) + 0.5).to(device)
    offs = torch.randn(nsub, nchan, generator=g).to(device)
    calls = {
        "B1": lambda sl: F.fused_cross_spectrum(port[sl].contiguous(), model,
                                                w[sl].contiguous(), K),
        "B1 want_m2": lambda sl: F.fused_cross_spectrum(
            port[sl].contiguous(), model, w[sl].contiguous(), K,
            want_m2=True),
        "B2": lambda sl: F.fused_decode_cross_spectrum(
            raw[sl].contiguous(), scl[sl], offs[sl], model,
            w[sl].contiguous(), K, code="p2", nbin=nbin)}
    for name, fn in calls.items():
        whole = fn(slice(None))
        for i in range(nsub):
            one = fn(slice(i, i + 1))
            if not all(torch.equal(a[0], b[i]) for a, b in zip(one, whole)):
                raise AssertionError(f"{name} at {nsub}x{nchan}x{nbin} K={K}: "
                                     f"subint {i} alone differs from the "
                                     "batch")
    log(f"kernels at an odd channel count ({nsub}x{nchan}x{nbin}, K={K}): "
        "B1, B1 want_m2 and B2 give each subint alone the batch's bits")


def c8_gate(inp, nsub, runs, device, label):
    """C8's gate: for each (lane, window) of runs, c8_fit of the nsub
    subints of inp as one batch and of each subint alone; each alone
    must give the batch's bits in every tensor field of the result and
    the batch return codes in {0, 1, 2}, else raise."""
    import torch

    for lane, k in runs:
        t0 = time.perf_counter()
        ref = c8_fit(lane, inp, slice(0, nsub), k, device)
        sync(device)
        t_batch = time.perf_counter() - t0
        fields = [f for f in (ref._fields if hasattr(ref, "_fields")
                              else ref.keys())
                  if torch.is_tensor(ref[f] if isinstance(ref, dict)
                                     else getattr(ref, f))]
        get = ((lambda r, f: r[f]) if isinstance(ref, dict) else getattr)
        walls = []
        for i in range(nsub):
            t0 = time.perf_counter()
            one = c8_fit(lane, inp, slice(i, i + 1), k, device)
            sync(device)
            walls.append(time.perf_counter() - t0)
            diff = [f for f in fields
                    if not torch.equal(get(one, f)[0], get(ref, f)[i])]
            if diff:
                raise AssertionError(
                    f"{label}: lane {lane} window {k}: subint {i} fitted "
                    f"alone differs from the batch of {nsub} in {diff}")
        codes = (ref.return_code.tolist() if hasattr(ref, "_fields")
                 else [0])
        log(f"{label} {lane} window {k}: {nsub} subints alone = the batch "
            f"of {nsub} bit for bit in all {len(fields)} fields; batch "
            f"{t_batch:.3f} s, alone {min(walls):.3f}-{max(walls):.3f} s, "
            f"codes {codes}")
        if not all(c in (0, 1, 2) for c in codes):
            raise AssertionError(f"{label} {lane}: codes {codes}")


def phase_batch_invariance(device="cuda", nsub=C8_NSUB, nchan=NCHAN,
                           nbin=NBIN):
    """Phase 22, ROADMAP C8's gate on every fast lane: c8_inputs' nsub
    subints fitted as one batch and each alone, through the fast fit
    (B1), the packed 2-bit fit (B2) and the scattering fit with
    scat_guess='auto' (B1's want_m2 form for the seed and the fit), with
    the template's window and without one (every harmonic through the
    kernels on CUDA, K = nbin / 2 + 1): each subint alone must give the
    batch's bits in every FitResult field, else raise.  The kernels'
    counters are set to 0 just before the fits and read just after; on
    CUDA every lane must have launched its kernel through the FFT arm
    only, and the unwindowed fits at K = nbin / 2 + 1 only.  Returns the
    launches."""
    from pulseportraiture_tpu_torch.ops import fused as F

    t0 = time.perf_counter()
    inp, K = c8_inputs(device, nsub, nchan, nbin)
    log(f"C8 gate inputs: {nsub} x {nchan} x {nbin} scattered int16 and "
        f"its 2-bit rows, window K={K}, in {time.perf_counter() - t0:.2f} s")
    if K is None:
        raise AssertionError("C8 gate: the template derived no window")
    cuda = device_type(device) == "cuda"
    if cuda:
        seen, restore = _kernel_windows()
    F.reset_kernel_launches()
    try:
        c8_gate(inp, nsub, [(ln, kk) for ln in C8_LANES for kk in (K, None)]
                + [(ln, None) for ln in C8_FULL_LANES], device, "C8 gate")
    finally:
        if cuda:
            restore()
    launches = F.kernel_launches()
    log(f"C8 gate kernel launches {launches}")
    if cuda:
        kernel_rows_invariance(device, nbin=nbin)
        fft_only(launches, ("fused_cross_spectrum",
                            "fused_decode_cross_spectrum"), "the C8 gate")
        if not launches["fused_cross_spectrum.m2"]:
            raise AssertionError("C8 gate: B1's want_m2 form never ran")
        log(f"C8 gate calls by (kernel, K): "
            f"{dict(sorted(Counter(seen).items()))} (two launches each)")
        full = {(n, kk) for n, kk in seen if kk == nbin // 2 + 1}
        want = {("B1", nbin // 2 + 1), ("B1.m2", nbin // 2 + 1),
                ("B2", nbin // 2 + 1)}
        if not want <= full or {kk for _, kk in seen} != {K, nbin // 2 + 1}:
            raise AssertionError(f"C8 gate: kernel windows {sorted(set(seen))}"
                                 f"; expected every kernel at K={K} and "
                                 f"{nbin // 2 + 1}")
    return launches


def phase_stream_alone(device="cuda", which=1):
    """Phase 22's end-to-end gate: ``pptoas --stream`` over the stream
    path's 9-archive campaign (phase 6's metafile) and over its 2-bit
    archive ``which`` alone, both with no harmonic window (the template's
    window off: every harmonic through B2 and B1 on CUDA); the lone
    archive's .tim lines must equal its lines in the campaign's .tim,
    byte for byte, and every campaign TOA recover the injected phase to
    1e-4 rot.  The counters are set to 0 before each run and read
    after it (B2 and B1 at K = nbin / 2 + 1 through the FFT arm).
    Returns the launches of both runs."""
    from pulseportraiture_tpu_torch import config

    meta = os.path.join(WORK, "stream_meta.txt")
    gmodel = os.path.join(WORK, "model.gmodel")
    with open(meta) as f:
        files = [ln.strip() for ln in f if ln.strip()]
    lone = os.path.join(WORK, "stream_alone_meta.txt")
    with open(lone, "w") as f:
        f.write(files[which] + "\n")
    saved = config.fit_harmonic_window
    config.fit_harmonic_window = None
    total = None
    tims = []
    try:
        for m, label in ((meta, "campaign"), (lone, "alone")):
            tim = os.path.join(WORK, f"stream_nowindow_{label}.tim")
            if os.path.exists(tim):
                os.remove(tim)
            wall, launches = run_cli(
                ["--stream", "-d", m, "-m", gmodel, "-o", tim, "--quiet",
                 "--print_phase", "--quality_flags", "--device", device],
                f"pptoas --stream no window ({label})")
            log(f"stream no window ({label}): {wall:.3f} s, launches "
                f"{launches}")
            if device_type(device) == "cuda":
                fft_only(launches, ("fused_decode_cross_spectrum",
                                    "fused_cross_spectrum")
                         if label == "campaign"
                         else ("fused_decode_cross_spectrum",),
                         f"stream no window ({label})")
            total = launches if total is None else {
                k: total[k] + v for k, v in launches.items()}
            with open(tim) as f:
                tims.append([ln for ln in f if ln.strip()])
    finally:
        config.fit_harmonic_window = saved
    name = os.path.basename(files[which])
    mine = [ln for ln in tims[0]
            if ln.split()[0] in (files[which], name)]
    if not mine or mine != tims[1]:
        raise AssertionError(
            f"stream no window: {name} alone wrote {len(tims[1])} lines, "
            f"{len(mine)} in the campaign; equal byte for byte: "
            f"{mine == tims[1]}")
    worst = 0.0
    for tok in (ln.split() for ln in tims[0]):
        phi = float(dict(zip(tok[5::2], tok[6::2]))["-phs"])
        worst = max(worst, abs((phi - expected_phase(float(tok[1])) + 0.5)
                               % 1.0 - 0.5))
    if not worst < 1e-4:
        raise AssertionError(f"stream no window: phase recovery |dphi| = "
                             f"{worst:.3e} rot >= 1e-4")
    log(f"stream no window: {name} streamed alone = its {len(mine)} lines "
        f"of the {len(files)}-archive campaign, byte for byte; max |dphi| "
        f"= {worst:.3e} rot over the campaign's {len(tims[0])} TOAs (limit "
        "1e-4)")
    return total


def phase_compile_cache(device="cuda"):
    """--compile-cache: a fresh process pointed at this process's kernel
    build (PPT_COMPILE_CACHE = ops.fused.BUILD_DIR) must load the
    library built there without the builder (build_info 'cached'), and
    launch B1 through it.  Returns that process's load seconds."""
    from pulseportraiture_tpu_torch.ops import fused as F

    code = ("import json, torch; from pulseportraiture_tpu_torch.ops "
            "import fused as F; from pulseportraiture_tpu_torch.utils."
            "device import enable_compile_cache; enable_compile_cache(); "
            "F.build_kernels(); x = torch.randn(2, 8, 256, device='cuda'); "
            "m = torch.randn(8, 256, device='cuda'); w = torch.rand(8, 129, "
            "device='cuda'); F.fused_cross_spectrum(x, m, w, 129); "
            "torch.cuda.synchronize(); print(json.dumps(dict(F.build_info, "
            "launches=F.kernel_launches()['fused_cross_spectrum'])))")
    env = dict(os.environ, PPT_COMPILE_CACHE=F.BUILD_DIR,
               PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"compile cache: the fresh process failed: "
                             f"{r.stderr[-2000:]}")
    info = json.loads(r.stdout.strip().splitlines()[-1])
    if not info["cached"] or info["launches"] != 2:
        raise AssertionError(f"compile cache: {info}")
    log(f"compile cache: a fresh process loaded the kernels from "
        f"{info['dir']} without nvcc in {info['seconds']:.3f} s "
        f"(process wall {wall:.2f} s; this process's build "
        f"{F.build_info['seconds']:.2f} s, cached {F.build_info['cached']})")
    return info["seconds"]


# dft_precision 'high' / 'default' (TF32 matmul DFTs) against 'highest',
# as a fraction of max|ref| (TF32 keeps 10 mantissa bits: ~5e-4 per
# product; the measured gap at 512 x 2048 was 7.3e-5, PERF.md PR 18)
TF32_TOL = 1e-3


def check_tf32_arms(device="cuda", nsub=8, nchan=NCHAN, nbin=NBIN):
    """The TF32 arms of dft_precision on the card: rfft_mm and
    irfft_mm_invariant of nsub x nchan x nbin random rows at 'high' and
    'default' against 'highest', each output within TF32_TOL x its
    max|ref| and not all equal to it (TF32 engaged), and torch's TF32
    flag as it was after every call.  Returns the worst relative gap."""
    import torch
    from pulseportraiture_tpu_torch.ops import fourier as FO

    g = torch.Generator().manual_seed(SEED + 300)
    x = torch.randn(nsub, nchan, nbin, generator=g).to(device)
    flag = torch.backends.cuda.matmul.allow_tf32
    ref = FO.rfft_mm(x, precision="highest")
    iref = FO.irfft_mm_invariant(*ref, n=2 * nbin, precision="highest")
    worst = 0.0
    for prec in ("high", "default"):
        got = FO.rfft_mm(x, precision=prec)
        igot = FO.irfft_mm_invariant(*got, n=2 * nbin, precision=prec)
        if torch.backends.cuda.matmul.allow_tf32 != flag:
            raise AssertionError(f"dft_precision={prec}: the TF32 flag was "
                                 "left changed")
        for a, b in zip(got + (igot,), ref + (iref,)):
            rel = float((a - b).abs().max() / b.abs().max())
            worst = max(worst, rel)
            if not rel <= TF32_TOL:
                raise AssertionError(f"dft_precision={prec}: {rel:.3e} x "
                                     f"max|ref| (limit {TF32_TOL})")
    if device_type(device) == "cuda" and worst == 0.0:
        raise AssertionError("dft_precision high/default gave the 'highest' "
                             "bits: TF32 never engaged")
    log(f"dft_precision high/default (TF32) vs highest at {nsub}x{nchan}x"
        f"{nbin}: worst {worst:.3e} x max|ref| (limit {TF32_TOL}), the TF32 "
        "flag restored")
    return worst


def phase_full_spectrum_timing():
    """The kernels at K = NBIN / 2 + 1, the unwindowed lanes' shape: B1's
    S0 form at the main path's shape (phase_timing), its want_m2 form at
    the scattering bucket's (phase_m2_timing) and B2 at the stream
    bucket's (phase_decode_timing), each held to its plain version at
    1e-5 x max|ref| (float64 oracle) and timed beside its bound, plain
    version and library equivalents.  Returns the three records."""
    K = NBIN // 2 + 1
    return dict(s0=phase_timing(K, Ks=(K,))[K], m2=phase_m2_timing(K),
                b2=phase_decode_timing(K))


def gemm_bound_ms(rows, nbin, K):
    """The float32 GEMM arm's own least time for the form it runs: 4 L K
    FLOPs (cos and sin products) per transformed row (data and template
    rows) over L samples, L = nbin / 2 - 1 at even nbin >= 8 (it folds:
    the symmetric and antisymmetric sums) and nbin otherwise, three TF32
    products each (FP32 accuracy), over the dense TF32 tensor-core
    peak."""
    L = nbin // 2 - 1 if nbin % 2 == 0 and nbin >= 8 else nbin
    return 3.0 * 4.0 * rows * L * K / PEAK_TF32_FLOPS * 1e3


def gemm_fma_bound_ms(rows, nbin, K):
    """The direct form's 4 nbin K FLOPs per row over the FP32 FMA peak:
    the bound of the SIMT GEMM that ran float32 before the tensor cores
    (PR 1-19, direct unless fold was asked for), printed beside
    gemm_bound_ms for the history."""
    return 4.0 * rows * nbin * K / PEAK_FP32_FLOPS * 1e3


def time_cross_spectrum(nb, nchan, nbin, K, want_m2=False, seed=0, n=10):
    """B1 at nb x nchan x nbin (float32, one shared template, per-element
    weights) at window K: the kernel through the arm the shape rule picks,
    its GEMM arm, its plain version and the torch.matmul and cuFFT
    equivalents, each output held first to 1e-5 x max|ref| (plain_oracle,
    the float64 oracle; the matmul equivalent, which sums in the float32
    plain version's order, to that version), then timed (median of n
    samples of 5 calls); with the function's bound
    (cross_spectrum_bound_ms) and the GEMM arm's own (gemm_bound_ms: its
    three-product TF32 bound, and the FP32-FMA one of the SIMT arm it
    replaced).  Returns the record."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.ops.fourier import device_weights

    name = (f"{'want_m2' if want_m2 else 'S0'} {nb}x{nchan}x{nbin} K={K}")
    c = cross_spectrum_case(name, nb, nchan, nbin, K, torch.float32,
                            want_m2=want_m2, seed=seed)
    args = (c["port"], c["model"], c["w"], K)
    kw = dict(want_m2=want_m2)
    parts = ("Xr", "Xi", "M2w" if want_m2 else "S0")
    before = F.kernel_launches()
    got = F.fused_cross_spectrum_cuda(*args, **kw)
    arm = expect_arm("fused_cross_spectrum", before, case_arm(c, nbin), name)
    ref, ref32 = plain_oracle(F.fused_cross_spectrum_ref, args, kw)
    errs, text = check_outputs(name, "fused_cross_spectrum", got, ref, ref32,
                               parts)
    del got
    if arm != "gemm":
        check_outputs(f"{name} GEMM arm", "fused_cross_spectrum",
                      F.fused_cross_spectrum_cuda(*args, arm="gemm", **kw),
                      ref, ref32, parts)
    Wc, Ws = device_weights("rfft", c["port"].device, nbin, "float32", K)
    W = torch.cat([Wc, Ws], dim=1).contiguous()
    check_outputs(f"{name} torch.matmul equivalent", "library_equivalent",
                  library_equivalent(c["port"], c["model"], c["w"], K, W,
                                     want_m2=want_m2), ref32, ref32, parts)
    check_outputs(f"{name} cuFFT equivalent", "cufft_equivalent",
                  cufft_equivalent(c["port"], c["model"], c["w"], K,
                                   want_m2=want_m2), ref, ref32, parts)
    del ref, ref32
    err, scale, _ = max(errs, key=lambda t: t[0] / max(t[1], 1e-300))
    ms = median_ms(lambda: F.fused_cross_spectrum_cuda(*args, **kw), n=n)
    gemm_ms = ms if arm == "gemm" else median_ms(
        lambda: F.fused_cross_spectrum_cuda(*args, arm="gemm", **kw), n=n)
    plain_ms = median_ms(lambda: F.fused_cross_spectrum_ref(*args, **kw),
                         n=n)
    lib_ms = median_ms(lambda: library_equivalent(
        c["port"], c["model"], c["w"], K, W, want_m2=want_m2), n=n)
    cufft_ms = median_ms(lambda: cufft_equivalent(
        c["port"], c["model"], c["w"], K, want_m2=want_m2), n=n)
    ms2 = median_ms(lambda: F.fused_cross_spectrum_cuda(*args, **kw), n=n)
    bound, by = cross_spectrum_bound_ms(nb, nchan, nbin, K, 4, want_m2)
    gbound = gemm_bound_ms(nb * nchan + nchan, nbin, K)
    fbound = gemm_fma_bound_ms(nb * nchan + nchan, nbin, K)
    log(f"timing fused_cross_spectrum {name} f32: kernel ({arm} arm) "
        f"{ms:.4f} ms (again {ms2:.4f}), GEMM arm {gemm_ms:.4f} ms (its own "
        f"three-product TF32 bound {gbound:.4f} ms, "
        f"{100.0 * gbound / gemm_ms:.1f} %; FP32-FMA bound {fbound:.4f} "
        f"ms), plain {plain_ms:.4f} ms, torch.matmul equivalent "
        f"{lib_ms:.4f} ms, cuFFT equivalent {cufft_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}), "
        f"kernel at {100.0 * bound / ms:.1f} % of its bound"
        f"{'' if ms <= cufft_ms else ', SLOWER than the cuFFT equivalent'}; "
        f"max abs err {text}")
    return dict(shape=[nb, nchan, nbin, K], want_m2=want_m2, arm=arm, ms=ms,
                ms_again=ms2, gemm_arm_ms=gemm_ms, gemm_bound_ms=gbound,
                gemm_fma_bound_ms=fbound,
                plain_ms=plain_ms, library_ms=lib_ms, cufft_ms=cufft_ms,
                bound_ms=bound, bound_by=by, max_abs_err=err,
                max_abs_ref=scale)


def time_decode(nb, nchan, nbin, K, code="p2", seed=0, n=10):
    """B2 at nb x nchan x nbin packed rows (float32, per-element weights)
    at window K: the kernel (its arm by the shape rule), its GEMM arm,
    its plain version and the two torch equivalents (the decode as torch
    ops, then torch.matmul or torch.fft.rfft), each output held first to
    1e-5 x max|ref| (check_decode_case, plain_oracle), then timed (median
    of n samples of 5 calls); with the bound (decode_bound_ms) and the
    GEMM arm's own (gemm_bound_ms).  Returns the record."""
    import torch
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.ops.decode import PACKED_BITS
    from pulseportraiture_tpu_torch.ops.fourier import device_weights

    nbit = PACKED_BITS[code]
    name = f"{nbit}-bit {nb}x{nchan}x{nbin} K={K}"
    c = decode_case(name, nb, nchan, nbin, K, torch.float32, code, seed=seed)
    err, scale, part = check_decode_case(c)
    arm = case_arm(c, nbin)
    args = (c["raw"], c["scl"], c["offs"], c["model"], c["w"], K)
    kw = dict(code=code, nbin=nbin)
    parts = ("Xr", "Xi", "S0", "pwr", "x0")
    ref, ref32 = plain_oracle(F.fused_decode_cross_spectrum_ref, args, kw)
    if arm != "gemm":
        check_outputs(f"{name} GEMM arm", "fused_decode_cross_spectrum",
                      F.fused_decode_cross_spectrum_cuda(*args, arm="gemm",
                                                         **kw),
                      ref, ref32, parts)
    check_outputs(f"{name} cuFFT equivalent", "decode_library_equivalent",
                  decode_library_equivalent(*args, code, nbin), ref, ref32,
                  parts)
    del ref, ref32
    Wc, Ws = device_weights("rfft", c["raw"].device, nbin, "float32", K)
    W = torch.cat([Wc, Ws], dim=1).contiguous()
    ms = median_ms(lambda: F.fused_decode_cross_spectrum_cuda(*args, **kw),
                   n=n)
    gemm_ms = ms if arm == "gemm" else median_ms(
        lambda: F.fused_decode_cross_spectrum_cuda(*args, arm="gemm", **kw),
        n=n)
    plain_ms = median_ms(
        lambda: F.fused_decode_cross_spectrum_ref(*args, **kw), n=n)
    lib_ms = median_ms(lambda: decode_library_equivalent(
        *args, code, nbin, W), n=n)
    cufft_ms = median_ms(lambda: decode_library_equivalent(
        *args, code, nbin), n=n)
    ms2 = median_ms(lambda: F.fused_decode_cross_spectrum_cuda(*args, **kw),
                    n=n)
    bound, by = decode_bound_ms(nb, nchan, nbin, K, nbit)
    gbound = gemm_bound_ms(nb * nchan + nchan, nbin, K)
    fbound = gemm_fma_bound_ms(nb * nchan + nchan, nbin, K)
    log(f"timing fused_decode_cross_spectrum {name} f32: kernel ({arm} arm) "
        f"{ms:.4f} ms (again {ms2:.4f}), GEMM arm {gemm_ms:.4f} ms (its own "
        f"three-product TF32 bound {gbound:.4f} ms, "
        f"{100.0 * gbound / gemm_ms:.1f} %; FP32-FMA bound {fbound:.4f} ms), "
        f"plain {plain_ms:.4f} ms, torch "
        f"equivalents: decode + torch.matmul {lib_ms:.4f} ms, decode + "
        f"torch.fft.rfft {cufft_ms:.4f} ms; bound {bound:.4f} ms ({by}), "
        f"kernel at {100.0 * bound / ms:.1f} % of its bound"
        f"{'' if ms <= cufft_ms else ', SLOWER than the cuFFT equivalent'}; "
        f"worst {part} max abs err {err:.3e} of max|ref| {scale:.3e}")
    return dict(shape=[nb, nchan, nbin, K], code=code, arm=arm, ms=ms,
                ms_again=ms2, gemm_arm_ms=gemm_ms, gemm_bound_ms=gbound,
                gemm_fma_bound_ms=fbound,
                plain_ms=plain_ms, library_ms=lib_ms, cufft_ms=cufft_ms,
                bound_ms=bound, bound_by=by, max_abs_err=err,
                max_abs_ref=scale)


def mixed_archives(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=MIXED_NBIN,
                   narch=MIXED_NARCH, sub="mixed"):
    """Phase 23's (and 24's) campaign under WORK/sub: an int16 archive of
    nsub x nchan x nbin with the main path's injection and narch 2-bit
    archives (each its own epoch and noise draw) in one metafile, and the
    .gmodel.  Returns (metafile, int16 archive, 2-bit archives,
    .gmodel)."""
    import numpy as np
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    work = os.path.join(WORK, sub)
    os.makedirs(work, exist_ok=True)
    model = default_test_model(1500.0)
    gmodel = os.path.join(work, "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    int16 = os.path.join(work, "fake.fits")
    files = []
    for i in range(narch + 1):
        path = int16 if i == 0 else os.path.join(work, f"fake2bit-{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=nsub, nchan=nchan,
                         nbin=nbin, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=PHI_INJ, dDM=DDM_INJ,
                         start_MJD=MJD(55300 + i, 0.1),
                         noise_stds=1.0 if i == 0 else NOISE_2BIT,
                         dedispersed=False, quiet=True,
                         rng=np.random.default_rng(SEED + 400 + i),
                         nbit=2 if i else 16, device=device)
        if i:
            files.append(path)
    meta = os.path.join(work, "stream_meta.txt")
    with open(meta, "w") as f:
        f.write("\n".join([int16] + files) + "\n")
    return meta, int16, files, gmodel


def tim_phase_recovery(tim, n):
    """The worst |dphi| [rot] of the .tim's TOAs against the injection
    (expected_phase at each TOA's frequency); raises unless the file has
    n finite TOA lines."""
    worst = 0.0
    with open(tim) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    if len(lines) != n:
        raise AssertionError(f"{tim}: {len(lines)} TOAs, expected {n}")
    for tok in lines:
        flags = dict(zip(tok[5::2], tok[6::2]))
        phi = float(flags["-phs"])
        if not all(math.isfinite(float(x))
                   for x in (tok[3], phi, flags["-pp_dm"])):
            raise AssertionError(f"non-finite TOA line {tok}")
        worst = max(worst, abs((phi - expected_phase(float(tok[1])) + 0.5)
                               % 1.0 - 0.5))
    return worst


def phase_nbin_mixed(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=MIXED_NBIN,
                     narch=MIXED_NARCH, nsub_c8=MIXED_C8_NSUB, arm="fft"):
    """Phase 23 (arm 'fft': a non-power-of-two 5-smooth nbin, the FFT
    arm's mixed-radix plan) and phase 24 (arm 'gemm': an nbin with a
    prime factor above 5, the GEMM arm) on the main and stream paths:
    mixed_archives at nbin bins; ``pptoas`` (GetTOAs) on the int16 archive
    at window MIXED_K and unwindowed (every harmonic through B1 on CUDA),
    then ``pptoas --stream`` over it and the 2-bit archives at MIXED_K,
    each run in this process with the counters set to 0 just before it
    and read just after: every TOA within 1e-4 rot of the injection, and
    on CUDA every B1 and B2 launch through ``arm``, none through the
    other; then the C8 gate (c8_gate) on nsub_c8 scattered subints at
    nbin bins, the fast, packed and scat_guess='auto' lanes at MIXED_K and
    unwindowed.  Runs before phase 22, which stays last.  Returns the
    launches of all its runs."""
    from pulseportraiture_tpu_torch import config
    from pulseportraiture_tpu_torch.ops import fused as F

    sub = "mixed" if arm == "fft" else f"nbin{nbin}"
    only = fft_only if arm == "fft" else gemm_only
    t0 = time.perf_counter()
    meta, int16, files, gmodel = mixed_archives(device, nsub, nchan, nbin,
                                                narch, sub)
    log(f"nbin {nbin} ({arm} arm) archives: an int16 and {narch} 2-bit "
        f"{nsub}x{nchan}x{nbin} written in {time.perf_counter() - t0:.2f} s")
    cuda = device_type(device) == "cuda"
    total = Counter()
    saved = config.fit_harmonic_window
    if cuda:
        seen, restore = _kernel_windows()
    try:
        runs = [(["-d", int16], MIXED_K, nsub, ("fused_cross_spectrum",)),
                (["-d", int16], None, nsub, ("fused_cross_spectrum",)),
                (["--stream", "-d", meta], MIXED_K, (narch + 1) * nsub,
                 ("fused_cross_spectrum", "fused_decode_cross_spectrum"))]
        for args, window, ntoa, kernels in runs:
            config.fit_harmonic_window = window
            label = (f"{'pptoas --stream' if '--stream' in args else 'pptoas'}"
                     f" at {nbin} bins, window {window}")
            tim = os.path.join(WORK, sub, "out.tim")
            if os.path.exists(tim):
                os.remove(tim)
            wall, launches = run_cli(
                args + ["-m", gmodel, "-o", tim, "--quiet", "--print_phase",
                        "--quality_flags", "--device", device], label)
            worst = tim_phase_recovery(tim, ntoa)
            if not worst < 1e-4:
                raise AssertionError(f"{label}: phase recovery |dphi| = "
                                     f"{worst:.3e} rot >= 1e-4")
            log(f"{label}: {ntoa} TOAs in {wall:.3f} s wall incl. load and "
                f"first use, max |dphi| = {worst:.3e} rot (limit 1e-4), "
                f"kernel launches {launches}")
            if cuda:
                only(launches, kernels, label)
            total.update(launches)
        config.fit_harmonic_window = saved
        t0 = time.perf_counter()
        inp, _ = c8_inputs(device, nsub_c8, nchan, nbin,
                           work=os.path.join(WORK, sub, "c8"))
        log(f"nbin {nbin} C8 inputs: {nsub_c8} x {nchan} x {nbin} scattered "
            f"int16 and its 2-bit rows in {time.perf_counter() - t0:.2f} s")
        F.reset_kernel_launches()
        c8_gate(inp, nsub_c8, [(ln, k) for ln in C8_LANES
                               for k in (MIXED_K, None)], device,
                f"C8 gate at {nbin} bins")
        launches = F.kernel_launches()
        if cuda:
            only(launches, ("fused_cross_spectrum",
                            "fused_decode_cross_spectrum"),
                 f"the C8 gate at {nbin} bins")
        total.update(launches)
    finally:
        config.fit_harmonic_window = saved
        if cuda:
            restore()
    total = {k: total[k] for k in F.kernel_launches()}
    log(f"nbin {nbin} launches {total}")
    if cuda:
        windows = sorted({kk for _, kk in seen})
        log(f"nbin {nbin} calls by (kernel, K): "
            f"{dict(sorted(Counter(seen).items()))}")
        if windows != [MIXED_K, nbin // 2 + 1] \
                or not total["fused_cross_spectrum.m2"]:
            raise AssertionError(f"nbin {nbin}: kernel windows {windows}, "
                                 f"want_m2 launches "
                                 f"{total['fused_cross_spectrum.m2']}; "
                                 f"expected K={MIXED_K} and "
                                 f"{nbin // 2 + 1}, want_m2 run")
    return total


def phase_mixed_timing():
    """Phase 23's timing rows: B1's S0 form at 64 x 512 x nbin for nbin in
    MIXED_TIME_NBINS at K = MIXED_K and nbin / 2 + 1, its want_m2 form
    and B2 (2-bit) at a full bucket (NSUB_BATCH x 512 x
    MIXED_BUCKET_NBIN, K = MIXED_K) (time_cross_spectrum, time_decode).
    Returns {"b1": [...], "b2": [...]}."""
    b1 = [time_cross_spectrum(NSUB, NCHAN, n, K, seed=90 + i)
          for i, (n, K) in enumerate((n, K) for n in MIXED_TIME_NBINS
                                     for K in (MIXED_K, n // 2 + 1))]
    b1.append(time_cross_spectrum(NSUB_BATCH, NCHAN, MIXED_BUCKET_NBIN,
                                  MIXED_K, want_m2=True, seed=97))
    b2 = [time_decode(NSUB_BATCH, NCHAN, MIXED_BUCKET_NBIN, MIXED_K,
                      seed=99)]
    return {"b1": b1, "b2": b2}


def phase_nbin_prime(device="cuda", nsub=NSUB, nchan=NCHAN, nbin=PRIME_NBIN,
                     narch=MIXED_NARCH, nsub_c8=MIXED_C8_NSUB):
    """Phase 24: phase_nbin_mixed at an nbin with a prime factor above 5
    (PRIME_NBIN = 2^3 3 43), every B1 and B2 launch through the GEMM arm
    (the float32 three-product TF32 tensor-core GEMM).  Returns the
    launches of all its runs."""
    return phase_nbin_mixed(device, nsub, nchan, nbin, narch, nsub_c8,
                            arm="gemm")


def phase_prime_timing():
    """Phase 24's timing rows, each through the GEMM arm by the rule:
    B1's S0 form at 64 x 512 x PRIME_TIME_NBIN at K = MIXED_K and 512, its
    want_m2 form at NSUB_BATCH x 512 x PRIME_TIME_NBIN, K = MIXED_K, and B2
    2-bit at NSUB_BATCH x 512 x PRIME_NBIN, K = MIXED_K
    (time_cross_spectrum, time_decode: the kernel beside its plain
    version, the torch.matmul and cuFFT equivalents, its byte bound and
    its three-product TF32 bound).  Returns {"b1": [...], "b2": [...]}."""
    b1 = [time_cross_spectrum(NSUB, NCHAN, PRIME_TIME_NBIN, K, seed=98 + i)
          for i, K in enumerate((MIXED_K, PRIME_TIME_NBIN // 2 + 1))]
    b1.append(time_cross_spectrum(NSUB_BATCH, NCHAN, PRIME_TIME_NBIN,
                                  MIXED_K, want_m2=True, seed=100))
    b2 = [time_decode(NSUB_BATCH, NCHAN, PRIME_NBIN, MIXED_K, seed=101)]
    for r in b1 + b2:
        if r["arm"] != "gemm":
            raise AssertionError(f"phase 24 timing row {r['shape']}: the "
                                 f"{r['arm']} arm")
    return {"b1": b1, "b2": b2}


def _one_arm(launches, kernels, path, arm):
    other = "gemm" if arm == "fft" else "fft"
    for k in kernels:
        if launches[f"{k}.{arm}"] < 1 or launches[f"{k}.{other}"]:
            raise AssertionError(
                f"{path}: {k} launched {launches[f'{k}.fft']} times through "
                f"the FFT arm and {launches[f'{k}.gemm']} through the GEMM "
                f"arm; expected {arm.upper()}-arm launches only")


def fft_only(launches, kernels, path):
    """Raise unless each kernel was launched on the path, through its
    FFT arm only (the paths run 2048 bins)."""
    _one_arm(launches, kernels, path, "fft")


def gemm_only(launches, kernels, path):
    """Raise unless each kernel was launched on the path, through its
    GEMM arm only (phase 24's nbin has a prime factor above 5)."""
    _one_arm(launches, kernels, path, "gemm")


def device_type(device):
    import torch

    return torch.device(device).type


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from pulseportraiture_tpu_torch.ops import fused as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_main = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    F.build_kernels(verbose=True)
    log(f"build: fused_cross_spectrum.cu and fused_decode_cross_spectrum.cu "
        f"(with fcs_gemm.cuh and fft_smem.cuh) compiled and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_kernels()
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    launches = phase_main_path()
    K = phase_fit_profile(os.path.join(WORK, "fake.fits"),
                          os.path.join(WORK, "model.gmodel"))
    if K is None:
        raise AssertionError("the main path derived no harmonic window, "
                             "so the fused kernel lane was not active")
    log(f"phase main path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    rec = phase_timing(K)[K]
    log(f"phase timing B1: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    stream_launches = phase_stream(K=K)
    log(f"phase stream path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    rec2 = phase_decode_timing(K)
    log(f"phase timing B2: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    scat_launches = phase_scatter()
    log(f"phase scattering path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    rec_m2 = phase_m2_timing(K)
    log(f"phase timing B1 want_m2: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    spl_launches, spl = phase_spline()
    log(f"phase spline path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    nb_launches = phase_narrowband()
    log(f"phase narrowband path: {time.perf_counter() - t0:.1f} s wall")
    nb_total = {k: sum(c[k] for c in nb_launches.values())
                for k in ("fused_cross_spectrum",
                          "fused_decode_cross_spectrum")}
    t0 = time.perf_counter()
    zap_launches = phase_zap()
    log(f"phase zap path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    align_launches = phase_align()
    log(f"phase align path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    template_launches = phase_template()
    log(f"phase template path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    pta_a, pta_b, pta_ctx = phase_pta()
    log(f"phase pta path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    camp = phase_campaign(pta_ctx)
    log(f"phase campaign path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    scale = phase_scale_out(pta_ctx)
    log(f"phase scale-out path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    serve, serve_ctx = phase_serve()
    log(f"phase serve path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    router, router_ctx = phase_router(serve_ctx, pta_ctx)
    log(f"phase router path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    ingest = phase_ingest(router_ctx)
    log(f"phase ingest path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    tune = phase_tune()
    log(f"phase tune path: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    mixed = phase_nbin_mixed()
    mixed_rows = phase_mixed_timing()
    log(f"phase non-power-of-two nbin: {time.perf_counter() - t0:.1f} s "
        "wall")
    t0 = time.perf_counter()
    prime = phase_nbin_prime()
    prime_rows = phase_prime_timing()
    log(f"phase nbin with a prime factor above 5: "
        f"{time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    c8 = phase_batch_invariance()
    alone = phase_stream_alone()
    phase_compile_cache()
    check_tf32_arms()
    full = phase_full_spectrum_timing()
    log(f"phase batch invariance: {time.perf_counter() - t0:.1f} s wall")
    kernels = [{
        "name": "fused_cross_spectrum",
        "route": "cuda",
        "source": "pulseportraiture_tpu_torch/ops/csrc/"
                  "fused_cross_spectrum.cu",
        "replaces": "pulseportraiture_tpu/ops/fused.py:291",
        "launches": launches,
        "max_abs_err": rec["max_abs_err"],
        "max_abs_ref": rec["max_abs_ref"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"],
        "cufft_ms": rec["cufft_ms"],
        "gemm_arm_ms": rec["gemm_arm_ms"],
        "arm": rec["arm"],
        "launches_by_path": {
            "main": launches,
            "stream": stream_launches["fused_cross_spectrum"],
            "scattering": scat_launches["fused_cross_spectrum"],
            "spline_main": spl_launches["main"]["fused_cross_spectrum"],
            "spline_stream": spl_launches["stream"][
                "fused_cross_spectrum"],
            "narrowband": nb_total["fused_cross_spectrum"],
            "zap": zap_launches["fused_cross_spectrum"],
            "align": align_launches,
            "template": template_launches,
            "pta": pta_a["fused_cross_spectrum"]
            + pta_b["fused_cross_spectrum"],
            "campaign": camp["fused_cross_spectrum"],
            "scale_out": scale["fused_cross_spectrum"],
            "serve": serve["fused_cross_spectrum"],
            "router": router["fused_cross_spectrum"],
            "ingest": ingest["fused_cross_spectrum"],
            "tune": tune["fused_cross_spectrum"],
            "c8": c8["fused_cross_spectrum"],
            "stream_alone": alone["fused_cross_spectrum"],
            "nbin_mixed": mixed["fused_cross_spectrum"],
            "nbin_prime": prime["fused_cross_spectrum"]},
        "gemm_launches": prime["fused_cross_spectrum.gemm"],
        "want_m2": dict(rec_m2, launches=scat_launches[
            "fused_cross_spectrum.m2"], launches_by_path={
                "scattering": scat_launches["fused_cross_spectrum.m2"],
                "scale_out": scale["fused_cross_spectrum.m2"],
                "c8": c8["fused_cross_spectrum.m2"],
                "nbin_mixed": mixed["fused_cross_spectrum.m2"],
                "nbin_prime": prime["fused_cross_spectrum.m2"]}),
        "full_spectrum": {"K": NBIN // 2 + 1, "s0": full["s0"],
                          "want_m2": full["m2"]},
        "nbin_mixed": mixed_rows["b1"],
        "nbin_prime": prime_rows["b1"],
    }, {
        "name": "fused_decode_cross_spectrum",
        "route": "cuda",
        "source": "pulseportraiture_tpu_torch/ops/csrc/"
                  "fused_decode_cross_spectrum.cu",
        "replaces": "pulseportraiture_tpu/ops/fused.py:358",
        "launches": stream_launches["fused_decode_cross_spectrum"],
        "max_abs_err": rec2["max_abs_err"],
        "max_abs_ref": rec2["max_abs_ref"],
        "ms": rec2["ms"],
        "plain_ms": rec2["plain_ms"],
        "bound_ms": rec2["bound_ms"],
        "bound_by": rec2["bound_by"],
        "library_ms": rec2["library_ms"],
        "cufft_ms": rec2["cufft_ms"],
        "gemm_arm_ms": rec2["gemm_arm_ms"],
        "arm": rec2["arm"],
        "launches_by_path": {
            "stream": stream_launches["fused_decode_cross_spectrum"],
            "scattering": scat_launches["fused_decode_cross_spectrum"],
            "spline_stream": spl_launches["stream"][
                "fused_decode_cross_spectrum"],
            "narrowband": nb_total["fused_decode_cross_spectrum"],
            "zap": zap_launches["fused_decode_cross_spectrum"],
            "pta": pta_a["fused_decode_cross_spectrum"]
            + pta_b["fused_decode_cross_spectrum"],
            "campaign": camp["fused_decode_cross_spectrum"],
            "scale_out": scale["fused_decode_cross_spectrum"],
            "serve": serve["fused_decode_cross_spectrum"],
            "router": router["fused_decode_cross_spectrum"],
            "ingest": ingest["fused_decode_cross_spectrum"],
            "tune": tune["fused_decode_cross_spectrum"],
            "c8": c8["fused_decode_cross_spectrum"],
            "stream_alone": alone["fused_decode_cross_spectrum"],
            "nbin_mixed": mixed["fused_decode_cross_spectrum"],
            "nbin_prime": prime["fused_decode_cross_spectrum"]},
        "gemm_launches": prime["fused_decode_cross_spectrum.gemm"],
        "full_spectrum": dict(full["b2"], K=NBIN // 2 + 1),
        "nbin_mixed": mixed_rows["b2"],
        "nbin_prime": prime_rows["b2"],
    }]
    log(f"chip_smoke total: {time.perf_counter() - t_main:.1f} s wall")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
