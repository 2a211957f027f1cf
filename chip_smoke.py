#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's in-situ frames on one CUDA card: the
single-chip frame, the distributed sort-last frame, the fold
microbenchmark, the in-situ session, the sort-last exchange schedules,
the render decomposition, the two-level composite, the K budgets
and fragment reuse, the gather engine with the plain images, the
VDI's novel views with the pre-shaded (ambient-occlusion) march, the
particle and hybrid workloads, the externally driven multi-grid
scene with in-process steering and the example twins, bf16
resampling with the system's edges (the VDI stream, the serving tier,
the head node and the H.264 movie), and the multi-process fleet (the
process mesh, the two-level composite's host path, the host gathers).

    python3 chip_smoke.py               # the whole run (needs one card)
    python3 chip_smoke.py --profile     # + device time by kernel
    python3 chip_smoke.py --phase11-only  # phase 4's frame and phase 11
    python3 chip_smoke.py --phase12-only  # the build and phase 12
    python3 chip_smoke.py --phase13-only  # the build and phase 13
    python3 chip_smoke.py --phase14-only  # the build and phase 14
    python3 chip_smoke.py --phase15-only  # the build and phase 15
    python3 chip_smoke.py --phase16-only  # the build and phase 16
    python3 chip_smoke.py --phase17-only  # the build and phase 17
    python3 chip_smoke.py --phase18-only  # the build and phase 18
    python3 chip_smoke.py --phase19-only  # the build and phase 19
    python3 chip_smoke.py --k4-compare old=OTHER/resegment.cu \
        --k2-compare old=OTHER/count_multi.cu \
        --events-compare old=OTHER/fold_chunk.cu  # + designs in turns

``--profile`` adds to each frame of phases 3 to 5 and 8 to 11 (a) two
profiled frames: device time by kernel and by operator, each of the port's own kernels'
device ms and launches a frame by build (``<prefix>.port_kernel``),
the busy share, the idle gaps, copies and synchronisations.

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions, and the build of every kernel from ``csrc/`` with its wall
   seconds;
2. every kernel against its plain PyTorch version on the card, on seeded
   inputs at the flagship shapes and on real chunks of the frame: K3
   (fused Gray-Scott stencil) at 512^3 for T=4 and T=2, bit for bit,
   with the registers, local bytes, shared bytes, resident blocks an SM
   and tile of its build for each T and its achieved GB/s, K1 (segmented
   write fold) and K2 (multi-threshold count) at C=16 and C=1, K=16,
   B=16, 640x640, and on the frame's own chunks; K1's builds (C=16, and
   the generic one C=1 takes; registers, local and shared bytes, blocks
   an SM) and, over one frame's 32 chunks, its summed time ("K1 ms a
   frame") with that work's bound (the bytes the 32 folds need from
   HBM; the sum of the launches' own bounds beside it), GB/s and the
   histogram of the slots a pixel touches a chunk; B1b (K1's planes form) equal to K1 bit for bit on the
   frame's chunks and a seeded chunk; B7 (the machine's fold) with and
   without its count on a seeded chunk and the frame's chunks; B5 (shade
   and fold) on the frame's raw value chunks and B6 over the whole raw
   stream, B6 equal to B5 chunk after chunk bit for bit; B5's and B6's
   builds (C = 16, C = 1, the generic one), B5 on the fullest chunk and
   on dead chunks of 1 and 16 planes, "B5 a frame" (the 32 chunks the
   ``pallas_fused`` march feeds, folded in order into a fresh state,
   with its bound counted once for the frame and the dead, live-but-empty
   and non-empty shares of its samples) and B6 over the stream, each
   with its GB/s. Each prints its largest difference against the stated
   tolerance, its median time from CUDA events (K3's and B4b's of 10
   launches back to back, so the wrapper's host time hides behind the
   previous launch; K1's, B1b's, K2's, B7's, B5's and B6's of 10 (B6 5)
   launches back to back behind a device sleep, each on a state cloned
   before the window, with the one-launch time beside),
   the plain version's time, and its bound (the larger of bytes / 3.35
   TB/s and operations / 67 TFLOP/s, the H100 SXM's f32 rate outside the
   tensor cores). ``--k1-compare NAME=PATH`` serves the same wrapper
   from another design of ``csrc/seg_fold.cu`` (e.g. an earlier
   commit's), checks it the same way and times it in turns with K1 and
   B1b (K1, other, other, K1) on the seeded chunks and the frame's
   chunks; ``--fused-compare NAME=PATH`` does the same for
   ``csrc/fused_fold.cu`` with B5 and B6 (the fullest chunk, the dead
   chunks, B5 a frame, B6). K2 is timed with the stream kept full on
   carries cloned before the window at C = 16 and C = 1 (the one launch
   beside it) and over the threshold seed's 32 chunks counted into a
   fresh carry ("K2 a seed", ``count_frame.ms``, beside its bound with
   the carry read and written once and the sum of the launches' own
   bounds), with its builds (``count_multi.build``: C = 16, 1 and the
   generic one at B = 16, and the padded 32-wide one at B = 5);
   ``--k2-compare NAME=PATH`` serves ``cuda_march.count_multi_chunk``
   from another ``csrc/count_multi.cu``, checks it the same way and
   times it in turns with K2 (C = 16, C = 1, the seed);
3. the frame at the flagship size (512^3 Gray-Scott, 10 sim steps a
   frame, K=16, 16 histogram bins, chunk 16, temporal thresholds, the
   eye oscillating within the z march regime): ``init_threshold`` once,
   2 warm-up frames, 6 timed frames, with every kernel's launch count
   read from that run and required > 0; then the sim and the march
   timed apart; then the frame held against the CPU's plain versions on
   a small grid;
3b. the same frame under the folds ``pallas`` (B7), ``pallas_fused``
   (B5) and ``fused_stream`` (B6), each run as phase 3 runs it with the
   launch counts set to 0 before it and read after it (its kernel must
   launch), each VDI against the phase 3 fold's at the same state, eye
   and threshold (PSNR at least 60 dB, with the share of pixels whose
   live slot count differs), and each fold's 32^3 frame against the
   CPU's plain versions;
4. the distributed frame on an 8-rank in-process mesh (the reference's
   8-rank shape; 64 x 512 x 512 slabs, composited into K_out=16 slots
   with a 6-step threshold search): the seed, 2 warm-up and 6 timed
   temporal frames with the launch counts read from that run (K4 once
   per rank and frame); the sim, the march summed over the ranks, the
   column exchange and the composite timed apart; the PSNR against the
   single-chip march at the same state and eye (information); K4 (the
   composite's resegment) against its plain version at the per-rank
   shapes, on a seeded stream and on a real column block of the frame
   (thresholds and live slots exact, colour and depth within 1e-6),
   each timed with the stream kept full (the one launch beside it), and
   the frame's 8 column blocks resegmented back to back as one frame
   (``resegment_frame.ms`` beside ``resegment_frame.bound_ms``), with
   K4's builds (``resegment.build``: the frame's, the one without the
   search and the shared-memory list of a K_out above 16);
   ``--k4-compare NAME=PATH`` serves ``cuda_composite.resegment_sorted``
   from another ``csrc/resegment.cu``, checks it the same way and times
   it in turns with K4 (the seeded stream, the fullest block, the
   frame);
   then the distributed frame on a 32^3 volume over 4 ranks held
   against the CPU's plain versions in both march regimes;
5. the sim-fused occupancy frame: (a) B4b (K3 with the ranges epilogue,
   checked with phase 2's kernels on its state) on the 512^3 state at
   T=4 and T=2 and on ragged grids whose brick edges fall inside K3's
   tiles and z segments (v partly negative on one), its u', v' equal to
   K3's bit for bit and its per-brick ranges equal to its plain
   version's and to ``field_ranges`` of its own v' exactly, timed
   against K3 in turns, with its builds as phase 2 logs K3's; (b) the
   flagship frame of phase 3 under
   ``occupancy="pyramid"`` and ``occupancy="sim"`` (16 in-plane tiles),
   run and timed as phase 3 runs it (B4b once a frame under "sim"), each
   image at least 60 dB from phase 3's chunk-skip frame at the same
   state, eye and threshold, with the largest difference; (c) the 32^3
   ``occupancy="sim"`` frame under every fold against the CPU's plain
   versions; (d) one run of the benchmark twin
   (``scenery_insitu_tpu_torch.bench``) with ``SITPU_BENCH_SKIP=sim`` at
   512^3, its JSON line logged as ``bench_twin``;
6. the fold microbenchmark (the twin of the reference's
   ``benchmarks/fold_microbench.py``): (a) B8 (the deferred close events
   in registers) and B9 (in shared memory) against their plain versions
   and against B7 on the frame's captured chunks and on seeded streams
   at 320 x 320 and 640 x 640 (C = 16, K = 16, and K = 4 filling the slot
   cap): slot counters exact, colour and depth within 1e-6, with whether
   they equal B7 bit for bit; B7, B8 and B9 timed at 640 x 640 for
   several (C, K) with the stream kept full (10 launches behind a device
   sleep, each on a state cloned before the window; the one launch
   beside), against their bound, with the registers, local bytes, shared
   bytes, resident blocks an SM, threads and close events a thread of
   each build; then a march: the microbenchmark's own stream at S = 512
   on 640 x 640 generated once, B8 and B9 against their plain versions
   and B7 over it, the closes a pixel a chunk, and B7, B8 and B9 each
   folding its 32 chunks back to back from the initial state behind a
   device sleep, against the march's bound (``*_march.ms``);
   ``--events-compare NAME=PATH`` serves the B8 and B9 wrappers from
   another ``csrc/fold_chunk.cu``, checks it at every gate above and
   times it in turns (new, other, other, new) at C = 16, K = 16 and over
   the march; (b) the twin's sweep with ``--check`` over every variant
   at S = 256 (320 x 320) and S = 512 (640 x 640), K = 16, C = 16, its
   JSON rows logged, the launch counts set to 0 before it and read after
   it (B8 and B9 each S/C launches a march; B1b, which the
   ``pallas_seg`` and ``tf_pallas_seg`` variants run, must launch: the
   kernel table's B1b count is this sweep's);
7. the in-situ session (``runtime/session.InSituSession``) on phase 3's
   configuration, built through ``FrameworkConfig`` overrides on one
   rank with ``orbit_rate`` 0.05: (a) one warm frame and 8 timed frames
   with ``png_sink``, ``vdi_sink`` and ``checkpoint_sink`` every 4
   frames into a temporary directory, the launch counts set to 0 before
   the loop and read after it (K3, K2 and K1 must launch), the
   session's ms a frame on the host clock and its timers' sim,
   dispatch, fetch, sinks and frame stats over the timed frames, then 8
   more frames without sinks, beside phase 3's ms a frame; (b) the
   session's first 2 frames equal bit for bit to
   ``distributed_vdi_step_mxu_temporal`` and its seed driven by hand
   from the same state and camera; (c) a session checkpointed after 4
   frames (``save_session``) and resumed in a fresh session gives
   frames 4 to 7 of the uninterrupted run bit for bit, and so does the
   sink's checkpoint after frame 5 for frames 6 to 8; (d)
   ``pipeline_depth`` 2 gives frames 0 to 3 of depth 1 bit for bit; (e)
   the ``.npz`` VDI the sink dumped at frame 4 loads back with
   ``load_vdi`` equal to that frame's payload; (f) a 4-rank 32^3
   session on the card against the same session with ``device="cpu"``
   (3 frames, ``fold="pallas_seg"`` on both; largest and mean image
   difference at most 1e-4), K4 launched once per rank and frame;
8. the sort-last exchange schedules on phase 4's configuration: (a) eight
   configurations of (exchange, wire, schedule), the ring lossless and
   with ``ring_slots`` 32, the all_to_all on the bf16 and qpack8 wires,
   the ring on qpack8, and tile waves (``wave_tiles`` 4, or the largest
   of 2-4 that splits a rank's column block) under the all_to_all, the
   ring and the ring on qpack8, each driven as phase 4 drives its frame
   from the same seeded state, eye and seed threshold, with K4's
   launches counted (8 a frame, 8·T in waves) and its modeled exchange
   traffic logged (a model: the in-process ranks move no bytes across a
   link); each configuration's parts timed apart on the final state
   (encode, exchange, decode and composite; the ring's sort and encode,
   decodes, merges and resegment; the waves' frame state, marches and
   composites) and one frame's K4 launches on its own streams beside
   their bound; K4 against its plain version on the capped ring's and
   the waves' streams; the gates against configuration 0 (phase 4's last
   frame): the lossless ring within 1e-6, the capped ring's image at
   least 30 dB from the lossless ring's, each lossy wire's image at
   least 40 dB from f32's and not equal to it with the threshold maps
   within 1e-6, each f32 waves VDI at ``assert_vdi_close``'s bar of its
   frame twin (the qpack8 waves' image at 40 dB: a wave's fragment has
   its own depth scale) with its threshold maps within 1e-6 and equal
   meta; (b) every configuration at 32^3 over 4 ranks against the CPU's
   plain versions in both march regimes (phase 4's bar; the lossy wires'
   images at 60 dB; threshold maps within 1e-6); (c) phase 7's session
   over 8 ranks with the ring in tile waves and a tile sink (K3, K2, K1
   and K4 launched; every frame's tiles in ascending column order
   before its frame sinks, side by side the frame bit for bit), then
   with ``delivery.enabled`` and a ``vdi_tile_sink`` (the same frames
   bit for bit, the dumped tiles reassembling the frame).
9. the render decomposition on phase 4's configuration: (a) nine
   configurations, each driven as phase 4 drives its frame from the same
   seeded state, eye and frames with the launch counts read from its run
   (K1, K2 and K4 must launch; K4 8 a frame, 8·T in waves) and its build
   counters: p1 the plan ``slice_plan`` gives for the start state's
   ``z_live_profile`` (min depth 4, quantum 4), p2 the fixed plan (128,
   64, 64, 64, 64, 32, 32, 64), b1 the steal from the contiguous map of
   32 bricks (2 moves), b2 32 bricks to rank 3b mod 8, b3 32 bricks with
   rank 7 owning none (5 slots a rank: K4 on 640 sorted slots), l1 b2
   with level 2 on an empty brick, l2 b2 at level 1, x1 and x2 p2 and b3
   under the ring in tile waves; each one's parts timed apart on the
   final state (the reslab, each rank's march alone, the column
   exchange, the sort of each block's stream, K4 on those streams), the
   measured straggler factor (max/mean of the ranks' march ms) beside
   the modeled one and phase 4's even ones, and the gates against phase
   4's frame: the image at least 60 dB (l2: information), the VDI's
   differences and whether it is within 1e-5 with the same live slots
   logged (a decomposition cuts supersegments where the even split does
   not, so on Gray-Scott it is not), the metadata's global dims; (b) p2,
   b2, b3, l1, l2, x1 and x2 scaled to 32^3 over 4 ranks (8 bricks)
   against the CPU's plain versions in both march regimes (phase 4's
   bar, threshold maps within 1e-6); (c) K4 against its plain version on
   b3's fullest column block (M = 640; thresholds and live slots exact,
   colour and depth within 1e-6), timed with the stream kept full beside
   its one launch and bound; (d) phase 7's session over 8 ranks with
   ``composite.rebalance=occupancy`` and then ``bricks`` with
   ``lod.enabled``, a replan every 4 of 12 frames: every replan logged,
   the steps rebuilt on a replan only, each replan's first frame equal
   to the hand-driven step with the same plan or map bit for bit, ms a
   frame beside phase 7's.
10. the two-level ``(hosts, ranks)`` composite on phase 4's
   configuration: (a) seven topologies, each driven as phase 4 drives
   its frame from the same seeded state, eye and frames: h1 2 x 4 and
   h2 4 x 2 on the all_to_all, h3 2 x 4 on the ring, h4 and h5 2 x 4 on
   the bf16 and qpack8 DCN wires, h6 2 x 4 in phase 8's ring tile waves,
   h7 2 x 4 under phase 9's plan p1; each with its K1, K2 and K4
   launches read from the run (K4 8 a frame at the top, 8·T in waves),
   its build counters and modelled DCN bytes a host (a model: no byte
   crosses a link on one card), its parts timed apart on the final state
   (the level-1 exchange, the level-1 sort or ring merges, the level-2
   DCN merges, K4), a frame's K4 launches on their own N·K-slot streams
   beside their bound, and K4 against its plain version on h1's and
   h6's streams; the gates: the lossless h1, h2, h3 and h6 within 1e-6
   of phase 4's frame with the same live slots (h7 of phase 9's p1
   frame), bit for bit logged, threshold maps within 1e-6, h4's and
   h5's images at least 30 dB from phase 4's and not equal to it;
   (b) h1, h3, h5 and h6 at 32^3 over 4 ranks (2 x 2) against the CPU's
   plain versions in both march regimes (phase 4's bar, the lossy
   wire's images at 60 dB, threshold maps within 1e-6); (c) phase 7's
   session on a 2 x 4 topology over 8 ranks: a warm and 8 timed frames
   (K4 8 a frame), its first two frames equal to the hand-driven
   hierarchical step bit for bit, a checkpoint after 4 frames resumed
   bit for bit, ms a frame beside phase 7's.
11. occupancy K budgets and temporal fragment reuse on phase 4's
   configuration: (a) ``k_budget="occupancy"`` with ``k_budget_min`` K
   (every target K), driven as phase 4 drives its frame, bit for bit
   phase 4's frame and thresholds; then the default budget: each
   rank's target at the last frame against ``k_budget_target``
   recomputed on the host from the ranks' live fractions, each rank's
   mean used slots against the static frame's, the image's dB against
   phase 4's; (b) ``temporal_reuse="ranges"`` on a frozen field (phase
   4's initial state, no sim advance, a still camera; temporal
   thresholds) on the frame schedule, in tile waves and on the 2 x 4
   mesh: frame 1 marches every rank, frames 2-8 launch no K1 and 8 K4
   a frame (8·T in waves), each equal to frame 1 bit for bit, ms a
   frame beside phase 4's; (c) reuse on an advancing Gray-Scott field
   whose seed cubes sit in rank 1's slab (the others at the exact
   fixed point u = 1, v = 0), histogram and temporal, each against
   the same run with reuse off: the clean ranks and K1's launches a
   frame, ms a frame, histogram frames bit for bit, temporal ones at
   60 dB or more; (d) phase 7's session over 8 ranks with reuse and
   ``obs.enabled`` on that field, the camera still: a warm and 8 timed
   frames (host clock), the reuse counters and the last
   ``delta_dirty_tiles`` event, its first 3 frames bit for bit against
   the hand-driven step; (e) the P-frame codec (``ops/delta.py``) on
   (c)'s histogram reuse frames, 8 column tiles a frame through
   qpack8, encoded, packed, unpacked and decoded bit for bit, the code
   bytes a frame against ``modeled_delta_traffic``.
12. the gather engine and the plain images at the bench's gather
   configuration (1280 x 720, 256 samples a ray, K = 16, histogram
   with 16 bins): (a) the single-chip gather frame on the 512^3
   Gray-Scott state with phase 3's oscillating eye, 1 warm-up and 2
   timed frames, K3 launched and no other kernel (the ray march and the
   one-rank composite launch none), the sim and the march timed apart,
   and 3 frames at 32^3 (96 x 72, 64 steps) against the CPU's plain
   versions; (b) the gather ``distributed_vdi_step`` on phase 4's
   8-rank mesh and composite, from (a)'s final state, 1 warm-up and 1
   timed frame, K4 8 a frame, its same-view image at least 25 dB from
   the single-chip plain raycast at that state and eye (the reference's
   bar), K4 against its plain version on the step's own 128-slot,
   720 x 160 streams (rebuilt from the last frame's fragments, which
   resegment to the step's VDI bit for bit) and a frame's 8 launches
   timed beside their bound, and at 32^3 over 4 ranks against the CPU
   the ring in tile
   waves and the 2 x 2 topology; (c) ``distributed_plain_step`` and
   ``distributed_plain_step_mxu`` (warped to the display camera) on the
   8 ranks, at least 28 and 32 dB from ``raycast`` and
   ``slicer.raycast_mxu``, launching no kernel; (d) phase 7's session
   over 8 ranks in the plain slice-march mode and the gather VDI mode,
   a warm and 2 timed frames each with a PNG sink every 2, the first 2
   frames bit for bit against the hand-driven step, the plain PNG's
   pixels the payload's; (e) the committed golden images of the gather
   raycast, the slice-march plain render and the gather VDI's decode
   rendered on the card within 3.0 (8-bit).
13. the VDI's novel views and the pre-shaded march, on the default
   frame's VDI (phase 3's step from the seeded init, 2 frames: K3, K2,
   K1) at the 1280 x 720 display camera: (a) the plane sweep
   (``render_vdi_mxu``, 512 planes) at three same-regime eyes >= 25 dB
   from the gather renderer (``vdi_render.render_vdi``, 512 steps), the
   frame's own view >= 25 dB from the same-view decode, the camera
   rebuilt from the metadata >= 40 dB from the stored one; the
   pre-shaded proxy built once (bytes logged) and marched across regimes
   (an x march, ``render_vdi_any``) >= 24 dB from the gather renderer,
   its same view >= 24 dB from the decode, the exact renderer >= 24 dB
   from the proxy; ``render_vdi_batch`` of 8 cameras within 1e-5 of the
   8 single renders; no kernel; (b) ``shade_volume_ao`` of the 512^3
   field and its ``raycast_mxu`` >= 24 dB from the gather AO render;
   ``generate_vdi_mxu`` of it under ``fold="auto"`` (K2, K1), K2 and K1
   against their plain versions on the march's own chunks (counts and
   thresholds exact, colour and depth within 1e-6), the pre-shaded
   pyramid's gates the same on the card and the CPU; (c) the 8-rank
   ``distributed_plain_step_mxu`` with AO against the single-device
   pre-shaded render (rtol 1e-4, atol 2e-5); (d) ``vdi_convert`` on the
   card's VDI (the NDC and layout round trips, ``validate_vdi`` clean)
   and the goldens ``novel_view``, ``vdi_decode`` and
   ``reference_frame`` through the port on the card within 3.0. Each
   view is timed (ms a view, CUDA events and the host clock);
   ``--profile`` adds the device operations of a view.
14. the particle and hybrid workloads at the full width of the
   reference's BASELINE Configs 3-5 (``benchmarks/configs_bench.py``: 5
   sim steps a frame, K = 16 into 16 output slots, 1280 x 720), each a
   session with a warm frame (its seed included) and 3 timed frames
   (host clock), the launch counts set to 0 before the warm frame and
   read after the timed ones: (a) Config 3, the vortex session at 256^3
   over 4 ranks (mxu, temporal; K1, K2 and K4 launched), the flow's
   spectral divergence below 1e-4 of max|rfft(u_x)|, and a 32^3 session
   on the card >= 60 dB from the CPU's; (b) Config 4, the Lennard-Jones
   session of 1,000,000 particles over 8 ranks (histogram; no kernel
   launched), the sim and the splat timed apart, the force pass's peak
   memory, the energy drift over the frames below 2 %, the 8-rank
   sort-first splat against the single-device splat (depth within
   1e-6, >= 99.9 % of the pixels within 1e-5), and a 2,048-particle
   session against the CPU's (states within 1e-4, splats at that bar);
   (c) Config 5, the hybrid session at 256^3 with 500,000 tracers over
   8 ranks (temporal; K1, K2 and K4 launched), K1 against its plain
   version on one rank's chunks of the frame's march at its carried
   maps and K4 on the frame's composite streams, the distributed image
   >= 35 dB from ``hybrid_vortex_frame_step``'s at the same state, one
   frame each of the ring (within 1e-6), bf16 and qpack8 (>= 40 dB, not
   equal), tile waves (within 1e-5), plan p1 (>= 35 dB) and a 2 x 4
   topology (within 1e-6) against the frame schedule, and a 32^3 hybrid
   session >= 60 dB from the CPU's. ``phase14.wall_s`` prints its
   seconds.
15. the externally driven multi-grid scene, steering and the example
   twins: (a) phase 4's 512^3 field after its frames cut OpenFPM-style
   into 6 grids (z slabs of 150, 190 and 172 slices, the middle one cut
   in x at 97, 133, 141 and 141 columns; 1-voxel ghosts on every inner
   face), pushed as host arrays through ``SceneSession.update_data`` on
   a z-marching camera (x is the march's u axis: the x cuts exercise
   ``u_bounds``) in phase 3's temporal configuration at 1280 x 720, 4
   frames each after an ``update_grid`` of every grid (host clock; K1,
   K2 and K4 launched, no other kernel), frame 0's image >= 30 dB from
   the single-volume ``generate_vdi_mxu`` of the assembled field
   (``tests/test_scene.py``'s bar), K1 against its plain version on
   grid 2's chunks at its carried maps and K4 on the frame's 6-grid
   sorted stream (thresholds and live slots exact, colour and depth
   within 1e-6); (b) the ``gray_scott`` scenario at 512^3 through
   ``scenarios.run_steered`` for 13 frames (TF updates at 4, 8 and 12;
   frame 8's TF has the knots of the session's start TF: 3 updates, 2
   reuses, 2 step builds, as the reference counts), checkpointed right
   after frame 12's message, and a session built with that TF from the
   checkpoint rendering frame 12 within 1e-6 of the frame on the
   restored steps;
   (c) the example twins ``volume_from_file`` (with ``--store-vdis``)
   and ``ao_render`` at their default sizes, every PNG non-blank and
   every VDI finite with a live slot. ``phase15.wall_s`` prints its
   seconds.

16. bf16 resampling and the edges: (a) phase 3's frames (the seeded
   init, its seed, 2 warm-up and 6 timed frames) with the resampling
   products in bf16 (the card's default) and in f32, each
   timed, the bf16 image >= 40 dB from the f32's and its launch counts
   equal to the f32 run's and phase 3's, K1 against its plain version
   on the bf16 frame's chunks (within 1e-5, start counts exact), one
   chunk's bf16 product against the CPU's plain form (within 1e-5 of
   its largest value; both products timed against the f32 pair) and the
   viewer's proxy (``vdi_novel.vdi_to_rgba_volume`` marched across
   regimes) in bf16 >= 40 dB from f32; then the main path: phase 7's
   session (512^3, temporal) and the same over phase 4's 8 ranks, 3
   frames each, their launch counts set to 0 before and read after (K3,
   K2, K1 and K4), the 1-rank session's frames to the I_PCM H.264 sink
   and a P-frame publisher without a socket, the 8-rank session's to
   another; (b) the serving tier (``ViewerServer.without_sockets``, its
   messages through ``handle``) on the session's last 2 VDIs at 128 x
   96 and on its last at the VDI's own width (640 x 480): each tier a
   full bucket of 16 viewers, ms a batch and a viewer, the answers
   against independent single-camera ``render_vdi_batch`` renders
   (exact and proxy within 1e-5, wire within one u8 step; every answer
   at 128 x 96, 2 a tier at 640 x 480), the unchanged cameras answered
   again from the cache with no render, and the device operations of a
   view; (c) the head node's depth-min composite of 8
   rank images (phase 4's field in 8 z slabs, each ``raycast_mxu`` at
   1280 x 720) equal to ``ops/composite.composite_depth_min`` on the
   card bit for bit; (d) the stream's encoding of the sessions' VDIs:
   the last frame in f32 with zlib decoded bit for bit, the qpack8
   P-frame records decoded to the frames' codes bit for bit, bytes a
   frame against the codec's model, encode ms; (e) the H.264 stream's size equal to the I_PCM
   layout's; (f) where pyzmq and msgpack are installed, the loopback
   session frame -> ``VDIPublisher`` -> ``VDISubscriber`` (bit for bit)
   -> ``ViewerServer`` -> ``ViewerClient``, else a line saying it was not
   run and why. ``phase16.wall_s`` prints its seconds.

17. the multi-process fleet: two worker processes of
   ``testing/multiproc.run_multiproc``, all on the card, over gloo
   (NCCL refuses two ranks on one card; a CUDA tensor crosses through a
   counted host copy), each holding 4 of phase 4's 8 ranks. The parent
   first runs the in-process references on phase 4's field: the 8-rank
   seed and 3 temporal frames, and phase 12's 8-rank gather step (1280
   x 720, 256 steps); then writes the field once to a temporary
   workdir, from which each worker reads only its own slabs. (a) the
   process mesh: the seed and the 3 frames, every frame's column blocks
   equal to the in-process frame bit for bit, and the last frame put
   together on process 0 by the host gather bit for bit, each process's
   K1, K2 and K4 launches half the in-process run's; the ms a frame
   (CUDA events in each process, the host clock on the head) and the
   bytes through the host copies; (b) the two-level composite's host
   path of the gather step, 2 hosts x 4 ranks, f32 tiles over loopback
   with codec none, the head's merge (K4, once a tile, at the head
   only) bit for bit against the in-process step, the DCN bytes
   measured beside those modelled, the head's merge ms; (c) the host
   gathers and the obs merge across the two processes with both ranks'
   spans, then the lost host (host 1 publishes nothing: the frame
   degraded, ``multihost.host_down`` on the ledger); (d) the scaling
   twin (``benchmarks/scaling_bench --mode hosts``) at 1 and 2 hosts.
   The workers' launches come back through the workdir into the kernel
   table's ``phase17_launches``. ``phase17.wall_s`` prints its seconds.
18. the external simulation's ingest, LZ4 and the lint with B10: first
   /dev/shm's size (a ring that does not fit cuts the cube to the
   largest power of two that does, on a line of its own). (a) the
   port's demo producer (``ingest/native``, built with g++) publishes
   4 frames of its travelling Gaussian (512^3, 512 MiB a slot, 3 slots)
   while phase 4's 8-rank session renders 6 frames from
   ``ShmVolumeSource`` (the counts set to 0 before, read after: K2, K1,
   K4 and no K3), with the host-to-card ms and GB/s of each copy and
   the frames consumed, skipped and dropped; then, the producer gone,
   the session on a fresh source equals the same session fed the final
   frame as a tensor through a plain adapter, bit for bit, 3 frames;
   (b) 8 slab producers and a field producer of the same Gaussian:
   ``ShmShardedVolumeSource`` on the 8-rank mesh equals the field bit
   for bit and its session's 3 frames equal (a)'s; (c) phase 3's VDI
   through ``pack_vdi_segments(codec="lz4")`` and an lz4 ``.npz``, bit
   for bit, the ratio and MB/s each way; (d) ``python -m
   scenery_insitu_tpu_torch.tools.lint --fail-on-stale`` exits 0, B10
   (``tests/torch_lint_fixtures/good_double.cu``) at 8 x 128 and 8192 x
   8192 equals its plain version bit for bit with NaN and +-0 tiles, a
   height of 8196 raises, B10's ms with the stream kept full beside its
   bound, its plain version and the torch pair ``x * 2``, ``amax``.
   ``phase18.wall_s`` prints its seconds.
19. observability: (a) `ProfileCapture` (``obs/profiler.py``) over
   phase 3's 512^3 frame and phase 4's 8-rank frame (phase 4's sim
   advance under its ``sim_step`` scope), and over each path's seed: the
   capture succeeds with nothing on the ``obs.profiler`` ledger, every
   phase is in the catalog, the phases sum to the wall within 15 %, and
   every launch of K3, K1, K2 and K4 counted in the window is in the
   trace, joined to ``sim_step``, ``march``, ``march`` and
   ``resegment``; each kernel's device ms a frame beside
   `profile_frames`' over the same frames; (b) both frames' unprofiled
   ms with the scopes in place, beside earlier runs' ranges (no gate);
   (c) the bench twin at 512 with ``SITPU_BENCH_PROFILE=1``: every
   roofline field non-null, ``hbm_frac_peak`` and ``mfu_matmul`` in
   (0, 1]; (d) phase 4's 8 ranks as a session (histogram thresholds,
   async delivery) publishing to a `Collector` in this process: the
   merged fleet trace holds its spans and every frame's lineage, its
   ``run(profile_dir=...)`` trace names K1 to K4, and its
   ``device_snapshot()`` counts the step's bytes with its kernels'; (e)
   the chaos matrix (``testing/faults.run_matrix(seed=7)``) with the
   serving scenarios rendering on the card: all 15 scenarios ok.
   ``phase19.wall_s`` prints its seconds.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM f32, outside the tensor cores
GRID = 512
K = 16
BINS = 16
CHUNK = 16
SIM_STEPS = 10
WARMUP_FRAMES = 2
TIMED_FRAMES = 6
SEED = 0
# operations of one Gray-Scott step per cell: two Laplacians (6 adds, a
# multiply and a subtract each), u*v*v, the two rate expressions and the
# two Euler updates
STENCIL_FLOPS_PER_CELL_STEP = 32
# K1 per pixel per slice: distance (8), start/count/transmittance (6),
# premultiplied accumulation (8), the two depths and their min/max (4)
SEG_FLOPS_PER_PIXEL_SLICE = 26
# K4 per pixel per slot: a counting pass (distance 8, gap test 2) times
# the search iterations, and the write pass (distance 8, gap test 2,
# accumulation 8)
RESEG_COUNT_FLOPS, RESEG_WRITE_FLOPS = 10, 18
# B7 per pixel per slice: distance (8), break and close predicates (6),
# the under-accumulation (8), the start count (3), the depths (2)
MACHINE_FLOPS_PER_PIXEL_SLICE = 27
# B5/B6, counted from the run's own samples: every sample's dead test
# (1); a live sample's (v >= -0.5) value clamp (2), power (counted as 10:
# a logarithm, a multiply and an exponential), opacity clamp and
# subtractions (4), alpha knots and K1's fold; a non-empty sample's
# colour knots and premultiply (3). Each non-zero knot slope costs 4
# (subtract, max, multiply, add). A dead sample's alpha is 0 whatever
# the knots give, and an empty sample's colour is never read.
DEAD_TEST_FLOPS, ALPHA_FLOPS_PER_SAMPLE, PREMUL_FLOPS = 1, 16, 3
SHADE_FLOPS_PER_KNOT = 4
# the fold schedules of the fold phase and the kernel each launches
FOLD_KERNELS = {"pallas": "fold_chunk", "pallas_fused": "fused_fold_chunk",
                "fused_stream": "fused_stream_fold"}
FOLD_PSNR_DB = 60.0
# the kernels of each path
FRAME_KERNELS = ("grayscott_fused", "seg_fold_compact", "count_multi")
SIM_OCC_KERNELS = FRAME_KERNELS + ("grayscott_fused_ranges",)
OCC_PSNR_DB = 60.0
BENCH_FRAMES = 5
DIST_KERNELS = FRAME_KERNELS + ("resegment_sorted",)
# the distributed frame: the reference's 8-rank mesh, composited into
# K_OUT slots with the default 6-step threshold search
RANKS = 8
K_OUT = 16
COMP_ITERS = 6
SMALL_RANKS = 4
# the fold microbenchmark (phase 6): the reference's default S = 256
# (320 x 320) and the flagship's 512 (640 x 640), K = 16, C = 16
MICRO_GRIDS = (256, 512)
# phase 6 (a)'s march: the microbenchmark's stream at S = 512 (640 x 640)
MARCH_S = 512
# device sleep ahead of a timed window (~10 ms at the H100's clocks), so
# the host's launches queue behind it
LEAD_CYCLES = 20_000_000
MICRO_ITERS = 3
EVENT_KERNELS = {"events": "events_fold_chunk",
                 "scratch": "scratch_fold_chunk"}
# B8's and B9's seeded gates: (image side, K, chunks); the timed (C, K)
# pairs at the largest side, the first the microbenchmark's
EVENT_SEEDED = ((320, K, 1), (640, K, 1), (640, 4, 3))
EVENT_TIMED = ((16, 16), (8, 16), (32, 16), (16, 4))
# the session phase (7): warm and timed frames, the sinks' period and the
# camera's orbit a frame (8 frames stay within the z march regime)
SESSION_WARM = 1
SESSION_TIMED = 8
SESSION_EVERY = 4
SESSION_ORBIT = 0.05
# each timed path's median ms a frame (CUDA events, host clock), by prefix
FRAME_MS = {}
PHASE3_VDI = {}             # phase 3's last timed VDI on the host (18 c)
# the session's ms a frame (host clock), by prefix
SESSION_MS = {}


def log(key, value):
    print(f"{key}={value}", flush=True)


def bound_ms(nbytes: float, flops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def median_ms(fn, reps: int, setup=None) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn(setup())``; the
    setup runs outside the timed window."""
    import torch

    times = []
    for _ in range(reps):
        arg = setup() if setup is not None else None
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def stream_ms(fn, launches: int = 10, reps: int = 5,
              behind_sleep: bool = False) -> float:
    """Device ms a call of ``fn()`` with the stream kept full: the median
    over ``reps`` of the CUDA-event time of ``launches`` calls back to
    back, over ``launches``. Unlike `median_ms` of one call, the host's
    time in the wrapper hides behind the previous launch. With
    ``behind_sleep`` the calls also queue behind `lead`, so a wrapper
    whose host time exceeds its kernel's device time is still timed by
    the device."""
    import torch

    def setup():
        torch.cuda.synchronize()
        lead()

    def run(_):
        for _ in range(launches):
            fn()                    # each result freed before the next

    return median_ms(run, reps, setup if behind_sleep else None) / launches


def clone(xs):
    return tuple(x.clone() for x in xs)


def require_launched(launches, names, path):
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on "
                                 f"{path}")


def max_abs(a, b) -> float:
    """Largest |a - b| where both are finite; +inf entries must agree."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or \
            not torch.equal(a[~fin], b[~fin]):
        return math.inf
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def check(name, err, tol):
    log(f"{name}.max_abs_err", f"{err:.3e} (tolerance {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"by {err} > {tol}")


# ------------------------------------------------------------- phase 2


def check_stencil(dev):
    import torch

    from scenery_insitu_tpu_torch.sim import cuda_stencil as cst
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    u = (st.u - 0.05 * torch.rand(st.u.shape, generator=g,
                                  device=dev)).contiguous()
    v = (st.v + 0.05 * torch.rand(st.v.shape, generator=g,
                                  device=dev)).contiguous()
    p = st.params.vector()
    log_stencil_builds("stencil", ranges=False)
    out = {}
    for t in (4, 2):
        uk, vk = cst.step_fused(u, v, p, t)
        up, vp = cst.step_fused_plain(u, v, p, t)
        torch.cuda.synchronize()
        err = max(max_abs(uk, up), max_abs(vk, vp))
        check(f"stencil_T{t}", err, 1e-6 * t)
        # the kernel repeats the plain version's operations: bit for bit
        if not (torch.equal(uk, up) and torch.equal(vk, vp)):
            raise AssertionError(f"stencil_T{t}: K3 differs from its plain "
                                 f"version")
        ms = stream_ms(lambda: cst.step_fused(u, v, p, t))
        one = median_ms(lambda _: cst.step_fused(u, v, p, t), 10)
        pms = median_ms(lambda _: cst.step_fused_plain(u, v, p, t), 3)
        cells = u.numel()
        b, by = bound_ms(4 * 4 * cells,
                         STENCIL_FLOPS_PER_CELL_STEP * t * cells)
        log(f"stencil_T{t}.ms", f"{ms:.4f} plain_ms={pms:.4f} "
            f"bound_ms={b:.4f} ({by}) one_launch_ms={one:.4f} (the host's "
            f"wrapper time included)")
        log(f"stencil_T{t}.achieved_gb_s", f"{4 * 4 * cells / ms / 1e6:.1f} "
            f"(the bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
        out[t] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b, bound_by=by)
    return out


def log_stencil_builds(prefix, ranges):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM and the tile of K3's (``ranges=False``) or B4b's build for every
    T, from ``cudaFuncGetAttributes`` and the occupancy calculator."""
    from scenery_insitu_tpu_torch.sim import cuda_stencil as cst

    for t in range(1, cst.FUSE_T + 1):
        a = cst.attributes(t, ranges)
        log(f"{prefix}_T{t}.build",
            f"registers={a['registers']} local_bytes={a['local_bytes']} "
            f"shared_bytes={a['shared_bytes']} "
            f"blocks_per_sm={a['blocks_per_sm']} threads={a['threads']} "
            f"core={a['core_x']}x{a['core_y']} seg_z={a['seg_z']}")


def seeded_stream(c, h, w, dev, seed):
    """Depth-ordered shaded chunk with empty runs and near-duplicate
    colors, so starts on gaps, breaks on the distance and accumulation
    all occur."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, device=dev)
    rgb = r(c, 3, h, w)
    dup = (r(c, 1, h, w) < 0.3) & (torch.arange(c, device=dev)
                                   .reshape(c, 1, 1, 1) > 0)
    rgb = torch.where(dup, torch.roll(rgb, 1, 0), rgb)
    alpha = (0.05 + 0.85 * r(c, 1, h, w)) * (r(c, 1, h, w) > 0.4)
    return torch.cat([rgb * alpha, alpha], dim=1).contiguous()


def touched_mask(rgba, small, thr, k):
    """The state rows one K1 call reads and writes: bool [K, H, W], true
    where a non-empty slice of this chunk lands in slot s of a pixel."""
    import torch

    from scenery_insitu_tpu_torch.ops import seg_fold as sf

    emp, starts = sf.chunk_flags(rgba, small[1:4], small[4] > 0.5, thr)
    sid = small[0][None] + torch.cumsum(starts.to(torch.float32), 0) - 1
    slot = torch.clamp(sid, 0, k - 1)
    return torch.stack([((slot == s) & ~emp).any(0) for s in range(k)])


def touched_rows(rgba, small, thr, k):
    """(pixel, slot) state rows one K1 call reads and writes."""
    return int(touched_mask(rgba, small, thr, k).sum())


def k1_work(rgba, small, thr, k):
    """(bytes, operations) one K1 call on these inputs must move and do:
    rgba, length and threshold read, the ratios, small read and written,
    and the touched rows read and written."""
    c, _, h, w = rgba.shape
    hw = h * w
    rows = touched_rows(rgba, small, thr, k)
    nbytes = 4 * (c * 4 * hw + 2 * hw + 2 * c + 2 * 5 * hw + 2 * 6 * rows)
    return nbytes, SEG_FLOPS_PER_PIXEL_SLICE * c * hw


def lead():
    """Enqueue ~10 ms of device sleep, so that the launches the host
    makes next queue up behind it and a window opened after it holds
    device time only (the stream kept full)."""
    import torch

    torch.cuda._sleep(LEAD_CYCLES)


def fresh_ms(fold, base, launches=10, reps=5) -> float:
    """Device ms a call of ``fold(state)`` with the stream kept full:
    ``launches`` calls back to back, each on its own copy of ``base``
    cloned before the window (so each does the same work as one call on
    ``base``), behind `lead`; the median over ``reps`` over
    ``launches``."""
    import torch

    def setup():
        states = [clone(base) for _ in range(launches)]
        torch.cuda.synchronize()
        lead()
        return states

    def run(states):
        for st in states:
            fold(st)

    return median_ms(run, reps, setup) / launches


def compare_designs(specs, lib, query, log_builds, tag, *wrappers):
    """{name: (wrapper, ...)} for each ``NAME=PATH`` of ``specs``,
    another design of ``csrc/<lib>.cu`` with the same C entries: each of
    ``wrappers`` served by that source's build
    (`kernels.source_override`), built here; each build's attributes are
    logged by ``log_builds`` where its source has the ``query``."""
    from scenery_insitu_tpu_torch import kernels

    def served(fn, path):
        def call(*args, **kw):
            with kernels.source_override(lib, path):
                return fn(*args, **kw)
        return call

    out = {}
    for spec in specs:
        name, path = spec.split("=", 1)
        with kernels.source_override(lib, path):
            secs = kernels.build([lib])
            log(f"{tag}_{name}.build_s", f"{secs:.1f}")
            with open(path) as f:
                if query in f.read():
                    log_builds(f"{tag}_{name}_")
        out[name] = tuple(served(fn, path) for fn in wrappers)
    return out


def compare_folds(specs):
    """{name: fold} for each ``NAME=PATH`` of ``--k1-compare``, another
    design of ``csrc/seg_fold.cu``: fold is `cuda_seg.fold_chunk_packed`
    served by that source's build."""
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs

    return {name: fold for name, (fold,) in compare_designs(
        specs, "seg_fold", "seg_fold_attributes", log_k1_builds,
        "k1_compare", cs.fold_chunk_packed).items()}


def log_k1_builds(prefix=""):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM, threads a block and slices held at once of K1's and B1b's builds
    (C = 16 unrolled; the generic one, which C = 1 takes), from
    ``cudaFuncGetAttributes`` and the occupancy calculator."""
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs

    for planes, tag in ((False, "seg_fold"), (True, "seg_fold_planes")):
        for c, name in ((16, "C16"), (1, "C1_generic")):
            a = cs.attributes(c, planes)
            log(f"{prefix}{tag}_{name}.build",
                " ".join(f"{n}={v}" for n, v in a.items()))


def k2_work(rgba, b):
    """Bytes and operations of one K2 launch: the chunk and the
    thresholds read once, the counts, prev rgb and prev-empty read and
    written once; a distance and B compares and adds a slice."""
    c, _, h, w = rgba.shape
    hw = h * w
    nbytes = 4 * (c * 4 * hw + b + 2 * b * hw + 2 * 3 * hw + 2 * hw)
    return nbytes, (8 + 2 * b) * c * hw


def log_k2_builds(prefix=""):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM, threads a block and slices whose loads go out together of K2's
    builds (C = 16 and C = 1 fixed, the generic one; B = 16 exact, the
    padded 32-wide one), from ``cudaFuncGetAttributes`` and the occupancy
    calculator."""
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    for c, b in ((16, BINS), (1, BINS), (7, BINS), (16, 5)):
        a = cm.count_attributes(c, b)
        log(f"{prefix}count_multi.build", f"C={c} B={b} " + " ".join(
            f"{n}={v}" for n, v in a.items()))


def compare_counts(specs):
    """{name: count} for each ``NAME=PATH`` of ``--k2-compare``, another
    design of ``csrc/count_multi.cu``: count is
    `cuda_march.count_multi_chunk` served by that source's build."""
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    return {name: count for name, (count,) in compare_designs(
        specs, "count_multi", "count_multi_attributes", log_k2_builds,
        "k2_compare", cm.count_multi_chunk).items()}


def check_counts(name, got, want):
    """K2's carry ``got`` against the plain version's ``want``: every
    count, prev rgb and prev-empty flag exactly."""
    import torch

    mism = int((got[0] != want[0]).sum())
    log(f"{name}.mismatches", f"{mism} (must be 0)")
    err = max(packed_err(got[1:], want[1:]),
              float((got[0] - want[0]).abs().max()))
    check(name, err, 0.0)
    if mism or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: counts differ from the plain version")
    return err


def k2_frame(chunks, tvec, h, w, dev, compare):
    """K2 over the threshold seed's counting march: the frame's 32
    chunks counted in order into a fresh carry, all launches back to
    back behind `lead`, the median of 5; each ``compare`` build in
    turns. The bound counts the same work with the carry (counts, prev
    rgb, prev-empty) read and written once; the sum of the 32 launches'
    own bounds, which count the carry at every launch, is logged beside
    it."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    def setup():
        st = cm.init_count_multi_packed(BINS, h, w, device=dev)
        torch.cuda.synchronize()
        lead()
        return st

    run = lambda count: (lambda st: count_chunks(count, st, chunks, tvec))
    k2 = run(cm.count_multi_chunk)
    ms = median_ms(k2, 5, setup)
    launch_bytes = sum(k2_work(c[0], BINS)[0] for c in chunks)
    flops = sum(k2_work(c[0], BINS)[1] for c in chunks)
    carry = 4 * (2 * BINS + 2 * 3 + 2) * h * w
    nbytes = launch_bytes - (len(chunks) - 1) * carry
    bound, by = bound_ms(nbytes, flops)
    launch_bound, _ = bound_ms(launch_bytes, flops)
    log("count_frame.bound_ms", f"{bound:.4f} ({by}; the {len(chunks)} "
        f"chunks read once, the carry read and written once)")
    log("count_frame.ms", f"{ms:.4f} bound_ms={bound:.4f} launches="
        f"{len(chunks)}; the stream kept full, a fresh carry each time")
    log("count_frame.launch_bounds_sum_ms", f"{launch_bound:.4f} (the "
        f"carry counted at each of the {len(chunks)} launches)")
    log("count_frame.achieved_gb_s", f"{nbytes / ms / 1e6:.1f} (the "
        f"bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
    compare_ms = {}
    for name, count in compare.items():
        turns = [median_ms(f, 5, setup) for f in (k2, run(count), run(count),
                                                  k2)]
        log(f"count_frame.vs_{name}", in_turns(turns, nbytes, "k2"))
        compare_ms[name] = (turns[1] + turns[2]) / 2
    return dict(ms=ms, bound_ms=bound, bound_by=by, compare_ms=compare_ms)


def fold_chunks(fold, packed, chunks, thr, length):
    for rgba, sk0, sk1 in chunks:
        fold(packed, rgba, thr, max_k=K, sk0=sk0, sk1=sk1, length=length)
    return packed


def count_chunks(count, carry, chunks, tvec):
    for rgba, _, _ in chunks:
        count(carry, rgba, tvec)
    return carry


def packed_err(a, b):
    return max(max_abs(x, y) for x, y in zip(a, b))


def check_fold_and_count(dev, real_chunks, real_thr, real_length,
                         compare=None, k2_compare=None):
    """K1 and K2 against their plain versions on seeded chunks at C = 16
    and C = 1 and on the frame's own chunks. Both are timed with the
    stream kept full on states cloned before the window (`fresh_ms`;
    the one launch beside it), and over the frame's chunks as one frame
    folds (K1) or the threshold seed counts (K2) them; each ``compare``
    build (``--k1-compare``) and ``k2_compare`` build (``--k2-compare``)
    is checked the same way and timed in turns (ours, other, other,
    ours)."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_march as cm
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs
    from scenery_insitu_tpu_torch.ops import supersegments as ss

    compare = compare or {}
    k2_compare = k2_compare or {}
    log_k1_builds()
    log_k2_builds()
    h, w = real_thr.shape          # the frame's intermediate grid
    g = torch.Generator(device=dev).manual_seed(SEED)
    thr = (0.05 + 0.5 * torch.rand((h, w), generator=g, device=dev))
    length = (2.0 + torch.rand((h, w), generator=g, device=dev))
    tvec = ss.threshold_candidates(BINS, device=dev)
    res = {}
    for c in (16, 1):
        rgba = seeded_stream(c, h, w, dev, SEED + c)
        sk0 = torch.linspace(1.0, 1.5, c, device=dev)
        sk1 = (sk0 + 0.5 / max(c, 1)).contiguous()
        # a state that has already folded one chunk, so slots continue
        # across the chunk boundary
        base = cs.init_seg_packed(K, h, w, device=dev)
        pre0 = torch.linspace(0.5, 0.9, 16, device=dev)
        cs.fold_chunk_packed_plain(base, seeded_stream(16, h, w, dev, 99),
                                   thr, max_k=K, sk0=pre0,
                                   sk1=(pre0 + 0.025).contiguous(),
                                   length=length)
        args = dict(max_k=K, sk0=sk0, sk1=sk1, length=length)
        plain = cs.fold_chunk_packed_plain(clone(base), rgba, thr, **args)
        folds = {"k1": cs.fold_chunk_packed, **compare}
        errs = {}
        for name, fold in folds.items():
            got = fold(clone(base), rgba, thr, **args)
            torch.cuda.synchronize()
            tag = f"seg_fold_C{c}" + ("" if name == "k1" else f"_{name}")
            errs[name] = packed_err(got, plain)
            check(tag, errs[name], 1e-5)
            if not torch.equal(got[2][0], plain[2][0]):
                raise AssertionError(f"{tag}: start counts differ")
        err1 = errs["k1"]
        k1 = lambda st: cs.fold_chunk_packed(st, rgba, thr, **args)
        ms1 = fresh_ms(k1, base)
        one = median_ms(k1, 20, lambda: clone(base))
        pms1 = median_ms(lambda st: cs.fold_chunk_packed_plain(
            st, rgba, thr, **args), 3, lambda: clone(base))
        nbytes, flops = k1_work(rgba, base[2], thr, K)
        b1, by1 = bound_ms(nbytes, flops)
        log(f"seg_fold_C{c}.ms", f"{ms1:.4f} plain_ms={pms1:.4f} "
            f"bound_ms={b1:.4f} ({by1}) one_launch_ms={one:.4f} (the "
            f"host's wrapper time included); stream kept full on states "
            f"cloned before the window")
        log(f"seg_fold_C{c}.achieved_gb_s", f"{nbytes / ms1 / 1e6:.1f} (the "
            f"bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak); touched "
            f"rows a pixel {touched_rows(rgba, base[2], thr, K) / (h * w):.3f}")
        for name, fold in compare.items():
            other = lambda st: fold(st, rgba, thr, **args)
            turns = [fresh_ms(f, base) for f in (k1, other, other, k1)]
            log(f"seg_fold_C{c}.vs_{name}", in_turns(turns, nbytes))

        # a carry that has already counted one chunk
        cbase = cm.count_multi_chunk_plain(
            cm.init_count_multi_packed(BINS, h, w, device=dev),
            seeded_stream(16, h, w, dev, 98), tvec)
        cp = cm.count_multi_chunk_plain(clone(cbase), rgba, tvec)
        err2 = check_counts(f"count_C{c}", cm.count_multi_chunk(
            clone(cbase), rgba, tvec), cp)
        for name, count in k2_compare.items():
            check_counts(f"count_C{c}_{name}", count(clone(cbase), rgba,
                                                     tvec), cp)
        k2 = lambda st: cm.count_multi_chunk(st, rgba, tvec)
        ms2 = fresh_ms(k2, cbase)
        one2 = median_ms(k2, 20, lambda: clone(cbase))
        pms2 = median_ms(lambda st: cm.count_multi_chunk_plain(
            st, rgba, tvec), 3, lambda: clone(cbase))
        nbytes2, flops2 = k2_work(rgba, BINS)
        b2, by2 = bound_ms(nbytes2, flops2)
        log(f"count_C{c}.ms", f"{ms2:.4f} plain_ms={pms2:.4f} "
            f"bound_ms={b2:.4f} ({by2}) one_launch_ms={one2:.4f} (the "
            f"host's wrapper time included); stream kept full on states "
            f"cloned before the window")
        log(f"count_C{c}.achieved_gb_s", f"{nbytes2 / ms2 / 1e6:.1f} (the "
            f"bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
        k2_ms = {}
        for name, count in k2_compare.items():
            other = lambda st: count(st, rgba, tvec)
            turns = [fresh_ms(f, cbase) for f in (k2, other, other, k2)]
            log(f"count_C{c}.vs_{name}", in_turns(turns, nbytes2, "k2"))
            k2_ms[name] = (turns[1] + turns[2]) / 2
        res[c] = dict(seg=dict(err=err1, ms=ms1, plain_ms=pms1, bound_ms=b1,
                               bound_by=by1, one_launch_ms=one),
                      count=dict(err=err2, ms=ms2, plain_ms=pms2,
                                 bound_ms=b2, bound_by=by2,
                                 one_launch_ms=one2, compare_ms=k2_ms))

    # the frame's own shaded chunks, folded and counted end to end
    init = lambda: cs.init_seg_packed(K, h, w, device=dev)
    smalls = []
    kern = init()
    for rgba, sk0, sk1 in real_chunks:
        smalls.append(kern[2].clone())
        cs.fold_chunk_packed(kern, rgba, real_thr, max_k=K, sk0=sk0, sk1=sk1,
                             length=real_length)
    plain = fold_chunks(cs.fold_chunk_packed_plain, init(), real_chunks,
                        real_thr, real_length)
    torch.cuda.synchronize()
    err = packed_err(kern, plain)
    check("seg_fold_frame_chunks", err, 1e-5)
    if not torch.equal(kern[2][0], plain[2][0]):
        raise AssertionError("seg_fold_frame_chunks: start counts differ")
    for name, fold in compare.items():
        got = fold_chunks(fold, init(), real_chunks, real_thr, real_length)
        torch.cuda.synchronize()
        check(f"seg_fold_frame_chunks_{name}", packed_err(got, plain), 1e-5)
    res["frame"] = k1_frame(real_chunks, smalls, real_thr, real_length,
                            init, compare)
    res["frame"]["err"] = err
    del kern, plain, smalls

    init = lambda: cm.init_count_multi_packed(BINS, h, w, device=dev)
    cp = count_chunks(cm.count_multi_chunk_plain, init(), real_chunks, tvec)
    for name, count in {"k2": cm.count_multi_chunk, **k2_compare}.items():
        check_counts("count_frame_chunks" + ("" if name == "k2" else
                                             f"_{name}"),
                     count_chunks(count, init(), real_chunks, tvec), cp)
    del cp
    log("frame_chunks", f"{len(real_chunks)} (C="
        f"{sorted({c[0].shape[0] for c in real_chunks})})")
    res["count_frame"] = k2_frame(real_chunks, tvec, h, w, dev, k2_compare)
    return res


def in_turns(turns, nbytes, tag="k1"):
    """The log line of a timing in turns (ours, other, other, ours), ours
    named ``tag``."""
    ms, other = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    return (f"{tag}_ms={ms:.4f} other_ms={other:.4f} other/{tag}="
            f"{other / ms:.3f} turns={'/'.join(f'{x:.4f}' for x in turns)} "
            f"{tag}_gb_s={nbytes / ms / 1e6:.1f} other_gb_s="
            f"{nbytes / other / 1e6:.1f}")


def k1_frame(chunks, smalls, thr, length, init, compare):
    """K1 over one flagship frame's write march: its captured chunks
    folded in order into a fresh state, all launches back to back behind
    `lead` (the stream kept full), the median of 5; the bound of the
    same work; the histogram of the slots a pixel touches a chunk. Each
    ``compare`` build in turns.

    The bound counts the bytes the 32 folds need from HBM: every chunk's
    rgba and ratios, the small state, threshold and length read once and
    the small state written once, and each (pixel, slot) row any chunk
    touches read once and written once. The sum of the 32 launches'
    own bounds, which count the per-pixel state and the rows at every
    launch, is logged beside it."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_seg as cs

    run = lambda fold: (lambda st: fold_chunks(fold, st, chunks, thr,
                                               length))

    def setup():
        st = init()
        torch.cuda.synchronize()
        lead()
        return st

    k1 = run(cs.fold_chunk_packed)
    ms = median_ms(k1, 5, setup)
    h, w = thr.shape
    rows = torch.zeros((K, h, w), dtype=torch.bool, device=thr.device)
    hist = torch.zeros(K + 1, dtype=torch.int64, device=thr.device)
    nbytes, flops, launch_bytes = 4 * (2 * 5 + 2) * h * w, 0, 0
    for (rgba, _, _), small in zip(chunks, smalls):
        c = rgba.shape[0]
        mask = touched_mask(rgba, small, thr, K)
        rows |= mask
        hist += torch.bincount(mask.sum(0).flatten(), minlength=K + 1)
        nbytes += 4 * (c * 4 * h * w + 2 * c)
        b, f = k1_work(rgba, small, thr, K)
        launch_bytes, flops = launch_bytes + b, flops + f
    nbytes += 4 * 2 * 6 * int(rows.sum())
    bound, by = bound_ms(nbytes, flops)
    launch_bound, _ = bound_ms(launch_bytes, flops)
    n_c = collections.Counter(rgba.shape[0] for rgba, _, _ in chunks)
    log("seg_fold_frame.ms", f"{ms:.4f} bound_ms={bound:.4f} ({by}; "
        f"{nbytes / (h * w):.1f} B a pixel) launches={len(chunks)} (chunks "
        f"by C: {dict(n_c)}); the stream kept full, a fresh state each time")
    log("seg_fold_frame.launch_bounds_sum_ms", f"{launch_bound:.4f} "
        f"({launch_bytes / (h * w):.1f} B a pixel: the per-pixel state "
        f"and rows counted at each of the {len(chunks)} launches)")
    log("seg_fold_frame.achieved_gb_s", f"{nbytes / ms / 1e6:.1f} (the "
        f"bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
    hist = hist.tolist()
    live = sum(hist[1:])
    log("seg_fold_frame.touched_slots", json.dumps(
        {"pixel_chunks_by_slots": {i: n for i, n in enumerate(hist) if n},
         "share_touching_none": hist[0] / sum(hist),
         "mean_over_touching": sum(i * n for i, n in enumerate(hist))
         / max(live, 1)}))
    for name, fold in compare.items():
        other = run(fold)
        turns = [median_ms(f, 5, setup) for f in (k1, other, other, k1)]
        log(f"seg_fold_frame.vs_{name}", in_turns(turns, nbytes))
    return dict(ms=ms, bound_ms=bound, bound_by=by)


def planes(sk, length):
    """Depth planes t = sk * length, one f32 multiply each (what the
    compact form computes in the kernel)."""
    return (sk[:, None, None] * length[None]).contiguous()


def packed_equal(a, b):
    return all(bool((x == y).all()) for x, y in zip(a, b))


def fused_work(raw, ratio, tf, rows):
    """Bytes and operations B5 or B6 need to fold the value chunks
    ``raw`` [(val, sk)] in order into one state (what these chunks'
    data needs, not the most it could). Bytes: every value plane and
    its two ratios read once and the knots; prev-empty written for every
    pixel; where a pixel has a live sample (v >= -0.5) its ratio read;
    where it has a non-empty one, its length and threshold read and the
    rest of the small state read and written once; ``rows`` (pixel,
    slot) rows read and written once. Operations: the dead test on every
    sample, the alpha shading and K1's fold on the live ones, the colour
    knots and premultiply on the non-empty ones. Returns (bytes,
    operations, live samples, non-empty samples)."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_fused as cf
    from scenery_insitu_tpu_torch.ops import supersegments as ss

    nz_a = int(torch.count_nonzero(tf.alpha_m))
    nz_c = int(torch.count_nonzero(tf.color_m))
    lit = torch.zeros(ratio.shape, dtype=torch.bool, device=ratio.device)
    full = torch.zeros_like(lit)
    planes = live = solid = 0
    for val, _ in raw:
        alive = val >= -0.5
        drawn = cf.shade_plain(val, ratio, tf)[:, 3] >= ss.EMPTY_ALPHA
        lit |= alive.any(0)
        full |= drawn.any(0)
        planes += val.shape[0]
        live += int(alive.sum())
        solid += int(drawn.sum())
    hw = ratio.numel()
    nbytes = 4 * (planes * hw + 2 * planes + cf.NKNOTS + hw + int(lit.sum())
                  + (2 + 5 + 4) * int(full.sum()) + 2 * 6 * rows)
    ops = (DEAD_TEST_FLOPS * planes * hw
           + (ALPHA_FLOPS_PER_SAMPLE + SHADE_FLOPS_PER_KNOT * nz_a
              + SEG_FLOPS_PER_PIXEL_SLICE) * live
           + (SHADE_FLOPS_PER_KNOT * nz_c + PREMUL_FLOPS) * solid)
    return nbytes, ops, live, solid


def check_new_folds(dev, cap, compare=None, fused_compare=None):
    """B1b, B7, B5 and B6 against their plain versions on the card, on
    the frame's captured chunks and on a seeded stream, with their times
    and bounds. B1b must equal K1's compact form bit for bit; B7's
    counts, B5's and B6's start counts exactly, colour and depth within
    1e-6; B6 must equal B5 chunk after chunk bit for bit. B1b is timed as
    K1 is (`fresh_ms`), each ``compare`` build's planes entry in turns
    with it."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_fused as cf
    from scenery_insitu_tpu_torch.ops import cuda_march as cm
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs

    thr, length, ratio, tf = cap["thr"], cap["length"], cap["ratio"], \
        cap["tf"]
    h, w = thr.shape
    hw = h * w
    res = {}

    # B1b: the frame's chunks through both K1 forms, then a seeded chunk
    compact = cs.init_seg_packed(K, h, w, device=dev)
    plane = cs.init_seg_packed(K, h, w, device=dev)
    for rgba, sk0, sk1 in cap["chunks"]:
        cs.fold_chunk_packed(compact, rgba, thr, max_k=K, sk0=sk0, sk1=sk1,
                             length=length)
        cs.fold_chunk_packed(plane, rgba, thr, max_k=K, t0=planes(sk0, length),
                             t1=planes(sk1, length))
    torch.cuda.synchronize()
    if not packed_equal(compact, plane):
        raise AssertionError("seg_fold_planes differs from K1's compact "
                             "form on the frame's chunks")
    log("seg_fold_planes_frame_chunks", "equal to K1's compact form bit "
        "for bit")
    del compact, plane
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    sthr = (0.05 + 0.5 * torch.rand((h, w), generator=g, device=dev))
    rgba = seeded_stream(CHUNK, h, w, dev, SEED + 7)
    sk0 = torch.linspace(1.0, 1.5, CHUNK, device=dev)
    sk1 = (sk0 + 0.5 / CHUNK).contiguous()
    t0, t1 = planes(sk0, length), planes(sk1, length)
    pre0 = torch.linspace(0.5, 0.9, 16, device=dev)
    pre_rgba = seeded_stream(16, h, w, dev, 99)
    base = cs.init_seg_packed(K, h, w, device=dev)
    cs.fold_chunk_packed_plain(base, pre_rgba, sthr, max_k=K,
                               t0=planes(pre0, length),
                               t1=planes(pre0 + 0.025, length))
    kern = cs.fold_chunk_packed(clone(base), rgba, sthr, max_k=K, t0=t0,
                                t1=t1)
    comp = cs.fold_chunk_packed(clone(base), rgba, sthr, max_k=K, sk0=sk0,
                                sk1=sk1, length=length)
    plain = cs.fold_chunk_packed_plain(clone(base), rgba, sthr, max_k=K,
                                       t0=t0, t1=t1)
    torch.cuda.synchronize()
    if not packed_equal(kern, comp):
        raise AssertionError("seg_fold_planes differs from K1's compact "
                             "form on a seeded chunk")
    err = packed_err(kern, plain)
    check("seg_fold_planes", err, 1e-5)
    b1b = lambda st: cs.fold_chunk_packed(st, rgba, sthr, max_k=K, t0=t0,
                                          t1=t1)
    ms = fresh_ms(b1b, base)
    one = median_ms(b1b, 20, lambda: clone(base))
    pms = median_ms(lambda st: cs.fold_chunk_packed_plain(
        st, rgba, sthr, max_k=K, t0=t0, t1=t1), 3, lambda: clone(base))
    rows = touched_rows(rgba, base[2], sthr, K)
    nbytes = 4 * (CHUNK * 6 * hw + hw + 2 * 5 * hw + 2 * 6 * rows)
    b, by = bound_ms(nbytes, SEG_FLOPS_PER_PIXEL_SLICE * CHUNK * hw)
    log("seg_fold_planes.ms", f"{ms:.4f} plain_ms={pms:.4f} "
        f"bound_ms={b:.4f} ({by}) one_launch_ms={one:.4f} (the host's "
        f"wrapper time included); stream kept full on states cloned before "
        f"the window")
    log("seg_fold_planes.achieved_gb_s", f"{nbytes / ms / 1e6:.1f}")
    for name, fold in (compare or {}).items():
        got = fold(clone(base), rgba, sthr, max_k=K, t0=t0, t1=t1)
        torch.cuda.synchronize()
        check(f"seg_fold_planes_{name}", packed_err(got, plain), 1e-5)
        other = lambda st: fold(st, rgba, sthr, max_k=K, t0=t0, t1=t1)
        turns = [fresh_ms(f, base) for f in (b1b, other, other, b1b)]
        log(f"seg_fold_planes.vs_{name}", in_turns(turns, nbytes))
    res["seg_fold_planes"] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b,
                                  bound_by=by, one_launch_ms=one)

    # B7: a seeded chunk after one folded chunk, without and with count
    mbase = cm.init_packed(K, h, w, device=dev)
    cm.fold_chunk_plain(mbase, pre_rgba, planes(pre0, length),
                        planes(pre0 + 0.025, length), sthr, max_k=K)
    errs = []
    for with_count in (False, True):
        ck = torch.zeros((h, w), dtype=torch.int32, device=dev)
        cp = ck.clone()
        kern = cm.fold_chunk(clone(mbase), rgba, t0, t1, sthr, max_k=K,
                             count=ck if with_count else None)
        plain = cm.fold_chunk_plain(clone(mbase), rgba, t0, t1, sthr,
                                    max_k=K, count=cp if with_count else None)
        if with_count:
            kern, plain = kern[0], plain[0]
        torch.cuda.synchronize()
        if not (torch.equal(ck, cp) and torch.equal(kern[2][11],
                                                   plain[2][11])):
            raise AssertionError(f"fold_chunk (count={with_count}): counts "
                                 f"or slot counters differ")
        errs.append(packed_err(kern, plain))
        check(f"fold_chunk_count{int(with_count)}", errs[-1], 1e-6)
    cnt = torch.zeros((h, w), dtype=torch.int32, device=dev)
    b7 = lambda st: cm.fold_chunk(st, rgba, t0, t1, sthr, max_k=K, count=cnt)
    ms = fresh_ms(b7, mbase)
    one = median_ms(b7, 20, lambda: clone(mbase))
    pms = median_ms(lambda st: cm.fold_chunk_plain(
        st, rgba, t0, t1, sthr, max_k=K, count=cnt), 3, lambda: clone(mbase))
    closes = float((kern[2][11] - mbase[2][11]).sum())
    b, by = bound_ms(4 * (CHUNK * 6 * hw + hw + 2 * 12 * hw + 2 * hw
                          + 6 * closes),
                     MACHINE_FLOPS_PER_PIXEL_SLICE * CHUNK * hw)
    log("fold_chunk.ms", f"{ms:.4f} plain_ms={pms:.4f} bound_ms={b:.4f} "
        f"({by}) one_launch_ms={one:.4f} (the host's wrapper time "
        f"included) closes_per_pixel={closes / hw:.3f}; stream kept full on "
        f"states cloned before the window")
    # the frame's chunks, with the temporal count
    packs = [cm.init_packed(K, h, w, device=dev) for _ in range(2)]
    cnts = [torch.zeros((h, w), dtype=torch.int32, device=dev)
            for _ in range(2)]
    for rgba_c, sk0_c, sk1_c in cap["chunks"]:
        a0, a1 = planes(sk0_c, length), planes(sk1_c, length)
        cm.fold_chunk(packs[0], rgba_c, a0, a1, thr, max_k=K, count=cnts[0])
        cm.fold_chunk_plain(packs[1], rgba_c, a0, a1, thr, max_k=K,
                            count=cnts[1])
    torch.cuda.synchronize()
    log("fold_chunk_frame_chunks.count_mismatches",
        f"{int((cnts[0] != cnts[1]).sum())} (must be 0)")
    if not torch.equal(cnts[0], cnts[1]):
        raise AssertionError("fold_chunk: counts differ on the frame's "
                             "chunks")
    errs.append(packed_err(*packs))
    check("fold_chunk_frame_chunks", errs[-1], 1e-6)
    # the least a frame's 32 launches need from HBM, counted once for the
    # frame: every sample's rgba and two depths, the 12-float state and
    # the count read and written and the threshold read once, and a
    # 6-float row written at each slot the machine closed
    samples = sum(rgba_c.shape[0] for rgba_c, _, _ in cap["chunks"]) * hw
    closes = float(packs[0][2][11].sum())
    fb, fby = bound_ms(4 * (6 * samples + 2 * 12 * hw + hw + 2 * hw
                            + 6 * closes),
                       MACHINE_FLOPS_PER_PIXEL_SLICE * samples)
    log("fold_chunk_frame.bound_ms", f"{fb:.4f} ({fby}; the frame's "
        f"{len(cap['chunks'])} chunks, {closes / hw:.3f} slots closed a "
        f"pixel)")
    res["fold_chunk"] = dict(err=max(errs), ms=ms, plain_ms=pms, bound_ms=b,
                             bound_by=by, one_launch_ms=one)
    del packs, cnts, mbase

    res.update(check_fused_folds(dev, cap, fused_compare))
    return res


def log_fused_builds(prefix=""):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM, threads a block and slices a stage holds of B5's and B6's builds
    (C = 16 and C = 1 fixed; the generic one), from
    ``cudaFuncGetAttributes`` and the occupancy calculator."""
    from scenery_insitu_tpu_torch.ops import cuda_fused as cf

    for c, name in ((16, "C16"), (1, "C1"), (5, "generic")):
        a = cf.attributes(c)
        log(f"{prefix}fused_fold_{name}.build",
            " ".join(f"{n}={v}" for n, v in a.items()))


def compare_fused(specs):
    """{name: (b5, b6)} for each ``NAME=PATH`` of ``--fused-compare``,
    another design of ``csrc/fused_fold.cu``: the wrappers
    `cuda_fused.fused_fold_chunk` and `fused_stream_fold` served by that
    source's build."""
    from scenery_insitu_tpu_torch.ops import cuda_fused as cf

    return compare_designs(specs, "fused_fold", "fused_fold_attributes",
                           log_fused_builds, "fused_compare",
                           cf.fused_fold_chunk, cf.fused_stream_fold)


def time_vs(compare_ms, key, label, ours, others, nbytes, timer, tag):
    """Each fold of ``others`` {name: fn} timed in turns with ``ours``
    (ours, other, other, ours, each by ``timer``): the log line
    ``<label>.vs_<name>`` and the other's time at
    ``compare_ms[name][key]``."""
    for name, other in others.items():
        turns = [timer(f) for f in (ours, other, other, ours)]
        log(f"{label}.vs_{name}", in_turns(turns, nbytes, tag))
        compare_ms.setdefault(name, {})[key] = (turns[1] + turns[2]) / 2


def check_same(name, got, want):
    """``got`` against the packed state ``want``: start counts exactly,
    colour and depth within 1e-6."""
    import torch

    if not torch.equal(got[2][0], want[2][0]):
        raise AssertionError(f"{name}: start counts differ")
    check(name, packed_err(got, want), 1e-6)


def sample_shares(raw, live, solid):
    """The log line of the shares of the samples of the value chunks
    ``raw`` [(val, sk)] that B5/B6 find dead (v < -0.5), live with a
    corrected alpha below EMPTY_ALPHA, and non-empty (``live`` and
    ``solid`` samples, from `fused_work`)."""
    total = sum(val.numel() for val, _ in raw)
    return json.dumps(dict(samples=total, dead=(total - live) / total,
                           live_empty=(live - solid) / total,
                           non_empty=solid / total))


def check_fused_folds(dev, cap, compare=None):
    """B5 and B6 on the frame's captured value chunks: B5 over the 32
    chunks of the gathered feed (every skipped chunk a whole chunk of -1
    planes) and B6 over their stream against their plain versions (start
    counts exact, colour and depth within 1e-6; B6 equal to B5 chunk
    after chunk bit for bit). Timed with the stream kept full on states
    cloned before the window (`fresh_ms`, one launch beside it): B5 on
    the fullest chunk and on dead chunks of 1 and 16 planes, B6 over the
    stream; "B5 a frame": the 32 chunks the ``pallas_fused`` march feeds
    (a skipped chunk one -1 plane) folded in order into a fresh state,
    all launches back to back behind `lead`, with its own bound (counted
    once for the frame) and the dead, live-but-empty and non-empty
    shares of its samples. Each ``compare`` build (``--fused-compare``)
    is checked the same way and timed in turns (new, other, other,
    new)."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_fused as cf
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs

    compare = compare or {}
    thr, length, ratio, tf, ds = (cap[n] for n in ("thr", "length", "ratio",
                                                   "tf", "ds"))
    h, w = thr.shape
    hw = h * w
    res = {}
    log_fused_builds()
    init = lambda: cs.init_seg_packed(K, h, w, device=dev)
    # the knots built once, as a march does, so no launch in a timed
    # window builds them
    kw = dict(max_k=K, tf=tf, knots=cf.tf_knots(tf))
    args_of = lambda val, sk: (val, length, ratio, sk, (sk + ds).contiguous(),
                               thr)
    # each design's B5 on fixed arguments, and B5 over a feed of them
    b5_of = lambda fold, args: (lambda st: fold(st, *args, **kw))

    def feed_of(fold, feed):
        def run(st):
            for args in feed:
                fold(st, *args, **kw)
            return st
        return run

    designs = lambda make: {name: make(o5, o6)
                            for name, (o5, o6) in compare.items()}

    # B5 over the gathered feed's chunks, from the initial state
    gathered = [args_of(val, sk) for val, sk in cap["raw"]]
    live = [int((val >= -0.5).sum()) for val, _ in cap["raw"]]
    j = live.index(max(live))
    base5 = feed_of(cf.fused_fold_chunk, gathered[:j])(init())
    k5 = feed_of(cf.fused_fold_chunk, gathered[j:])(clone(base5))
    p5 = init()
    for args in gathered:
        cf.fused_fold_chunk_plain(p5, *args, max_k=K, tf=tf)
    torch.cuda.synchronize()
    mism = int((k5[2][0] != p5[2][0]).sum())
    log("fused_fold_chunk_frame_chunks.count_mismatches",
        f"{mism} (must be 0)")
    if mism:
        raise AssertionError("fused_fold_chunk: start counts differ")
    err5 = packed_err(k5, p5)
    check("fused_fold_chunk_frame_chunks", err5, 1e-6)
    del p5
    for name, (o5, _) in compare.items():
        check_same(f"fused_fold_chunk_frame_chunks_{name}",
                   feed_of(o5, gathered)(init()), k5)

    # B5 on the fullest chunk and on dead chunks, stream kept full
    compare_ms = {}
    timer = lambda f: fresh_ms(f, base5)
    val, sk = cap["raw"][j]
    args = gathered[j]
    b5 = b5_of(cf.fused_fold_chunk, args)
    ms = fresh_ms(b5, base5)
    one = median_ms(b5, 20, lambda: clone(base5))
    pms = median_ms(lambda st: cf.fused_fold_chunk_plain(
        st, *args, max_k=K, tf=tf), 3, lambda: clone(base5))
    rows = touched_rows(cf.shade_plain(val, ratio, tf), base5[2], thr, K)
    nbytes, ops, n_live, n_solid = fused_work([(val, sk)], ratio, tf, rows)
    b, by = bound_ms(nbytes, ops)
    log("fused_fold_chunk.ms", f"{ms:.4f} plain_ms={pms:.4f} "
        f"bound_ms={b:.4f} ({by}) one_launch_ms={one:.4f} (the host's "
        f"wrapper time included); stream kept full on states cloned before "
        f"the window; chunk={j} samples={CHUNK * hw} live={n_live} "
        f"non_empty={n_solid}")
    log("fused_fold_chunk.achieved_gb_s", f"{nbytes / ms / 1e6:.1f} (the "
        f"bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
    time_vs(compare_ms, "ms", "fused_fold_chunk", b5,
            designs(lambda o5, _: b5_of(o5, args)), nbytes, timer, "b5")
    # what a skipped chunk costs B5: one -1 plane (the chunked feed) or a
    # whole chunk of them (the gathered feed)
    for planes_n in (1, CHUNK):
        dead = torch.full((planes_n, h, w), -1.0, device=dev)
        dsk = sk[:planes_n].contiguous()
        dargs = args_of(dead, dsk)
        d5 = b5_of(cf.fused_fold_chunk, dargs)
        dms = fresh_ms(d5, base5)
        dbytes, dops, _, _ = fused_work([(dead, dsk)], ratio, tf, 0)
        db, dby = bound_ms(dbytes, dops)
        log(f"fused_fold_chunk_dead_C{planes_n}.ms", f"{dms:.4f} "
            f"bound_ms={db:.4f} ({dby}; {dbytes / hw:.1f} B a pixel) "
            f"one_launch_ms={median_ms(d5, 20, lambda: clone(base5)):.4f}; "
            f"stream kept full")
        time_vs(compare_ms, f"dead_C{planes_n}_ms",
                f"fused_fold_chunk_dead_C{planes_n}", d5,
                designs(lambda o5, _: b5_of(o5, dargs)), dbytes, timer,
                "b5")
    del base5

    # B5 a frame: the chunks the pallas_fused march feeds, in order
    feed = cap["raw_b5"]
    fargs = [args_of(v_, s_) for v_, s_ in feed]

    def setup():
        st = init()
        torch.cuda.synchronize()
        lead()
        return st

    b5_frame = feed_of(cf.fused_fold_chunk, fargs)
    frame_ms = median_ms(b5_frame, 5, setup)
    st = b5_frame(init())
    torch.cuda.synchronize()
    if not packed_equal(st, k5):
        raise AssertionError("B5 over the chunked feed differs from B5 over "
                             "the gathered feed")
    planes_n = sum(v_.shape[0] for v_, _ in feed)
    rows = float(torch.clamp(st[2][0], max=K).sum())
    fbytes, fops, f_live, f_solid = fused_work(feed, ratio, tf, rows)
    fb, fby = bound_ms(fbytes, fops)
    n_c = collections.Counter(v_.shape[0] for v_, _ in feed)
    log("fused_fold_frame.ms", f"{frame_ms:.4f} bound_ms={fb:.4f} ({fby}; "
        f"{fbytes / hw:.1f} B a pixel) launches={len(feed)} (chunks by C: "
        f"{dict(n_c)}, {planes_n} planes); the stream kept full, a fresh "
        f"state each time; equal to B5 over the gathered feed bit for bit")
    log("fused_fold_frame.achieved_gb_s", f"{fbytes / frame_ms / 1e6:.1f}")
    log("fused_fold_frame.samples", sample_shares(feed, f_live, f_solid))
    time_vs(compare_ms, "frame_ms", "fused_fold_frame", b5_frame,
            designs(lambda o5, _: feed_of(o5, fargs)), fbytes,
            lambda f: median_ms(f, 5, setup), "b5")
    del st
    res["fused_fold_chunk"] = dict(
        err=err5, ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
        one_launch_ms=one, frame_ms=frame_ms, frame_bound_ms=fb,
        compare_ms=compare_ms)

    # B6 over the whole gathered stream
    val = torch.cat([v_ for v_, _ in cap["raw"]])
    sk = torch.cat([s_ for _, s_ in cap["raw"]])
    args = args_of(val, sk)
    b6_of = lambda fold: (lambda st: fold(st, *args, chunk=CHUNK, **kw))
    b6 = b6_of(cf.fused_stream_fold)
    k6 = b6(init())
    p6 = cf.fused_stream_fold_plain(init(), *args, max_k=K, chunk=CHUNK,
                                    tf=tf)
    torch.cuda.synchronize()
    mism = int((k6[2][0] != p6[2][0]).sum())
    log("fused_stream_fold.count_mismatches", f"{mism} (must be 0)")
    if mism:
        raise AssertionError("fused_stream_fold: start counts differ")
    err6 = packed_err(k6, p6)
    check("fused_stream_fold", err6, 1e-6)
    if not packed_equal(k6, k5):
        raise AssertionError("fused_stream_fold differs from "
                             "fused_fold_chunk chunk after chunk")
    log("fused_stream_fold_vs_chunks", "equal to fused_fold_chunk chunk "
        "after chunk bit for bit")
    del p6
    others6 = designs(lambda _, o6: b6_of(o6))
    for name, other in others6.items():
        check_same(f"fused_stream_fold_{name}", other(init()), k6)
    base6 = init()
    ms = fresh_ms(b6, base6, launches=5)
    one = median_ms(b6, 5, lambda: clone(base6))
    pms = median_ms(lambda st: cf.fused_stream_fold_plain(
        st, *args, max_k=K, chunk=CHUNK, tf=tf), 1, lambda: clone(base6))
    s_total = val.shape[0]
    rows = float(torch.clamp(k6[2][0], max=K).sum())
    nbytes, ops, n_live, n_solid = fused_work(cap["raw"], ratio, tf, rows)
    b, by = bound_ms(nbytes, ops)
    log("fused_stream_fold.ms", f"{ms:.4f} plain_ms={pms:.4f} "
        f"bound_ms={b:.4f} ({by}) one_launch_ms={one:.4f}; stream kept "
        f"full on states cloned before the window; slices={s_total} "
        f"samples={s_total * hw} live={n_live} non_empty={n_solid}")
    log("fused_stream_fold.achieved_gb_s", f"{nbytes / ms / 1e6:.1f}")
    log("fused_stream_fold.samples", sample_shares(cap["raw"], n_live,
                                                   n_solid))
    compare6 = {}
    time_vs(compare6, "ms", "fused_stream_fold", b6, others6, nbytes,
            lambda f: fresh_ms(f, base6, launches=5), "b6")
    # one launch a march: the frame's B6 time is the march's
    res["fused_stream_fold"] = dict(err=err6, ms=ms, plain_ms=pms,
                                    bound_ms=b, bound_by=by,
                                    one_launch_ms=one, frame_ms=ms,
                                    frame_bound_ms=b, compare_ms=compare6)
    return res


def capture_chunks(dev, u, v, eye):
    """The shaded chunks (rgba, sk0, sk1) of one write march of the
    flagship frame, with its seed threshold and ray lengths, and the same
    march's raw value chunks (val, sk) as the fused folds see them: as
    ``fused_stream`` gathers them (``raw``, every skipped chunk a full
    chunk of -1 planes) and as ``pallas_fused`` feeds them (``raw_b5``,
    a skipped chunk one -1 plane); the raw chunks' opacity ratios and
    the transfer function."""
    import torch

    from scenery_insitu_tpu_torch.config import SliceMarchConfig, VDIConfig
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops.sampling import nominal_step

    tf = for_dataset("gray_scott", device=dev)
    vol = Volume.centered(v, extent=2.0)
    cam = Camera.create(eye, fov_y_deg=50.0, near=0.5, far=20.0, device=dev)
    spec = slicer.make_spec(cam, tuple(v.shape),
                            SliceMarchConfig(chunk=CHUNK))
    axcam = slicer.make_axis_camera(vol, cam, spec)
    thr = slicer.initial_threshold(
        vol, tf, cam, spec, VDIConfig(max_supersegments=K,
                                      adaptive_mode="temporal",
                                      histogram_bins=BINS)).thr
    chunks = []

    def keep(carry, rgba, sk0, sk1):
        chunks.append((rgba.clone(), sk0.clone(), sk1.clone()))
        return carry

    occ = slicer.occupancy_for(vol, tf, spec)
    slicer.slice_march(vol, tf, axcam, spec, keep, None, occupancy=occ,
                       shaded_compact=True)
    raw = []

    def keep_raw(carry, val, sk):
        raw.append((val.clone(), sk.clone()))
        return carry

    slicer.slice_march(vol, tf, axcam, spec, keep_raw, None, occupancy=occ,
                       raw=True, raw_full_skip=True)
    gathered, raw = raw, []
    slicer.slice_march(vol, tf, axcam, spec, keep_raw, None, occupancy=occ,
                       raw=True)
    length = axcam.ray_lengths().contiguous()
    ds = torch.abs(axcam.dwm) / axcam.zp
    ratio = (ds * length / nominal_step(vol)).contiguous()
    return dict(chunks=chunks, raw=gathered, raw_b5=raw, thr=thr.contiguous(),
                length=length, ds=ds, ratio=ratio, tf=tf)


# ------------------------------------------------------------- phase 3


def frame_config(device, fold="auto", occupancy=None, mm="bf16"):
    """Phase 3's frame step settings; ``mm`` the resampling products'
    dtype (bf16 resolves to f32 on the CPU, so a card frame held against
    the CPU's passes f32 on both sides)."""
    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 SliceMarchConfig, VDIConfig)

    return dict(
        sim_steps=SIM_STEPS, occupancy=occupancy,
        vdi_cfg=VDIConfig(max_supersegments=K, adaptive_iters=2,
                          adaptive_mode="temporal", histogram_bins=BINS),
        comp_cfg=CompositeConfig(max_output_supersegments=K,
                                 adaptive_iters=2),
        slicer_cfg=SliceMarchConfig(fold=fold, chunk=CHUNK, matmul_dtype=mm),
        device=device)


def yaw_of(i):
    # within ±0.35 rad of the base camera: every frame stays in the z
    # march regime the step was built for
    return 0.35 * math.sin(0.7 * (i + 1))


def run_frame(dev, profile=False, fold="auto", prefix="frame",
              kernel_names=FRAME_KERNELS, time_sim=True, occupancy=None):
    """The flagship temporal frame under ``fold`` and the empty-space
    mode ``occupancy``: ``init_threshold``, the warm-up and timed frames
    with the launch counts read from that run (every kernel of
    ``kernel_names`` launched), then the march and (``time_sim``) the
    sim timed apart, each the median of TIMED_FRAMES. The sim is the
    same K3 work under every fold, so the fold frames leave it to phase
    3; under ``occupancy="sim"`` it is the sim with B4b's ranges and the
    march includes the pyramid built from them. Logs under ``prefix``;
    returns the launch counts and the final (u, v, thresholds, step)."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.models.pipelines import \
        grayscott_vdi_frame_step
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    base = Camera.create((0.0, 0.6, 3.0), fov_y_deg=50.0, near=0.5,
                         far=20.0, device=dev)
    step = grayscott_vdi_frame_step(grid_shape=(GRID,) * 3,
                                    axis_sign=slicer.choose_axis(base),
                                    **frame_config(dev, fold, occupancy))
    log(f"{prefix}.spec", step.spec)
    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    u, v = st.u, st.v
    eye = lambda i: orbit(base, yaw_of(i)).eye

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thr = step.init_threshold(u, v, eye(-1))
    torch.cuda.synchronize()
    log(f"{prefix}.init_threshold_s", f"{time.perf_counter() - t0:.3f}")
    for i in range(WARMUP_FRAMES):
        color, depth, u, v, thr = step(u, v, eye(i), thr)
    torch.cuda.synchronize()
    ev = []
    wall = []
    for i in range(WARMUP_FRAMES, WARMUP_FRAMES + TIMED_FRAMES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        a.record()
        color, depth, u, v, thr = step(u, v, eye(i), thr)
        b.record()
        b.synchronize()
        wall.append((time.perf_counter() - h0) * 1e3)
        ev.append(a.elapsed_time(b))
    launches = kernels.launches()
    log(f"{prefix}.launches", json.dumps(launches))
    require_launched(launches, kernel_names,
                     f"the single-chip frame (fold {step.spec.fold})")
    ev.sort()
    wall.sort()
    FRAME_MS[prefix] = (ev[len(ev) // 2], wall[len(wall) // 2])
    if prefix == "frame":
        PHASE3_VDI.update(color=color.cpu().numpy(),
                          depth=depth.cpu().numpy())
    log(f"{prefix}.ms_per_frame", f"{ev[len(ev) // 2]:.3f} (median of "
        f"{TIMED_FRAMES}, CUDA events; host clock {wall[len(wall) // 2]:.3f})")

    nj, ni = step.spec.nj, step.spec.ni
    check_vdi(prefix, VDI(color, depth), (K, 4, nj, ni), (K, 2, nj, ni))
    if not bool(torch.isfinite(u).all() & torch.isfinite(v).all()):
        raise AssertionError("sim state is not finite")

    # the split: the sim advance and the march, timed apart on this state
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import occupancy as occ

    sim_occ = occupancy == "sim"
    if time_sim:
        advance = gs.multi_step_fast_ranges if sim_occ else gs.multi_step_fast
        sim_ms = median_ms(lambda _: advance(
            gs.GrayScott(u, v, st.params), SIM_STEPS), TIMED_FRAMES)
        log(f"{prefix}.sim_ms", f"{sim_ms:.3f}")
    cfg = frame_config(dev)
    tf = for_dataset("gray_scott", device=dev)
    vol = Volume.centered(v, extent=2.0)
    cam = Camera.create(eye(0), fov_y_deg=50.0, near=0.5, far=20.0,
                        device=dev)
    pyramid = lambda: None
    if sim_occ:
        # the sim's ranges of this field (B4b's equal these exactly, 5a)
        rng = occ.field_ranges(v, *occ.default_bricks(tuple(v.shape)))
        pyramid = lambda: occ.pyramid_from_ranges(rng, vol, tf, step.spec)
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
    march_ms = median_ms(lambda _: slicer.generate_vdi_mxu_temporal(
        vol, tf, cam, step.spec, thr, cfg["vdi_cfg"], occupancy=pyramid()),
        TIMED_FRAMES)
    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - allocs
    log(f"{prefix}.march_ms", f"{march_ms:.3f} (median of {TIMED_FRAMES} "
        f"marches "
        f"alone; device allocations in them: {allocs})")
    if profile:
        state = [u, v, thr]

        def one(i):
            _, _, state[0], state[1], state[2] = step(*state[:2], eye(i),
                                                      state[2])

        profile_frames("profile" if prefix == "frame" else
                       f"{prefix}.profile", one)
    return launches, (u, v, thr, step)


def run_fold_frames(dev, ref, profile=False):
    """The flagship frame under each fold of FOLD_KERNELS, through
    ``grayscott_vdi_frame_step`` exactly as phase 3 runs it, with the
    launch counts set to 0 before each fold's run and read after it (the
    fold's kernel must launch). Then each fold's VDI against the phase 3
    frame's fold (``pallas_seg``) at the same state, eye and threshold:
    PSNR of the two images at least FOLD_PSNR_DB, and the share of
    pixels whose live slot count differs. Returns {fold: (launches,
    psnr)}."""
    import torch

    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer

    u, v, thr, ref_step = ref
    cfg = frame_config(dev)["vdi_cfg"]
    tf = for_dataset("gray_scott", device=dev)
    base = Camera.create((0.0, 0.6, 3.0), fov_y_deg=50.0, near=0.5,
                         far=20.0, device=dev)
    cam = Camera.create(orbit(base, yaw_of(0)).eye, fov_y_deg=50.0,
                        near=0.5, far=20.0, device=dev)
    vol = Volume.centered(v, extent=2.0)
    want, _, _, _ = slicer.generate_vdi_mxu_temporal(
        vol, tf, cam, ref_step.spec, thr, cfg)
    want_img = render_vdi_same_view(want)
    want_live = torch.isfinite(want.depth[:, 0]).sum(0)
    out = {}
    for fold, name in FOLD_KERNELS.items():
        torch.cuda.empty_cache()
        launches, (_, _, _, step) = run_frame(
            dev, profile, fold=fold, prefix=f"fold_{fold}",
            kernel_names=(name, "grayscott_fused", "count_multi"),
            time_sim=False)
        got, _, _, _ = slicer.generate_vdi_mxu_temporal(
            vol, tf, cam, step.spec, thr, cfg)
        psnr = image_psnr(render_vdi_same_view(got), want_img)
        live = torch.isfinite(got.depth[:, 0]).sum(0)
        share = float((live != want_live).float().mean())
        log(f"fold_{fold}.psnr_vs_pallas_seg_db", f"{psnr:.2f} (gate "
            f">= {FOLD_PSNR_DB}; pixels whose live slot count differs: "
            f"{share:.6f})")
        if not psnr >= FOLD_PSNR_DB:
            raise AssertionError(f"fold {fold}: image {psnr:.2f} dB from "
                                 f"the pallas_seg frame")
        out[fold] = (launches, psnr)
        del got
    return out


def profile_frames(prefix, frame, frames=2):
    """Device time by kernel over ``frames`` calls of ``frame(i)``
    (torch.profiler, after one unrecorded warm-up call), the device's
    busy share of the window's CUDA-event time, and from the trace the
    idle gaps and the host-to-device copies and stream synchronisations
    a frame makes; logged under ``prefix``, with each build of the
    port's own kernels as ``<prefix>.port_kernel``. The Chrome
    trace goes to chiprun_out/<prefix>_trace.json."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=frames, repeat=1)) as prof:
        frame(99)
        # the warm-up frame's device work ends before the window opens
        torch.cuda.synchronize()
        prof.step()
        a.record()
        for i in range(frames):
            frame(100 + i)
            if i == frames - 1:
                b.record()
                b.synchronize()
            prof.step()
    window_ms = a.elapsed_time(b)
    # device-side rows (kernels, copies, fills) make the busy time; an
    # operator's row repeats the device time of the kernels it launched,
    # so it is listed apart (the port's own kernels have no operator row).
    # "Command Buffer Full" marks the host waiting on a full launch queue,
    # not device work, and a "ProfilerStep#" row spans a whole step, as
    # a phase scope's row (``sitpu_*``, obs/profiler.py) spans its phase.
    kern, ops = [], []
    for e in prof.key_averages():
        if e.self_device_time_total <= 0 or e.key == "Command Buffer Full" \
                or e.key.startswith(("ProfilerStep", "sitpu_")):
            continue
        row = (e.self_device_time_total / 1e3, e.count, e.key)
        (kern if e.device_type == DeviceType.CUDA else ops).append(row)
    busy = sum(r[0] for r in kern)
    log(f"{prefix}.window_ms", f"{window_ms:.3f} ({frames} frames)")
    log(f"{prefix}.device_busy_ms", f"{busy:.3f} (busy share "
        f"{busy / window_ms:.3f})")
    own = collections.defaultdict(lambda: [0.0, 0])
    for ms, n, key in kern:
        m = re.match(r"(void )?\(anonymous namespace\)::(\w+(<[^>]*>)?)",
                     key)
        if m:
            own[m.group(2)][0] += ms
            own[m.group(2)][1] += n
    for name, (ms, n) in sorted(own.items(), key=lambda x: -x[1][0]):
        print(f"{prefix}.port_kernel {ms / frames:10.3f} ms/frame "
              f"{n / frames:6.1f} launches/frame  {name}", flush=True)
    for kind, rows in (("kernel", kern), ("op", ops)):
        for ms, n, key in sorted(rows, reverse=True)[:12]:
            print(f"{prefix}.{kind} {ms / frames:10.3f} ms/frame "
                  f"{n // frames:6d} calls/frame  {key[:90]}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", f"{prefix}_trace.json")
    prof.export_chrome_trace(path)
    trace_gaps(prefix, path, frames)
    # the port's kernels' {build: [device ms, launches]} over the frames,
    # and the trace's path
    return dict(own), path


def trace_gaps(prefix, path, frames):
    """From a Chrome trace: the union of the device's busy intervals
    over the span from its first to its last device event, the idle
    gaps between them, and per frame the host-to-device copies and the
    host's stream synchronisations (each one drains the device's queue
    before the host launches on)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, gaps, (s0, e0) = 0.0, [], dev[0]
    for s1, e1 in dev[1:]:
        if s1 > e0:
            busy += e0 - s0
            gaps.append(s1 - e0)
            s0, e0 = s1, e1
        else:
            e0 = max(e0, e1)
    busy += e0 - s0
    span = dev[-1][1] - dev[0][0]
    h2d = sum(1 for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", ""))
    syncs = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name") == "cudaStreamSynchronize")
    log(f"{prefix}.trace", f"device ops {len(dev) / frames:.0f}/frame, "
        f"busy {busy / 1e3:.3f} of {span / 1e3:.3f} ms (share "
        f"{busy / span:.3f}), idle gaps {sum(gaps) / 1e3 / frames:.3f} "
        f"ms/frame ({sum(g for g in gaps if g > 100) / 1e3 / frames:.3f} "
        f"in gaps over 0.1 ms), host-to-device copies "
        f"{h2d / frames:.1f}/frame, stream syncs {syncs / frames:.1f}/frame")


def check_small_frame(dev, fold="pallas_seg", occupancy=None):
    """The kernel path of ``fold`` (and empty-space mode ``occupancy``)
    on the card against its plain versions on the CPU, 3 temporal frames
    on a 32^3 grid from the same inputs."""
    import torch

    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
    from scenery_insitu_tpu_torch.models.pipelines import \
        grayscott_vdi_frame_step
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    n = 32
    st = gs.GrayScott.init((n,) * 3, seed=SEED, device="cpu")
    base = Camera.create((0.0, 0.6, 3.0), device="cpu")
    axis_sign = slicer.choose_axis(base)
    outs = {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        step = grayscott_vdi_frame_step(
            grid_shape=(n,) * 3, axis_sign=axis_sign,
            **frame_config(d, fold=fold, occupancy=occupancy, mm="f32"))
        u, v = st.u.to(d), st.v.to(d)
        thr = step.init_threshold(u, v, orbit(base, 0.1).eye.to(d))
        imgs = []
        for i in range(3):
            color, depth, u, v, thr = step(u, v, orbit(base, yaw_of(i))
                                           .eye.to(d), thr)
            imgs.append(render_vdi_same_view(VDI(color, depth)).cpu())
        outs[name] = (torch.stack(imgs), u.cpu(), v.cpu())
    prefix = "small_frame" if fold == "pallas_seg" else \
        f"small_frame_{fold}"
    if occupancy is not None:
        prefix = f"small_frame_{occupancy}_{fold}"
    uerr = max(max_abs(outs["cuda"][1], outs["cpu"][1]),
               max_abs(outs["cuda"][2], outs["cpu"][2]))
    check(f"{prefix}.sim", uerr, 1e-6 * 3 * SIM_STEPS)
    diff = (outs["cuda"][0] - outs["cpu"][0]).abs()
    log(f"{prefix}.image_max_abs_diff", f"{float(diff.max()):.3e}")
    log(f"{prefix}.image_mean_abs_diff", f"{float(diff.mean()):.3e}")
    if not (float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-4):
        raise AssertionError(f"the card's frame (fold {fold}) differs from "
                             f"the CPU's plain versions")


# ------------------------------------------------------------- phase 4


BASE_EYE = (0.0, 0.6, 3.0)


def dist_steps(dev, n, grid, base_eye, fold="auto", plan=None, bricks=None,
               topology=None, mm="bf16", mesh=None, **comp):
    """The distributed temporal step of an ``n``-rank mesh on ``dev``
    for a ``grid``^3 volume, in the march regime of ``base_eye``, with
    the composite settings ``comp`` (exchange, wire, schedule,
    rebalance, ...), the render decomposition ``plan`` or ``bricks``,
    and a ``TopologyConfig`` (None: the flat mesh), resampling in ``mm``
    (f32 where the card's step is held against the CPU's); ``mesh``
    (an n-rank process mesh) in place of the in-process one: (mesh,
    spec, tf, configs, seed, step, camera(i))."""
    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 MeshConfig,
                                                 SliceMarchConfig, VDIConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.topology import make_topology_mesh

    if mesh is None:
        mesh, _ = make_topology_mesh(topology, MeshConfig(num_devices=n),
                                     device=dev)
    base = Camera.create(base_eye, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    vcfg = VDIConfig(max_supersegments=K, adaptive_mode="temporal",
                     histogram_bins=BINS)
    spec = slicer.make_spec(base, (grid,) * 3,
                            SliceMarchConfig(fold=fold, chunk=CHUNK,
                                             matmul_dtype=mm),
                            axis_sign=slicer.choose_axis(base),
                            multiple_of=n)
    if comp.get("schedule") == "waves":
        comp.setdefault("wave_tiles", wave_tiles_for(spec.ni, n))
    ccfg = CompositeConfig(max_output_supersegments=K_OUT,
                           adaptive_iters=COMP_ITERS, **comp)
    tf = for_dataset("gray_scott", device=dev)
    seed = dp.distributed_initial_threshold_mxu(mesh, tf, spec, vcfg,
                                                plan=plan, bricks=bricks)
    step = dp.distributed_vdi_step_mxu_temporal(mesh, tf, spec, vcfg, ccfg,
                                                topology=topology, plan=plan,
                                                bricks=bricks)

    def camera(i):
        return Camera.create(orbit(base, yaw_of(i)).eye, fov_y_deg=50.0,
                             near=0.5, far=20.0, device=dev)

    return mesh, spec, tf, (vcfg, ccfg), seed, step, camera


def check_vdi(prefix, vdi, want_c, want_d):
    import torch

    if tuple(vdi.color.shape) != want_c or tuple(vdi.depth.shape) != want_d:
        raise AssertionError(f"{prefix}: VDI shapes {tuple(vdi.color.shape)}"
                             f", {tuple(vdi.depth.shape)}; expected "
                             f"{want_c}, {want_d}")
    if not bool(torch.isfinite(vdi.color).all()):
        raise AssertionError(f"{prefix}: VDI color is not finite")
    if not bool((torch.isfinite(vdi.depth) | (vdi.depth == torch.inf))
                .all()):
        raise AssertionError(f"{prefix}: VDI depth holds NaN or -inf")
    live = torch.isfinite(vdi.depth[:, 0])
    log(f"{prefix}.live_slots", f"{int(live.sum())} of {live.numel()} "
        f"(pixels with a slot: {int(live.any(0).sum())})")
    if not bool(live.any()):
        raise AssertionError(f"{prefix}: the VDI has no live slot")


def image_psnr(a, b) -> float:
    """PSNR in dB of two premultiplied images over white, rgb in [0, 1]."""
    import torch

    def over_white(img):
        return (img[:3] + (1.0 - img[3:4])).clamp(0.0, 1.0)

    mse = float(torch.mean((over_white(a) - over_white(b)) ** 2))
    return math.inf if mse == 0.0 else 10.0 * math.log10(1.0 / mse)


def run_dist_frame(dev, profile=False):
    """The distributed temporal frame at the flagship size on an
    8-rank mesh: K3 advances the whole grid, `shard_volume` cuts it into
    z-slabs, and the step marches every slab, exchanges the column
    blocks and composites them through K4. ``seed`` once, 2 warm-up and
    6 timed frames with the launch counts read from that run; then the
    frame's phases timed apart on its final state; then, as information,
    the PSNR of its image against the single-chip march at the same eye.
    Returns the launch counts, the frame's exchanged column blocks and
    the last frame (its VDI, metadata, thresholds and ms: phase 8's
    configuration 0)."""
    import torch

    from scenery_insitu_tpu_torch.config import VDIConfig
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops.composite import composite_vdis
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    mesh, spec, tf, (vcfg, ccfg), seed, step, camera = dist_steps(
        dev, RANKS, GRID, BASE_EYE)
    log("dist.spec", f"{spec} ranks={RANKS} slab={GRID // RANKS}x{GRID}x"
        f"{GRID} k_out={K_OUT} composite_iters={COMP_ITERS}")
    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    u, v = st.u, st.v
    box = Volume.centered(v, extent=2.0)
    origin, spacing = box.origin, box.spacing

    run = drive_dist_frames("dist", step, seed, mesh, camera, st, origin,
                            spacing)
    vdi, meta, thr, u, v, launches = (run[k] for k in (
        "vdi", "meta", "thr", "u", "v", "launches"))
    frames = WARMUP_FRAMES + TIMED_FRAMES
    require_launched(launches, DIST_KERNELS, "the distributed frame")
    if launches["resegment_sorted"] != RANKS * frames:
        raise AssertionError(f"K4 launched {launches['resegment_sorted']} "
                             f"times in {frames} frames of {RANKS} ranks")
    check_vdi("dist", vdi, (K_OUT, 4, spec.nj, spec.ni),
              (K_OUT, 2, spec.nj, spec.ni))
    if not bool(torch.isfinite(thr.thr).all()):
        raise AssertionError("dist: threshold maps are not finite")

    # the phases, timed apart on the final state
    sim_ms = median_ms(lambda _: gs.multi_step_fast(
        gs.GrayScott(u, v, st.params), SIM_STEPS), 5)
    slabs = shard_volume(v, mesh)
    halo = dp._halo_for(slabs, spec)
    cam = camera(WARMUP_FRAMES + TIMED_FRAMES)

    def march(_):
        return rank_fragments(dp, slabs, halo, origin, spacing, cam, spec,
                              tf, vcfg, thr)

    march_ms = median_ms(march, 3)
    frags = march(None)
    colors = torch.stack([f.color for f in frags])
    depths = torch.stack([f.depth for f in frags])
    del frags
    exchange_ms = median_ms(lambda _: dp._exchange_vdi_columns(
        colors, depths, RANKS), 5)
    rc, rd = dp._exchange_vdi_columns(colors, depths, RANKS)
    del colors, depths
    composite_ms = median_ms(lambda _: [
        composite_vdis(rc[j], rd[j], ccfg) for j in range(RANKS)], 3)
    log("dist.sim_ms", f"{sim_ms:.3f}")
    log("dist.march_ms", f"{march_ms:.3f} (sum over {RANKS} ranks)")
    log("dist.exchange_ms", f"{exchange_ms:.3f}")
    log("dist.composite_ms", f"{composite_ms:.3f} (sort + K4, {RANKS} "
        f"column blocks)")
    if profile:
        state = [u, v, thr]

        def one(i):
            _, _, state[0], state[1], state[2] = run["frame"](*state, i)

        profile_frames("dist.profile", one)

    # information only: the same state and eye, histogram thresholds,
    # against the single-chip march
    hcfg = VDIConfig(max_supersegments=K, adaptive_mode="histogram",
                     histogram_bins=BINS)
    dvdi, _ = dp.distributed_vdi_step_mxu(mesh, tf, spec, hcfg, ccfg)(
        slabs, origin, spacing, cam)
    svdi, _, _ = slicer.generate_vdi_mxu(Volume.centered(v, extent=2.0), tf,
                                         cam, spec, hcfg)
    psnr = image_psnr(render_vdi_same_view(dvdi), render_vdi_same_view(svdi))
    log("dist.psnr_vs_single_chip_db", f"{psnr:.2f} (information; "
        f"histogram thresholds, same state and eye)")
    return launches, rc, rd, run


def rank_fragments(dp, slabs, halo, origin, spacing, cam, spec, tf, vcfg,
                   thr):
    """Every rank's VDI fragment of the frame schedule's march."""
    return [dp._mxu_rank_generate(slabs, halo, r, origin, spacing, cam,
                                  spec, tf, vcfg,
                                  dp._rank_thr(thr, r, spec.nj))[0]
            for r in range(RANKS)]


def drive_dist_frames(prefix, step, seed, mesh, camera, st, origin,
                      spacing):
    """The distributed temporal frame as phase 4 drives it, from the
    seeded state ``st``: the launch counts set to 0, the seed, 2 warm-up
    and 6 timed frames (CUDA events and the host clock), the counts read
    after. Returns the last frame's VDI, meta and thresholds, the final
    u and v, the launch counts and the median ms."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    u, v = st.u, st.v

    def frame(u, v, thr, i):
        state = gs.multi_step_fast(gs.GrayScott(u, v, st.params), SIM_STEPS)
        (vdi, meta), thr = step(shard_volume(state.field, mesh), origin,
                                spacing, camera(i), thr)
        return vdi, meta, state.u, state.v, thr

    kernels.reset_launches()
    thr = seed(shard_volume(v, mesh), origin, spacing, camera(-1))
    for i in range(WARMUP_FRAMES):
        vdi, meta, u, v, thr = frame(u, v, thr, i)
    torch.cuda.synchronize()
    ev, wall = [], []
    for i in range(WARMUP_FRAMES, WARMUP_FRAMES + TIMED_FRAMES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        a.record()
        vdi, meta, u, v, thr = frame(u, v, thr, i)
        b.record()
        b.synchronize()
        wall.append((time.perf_counter() - h0) * 1e3)
        ev.append(a.elapsed_time(b))
    launches = kernels.launches()
    log(f"{prefix}.launches", json.dumps(launches))
    ev.sort()
    wall.sort()
    ms, wall_ms = ev[len(ev) // 2], wall[len(wall) // 2]
    log(f"{prefix}.ms_per_frame", f"{ms:.3f} (median of {TIMED_FRAMES}, "
        f"CUDA events; host clock {wall_ms:.3f})")
    return dict(vdi=vdi, meta=meta, thr=thr, u=u, v=v, launches=launches,
                ms=ms, wall_ms=wall_ms, frame=frame)


def seeded_sorted_stream(nk, h, w, dev, seed):
    """A per-pixel depth-sorted stream as the composite sees it: a random
    number of live slots front to back (repeated colours, depth gaps,
    alphas below the empty cut), then empty slots."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, device=dev)
    start = torch.sort(1.0 + 4.0 * r(nk, h, w), dim=0).values
    end = start + torch.where(r(nk, h, w) < 0.5, 0.001, 0.2)
    rgb = r(nk, 3, h, w)
    dup = (r(nk, 1, h, w) < 0.3) & (torch.arange(nk, device=dev)
                                    .reshape(nk, 1, 1, 1) > 0)
    rgb = torch.where(dup, torch.roll(rgb, 1, 0), rgb)
    a = 0.05 + 0.9 * r(nk, 1, h, w)
    a = torch.where(r(nk, 1, h, w) < 0.1, 5e-5, a)
    n_live = (r(h, w) * (nk + 1)).floor()
    live = torch.arange(nk, device=dev).reshape(nk, 1, 1) < n_live
    color = torch.where(live[:, None], torch.cat([rgb * a, a], 1), 0.0)
    depth = torch.where(live[:, None], torch.stack([start, end], 1),
                        torch.inf)
    return color.contiguous(), depth.contiguous()


def k4_bound(sc, iters):
    """The bound of the resegment of ``sc`` from the bytes and operations
    it needs: every slot's alpha (to know which are empty), the colour
    and depth of the non-empty slots (an empty slot's never enter the
    result), the K_OUT output slots. Returns ((ms, by), non-empty slots
    a pixel, bytes)."""
    nk, _, h, w = sc.shape
    slots = float((~(sc[:, 3] < 1e-4)).sum())
    nbytes = 4 * (nk * h * w + 5 * slots + 6 * K_OUT * h * w)
    return (bound_ms(nbytes, slots * (iters * RESEG_COUNT_FLOPS
                                      + RESEG_WRITE_FLOPS)),
            slots / (h * w), nbytes)


def log_k4_builds(prefix=""):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM, threads a block and the search list of K4's builds: the frame's
    (the search, the list in registers), the one without the search,
    and the one a K_out above 16 takes (the list in shared memory), from
    ``cudaFuncGetAttributes`` and the occupancy calculator."""
    from scenery_insitu_tpu_torch.ops import cuda_composite as cc

    for nk, k_out, iters in ((RANKS * K, K_OUT, COMP_ITERS),
                             (RANKS * K, K_OUT, 0),
                             (RANKS * K, 24, COMP_ITERS)):
        a = cc.attributes(nk, k_out, iters)
        log(f"{prefix}resegment.build", f"nk={nk} k_out={k_out} iters="
            f"{iters} " + " ".join(f"{n}={v}" for n, v in a.items()))


def log_live_slots(prefix, sc):
    """How the non-empty slots of a stream spread over its pixels and its
    warps (32 neighbouring pixels, as K4 takes them): the share of empty
    pixels, the mean over the others, and the fullest pixel of each warp
    that has one (median and max)."""
    n = (~(sc[:, 3] < 1e-4)).sum(0).flatten()
    if not bool((n > 0).any()):
        log(f"{prefix}.live_slots", "no non-empty slot")
        return
    warp_max = n[: n.numel() // 32 * 32].reshape(-1, 32).amax(1).float()
    warp_max = warp_max[warp_max > 0]
    log(f"{prefix}.live_slots",
        f"empty pixels {float((n == 0).float().mean()):.3f}, non-empty "
        f"slots a non-empty pixel {float(n[n > 0].float().mean()):.2f}, a "
        f"warp's fullest pixel median {float(warp_max.median()):.0f} max "
        f"{float(warp_max.max()):.0f}")


def compare_resegments(specs):
    """{name: resegment} for each ``NAME=PATH`` of ``--k4-compare``,
    another design of ``csrc/resegment.cu``: resegment is
    `cuda_composite.resegment_sorted` served by that source's build."""
    from scenery_insitu_tpu_torch.ops import cuda_composite as cc

    return {name: fn for name, (fn,) in compare_designs(
        specs, "resegment", "resegment_attributes", log_k4_builds,
        "k4_compare", cc.resegment_sorted).items()}


def check_k4(name, fn, sc, sd, want):
    """``fn`` (a build of K4) on the stream ``sc``, ``sd`` against the
    plain version's (color, depth, threshold) ``want``: thresholds and
    live slot counts exactly, colour and depth within 1e-6."""
    import torch

    h, w = sc.shape[2:]
    tk = torch.empty((h, w), device=sc.device)
    ck = fn(sc, sd, None, K_OUT, adaptive_iters=COMP_ITERS, threshold_out=tk)
    torch.cuda.synchronize()
    thr_mism = int((tk != want[2]).sum())
    slot_mism = int((torch.isfinite(ck[1][:, 0]).sum(0)
                     != torch.isfinite(want[1][:, 0]).sum(0)).sum())
    log(f"{name}.mismatches", f"thresholds {thr_mism}, live slot counts "
        f"{slot_mism} (must be 0)")
    if thr_mism or slot_mism:
        raise AssertionError(f"{name}: K4 differs from its plain version "
                             f"in thresholds or counts")
    err = max(max_abs(ck[0], want[0]), max_abs(ck[1], want[1]))
    check(name, err, 1e-6)
    return err


def check_resegment(dev, rc, rd, compare=None):
    """K4 against its plain version on the card at the distributed
    frame's per-rank shapes: a seeded stream and the frame's own
    exchanged column block with the most live slots. Thresholds and
    live slots exact, colour and depth within 1e-6; times with the
    stream kept full behind a device sleep (`stream_ms`; the one launch
    beside it), bound; a
    frame's 8 launches, one a column block, back to back. Each
    ``compare`` build (``--k4-compare``) is checked the same way and
    timed in turns with K4 (K4, other, other, K4)."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_composite as cc
    from scenery_insitu_tpu_torch.ops.composite import sort_stream

    compare = compare or {}
    log_k4_builds()
    _, n, k, _, h, w = rc.shape
    blocks = [sort_stream(rc[i].reshape(n * k, 4, h, w),
                          rd[i].reshape(n * k, 2, h, w))
              for i in range(rc.shape[0])]
    j = int(torch.isfinite(rd[:, :, :, 0]).flatten(1).sum(1).argmax())
    seeded = seeded_sorted_stream(n * k, h, w, dev, SEED)
    res = {}
    for name, (sc, sd) in (("seeded", seeded), ("frame_block", blocks[j])):
        tp = torch.empty((h, w), device=dev)
        want = cc.resegment_sorted_plain(sc, sd, None, K_OUT,
                                         adaptive_iters=COMP_ITERS,
                                         threshold_out=tp) + (tp,)
        err = check_k4(f"resegment_{name}", cc.resegment_sorted, sc, sd,
                       want)
        for other, fn in compare.items():
            check_k4(f"resegment_{name}_{other}", fn, sc, sd, want)
        del want
        k4 = lambda fn=cc.resegment_sorted: fn(sc, sd, None, K_OUT,
                                               adaptive_iters=COMP_ITERS)
        ms = stream_ms(k4, behind_sleep=True)
        one = median_ms(lambda _: k4(), 20)
        pms = median_ms(lambda _: cc.resegment_sorted_plain(
            sc, sd, None, K_OUT, adaptive_iters=COMP_ITERS), 3)
        log_live_slots(f"resegment_{name}", sc)
        (b, by), live_slots, nbytes = k4_bound(sc, COMP_ITERS)
        log(f"resegment_{name}.ms", f"{ms:.4f} plain_ms={pms:.4f} "
            f"bound_ms={b:.4f} ({by}) one_launch_ms={one:.4f} (the host's "
            f"wrapper time included) nk={n * k} hw={h}x{w} "
            f"non_empty_slots_per_pixel={live_slots:.2f}; stream kept full "
            f"behind a device sleep")
        log(f"resegment_{name}.achieved_gb_s", f"{nbytes / ms / 1e6:.1f} "
            f"(the bound's bytes / ms; {HBM_BYTES_PER_S / 1e9:.0f} peak)")
        compare_ms = {}
        for other, fn in compare.items():
            o = lambda: k4(fn)
            turns = [stream_ms(f, behind_sleep=True)
                     for f in (k4, o, o, k4)]
            log(f"resegment_{name}.vs_{other}", in_turns(turns, nbytes,
                                                         "k4"))
            compare_ms[other] = (turns[1] + turns[2]) / 2
        res[name] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b,
                         bound_by=by, one_launch_ms=one,
                         compare_ms=compare_ms)
    # a frame's K4 launches, one a column block: their bounds summed, to
    # set beside K4's device time a frame from the profile
    works = [k4_bound(sc, COMP_ITERS) for sc, _ in blocks]
    fb = sum(wk[0][0] for wk in works)
    log("resegment_frame.bound_ms", f"{fb:.4f} (the {rc.shape[0]} column "
        f"blocks' bounds summed: one frame's K4 launches)")

    def frame(fn):
        def run(_):
            for sc, sd in blocks:
                fn(sc, sd, None, K_OUT, adaptive_iters=COMP_ITERS)
        return run

    def setup():
        torch.cuda.synchronize()
        lead()

    k4f = frame(cc.resegment_sorted)
    fms = median_ms(k4f, 5, setup)
    fbytes = sum(wk[2] for wk in works)
    log("resegment_frame.ms", f"{fms:.4f} bound_ms={fb:.4f} launches="
        f"{len(blocks)}; the stream kept full; achieved_gb_s="
        f"{fbytes / fms / 1e6:.1f}")
    for other, fn in compare.items():
        o = frame(fn)
        turns = [median_ms(f, 5, setup) for f in (k4f, o, o, k4f)]
        log(f"resegment_frame.vs_{other}", in_turns(turns, fbytes, "k4"))
        res["frame_block"]["compare_ms"][f"{other}_frame"] = \
            (turns[1] + turns[2]) / 2
    res["frame"] = dict(ms=fms, bound_ms=fb)
    return res


def check_small_dist(dev):
    """The distributed step on the card (K1, K2, K4) against the CPU's
    plain versions on a 32^3 Gray-Scott volume over 4 ranks, in both
    march regimes: seed + 3 temporal frames from the same inputs."""
    import torch

    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    n = 32
    v0 = gs.multi_step(gs.GrayScott.init((n,) * 3, seed=SEED, device="cpu"),
                       2 * SIM_STEPS).v
    box = Volume.centered(v0, extent=2.0)
    for regime, eye in (("z", BASE_EYE), ("x", (3.0, 0.6, 0.4))):
        outs = {}
        for name, d in (("cuda", dev), ("cpu", "cpu")):
            mesh, spec, _, _, seed, step, camera = dist_steps(
                d, SMALL_RANKS, n, eye, fold="pallas_seg", mm="f32")
            data = shard_volume(v0.to(d), mesh)
            origin, spacing = box.origin.to(d), box.spacing.to(d)
            thr = seed(data, origin, spacing, camera(-1))
            imgs = []
            for i in range(3):
                (vdi, _), thr = step(data, origin, spacing, camera(i), thr)
                imgs.append(render_vdi_same_view(vdi).cpu())
            outs[name] = (torch.stack(imgs), thr.thr.cpu(), spec)
        log(f"small_dist_{regime}.spec", outs["cpu"][2])
        diff = (outs["cuda"][0] - outs["cpu"][0]).abs()
        tdiff = float((outs["cuda"][1] - outs["cpu"][1]).abs().max())
        log(f"small_dist_{regime}.image_max_abs_diff",
            f"{float(diff.max()):.3e}")
        log(f"small_dist_{regime}.image_mean_abs_diff",
            f"{float(diff.mean()):.3e}")
        log(f"small_dist_{regime}.threshold_max_abs_diff", f"{tdiff:.3e}")
        if not (float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-4):
            raise AssertionError(f"the card's distributed frame ({regime} "
                                 f"march) differs from the CPU's plain "
                                 f"versions")


# ------------------------------------------------------------- phase 8


# phase 8's configurations on phase 4's (name, exchange, wire, schedule,
# ring_slots); configuration 0 is phase 4's all_to_all f32 frame
EXCHANGE_CONFIGS = (
    ("c1_ring", "ring", "f32", "frame", 0),
    ("c2_ring_cap", "ring", "f32", "frame", 2 * K),
    ("c3_a2a_bf16", "all_to_all", "bf16", "frame", 0),
    ("c4_a2a_qpack8", "all_to_all", "qpack8", "frame", 0),
    ("c5_ring_qpack8", "ring", "qpack8", "frame", 0),
    ("c6_a2a_waves", "all_to_all", "f32", "waves", 0),
    ("c7_ring_waves", "ring", "f32", "waves", 0),
    ("c8_ring_qpack8_waves", "ring", "qpack8", "waves", 0),
)
C0 = "c0_a2a"
# each waves configuration's frame-schedule twin
WAVE_TWINS = {"c6_a2a_waves": C0, "c7_ring_waves": "c1_ring",
              "c8_ring_qpack8_waves": "c5_ring_qpack8"}
WAVE_TILES = 4
CAP_PSNR_DB, WIRE_PSNR_DB, SMALL_WIRE_PSNR_DB = 30.0, 40.0, 60.0
# the session's tile waves (phase 7 (g)): timed frames and the dumps'
# period
WAVE_SESSION_FRAMES = 4
WAVE_SESSION_EVERY = 2


def wave_tiles_for(ni, n):
    """WAVE_TILES, or the largest T of 2 to 4 whose tiles split every
    rank's column block of the width ``ni``."""
    for t in range(WAVE_TILES, 1, -1):
        if ni % (n * t) == 0:
            return t
    raise AssertionError(f"no wave tiling of 2 to {WAVE_TILES} splits "
                         f"{ni} columns over {n} ranks")


def exchange_comp(ex, wire, sched, slots):
    return dict(exchange=ex, wire=wire, schedule=sched, ring_slots=slots)


def vdi_gap(a, b):
    """(largest colour difference, largest live-depth difference, same
    live slots, share of pixels whose live slot count differs, bit for
    bit) of two VDIs."""
    import torch

    la, lb = torch.isfinite(a.depth), torch.isfinite(b.depth)
    both = la & lb
    dc = float((a.color - b.color).abs().max())
    dd = float((a.depth[both] - b.depth[both]).abs().max()) \
        if bool(both.any()) else 0.0
    ca, cb = la[:, 0].sum(0), lb[:, 0].sum(0)
    share = float((ca != cb).float().mean())
    exact = torch.equal(a.color, b.color) and torch.equal(a.depth, b.depth)
    return dc, dd, torch.equal(la, lb), share, exact


def vdi_close(a, b, rtol, atol) -> bool:
    """``tests/test_torch_pipeline.assert_vdi_close``'s bar: colours
    close, the same slots live, live depths close."""
    import torch

    live = torch.isfinite(b.depth)
    return (torch.allclose(a.color, b.color, rtol=rtol, atol=atol)
            and torch.equal(torch.isfinite(a.depth), live)
            and torch.allclose(a.depth[live], b.depth[live], rtol=rtol,
                               atol=atol))


def thr_gap(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def k4_streams_ms(prefix, streams):
    """One frame's K4 launches on the streams it resegments, back to
    back behind a device sleep (the stream kept full), beside their
    bounds summed. Returns (ms, bound_ms, bound_by)."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_composite as cc

    def run(_):
        for sc, sd in streams:
            cc.resegment_sorted(sc, sd, None, K_OUT,
                                adaptive_iters=COMP_ITERS)

    def setup():
        torch.cuda.synchronize()
        lead()

    ms = median_ms(run, 5, setup)
    works = [k4_bound(sc, COMP_ITERS) for sc, _ in streams]
    b = sum(w[0][0] for w in works)
    by = "bytes" if sum(w[0][1] == "bytes" for w in works) * 2 >= \
        len(works) else "operations"
    nbytes = sum(w[2] for w in works)
    nk, _, h, w = streams[0][0].shape
    log(f"{prefix}.k4_frame_ms", f"{ms:.4f} bound_ms={b:.4f} ({by}) "
        f"launches={len(streams)} stream={nk}x{h}x{w} achieved_gb_s="
        f"{nbytes / ms / 1e6:.1f}; a frame's K4 launches on their own "
        f"streams, the stream kept full")
    return ms, b, by


def check_k4_on(prefix, streams):
    """K4 against its plain version on the fullest of ``streams``
    (thresholds and live slots exact, colour and depth within 1e-6)."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_composite as cc

    j = max(range(len(streams)), key=lambda i: int(
        torch.isfinite(streams[i][1][:, 0]).sum()))
    sc, sd = streams[j]
    h, w = sc.shape[2:]
    tp = torch.empty((h, w), device=sc.device)
    want = cc.resegment_sorted_plain(sc, sd, None, K_OUT,
                                     adaptive_iters=COMP_ITERS,
                                     threshold_out=tp) + (tp,)
    log_live_slots(prefix, sc)
    return check_k4(prefix, cc.resegment_sorted, sc, sd, want)


def exchange_parts(prefix, dp, colors, depths, ccfg):
    """The exchange and composite of the frame's fragments under
    ``ccfg``, each part timed apart (median ms): the all_to_all's
    encode, exchange, decode and composite (sort + K4); the ring's sort
    and encode, the decodes alone, the merges (decodes included) and the
    resegment (K4). Returns (parts, the streams K4 resegments)."""
    from scenery_insitu_tpu_torch.ops import wire as wire_mod
    from scenery_insitu_tpu_torch.ops.composite import (composite_vdis,
                                                        resegment_stream,
                                                        sort_stream)

    n, wire = RANKS, ccfg.wire
    parts = {}
    if ccfg.exchange == "ring":
        cap = dp._ring_cap(ccfg, K)
        parts["sort_encode_ms"] = median_ms(
            lambda _: dp._ring_blocks(colors, depths, n, wire), 3)
        blocks = dp._ring_blocks(colors, depths, n, wire)
        parts["decode_ms"] = median_ms(lambda _: [
            wire_mod.decode_fragment(bc[r], bd[r], sc, wire)
            for bc, bd, sc in blocks for r in range(n)], 3)
        parts["merge_ms"] = median_ms(lambda _: [
            dp._ring_accumulate(blocks, r, wire, cap) for r in range(n)], 3)
        streams = [dp._ring_accumulate(blocks, r, wire, cap)
                   for r in range(n)]
        del blocks
        parts["resegment_ms"] = median_ms(lambda _: [
            resegment_stream(sc, sd, ccfg) for sc, sd in streams], 3)
    else:
        ec, ed, scales = colors, depths, None
        if wire != "f32":
            parts["encode_ms"] = median_ms(
                lambda _: dp._encode_ranks(colors, depths, wire), 5)
            ec, ed, scales = dp._encode_ranks(colors, depths, wire)
        parts["exchange_ms"] = median_ms(lambda _: (
            dp._exchange_columns(ec, n), dp._exchange_columns(ed, n)), 5)
        rc, rd = dp._exchange_columns(ec, n), dp._exchange_columns(ed, n)
        del ec, ed
        if wire != "f32":
            parts["decode_ms"] = median_ms(lambda _: wire_mod.decode_fragment(
                rc, rd, scales[None] if scales is not None else None,
                wire), 5)
            rc, rd = wire_mod.decode_fragment(
                rc, rd, scales[None] if scales is not None else None, wire)
        parts["composite_ms"] = median_ms(lambda _: [
            composite_vdis(rc[j], rd[j], ccfg) for j in range(n)], 3)
        _, _, k, _, h, w = rc.shape
        streams = [sort_stream(rc[j].reshape(n * k, 4, h, w),
                               rd[j].reshape(n * k, 2, h, w))
                   for j in range(n)]
        del rc, rd
    log(f"{prefix}.parts_ms", " ".join(f"{k}={v:.3f}"
                                       for k, v in parts.items()))
    return parts, streams


def wave_parts(prefix, dp, slabs, halo, origin, spacing, cam, spec, tf,
               vcfg, ccfg, thr):
    """The wave schedule's frame on the final state, its parts timed
    apart: the frame state (each rank's camera, permuted copy and
    occupancy gate), the T waves' marches, and the T waves' exchange
    and composite. Returns (parts, the streams of the frame's K4
    launches)."""
    from scenery_insitu_tpu_torch.ops.composite import sort_stream

    n, t = RANKS, ccfg.wave_tiles
    parts = {}
    parts["frame_state_ms"] = median_ms(lambda _: [
        dp._RankFrame(slabs, halo, r, origin, spacing, cam, spec, tf)
        for r in range(n)], 3)
    frames = [dp._RankFrame(slabs, halo, r, origin, spacing, cam, spec, tf)
              for r in range(n)]
    thr_full = [dp._rank_thr(thr, r, spec.nj) for r in range(n)]

    def march(_):
        return [dp._march_wave(frames, w, n, t, cam, spec, tf, vcfg,
                               list(thr_full)) for w in range(t)]

    parts["march_ms"] = median_ms(march, 3)
    frags = march(None)
    parts["compose_ms"] = median_ms(lambda _: [
        dp._composite_exchanged(c, d, n, ccfg) for c, d in frags], 3)
    streams = []
    for c, d in frags:
        if ccfg.exchange == "ring":
            blocks = dp._ring_blocks(c, d, n, ccfg.wire)
            streams += [dp._ring_accumulate(blocks, r, ccfg.wire,
                                            dp._ring_cap(ccfg, K))
                        for r in range(n)]
        else:
            rc, rd = dp._exchange_vdi_columns(c, d, n, ccfg.wire)
            _, _, k, _, h, w = rc.shape
            streams += [sort_stream(rc[j].reshape(n * k, 4, h, w),
                                    rd[j].reshape(n * k, 2, h, w))
                        for j in range(n)]
    log(f"{prefix}.parts_ms", " ".join(f"{k}={v:.3f}"
                                       for k, v in parts.items()) +
        f" (every rank, all {t} waves)")
    return parts, streams


def run_exchange_frames(dev, ref0, profile=False):
    """Phase 8 (a): each exchange configuration driven as phase 4 drives
    its frame, from the same seeded state, eye and seed threshold, with
    K4's launches counted; its parts timed apart on the final state; K4
    on the ring's and the waves' streams; the gates against
    configuration 0 (``ref0``, phase 4's last frame)."""
    import torch

    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import cuda_composite as cc
    from scenery_insitu_tpu_torch.ops.composite import (
        modeled_exchange_traffic)
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    frames = WARMUP_FRAMES + TIMED_FRAMES
    a = cc.attributes(2 * K, K_OUT, COMP_ITERS)
    log("exchange.resegment.build", f"nk={2 * K} k_out={K_OUT} iters="
        f"{COMP_ITERS} " + " ".join(f"{n}={v}" for n, v in a.items()) +
        " (the capped ring's stream)")
    runs, images, res = {C0: ref0}, {}, {}
    images[C0] = render_vdi_same_view(ref0["vdi"])
    for name, ex, wire, sched, slots in EXCHANGE_CONFIGS:
        comp = exchange_comp(ex, wire, sched, slots)
        mesh, spec, tf, (vcfg, ccfg), seed, step, camera = dist_steps(
            dev, RANKS, GRID, BASE_EYE, **comp)
        t = ccfg.wave_tiles if sched == "waves" else 1
        prefix = f"exchange_{name}"
        log(f"{prefix}.config", f"exchange={ex} wire={wire} schedule="
            f"{sched} ring_slots={slots} wave_tiles={t} ni={spec.ni} "
            f"nj={spec.nj} ranks={RANKS} column_block={spec.ni // RANKS} "
            f"wave_block={spec.ni // (RANKS * t)}")
        traffic = modeled_exchange_traffic(
            RANKS, K, spec.nj, spec.ni, k_out=K_OUT, mode=ex,
            ring_slots=slots, wire=wire, schedule=sched, wave_tiles=t)
        log(f"{prefix}.modeled_traffic", json.dumps(traffic) + " (a model: "
            "the in-process ranks move no bytes across a link)")
        st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
        box = Volume.centered(st.v, extent=2.0)
        run = drive_dist_frames(prefix, step, seed, mesh, camera, st,
                                box.origin, box.spacing)
        require_launched(run["launches"], DIST_KERNELS, prefix)
        k4 = run["launches"]["resegment_sorted"]
        if k4 != RANKS * t * frames:
            raise AssertionError(f"{prefix}: K4 launched {k4} times in "
                                 f"{frames} frames; expected "
                                 f"{RANKS * t * frames}")
        check_vdi(prefix, run["vdi"], (K_OUT, 4, spec.nj, spec.ni),
                  (K_OUT, 2, spec.nj, spec.ni))
        if profile:
            state = [run["u"], run["v"], run["thr"]]

            def one(i, frame=run["frame"], state=state):
                _, _, state[0], state[1], state[2] = frame(*state, i)

            profile_frames(f"{prefix}.profile", one)
        runs[name] = run
        images[name] = render_vdi_same_view(run["vdi"])
        res[name] = dict(ms=run["ms"], wall_ms=run["wall_ms"], k4=k4,
                         k4_per_frame=RANKS * t, wave_tiles=t,
                         traffic=traffic)
        del step, seed
        torch.cuda.empty_cache()

    # the gates, each against configuration 0 at the same frame
    r0 = runs[C0]
    for name, ex, wire, sched, slots in EXCHANGE_CONFIGS:
        run, prefix = runs[name], f"exchange_{name}"
        dc, dd, same, share, exact = vdi_gap(run["vdi"], r0["vdi"])
        log(f"{prefix}.vs_c0", f"colour_max_diff={dc:.3e} depth_max_diff="
            f"{dd:.3e} same_live_slots={same} pixels_live_count_differs="
            f"{share:.6f} bit_exact={exact} threshold_max_diff="
            f"{thr_gap(run['thr'], r0['thr']):.3e} psnr_db="
            f"{image_psnr(images[name], images[C0]):.2f}")
        if name == "c1_ring":
            err = max(max_abs(run["vdi"].color, r0["vdi"].color),
                      max_abs(run["vdi"].depth, r0["vdi"].depth))
            check(f"{prefix}.lossless_vs_c0", err, 1e-6)
        if name == "c2_ring_cap":
            q = image_psnr(images[name], images["c1_ring"])
            log(f"{prefix}.psnr_vs_lossless_ring_db", f"{q:.2f} (gate "
                f"{CAP_PSNR_DB})")
            if not q >= CAP_PSNR_DB:
                raise AssertionError(f"{prefix}: {q:.2f} dB from the "
                                     f"lossless ring")
        if wire != "f32" and sched == "frame":
            q = image_psnr(images[name], images[C0])
            log(f"{prefix}.psnr_vs_f32_db", f"{q:.2f} (gate "
                f"{WIRE_PSNR_DB}; bitwise f32: "
                f"{torch.equal(images[name], images[C0])})")
            if not q >= WIRE_PSNR_DB or torch.equal(images[name],
                                                    images[C0]):
                raise AssertionError(f"{prefix}: the lossy wire is "
                                     f"{q:.2f} dB from f32 or equals it")
            check(f"{prefix}.threshold_vs_f32",
                  thr_gap(run["thr"], r0["thr"]), 1e-6)
        if sched == "waves":
            twin = runs[WAVE_TWINS[name]]
            dc, dd, same, share, exact = vdi_gap(run["vdi"], twin["vdi"])
            log(f"{prefix}.vs_frame_twin", f"twin={WAVE_TWINS[name]} "
                f"colour_max_diff={dc:.3e} depth_max_diff={dd:.3e} "
                f"same_live_slots={same} pixels_live_count_differs="
                f"{share:.6f} bit_exact={exact}")
            if wire == "f32":
                if not vdi_close(run["vdi"], twin["vdi"], 1e-4, 1e-5):
                    raise AssertionError(f"{prefix}: the waves' VDI "
                                         f"differs from its frame twin")
            else:
                # qpack8 scales each fragment by its own [near, far]: a
                # wave's fragment holds a quarter of the columns, so its
                # codes are not the frame's; the image is held instead
                q = image_psnr(images[name], images[WAVE_TWINS[name]])
                log(f"{prefix}.psnr_vs_frame_twin_db", f"{q:.2f} (gate "
                    f"{WIRE_PSNR_DB}: the wave's own depth scale)")
                if not q >= WIRE_PSNR_DB:
                    raise AssertionError(f"{prefix}: {q:.2f} dB from its "
                                         f"frame twin")
            check(f"{prefix}.threshold_vs_frame_twin",
                  thr_gap(run["thr"], twin["thr"]), 1e-6)
            for f, x, y in zip(run["meta"]._fields, run["meta"],
                               twin["meta"]):
                if not torch.equal(torch.as_tensor(x), torch.as_tensor(y)):
                    raise AssertionError(f"{prefix}: meta {f} differs from "
                                         f"its frame twin's")

    # the parts, timed apart on configuration 0's final state and eye
    mesh, spec, tf, (vcfg, _), _, _, camera = dist_steps(
        dev, RANKS, GRID, BASE_EYE)
    box = Volume.centered(r0["v"], extent=2.0)
    origin, spacing = box.origin, box.spacing
    slabs = shard_volume(r0["v"], mesh)
    halo = dp._halo_for(slabs, spec)
    cam = camera(frames)
    frags = rank_fragments(dp, slabs, halo, origin, spacing, cam, spec, tf,
                           vcfg, r0["thr"])
    colors = torch.stack([f.color for f in frags])
    depths = torch.stack([f.depth for f in frags])
    del frags
    for name, ex, wire, sched, slots in ((C0, "all_to_all", "f32", "frame",
                                          0),) + EXCHANGE_CONFIGS:
        prefix = f"exchange_{name}"
        _, _, _, (_, ccfg), _, _, _ = dist_steps(
            dev, RANKS, GRID, BASE_EYE, **exchange_comp(ex, wire, sched,
                                                         slots))
        if sched == "waves":
            parts, streams = wave_parts(prefix, dp, slabs, halo, origin,
                                        spacing, cam, spec, tf, vcfg, ccfg,
                                        r0["thr"])
        else:
            parts, streams = exchange_parts(prefix, dp, colors, depths,
                                            ccfg)
        ms, b, by = k4_streams_ms(prefix, streams)
        res.setdefault(name, dict(ms=r0["ms"], wall_ms=r0["wall_ms"]))
        res[name].update(parts=parts, k4_frame_ms=ms, k4_frame_bound_ms=b,
                         k4_frame_bound_by=by,
                         k4_stream=list(streams[0][0].shape))
        if name in ("c2_ring_cap", "c7_ring_waves"):
            res[name]["k4_err"] = check_k4_on(f"{prefix}.resegment",
                                              streams)
        if name == "c6_a2a_waves":
            nk, _, h, w = streams[0][0].shape
            threads = cc.attributes(nk, K_OUT, COMP_ITERS)["threads"]
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            log(f"{prefix}.k4_launch", f"{h}x{w} pixels a wave block: "
                f"{-(-h * w // threads)} blocks of {threads} threads on "
                f"{sms} SMs")
        del streams
        torch.cuda.empty_cache()
    del colors, depths
    for name in [C0] + [c[0] for c in EXCHANGE_CONFIGS]:
        r = res[name]
        log(f"exchange_{name}.summary", f"ms_per_frame={r['ms']:.3f} "
            f"(phase 4: {r0['ms']:.3f}) k4_frame_ms={r['k4_frame_ms']:.4f} "
            f"k4_frame_bound_ms={r['k4_frame_bound_ms']:.4f}")
    return res


def check_small_exchange(dev):
    """Phase 8 (b): every exchange configuration on the card against the
    CPU's plain versions on a 32^3 Gray-Scott volume over 4 ranks, in
    both march regimes, seed + 3 temporal frames from the same inputs:
    the lossless ones at phase 4's bar, the lossy wires' images at
    60 dB, every threshold map within 1e-6."""
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    n = 32
    v0 = gs.multi_step(gs.GrayScott.init((n,) * 3, seed=SEED, device="cpu"),
                       2 * SIM_STEPS).v
    box = Volume.centered(v0, extent=2.0)
    for regime, eye in (("z", BASE_EYE), ("x", (3.0, 0.6, 0.4))):
        for name, ex, wire, sched, slots in EXCHANGE_CONFIGS:
            outs = {}
            for dname, d in (("cuda", dev), ("cpu", "cpu")):
                mesh, spec, _, (_, ccfg), seed, step, camera = dist_steps(
                    d, SMALL_RANKS, n, eye, fold="pallas_seg", mm="f32",
                    **exchange_comp(ex, wire, sched, slots))
                data = shard_volume(v0.to(d), mesh)
                origin, spacing = box.origin.to(d), box.spacing.to(d)
                thr = seed(data, origin, spacing, camera(-1))
                imgs = []
                for i in range(3):
                    (vdi, _), thr = step(data, origin, spacing, camera(i),
                                         thr)
                    imgs.append(render_vdi_same_view(vdi).cpu())
                outs[dname] = (imgs, [x.cpu() for x in thr])
            prefix = f"small_exchange_{regime}_{name}"
            diff = max(float((a - b).abs().max()) for a, b in
                       zip(*(outs[k][0] for k in ("cuda", "cpu"))))
            mean = max(float((a - b).abs().mean()) for a, b in
                       zip(*(outs[k][0] for k in ("cuda", "cpu"))))
            psnr = min(image_psnr(a, b) for a, b in
                       zip(*(outs[k][0] for k in ("cuda", "cpu"))))
            tdiff = thr_gap(outs["cuda"][1], outs["cpu"][1])
            log(prefix, f"wave_tiles={ccfg.wave_tiles if sched == 'waves' else 1}"
                f" image_max_abs_diff={diff:.3e} image_mean_abs_diff="
                f"{mean:.3e} psnr_db={psnr:.2f} threshold_max_abs_diff="
                f"{tdiff:.3e}")
            if wire == "f32":
                ok = diff <= 1e-4 and mean <= 1e-4
            else:
                ok = psnr >= SMALL_WIRE_PSNR_DB
            if not (ok and tdiff <= 1e-6):
                raise AssertionError(f"{prefix}: the card's frame differs "
                                     f"from the CPU's plain versions")


def tile_order_sink(events):
    """A tile sink that logs each tile's (frame, tile, col0, tiles) and
    keeps the payload's views."""
    def sink(index, payload):
        events.append(("tile", index, payload["tile"], payload["col0"],
                       payload["tiles"], payload["vdi_color"],
                       payload["vdi_depth"]))
    return sink


def check_tiles(prefix, events, frames, tiles_total):
    """Every frame's tiles in ascending column order, each before the
    frame's sinks, side by side the frame's payload bit for bit."""
    import numpy as np

    for f in sorted(frames):
        tiles = [e for e in events if e[0] == "tile" and e[1] == f]
        wb = frames[f]["vdi_color"].shape[-1] // tiles_total
        if [t[2] for t in tiles] != list(range(tiles_total)) or \
                [t[3] for t in tiles] != [i * wb for i in range(tiles_total)] \
                or any(t[4] != tiles_total for t in tiles):
            raise AssertionError(f"{prefix}: frame {f}'s tiles arrived as "
                                 f"{[t[2:5] for t in tiles]}")
        fi = events.index(("frame", f))
        if not all(events.index(t) < fi for t in tiles):
            raise AssertionError(f"{prefix}: a tile of frame {f} came after "
                                 f"the frame's sinks")
        for k, key in ((5, "vdi_color"), (6, "vdi_depth")):
            if not np.array_equal(np.concatenate([t[k] for t in tiles], -1),
                                  frames[f][key]):
                raise AssertionError(f"{prefix}: frame {f}'s tiles side by "
                                     f"side differ from its {key}")
    log(f"{prefix}.tiles", f"frames {sorted(frames)}: {tiles_total} tiles "
        f"each in ascending column order before the frame's sinks, side "
        f"by side the frame bit for bit")


def run_session_waves(dev, ring_waves_ms):
    """Phase 8 (c), phase 7's session extended: the 512^3 session over 8
    ranks with the ring exchange in tile waves. (1) A warm frame and
    WAVE_SESSION_FRAMES timed frames with a tile sink, the launch counts
    set to 0 before and read after (K3, K2, K1 and K4 must launch, K4
    8·T a frame), every frame's tiles checked; (2) the same session with
    ``delivery.enabled`` and a ``vdi_tile_sink`` every
    WAVE_SESSION_EVERY frames: the tiles checked, the frames equal to
    (1)'s bit for bit, and the dumped tiles side by side equal to the
    frame. Returns the launch counts of (1)."""
    import shutil
    import tempfile

    import numpy as np

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.io.vdi_io import dump_path, load_vdi_tile
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.runtime.session import vdi_tile_sink

    base = session_config(GRID, ranks=RANKS)
    cam0 = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    spec = slicer.make_spec(cam0, (GRID,) * 3, base.slicer,
                            multiple_of=RANKS)
    t = wave_tiles_for(spec.ni, RANKS)
    cfg = base.with_overrides("composite.exchange=ring",
                              "composite.schedule=waves",
                              f"composite.wave_tiles={t}")
    tiles_total = RANKS * t
    log("session_waves.config", f"grid={GRID}^3 ranks={RANKS} ni={spec.ni} "
        f"wave_tiles={t} tiles={tiles_total} tile_cols="
        f"{spec.ni // tiles_total} exchange=ring")
    out = tempfile.mkdtemp(prefix="chip_smoke_waves_")
    try:
        events, frames = [], {}
        sess = session(dev, cfg, [lambda i, p: events.append(("frame", i)),
                                  capture_into(frames)])
        sess.tile_sinks.append(tile_order_sink(events))
        kernels.reset_launches()
        sess.run(SESSION_WARM)
        before = phase_stats(sess.timers)
        ms, _ = timed_run(sess, WAVE_SESSION_FRAMES)
        launches = kernels.launches()
        log("session_waves.launches", json.dumps(launches))
        require_launched(launches, DIST_KERNELS, "the tile-wave session")
        n_frames = SESSION_WARM + WAVE_SESSION_FRAMES
        if launches["resegment_sorted"] != tiles_total * n_frames:
            raise AssertionError(
                f"session_waves: K4 launched {launches['resegment_sorted']}"
                f" times in {n_frames} frames of {tiles_total} tiles")
        p3_ev, _ = FRAME_MS["frame"]
        log("session_waves.ms_per_frame", f"{ms:.3f} (host clock, mean of "
            f"{WAVE_SESSION_FRAMES} frames with a tile sink; phase 8 (a)'s "
            f"configuration 7, the ring in waves without the session: "
            f"{ring_waves_ms:.3f} CUDA events, with {COMP_ITERS} composite "
            f"search steps against the session's 2; phase 3's one-card "
            f"frame {p3_ev:.3f})")
        log_phase_stats("session_waves", sess.timers, before)
        check_tiles("session_waves", events, frames, tiles_total)
        if sess.obs.counters.get("tiles_delivered", 0) != \
                tiles_total * n_frames:
            raise AssertionError("session_waves: tiles_delivered "
                                 f"{sess.obs.counters.get('tiles_delivered')}")
        del sess

        events2, frames2 = [], {}
        sess = session(dev, cfg.with_overrides("delivery.enabled=true"),
                       [lambda i, p: events2.append(("frame", i)),
                        capture_into(frames2)])
        sess.tile_sinks += [tile_order_sink(events2),
                            vdi_tile_sink(out, every=WAVE_SESSION_EVERY)]
        sess.run(3)
        del sess
        check_tiles("session_waves_delivery", events2, frames2, tiles_total)
        check_frames_equal("session_waves_delivery", frames2,
                           {i: frames[i] for i in frames2})
        for f in range(0, 3, WAVE_SESSION_EVERY):
            parts = []
            for k in range(tiles_total):
                vdi, _, place = load_vdi_tile(dump_path(
                    out, "session", f, f"vditile{k:02d}"))
                parts.append((place, vdi))
            if [p[0][:2] for p in parts] != [(k, tiles_total)
                                             for k in range(tiles_total)]:
                raise AssertionError(f"session_waves: tile placements "
                                     f"{[p[0] for p in parts]}")
            for key, attr in (("vdi_color", "color"), ("vdi_depth",
                                                       "depth")):
                whole = np.concatenate([getattr(p[1], attr) for p in parts],
                                       -1)
                if not np.array_equal(whole, frames[f][key]):
                    raise AssertionError(f"session_waves: frame {f}'s "
                                         f"dumped tiles differ from {key}")
        log("session_waves.tile_dumps", f"frames "
            f"{list(range(0, 3, WAVE_SESSION_EVERY))}: {tiles_total} "
            f"vdi_tile_sink artifacts each, side by side the frame bit "
            f"for bit")
        return launches
    finally:
        shutil.rmtree(out, ignore_errors=True)


# ------------------------------------------------------------- phase 5


def check_stencil_ranges(dev, g):
    """B4b against K3 and its plain version: the 512^3 state ``g`` with
    the default bricks (16 x 32 x 512 cells) at T=4 and T=2, and ragged
    grids whose brick edges fall inside K3's xy tiles and z segments,
    one with v partly negative. Its u', v' must equal K3's bit for bit,
    its ranges ``field_ranges`` of its own v' and its plain version's
    exactly. Times B4b against K3 at T=4 and T=2 (the frame's last pass,
    the one that carries the epilogue) on the 512^3 state, and logs its
    builds."""
    import torch

    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.sim import cuda_stencil as cst
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    p = g.params.vector()
    cases = [(f"{GRID}", g.u, g.v, occ.default_bricks(tuple(g.v.shape)),
              (4, 2))]
    for shape, bricks, shift in (((24, 24, 24), None, 0.0),
                                 ((36, 60, 50), (12, 5), -0.1),
                                 ((260, 70, 100), (26, 7), 0.0)):
        st = gs.GrayScott.init(shape, seed=SEED, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        u = (st.u - 0.05 * torch.rand(shape, generator=gen, device=dev))
        v = (st.v + shift + 0.05 * torch.rand(shape, generator=gen,
                                              device=dev))
        bricks = bricks or occ.default_bricks(shape)
        cases.append(("x".join(map(str, shape)), u.contiguous(),
                      v.contiguous(), bricks, (4, 3)))
    err = 0.0
    for name, u, v, bricks, ts in cases:
        for t in ts:
            ur, vr, lo, hi = cst.step_fused_ranges(u, v, p, t, bricks)
            uk, vk = cst.step_fused(u, v, p, t)
            _, _, lp, hp = cst.step_fused_ranges_plain(u, v, p, t, bricks)
            own = occ.field_ranges(vr, *bricks)
            torch.cuda.synchronize()
            tag = f"stencil_ranges_{name}_T{t}"
            if not (torch.equal(ur, uk) and torch.equal(vr, vk)):
                raise AssertionError(f"{tag}: u', v' differ from K3's")
            if not (torch.equal(lo, own.lo) and torch.equal(hi, own.hi)):
                raise AssertionError(f"{tag}: ranges differ from "
                                     f"field_ranges of the kernel's v'")
            e = max(max_abs(lo, lp), max_abs(hi, hp))
            log(f"{tag}.bricks", f"{bricks} lo in [{float(lo.min()):.4f}, "
                f"{float(lo.max()):.4f}], hi in [{float(hi.min()):.4f}, "
                f"{float(hi.max()):.4f}]; u', v' equal K3's bit for bit")
            check(tag, e, 0.0)
            err = max(err, e)
    log_stencil_builds("stencil_ranges", ranges=True)
    u, v, bricks = g.u, g.v, cases[0][3]
    cells = u.numel()
    out = {}
    for t in (4, 2):
        # in turns, B4b, K3, K3, B4b, each with the stream kept full
        b4b = lambda: cst.step_fused_ranges(u, v, p, t, bricks)
        k3 = lambda: cst.step_fused(u, v, p, t)
        turns = [stream_ms(f) for f in (b4b, k3, k3, b4b)]
        ms, k3_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        one = median_ms(lambda _: b4b(), 10)
        pms = median_ms(lambda _: cst.step_fused_ranges_plain(
            u, v, p, t, bricks), 3)
        # K3's bytes and operations, plus the ranges written and a compare
        # a cell for each of min and max
        b, by = bound_ms(4 * 4 * cells + 2 * 4 * bricks[0] * bricks[1],
                         (STENCIL_FLOPS_PER_CELL_STEP * t + 2) * cells)
        log(f"stencil_ranges_T{t}.ms", f"{ms:.4f} k3_ms={k3_ms:.4f} "
            f"plain_ms={pms:.4f} bound_ms={b:.4f} ({by}) bricks={bricks} "
            f"turns={'/'.join(f'{x:.4f}' for x in turns)} "
            f"one_launch_ms={one:.4f}")
        log(f"stencil_ranges_T{t}.achieved_gb_s",
            f"{4 * 4 * cells / ms / 1e6:.1f} (K3 {4 * 4 * cells / k3_ms / 1e6:.1f}"
            f"); B4b / K3 = {ms / k3_ms:.4f}")
        out[t] = dict(err=err, ms=ms, k3_ms=k3_ms, plain_ms=pms, bound_ms=b,
                      bound_by=by)
    return out


def run_occupancy_frames(dev, ref, profile=False):
    """The flagship frame under ``occupancy="pyramid"`` and ``"sim"``,
    through ``grayscott_vdi_frame_step`` as phase 3 runs it, the launch
    counts set to 0 before each run and read after it (B4b once a frame
    under "sim"). Then each mode's VDI against phase 3's chunk-skip frame
    at the same state, eye and threshold: PSNR at least OCC_PSNR_DB, the
    largest image difference and the share of pixels whose live slot
    count differs. Returns {mode: launches}."""
    import torch

    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.ops import slicer

    u, v, thr, ref_step = ref
    cfg = frame_config(dev)["vdi_cfg"]
    tf = for_dataset("gray_scott", device=dev)
    base = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    cam = Camera.create(orbit(base, yaw_of(0)).eye, fov_y_deg=50.0,
                        near=0.5, far=20.0, device=dev)
    vol = Volume.centered(v, extent=2.0)
    want, _, _, _ = slicer.generate_vdi_mxu_temporal(
        vol, tf, cam, ref_step.spec, thr, cfg)
    want_img = render_vdi_same_view(want)
    want_live = torch.isfinite(want.depth[:, 0]).sum(0)
    rng = occ.field_ranges(v, *occ.default_bricks(tuple(v.shape)))
    out = {}
    for mode in ("pyramid", "sim"):
        torch.cuda.empty_cache()
        launches, (_, _, _, step) = run_frame(
            dev, profile, prefix=f"occ_{mode}", occupancy=mode,
            kernel_names=SIM_OCC_KERNELS if mode == "sim" else FRAME_KERNELS,
            time_sim=mode == "sim")
        frames = WARMUP_FRAMES + TIMED_FRAMES
        if mode == "sim" and launches["grayscott_fused_ranges"] != frames:
            raise AssertionError(
                f"B4b launched {launches['grayscott_fused_ranges']} times "
                f"in {frames} frames")
        pyr = (occ.pyramid_from_ranges(rng, vol, tf, step.spec)
               if mode == "sim" else
               occ.pyramid_from_volume(vol, tf, step.spec))
        log(f"occ_{mode}.pyramid", f"vtiles={step.spec.vtiles} live cells "
            f"{float(pyr.live_fraction()):.4f}, live chunks "
            f"{int(pyr.chunks.sum())} of {pyr.chunks.numel()}")
        got, _, _, _ = slicer.generate_vdi_mxu_temporal(
            vol, tf, cam, step.spec, thr, cfg,
            occupancy=pyr if mode == "sim" else None)
        img = render_vdi_same_view(got)
        psnr = image_psnr(img, want_img)
        diff = float((img - want_img).abs().max())
        live = torch.isfinite(got.depth[:, 0]).sum(0)
        share = float((live != want_live).float().mean())
        log(f"occ_{mode}.psnr_vs_chunk_skip_db", f"{psnr:.2f} (gate >= "
            f"{OCC_PSNR_DB}; largest image difference {diff:.3e}; pixels "
            f"whose live slot count differs: {share:.6f})")
        if not psnr >= OCC_PSNR_DB:
            raise AssertionError(f"occupancy {mode}: image {psnr:.2f} dB "
                                 f"from the chunk-skip frame")
        out[mode] = launches
        del got
    return out


def run_bench_twin(dev):
    """One run of the benchmark twin at the flagship size with the
    sim-fused occupancy; its JSON line is logged as ``bench_twin``."""
    from scenery_insitu_tpu_torch import bench

    res = bench.run(dev, env={"SITPU_BENCH_GRID": str(GRID),
                         "SITPU_BENCH_SKIP": "sim",
                         "SITPU_BENCH_FRAMES": str(BENCH_FRAMES),
                         "SITPU_BENCH_REBALANCE": "occupancy"})
    log("bench_twin", json.dumps(res))
    if not (res["value"] > 0 and res["occupancy"]["mode"] == "sim"
            and sum(res["rebalance"]["plan"]) == GRID):
        raise AssertionError(f"bench twin: {res}")


# ------------------------------------------------------------- phase 6


def event_bound(rgba, closes):
    """B8's and B9's (bound ms, what bounds it, bytes): B7's without the
    count (each input read once, the state read and written once, the
    closing slots' rows written)."""
    c, _, h, w = rgba.shape
    hw = h * w
    nbytes = 4 * (c * 6 * hw + hw + 2 * 12 * hw + 6 * closes)
    return (*bound_ms(nbytes, (MACHINE_FLOPS_PER_PIXEL_SLICE - 3) * c * hw),
            nbytes)


def fold_events(fold, state, chunks, thr, k):
    """``chunks`` [(rgba, t0, t1)] through B8's or B9's ``fold`` (or its
    plain version) into ``state``, a ``((color, depth), small)`` pair."""
    for rgba, t0, t1 in chunks:
        fold(*state, rgba, t0, t1, thr, max_k=k)
    return state


def event_designs(specs):
    """{name: (B8, B9)}: this tree's wrappers under "" and, for each
    ``NAME=PATH`` of ``--events-compare`` (another design of
    ``csrc/fold_chunk.cu`` with the same C entries), the same wrappers
    served by that source's build."""
    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm

    return {"": (fm.events_fold_chunk, fm.scratch_fold_chunk),
            **compare_designs(specs, "fold_chunk", "fold_chunk_occupancy",
                              log_event_builds, "events_compare",
                              fm.events_fold_chunk, fm.scratch_fold_chunk)}


def log_event_builds(prefix=""):
    """Registers, local bytes, shared bytes a block, resident blocks an
    SM, threads a block and close events a thread holds of B7's build and
    of B8's and B9's at every timed (C, K), from ``cudaFuncGetAttributes``
    and the occupancy calculator."""
    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm

    builds = [("fold_chunk", "pallas", CHUNK, K)] + [
        (f"{name}_C{c}_K{k}", variant, c, k)
        for c, k in EVENT_TIMED
        for name, variant in (("events_fold_chunk", "events"),
                              ("scratch_fold_chunk", "scratch"))]
    for tag, variant, c, k in builds:
        a = fm.attributes(variant, c, k)
        log(f"{prefix}{tag}.build", " ".join(f"{n}={v}"
                                             for n, v in a.items()))


def check_event_case(tag, chunks, thr, k, base=None, designs=None):
    """B8 and B9 of each of ``designs`` (default: this tree's) over
    ``chunks`` from ``base`` (default: the initial state) against their
    plain versions and B7: slot counters exact, colour and depth within
    1e-6. Returns (largest difference, whether this tree's B8 and B9
    equal B7 bit for bit)."""
    import torch

    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    h, w = thr.shape
    if base is None:
        base = cm.init_packed(k, h, w, device=thr.device)
    designs = designs or {"": (fm.events_fold_chunk, fm.scratch_fold_chunk)}
    flat = lambda st: (*st[0], st[1])
    state = lambda: ((base[0].clone(), base[1].clone()), base[2].clone())
    b7 = clone(base)
    for rgba, t0, t1 in chunks:
        cm.fold_chunk(b7, rgba, t0, t1, thr, max_k=k)
    err, bitwise = 0.0, True
    for i, (name, plain) in enumerate((
            ("events_fold_chunk", fm.events_fold_chunk_plain),
            ("scratch_fold_chunk", fm.scratch_fold_chunk_plain))):
        want = flat(fold_events(plain, state(), chunks, thr, k))
        for design, folds in designs.items():
            case = f"{name}_{tag}" + (f"_{design}" if design else "")
            got = flat(fold_events(folds[i], state(), chunks, thr, k))
            torch.cuda.synchronize()
            for other, what in ((want, "its plain version"), (b7, "B7")):
                if not torch.equal(got[2][11], other[2][11]):
                    raise AssertionError(f"{case}: slot counters differ "
                                         f"from {what}")
            e = max(packed_err(got, want), packed_err(got, b7))
            check(case, e, 1e-6)
            if design:
                log(f"{case}.bit_for_bit_with_b7", packed_equal(got, b7))
            else:
                err = max(err, e)
                bitwise = bitwise and packed_equal(got, b7)
            del got
        del want
    log(f"events_{tag}.pixels_at_slot_cap",
        f"{float((b7[2][11] == k - 1).float().mean()):.4f}; B8 and B9 "
        f"{'equal' if bitwise else 'differ from'} B7 bit for bit")
    return err, bitwise


def event_folds(k, thr, rgba, t0, t1, designs):
    """{name: fold(flat state)} of one chunk: B7 (``fold_chunk``), then
    each design's B8 and B9 (``events_fold_chunk[_NAME]``, ...)."""
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    folds = {"fold_chunk": lambda s: cm.fold_chunk(s, rgba, t0, t1, thr,
                                                   max_k=k)}
    for design, pair in designs.items():
        for name, fold in zip(EVENT_KERNELS.values(), pair):
            folds[name + (f"_{design}" if design else "")] = \
                (lambda f: lambda s: f((s[0], s[1]), s[2], rgba, t0, t1, thr,
                                       max_k=k))(fold)
    return folds


def check_event_folds(dev, designs):
    """Phase 6 (a): B8 and B9 of each of ``designs`` against their plain
    versions and B7 on the frame's captured chunks (K = 16), on seeded
    streams at 320 x 320 and 640 x 640 (C = 16, K = 16, after one folded
    chunk), and a K = 4 stream that fills the slot cap; then B7, B8 and
    B9 timed at 640 x 640 at each (C, K) of EVENT_TIMED with the stream
    kept full (`fresh_ms`, the one launch beside it), against their bound
    and (at the first) their plain versions, each ``--events-compare``
    design in turns at the first; then a march (`event_march`). Logs
    every timed build (`log_event_builds`)."""
    import torch

    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    log_event_builds()
    g = gs_init(dev)
    cap = capture_chunks(dev, g.u, g.v, (0.0, 0.6, 3.0))
    del g
    length = cap["length"]
    frame = [(rgba, planes(sk0, length), planes(sk1, length))
             for rgba, sk0, sk1 in cap["chunks"]]
    err, bitwise = check_event_case("frame_chunks", frame, cap["thr"], K,
                                    designs=designs)
    del cap, frame
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    seeded = {}
    for side, k, n in EVENT_SEEDED:
        thr = (0.05 + 0.5 * torch.rand((side, side), generator=gen,
                                       device=dev))
        pre = seeded_stream(CHUNK, side, side, dev, 99)
        t = lambda i: torch.full((CHUNK, side, side), 0.0, device=dev) + \
            (0.1 * (i * CHUNK + 1 + torch.arange(
                CHUNK, device=dev, dtype=torch.float32)))[:, None, None]
        base = cm.init_packed(k, side, side, device=dev)
        cm.fold_chunk_plain(base, pre, t(0), t(0) + 0.1, thr, max_k=k)
        chunks = [(seeded_stream(CHUNK, side, side, dev, SEED + 10 + i),
                   t(i + 1), t(i + 1) + 0.1) for i in range(n)]
        e, same = check_event_case(f"seeded_{side}_K{k}", chunks, thr, k,
                                   base, designs)
        err, bitwise = max(err, e), bitwise and same
        seeded[(side, k)] = (chunks, thr, base)
    side = EVENT_SEEDED[-1][0]
    chunks, thr, base16 = seeded[(side, K)]
    res = {}
    for c, k in EVENT_TIMED:
        rgba, t0, t1 = chunks[0]
        rgba, t0, t1 = (x[:c] if c <= CHUNK else torch.cat([x, x])[:c]
                        for x in (rgba, t0, t1))
        rgba, t0, t1 = rgba.contiguous(), t0.contiguous(), t1.contiguous()
        base = base16 if k == K else seeded[(side, 4)][2]
        b7 = cm.fold_chunk(clone(base), rgba, t0, t1, thr, max_k=k)
        closes = float((b7[2][11] - base[2][11]).sum())
        del b7
        b, by, nbytes = event_bound(rgba, closes)
        first = (c, k) == EVENT_TIMED[0]
        folds = event_folds(k, thr, rgba, t0, t1, designs if first else
                            {"": designs[""]})
        for name, plain in (("fold_chunk", None),
                            ("events_fold_chunk", fm.events_fold_chunk_plain),
                            ("scratch_fold_chunk",
                             fm.scratch_fold_chunk_plain)):
            fold = folds[name]
            ms = fresh_ms(fold, base)
            one = median_ms(fold, 20, lambda: clone(base))
            pms = None
            if first and plain is not None:
                pms = median_ms(lambda s: plain((s[0], s[1]), s[2], rgba, t0,
                                                t1, thr, max_k=k), 3,
                                lambda: clone(base))
            log(f"{name}_C{c}_K{k}.ms", f"{ms:.4f} plain_ms="
                f"{pms if pms is None else round(pms, 4)} bound_ms={b:.4f} "
                f"({by}) one_launch_ms={one:.4f} (the host's wrapper time "
                f"included) closes_per_pixel="
                f"{closes / rgba[0, 0].numel():.3f}; stream kept full on "
                f"states cloned before the window")
            if not first:
                continue
            compare_ms = {}
            for design in designs:
                if design and name != "fold_chunk":
                    other = folds[f"{name}_{design}"]
                    turns = [fresh_ms(f, base)
                             for f in (fold, other, other, fold)]
                    log(f"{name}_C{c}_K{k}.vs_{design}",
                        in_turns(turns, nbytes, "new"))
                    compare_ms[design] = (turns[1] + turns[2]) / 2
            res[name] = dict(err=err, ms=ms, plain_ms=pms, bound_ms=b,
                             bound_by=by, one_launch_ms=one,
                             compare_ms=compare_ms)
    log("events.bit_for_bit_with_b7", bitwise)
    del seeded, chunks
    torch.cuda.empty_cache()
    for name, r in event_march(dev, designs).items():
        res[name]["compare_ms"].update(r.pop("compare_ms"))
        res[name].update(r, err=max(res[name]["err"], r["err"]))
    return res


def event_march(dev, designs):
    """B7, B8 and B9 over the microbenchmark's own stream: S = MARCH_S
    slices on its image (640 x 640), generated once (``stream_chunk``,
    S / C chunks of C = 16), K = 16, threshold 0.35. B8 and B9 against
    their plain versions and B7 over the march (`check_event_case`); the
    closes a pixel a chunk; each kernel's S / C launches back to back from
    the initial state behind `lead`, the median of 5; each
    ``--events-compare`` design in turns. The bound counts the bytes the
    march needs from HBM: every chunk's rgba, t0 and t1 read once, the
    threshold and the 12-float state read once, the state written once,
    and a 6-float row a close."""
    import torch

    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm
    from scenery_insitu_tpu_torch.ops import cuda_march as cm

    side = fm.image_side(MARCH_S)
    hw = side * side
    chunks = [fm.stream_chunk(ci, CHUNK, side, side, dev)
              for ci in range(MARCH_S // CHUNK)]
    thr = torch.full((side, side), fm.THRESHOLD, device=dev)
    err, _ = check_event_case("micro_march", chunks, thr, K,
                              designs=designs)
    st = cm.init_packed(K, side, side, device=dev)
    for rgba, t0, t1 in chunks:
        cm.fold_chunk(st, rgba, t0, t1, thr, max_k=K)
    closes = float(st[2][11].sum())
    del st
    nbytes = 4 * (MARCH_S * 6 * hw + hw + 2 * 12 * hw + 6 * closes)
    b, by = bound_ms(nbytes,
                     (MACHINE_FLOPS_PER_PIXEL_SLICE - 3) * MARCH_S * hw)
    log("events_march.closes", f"{closes / hw:.4f} a pixel, "
        f"{closes / hw / len(chunks):.4f} a pixel a chunk")
    log("events_march.bound_ms", f"{b:.4f} ({by}; {nbytes / hw:.1f} B a "
        f"pixel over {len(chunks)} chunks of {CHUNK} on {side}x{side})")

    def setup():
        s = cm.init_packed(K, side, side, device=dev)
        torch.cuda.synchronize()
        lead()
        return s

    def run(name):
        def march(s):
            for rgba, t0, t1 in chunks:
                event_folds(K, thr, rgba, t0, t1, designs)[name](s)
        return march

    res = {}
    for name in ("fold_chunk", *EVENT_KERNELS.values()):
        ms = median_ms(run(name), 5, setup)
        log(f"{name}_march.ms", f"{ms:.4f} bound_ms={b:.4f} "
            f"launches={len(chunks)}; the stream kept full, a fresh state "
            f"each time; achieved_gb_s={nbytes / ms / 1e6:.1f}")
        compare_ms = {}
        for design in designs:
            if design and name != "fold_chunk":
                turns = [median_ms(run(n), 5, setup) for n in
                         (name, f"{name}_{design}", f"{name}_{design}",
                          name)]
                log(f"{name}_march.vs_{design}", in_turns(turns, nbytes,
                                                          "new"))
                compare_ms[f"{design}_march"] = (turns[1] + turns[2]) / 2
        res[name] = dict(march_ms=ms, march_bound_ms=b, err=err,
                         compare_ms=compare_ms)
    return res


def run_microbench(dev):
    """Phase 6 (b): the fold microbenchmark twin with ``--check`` over
    every variant at each grid of MICRO_GRIDS (K = 16, C = 16), its rows
    logged as ``microbench_<grid>``; the launch counts set to 0 before
    the sweep and read after it. B8 and B9 must launch S/C times a march,
    and B1b (the ``pallas_seg`` and ``tf_pallas_seg`` variants) at
    least once.
    Returns (launches, {grid: rows})."""
    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.benchmarks import fold_microbench as fm

    rows = {}
    kernels.reset_launches()
    for grid in MICRO_GRIDS:
        rows[grid] = fm.sweep(
            fm.VARIANTS, grid, CHUNK, K, iters=MICRO_ITERS, check=True,
            device=dev,
            emit=lambda r, g=grid: log(f"microbench_{g}", json.dumps(r)))
    launches = kernels.launches()
    require_launched(launches, (*EVENT_KERNELS.values(), "seg_fold_planes"),
                     "the microbenchmark sweep")
    for variant, name in EVENT_KERNELS.items():
        want = 0
        for grid, rs in rows.items():
            r = next(x for x in rs if x["variant"] == variant)
            per_march = r["launches"].get(name, 0) / r["marches"]
            if per_march != grid // CHUNK:
                raise AssertionError(f"{variant} at S={grid}: {per_march} "
                                     f"launches a march, not "
                                     f"{grid // CHUNK}")
            want += r["launches"][name]
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, the "
                                 f"sweep's rows count {want}")
    log("microbench.launches", json.dumps(launches))
    return launches, rows


# ---------------------------------------------------------------- main

# ------------------------------------------------------------- phase 7


def session_config(grid, ranks=0, depth=1, fold="auto", mm="bf16"):
    """Phase 3's frame as a session configuration (``mm`` as in
    `frame_config`)."""
    from scenery_insitu_tpu_torch.config import FrameworkConfig

    return FrameworkConfig().with_overrides(
        f"sim.grid=[{grid},{grid},{grid}]",
        f"sim.steps_per_frame={SIM_STEPS}", "sim.fused_stencil=true",
        f"vdi.max_supersegments={K}", "vdi.adaptive_iters=2",
        "vdi.adaptive_mode=temporal", f"vdi.histogram_bins={BINS}",
        f"composite.max_output_supersegments={K}",
        "composite.adaptive_iters=2", "slicer.engine=mxu",
        f"slicer.chunk={CHUNK}", "slicer.scale=1.25", f"slicer.fold={fold}",
        f"slicer.matmul_dtype={mm}",
        f"mesh.num_devices={ranks}", f"runtime.pipeline_depth={depth}",
        "runtime.dataset=gray_scott")


def session(dev, cfg, sinks=()):
    """A session on ``cfg`` with phase 3's camera, orbiting."""
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.runtime.session import InSituSession

    cam = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                        device=dev)
    sess = InSituSession(cfg, camera=cam, sinks=sinks, device=dev)
    sess.orbit_rate = SESSION_ORBIT
    return sess


def capture_into(frames):
    def sink(index, payload):
        frames[index] = payload
    return sink


def check_frames_equal(name, got, want):
    """Payloads bit for bit (+inf slots included), frame by frame."""
    import numpy as np

    for i in sorted(want):
        for key in ("vdi_color", "vdi_depth"):
            if not np.array_equal(got[i][key], want[i][key]):
                n = int((got[i][key] != want[i][key]).sum())
                raise AssertionError(f"{name}: frame {i} {key} differs "
                                     f"at {n} values")
    log(f"{name}.bit_exact", f"frames {sorted(want)}")


def timed_sink(totals, name, sink):
    """``sink`` with its seconds added to ``totals[name]``."""
    def timed(index, payload):
        t0 = time.perf_counter()
        sink(index, payload)
        totals[name] += time.perf_counter() - t0
    return timed


def phase_stats(timers):
    return {k: (st.n, st.total) for k, st in timers.stats.items()}


def log_phase_stats(prefix, timers, before):
    """Mean ms of each timer phase over the frames since ``before``."""
    after = phase_stats(timers)
    for name in ("sim", "dispatch", "fetch", "sinks"):
        n1, t1 = after.get(name, (0, 0.0))
        n0, t0 = before.get(name, (0, 0.0))
        if n1 > n0:
            log(f"{prefix}.{name}_ms", f"{(t1 - t0) / (n1 - n0) * 1e3:.3f} "
                f"(mean of {n1 - n0})")


def timed_run(sess, frames):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = sess.run(frames)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / frames, last


def run_session(dev):
    """Phase 7 (a)-(e) at the flagship size; returns the launch counts of
    the loop's run."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.camera import orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.io.vdi_io import dump_path, load_vdi
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import make_mesh, shard_volume
    from scenery_insitu_tpu_torch.runtime.checkpoint import (
        checkpoint_sink, load_session, save_session)
    from scenery_insitu_tpu_torch.runtime.session import png_sink, vdi_sink
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    out = tempfile.mkdtemp(prefix="chip_smoke_session_")
    try:
        # (a) the loop with its sinks, each sink's time kept apart
        cfg = session_config(GRID)
        frames, sink_s = {}, collections.Counter()
        sess = session(dev, cfg)
        sess.sinks += [
            timed_sink(sink_s, "png", png_sink(out, every=SESSION_EVERY)),
            timed_sink(sink_s, "vdi", vdi_sink(out, every=SESSION_EVERY,
                                               workers=2)),
            timed_sink(sink_s, "checkpoint", checkpoint_sink(
                out, every=SESSION_EVERY).bind(sess)),
            capture_into(frames)]
        st0 = sess.sim.state
        u0, v0, cam0 = st0.u.clone(), st0.v.clone(), sess.camera
        log("session.config", f"grid={GRID}^3 ranks={sess._n_ranks} "
            f"spec={slicer.make_spec(cam0, (GRID,) * 3, cfg.slicer)} "
            f"orbit={SESSION_ORBIT} depth={cfg.runtime.pipeline_depth}")
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run(SESSION_WARM)
        torch.cuda.synchronize()
        log("session.warm_s", f"{time.perf_counter() - t0:.3f}")
        before = phase_stats(sess.timers)
        sink_s.clear()
        ms, _ = timed_run(sess, SESSION_TIMED)
        launches = kernels.launches()
        log("session.launches", json.dumps(launches))
        require_launched(launches, FRAME_KERNELS, "the session loop")
        p3_ev, p3_wall = FRAME_MS["frame"]
        SESSION_MS["session"] = ms
        log("session.ms_per_frame", f"{ms:.3f} (host clock, mean of "
            f"{SESSION_TIMED} frames with png, vdi and checkpoint sinks "
            f"every {SESSION_EVERY}; phase 3's frame: {p3_wall:.3f} host "
            f"clock, {p3_ev:.3f} CUDA events)")
        log_phase_stats("session", sess.timers, before)
        for name, sec in sorted(sink_s.items()):
            n = SESSION_TIMED // SESSION_EVERY
            log(f"session.sink_{name}_ms", f"{sec * 1e3 / n:.3f} (mean "
                f"of the {n} timed frames it wrote)")
        nj, ni = frames[0]["vdi_color"].shape[-2:]
        check_vdi("session", VDI(
            torch.from_numpy(frames[SESSION_TIMED]["vdi_color"]),
            torch.from_numpy(frames[SESSION_TIMED]["vdi_depth"])),
            (K, 4, nj, ni), (K, 2, nj, ni))
        del sess

        # the same frames without sinks: only each run's last is fetched
        sess = session(dev, cfg)
        sess.run(SESSION_WARM)
        before = phase_stats(sess.timers)
        ms, last = timed_run(sess, SESSION_TIMED)
        SESSION_MS["session_nosinks"] = ms
        log("session_nosinks.ms_per_frame", f"{ms:.3f} (host clock, mean "
            f"of {SESSION_TIMED} frames after a warm one, no sinks: the "
            f"last frame alone is copied to the host)")
        log_phase_stats("session_nosinks", sess.timers, before)
        check_frames_equal("session_nosinks", {last["frame"]: last},
                           {SESSION_TIMED: frames[SESSION_TIMED]})
        del sess, last

        # (b) the same two frames driven by hand
        mesh = make_mesh(1, device=dev)
        spec = slicer.make_spec(cam0, (GRID,) * 3, cfg.slicer,
                                axis_sign=slicer.choose_axis(cam0),
                                multiple_of=1)
        tf = for_dataset("gray_scott", device=dev)
        seed = dp.distributed_initial_threshold_mxu(mesh, tf, spec, cfg.vdi)
        step = dp.distributed_vdi_step_mxu_temporal(mesh, tf, spec, cfg.vdi,
                                                    cfg.composite)
        vox = 2.0 / GRID
        origin = torch.full((3,), -GRID * vox / 2, dtype=torch.float32,
                            device=dev)
        spacing = torch.full((3,), vox, dtype=torch.float32, device=dev)
        st = gs.GrayScott(u0, v0, st0.params)
        cam, thr, hand = cam0, None, {}
        for i in range(2):
            st = gs.multi_step_fast(st, SIM_STEPS)
            field = shard_volume(st.field, mesh)
            if thr is None:
                thr = seed(field, origin, spacing, cam)
            (vdi, _), thr = step(field, origin, spacing, cam, thr)
            hand[i] = {"vdi_color": vdi.color.cpu().numpy(),
                       "vdi_depth": vdi.depth.cpu().numpy()}
            cam = orbit(cam, np.float32(SESSION_ORBIT))
        del st, thr, vdi, field
        check_frames_equal("session_vs_hand", {i: frames[i] for i in hand},
                           hand)

        # (d) depth 2 against depth 1, then (c) its checkpoint resumed
        frames2 = {}
        sess = session(dev, session_config(GRID, depth=2),
                       [capture_into(frames2)])
        sess.run(4)
        check_frames_equal("session_depth2", frames2,
                           {i: frames[i] for i in range(4)})
        path = os.path.join(out, "after4.npz")
        save_session(sess, path)
        del sess
        frames3 = {}
        sess = session(dev, cfg, [capture_into(frames3)])
        sess.orbit_rate = 0.0          # the checkpoint restores it
        load_session(sess, path)
        if sess.frame_index != 4 or sess.orbit_rate != SESSION_ORBIT:
            raise AssertionError("session_resume: checkpoint header not "
                                 "restored")
        sess.run(4)
        check_frames_equal("session_resume", frames3,
                           {i: frames[i] for i in range(4, 8)})
        del sess
        ckpts = sorted(f for f in os.listdir(out) if f.startswith("ckpt_"))
        log("session.checkpoints", ckpts)
        frames4 = {}
        sess = session(dev, cfg, [capture_into(frames4)])
        load_session(sess, os.path.join(out, "ckpt_00006.npz"))
        sess.run(SESSION_WARM + SESSION_TIMED - 6)
        check_frames_equal("session_resume_sink", frames4,
                           {i: frames[i] for i in range(6, 9)})
        del sess

        # (e) the dumped artifacts
        dumped, _ = load_vdi(dump_path(out, "session", SESSION_EVERY,
                                       "vdi"))
        check_frames_equal("session_vdi_artifact", {SESSION_EVERY: {
            "vdi_color": dumped.color, "vdi_depth": dumped.depth}},
            {SESSION_EVERY: frames[SESSION_EVERY]})
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        for f in pngs:
            with open(os.path.join(out, f), "rb") as fh:
                if fh.read(8) != b"\x89PNG\r\n\x1a\n":
                    raise AssertionError(f"{f} is not a PNG")
        log("session.artifacts", f"{pngs} and "
            f"{sorted(f for f in os.listdir(out) if '_vdi_' in f)}")
        if len(pngs) != 3:
            raise AssertionError(f"expected 3 PNGs, got {pngs}")
        return launches
    finally:
        shutil.rmtree(out, ignore_errors=True)


def check_small_session(dev):
    """Phase 7 (f): a 4-rank 32^3 session on the card against the same
    session on the CPU; K4 once per rank and frame."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view

    n, frames = 32, 3
    imgs = {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        got = {}
        sess = session(d, session_config(n, ranks=SMALL_RANKS,
                                         fold="pallas_seg", mm="f32"),
                       [capture_into(got)])
        kernels.reset_launches()
        sess.run(frames)
        if name == "cuda":
            launches = kernels.launches()
            log("small_session.launches", json.dumps(launches))
            if launches["resegment_sorted"] != SMALL_RANKS * frames:
                raise AssertionError(
                    f"K4 launched {launches['resegment_sorted']} times in "
                    f"{frames} frames of {SMALL_RANKS} ranks")
        imgs[name] = torch.stack([render_vdi_same_view(VDI(
            torch.from_numpy(got[i]["vdi_color"]),
            torch.from_numpy(got[i]["vdi_depth"]))) for i in range(frames)])
    diff = (imgs["cuda"] - imgs["cpu"]).abs()
    log("small_session.image_max_abs_diff", f"{float(diff.max()):.3e}")
    log("small_session.image_mean_abs_diff", f"{float(diff.mean()):.3e}")
    if not (float(diff.max()) <= 1e-4 and float(diff.mean()) <= 1e-4):
        raise AssertionError("the card's 4-rank session differs from the "
                             "CPU's")
    return launches


# ------------------------------------------------------------- phase 9


# phase 9's configurations on phase 4's frame, in this order
DECOMP_NAMES = ("p1", "p2", "b1", "b2", "b3", "l1", "l2", "x1", "x2")
DECOMP_BRICKS = 32
FIXED_PLAN = (128, 64, 64, 64, 64, 32, 32, 64)   # the reference's PLAN x 16
DECOMP_PSNR_DB = 60.0
DECOMP_VDI_GATE = 1e-5
# phase 9 (b): 4 ranks at 32^3, 8 bricks (the level-2 brick needs 4
# slices), the fixed plan halved to 4 ranks
SMALL_BRICKS = 8
SMALL_PLAN = (12, 8, 4, 8)
# phase 9 (d): the 8-rank 512^3 session's frames and replan period
DECOMP_SESSION_FRAMES = 12
DECOMP_SESSION_PERIOD = 4


def interleaved_owner(nb, n):
    """Brick b to rank 3b mod n (4 slots a rank at 32 bricks, 8 ranks)."""
    return tuple(b * 3 % n for b in range(nb))


def empty_rank_owner(nb, n):
    """Runs of nb/n bricks to ranks 0 to n-2 in order, the last nb/n
    bricks to ranks 0, 1, ...: the last rank owns none (at 32 bricks on
    8 ranks, 5 slots a rank, a column block of 8 · 5 · K slots)."""
    per = nb // n
    return tuple(b // per if b < nb - per else b - (nb - per)
                 for b in range(nb))


def decomp_configs(profile, d, n, nb, fixed_plan, wave_tiles, log_prefix):
    """Phase 9's render decompositions of a ``d``-deep volume over ``n``
    ranks, from the z live ``profile`` of the state the frames start
    from: {name: (rebalance, plan, bricks, composite settings)}. p1 is
    the plan ``slice_plan`` gives (min depth 4, quantum 4), b1 the steal
    from the contiguous map of ``nb`` bricks (2 moves); b2 interleaves
    the bricks, b3 leaves the last rank none; l1 is b2 with level 2 on
    an empty brick (the lowest live fraction when none is empty), l2 b2
    with every brick at level 1; x1 and x2 are the fixed plan and b3
    under the ring in ``wave_tiles`` waves."""
    import numpy as np

    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.parallel import bricks as bk
    from scenery_insitu_tpu_torch.parallel import lod

    plan = occ.slice_plan(profile, d, n, min_depth=4, quantum=4)
    even = occ.even_plan(d, n)
    log(f"{log_prefix}.p1_plan", f"{list(plan)} histogram "
        f"{dict(collections.Counter(plan))} modeled_straggler even="
        f"{occ.straggler_factor(profile, d, even):.4f} planned="
        f"{occ.straggler_factor(profile, d, plan):.4f}" +
        (" (the even plan: the step takes the slab path)"
         if plan == even else ""))
    work = bk.brick_work(profile, d, nb)
    seed_map = bk.BrickMap.contiguous(d, n, nb)
    stolen = bk.steal_plan(seed_map, work, max_moves=2)
    log(f"{log_prefix}.b1_owners", f"{list(stolen.owner)} modeled_straggler "
        f"contiguous={bk.straggler_factor(seed_map, work):.4f} stolen="
        f"{bk.straggler_factor(stolen, work):.4f}" +
        (" (even-convex: the step takes the slab path)"
         if stolen.is_even_convex() else ""))
    inter = bk.BrickMap(d, n, interleaved_owner(nb, n))
    islands = bk.BrickMap(d, n, empty_rank_owner(nb, n))
    live = lod.per_brick(profile, nb, red="mean")
    empty = int(np.argmin(live))
    log(f"{log_prefix}.l1_brick", f"brick {empty} live_fraction "
        f"{live[empty]:.4f}" + ("" if live[empty] == 0 else
                                " (no brick is empty: l1's gate is "
                                "information)"))
    levels = [0] * nb
    levels[empty] = 2
    ring_waves = dict(exchange="ring", schedule="waves",
                      wave_tiles=wave_tiles)
    return {
        "p1": ("occupancy", plan, None, {}),
        "p2": ("occupancy", fixed_plan, None, {}),
        "b1": ("bricks", None, stolen, {}),
        "b2": ("bricks", None, inter, {}),
        "b3": ("bricks", None, islands, {}),
        "l1": ("bricks", None, inter.with_levels(levels), {}),
        "l2": ("bricks", None, inter.with_levels((1,) * nb), {}),
        "x1": ("occupancy", fixed_plan, None, ring_waves),
        "x2": ("bricks", None, islands, ring_waves),
    }, float(live[empty])


def decomp_modeled(profile, d, n, plan, bricks, ni, nj):
    """The modeled straggler factor (max/mean per-rank march work) of a
    decomposition, levels counted in their work units."""
    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.parallel import bricks as bk
    from scenery_insitu_tpu_torch.parallel import lod

    if bricks is None:
        return occ.straggler_factor(profile, d, plan or occ.even_plan(d, n))
    work = bk.brick_work(profile, d, bricks.nbricks)
    if bricks.max_level:
        work = work * lod.level_work_scale(bricks.level, (d, d, d), ni, nj)
    return bk.straggler_factor(bricks, work)


def decomp_parts(prefix, dp, slabs, origin, spacing, cam, spec, tf, vcfg,
                 ccfg, thr, plan, bricks):
    """A decomposition's frame parts on the final state, timed apart
    (median ms): the reslab (`_frame_rows`), each rank's march (the
    ranks run in turn on the card, so each is timed alone), the column
    exchange, the sort of each column block's M-slot stream, and K4 on
    the sorted streams (the stream kept full). Returns (parts, per-rank
    ms, the sorted streams)."""
    import torch

    from scenery_insitu_tpu_torch.ops.composite import sort_stream

    n = RANKS
    rows_a_rank = spec.nj * (bricks.total_slots if bricks else 1)
    parts = {"reslab_ms": median_ms(
        lambda _: dp._frame_rows(slabs, spec, plan, bricks), 5)}
    rows = dp._frame_rows(slabs, spec, plan, bricks)

    def march(r):
        return dp._mxu_rank_generate(
            slabs, rows, r, origin, spacing, cam, spec, tf, vcfg,
            dp._rank_thr(thr, r, rows_a_rank), plan, bricks)[0]

    rank_ms = [median_ms(lambda _, r=r: march(r), 3) for r in range(n)]
    frags = [march(r) for r in range(n)]
    del rows
    colors = torch.stack([f.color for f in frags])
    depths = torch.stack([f.depth for f in frags])
    del frags
    parts["exchange_ms"] = median_ms(lambda _: dp._exchange_vdi_columns(
        colors, depths, n, ccfg.wire), 5)
    rc, rd = dp._exchange_vdi_columns(colors, depths, n, ccfg.wire)
    del colors, depths
    _, _, k, _, h, w = rc.shape

    def sort_all(_):
        return [sort_stream(rc[j].reshape(n * k, 4, h, w),
                            rd[j].reshape(n * k, 2, h, w))
                for j in range(n)]

    parts["sort_ms"] = median_ms(sort_all, 3)
    streams = sort_all(None)
    del rc, rd
    ms, b, by = k4_streams_ms(prefix, streams)
    parts.update(k4_ms=ms, k4_bound_ms=b)
    parts["march_sum_ms"] = sum(rank_ms)
    log(f"{prefix}.parts_ms", " ".join(f"{key}={v:.3f}"
                                       for key, v in parts.items()) +
        f" stream_slots={n * k} stream_bytes_a_block="
        f"{n * k * 6 * h * w * 4}")
    log(f"{prefix}.rank_march_ms", " ".join(f"{m:.3f}" for m in rank_ms))
    return parts, rank_ms, streams


def run_decomp_frames(dev, ref0, profile=False):
    """Phase 9 (a) and (c): every render decomposition driven as phase 4
    drives its frame, from the same seeded state, eye and frames, with
    K1's, K2's and K4's launches counted and the build counters read;
    its parts timed apart on the final state (reslab, each rank's march,
    sort, K4), the measured straggler factor (max/mean of the ranks'
    march ms) beside the modeled one and phase 4's even ones; the gates
    against phase 4's frame ``ref0``. Then K4 alone on b3's fullest
    column block (M = 640) against its plain version. Returns the
    results by configuration."""
    import torch

    from scenery_insitu_tpu_torch import obs as tobs
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import cuda_composite as cc
    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    frames = WARMUP_FRAMES + TIMED_FRAMES
    tf = for_dataset("gray_scott", device=dev)
    st0 = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    prof0 = occ.z_live_profile(st0.v, tf).cpu().numpy()
    prof_final = occ.z_live_profile(ref0["v"], tf).cpu().numpy()
    _, spec0, _, _, _, _, _ = dist_steps(dev, RANKS, GRID, BASE_EYE)
    t = wave_tiles_for(spec0.ni, RANKS)
    configs, _ = decomp_configs(prof0, GRID, RANKS, DECOMP_BRICKS,
                                FIXED_PLAN, t, "decomp")
    a = cc.attributes(RANKS * 5 * K, K_OUT, COMP_ITERS)
    log("decomp.resegment.build", f"nk={RANKS * 5 * K} k_out={K_OUT} iters="
        f"{COMP_ITERS} " + " ".join(f"{k}={v}" for k, v in a.items()) +
        " (b3's brick stream)")
    img0 = render_vdi_same_view(ref0["vdi"])
    res = {}
    for name in DECOMP_NAMES:
        rebalance, plan, bricks, comp = configs[name]
        prefix = f"decomp_{name}"
        rec = tobs.Recorder(enabled=True)
        prev = tobs.set_recorder(rec)
        try:
            mesh, spec, tf, (vcfg, ccfg), seed, step, camera = dist_steps(
                dev, RANKS, GRID, BASE_EYE, plan=plan, bricks=bricks,
                rebalance=rebalance, **comp)
        finally:
            tobs.set_recorder(prev)
        built = {key: rec.counters.get(key, 0) for key in (
            "rebalance_steps_built", "bricks_steps_built",
            "wave_steps_built", "ring_exchange_builds")}
        slots = bricks.total_slots if bricks else 1
        waves = comp.get("schedule") == "waves"
        log(f"{prefix}.config", f"rebalance={rebalance} plan="
            f"{list(plan) if plan else None} owners="
            f"{list(bricks.owner) if bricks else None} levels="
            f"{list(bricks.level) if bricks else None} slots={slots} "
            f"composite={comp or 'all_to_all frame'} builds={built}")
        st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
        box = Volume.centered(st.v, extent=2.0)
        run = drive_dist_frames(prefix, step, seed, mesh, camera, st,
                                box.origin, box.spacing)
        launches = run["launches"]
        require_launched(launches, DIST_KERNELS, prefix)
        k4 = launches["resegment_sorted"]
        want_k4 = RANKS * (t if waves else 1) * frames
        if k4 != want_k4:
            raise AssertionError(f"{prefix}: K4 launched {k4} times in "
                                 f"{frames} frames; expected {want_k4}")
        check_vdi(prefix, run["vdi"], (K_OUT, 4, spec.nj, spec.ni),
                  (K_OUT, 2, spec.nj, spec.ni))
        dims = [float(x) for x in run["meta"].volume_dims]
        if dims != [float(GRID)] * 3:
            raise AssertionError(f"{prefix}: meta volume_dims {dims}")
        if profile:
            state = [run["u"], run["v"], run["thr"]]

            def one(i, frame=run["frame"], state=state):
                _, _, state[0], state[1], state[2] = frame(*state, i)

            profile_frames(f"{prefix}.profile", one)
        # the gates against phase 4's frame at the same state, eye, frame
        dc, dd, same, share, exact = vdi_gap(run["vdi"], ref0["vdi"])
        img = render_vdi_same_view(run["vdi"])
        psnr = image_psnr(img, img0)
        thr_d = thr_gap(run["thr"], ref0["thr"]) if bricks is None else None
        log(f"{prefix}.vs_phase4", f"colour_max_diff={dc:.3e} "
            f"depth_max_diff={dd:.3e} same_live_slots={same} "
            f"pixels_live_count_differs={share:.6f} bit_exact={exact} "
            f"within_{DECOMP_VDI_GATE:.0e}="
            f"{same and dc <= DECOMP_VDI_GATE and dd <= DECOMP_VDI_GATE} "
            f"threshold_max_diff={thr_d} psnr_db={psnr:.2f}")
        if name != "l2" and not psnr >= DECOMP_PSNR_DB:
            raise AssertionError(f"{prefix}: the image is {psnr:.2f} dB from "
                                 f"phase 4's even frame")
        # the parts, timed apart on the final state and eye
        slabs = shard_volume(run["v"], mesh)
        cam = camera(frames)
        parts, rank_ms, streams = decomp_parts(
            prefix, dp, slabs, box.origin, box.spacing, cam, spec, tf,
            vcfg, ccfg, run["thr"], dp._resolve_plan("occupancy", RANKS, plan),
            dp._resolve_bricks("bricks", RANKS, bricks))
        measured = max(rank_ms) / (sum(rank_ms) / RANKS)
        modeled = decomp_modeled(prof_final, GRID, RANKS, plan, bricks,
                                 spec.ni, spec.nj)
        res[name] = dict(
            ms=run["ms"], wall_ms=run["wall_ms"], k4=k4,
            k1=launches["seg_fold_compact"], k2=launches["count_multi"],
            psnr_db=psnr, colour_max_diff=dc, depth_max_diff=dd,
            same_live_slots=same, bit_exact=exact, parts=parts,
            rank_ms=rank_ms, measured_straggler=measured,
            modeled_straggler=modeled, builds=built, slots=slots,
            stream=list(streams[0][0].shape))
        if name == "b3":
            res["brick_stream"] = check_brick_stream(streams)
        if name == "p1":
            # phase 10's h7 is p1 on a two-level mesh, gated against this
            res["p1_frame"] = dict(vdi=run["vdi"], thr=run["thr"],
                                   ms=run["ms"], plan=plan)
        del streams, run, step, seed
        torch.cuda.empty_cache()
    # phase 4's even decomposition timed the same way, on the same state
    mesh, spec, tf, (vcfg, ccfg), _, _, camera = dist_steps(
        dev, RANKS, GRID, BASE_EYE)
    box = Volume.centered(ref0["v"], extent=2.0)
    _, even_ms, _ = decomp_parts(
        "decomp_even", dp, shard_volume(ref0["v"], mesh), box.origin,
        box.spacing, camera(frames), spec, tf, vcfg, ccfg, ref0["thr"],
        None, None)
    even_measured = max(even_ms) / (sum(even_ms) / RANKS)
    even_modeled = decomp_modeled(prof_final, GRID, RANKS, None, None,
                                  spec.ni, spec.nj)
    res["even"] = dict(ms=ref0["ms"], measured_straggler=even_measured,
                       modeled_straggler=even_modeled)
    for name in DECOMP_NAMES:
        r = res[name]
        log(f"decomp_{name}.summary", f"ms_per_frame={r['ms']:.3f} (phase 4: "
            f"{ref0['ms']:.3f}) straggler measured="
            f"{r['measured_straggler']:.4f} modeled="
            f"{r['modeled_straggler']:.4f} (phase 4's even: measured "
            f"{even_measured:.4f} modeled {even_modeled:.4f}) launches a "
            f"frame K1={r['k1'] / frames:.1f} K4={r['k4'] / frames:.1f} "
            f"K2 a seed={r['k2']} k4_frame_ms={r['parts']['k4_ms']:.4f} "
            f"psnr_db={r['psnr_db']:.2f}")
    return res


def check_brick_stream(streams):
    """Phase 9 (c): K4 against its plain version on b3's fullest column
    block (M = 640 sorted slots): thresholds and live slots exact, colour
    and depth within 1e-6; timed with the stream kept full behind a
    device sleep, the one launch beside, and its bound."""
    import torch

    from scenery_insitu_tpu_torch.ops import cuda_composite as cc

    err = check_k4_on("decomp_b3.resegment", streams)
    j = max(range(len(streams)), key=lambda i: int(
        torch.isfinite(streams[i][1][:, 0]).sum()))
    sc, sd = streams[j]
    k4 = lambda: cc.resegment_sorted(sc, sd, None, K_OUT,
                                     adaptive_iters=COMP_ITERS)
    ms = stream_ms(k4, behind_sleep=True)
    one = median_ms(lambda _: k4(), 20)
    pms = median_ms(lambda _: cc.resegment_sorted_plain(
        sc, sd, None, K_OUT, adaptive_iters=COMP_ITERS), 3)
    (b, by), live, nbytes = k4_bound(sc, COMP_ITERS)
    nk, _, h, w = sc.shape
    log("decomp_b3.resegment.ms", f"{ms:.4f} plain_ms={pms:.4f} bound_ms="
        f"{b:.4f} ({by}) one_launch_ms={one:.4f} nk={nk} hw={h}x{w} "
        f"non_empty_slots_per_pixel={live:.2f} achieved_gb_s="
        f"{nbytes / ms / 1e6:.1f}; the stream kept full behind a device "
        f"sleep")
    return dict(err=err, ms=ms, one_launch_ms=one, plain_ms=pms,
                bound_ms=b, bound_by=by, nk=nk)


def check_small_decomp(dev):
    """Phase 9 (b): p2, b2, b3, l1, l2, x1 and x2 scaled to 32^3 over 4
    ranks (8 bricks, the plan halved), on the card against the CPU's
    plain versions in both march regimes: seed + 3 temporal frames from
    the same inputs, phase 4's bar (largest and mean image difference
    at most 1e-4), threshold maps within 1e-6."""
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    n = 32
    v0 = gs.multi_step(gs.GrayScott.init((n,) * 3, seed=SEED, device="cpu"),
                       2 * SIM_STEPS).v
    box = Volume.centered(v0, extent=2.0)
    prof = occ.z_live_profile(v0, for_dataset("gray_scott",
                                              device="cpu")).numpy()
    for regime, eye in (("z", BASE_EYE), ("x", (3.0, 0.6, 0.4))):
        _, spec, _, _, _, _, _ = dist_steps("cpu", SMALL_RANKS, n, eye)
        configs, _ = decomp_configs(prof, n, SMALL_RANKS, SMALL_BRICKS,
                                    SMALL_PLAN, wave_tiles_for(
                                        spec.ni, SMALL_RANKS),
                                    f"small_decomp_{regime}")
        for name in ("p2", "b2", "b3", "l1", "l2", "x1", "x2"):
            rebalance, plan, bricks, comp = configs[name]
            outs = {}
            for dname, d in (("cuda", dev), ("cpu", "cpu")):
                mesh, spec, _, _, seed, step, camera = dist_steps(
                    d, SMALL_RANKS, n, eye, fold="pallas_seg", plan=plan,
                    bricks=bricks, rebalance=rebalance, mm="f32", **comp)
                data = shard_volume(v0.to(d), mesh)
                origin, spacing = box.origin.to(d), box.spacing.to(d)
                thr = seed(data, origin, spacing, camera(-1))
                imgs = []
                for i in range(3):
                    (vdi, _), thr = step(data, origin, spacing, camera(i),
                                         thr)
                    imgs.append(render_vdi_same_view(vdi).cpu())
                outs[dname] = (imgs, [x.cpu() for x in thr])
            prefix = f"small_decomp_{regime}_{name}"
            pairs = list(zip(*(outs[k][0] for k in ("cuda", "cpu"))))
            diff = max(float((a - b).abs().max()) for a, b in pairs)
            mean = max(float((a - b).abs().mean()) for a, b in pairs)
            tdiff = thr_gap(outs["cuda"][1], outs["cpu"][1])
            log(prefix, f"image_max_abs_diff={diff:.3e} image_mean_abs_diff="
                f"{mean:.3e} threshold_max_abs_diff={tdiff:.3e}")
            if not (diff <= 1e-4 and mean <= 1e-4 and tdiff <= 1e-6):
                raise AssertionError(f"{prefix}: the card's frame differs "
                                     f"from the CPU's plain versions")


def run_decomp_sessions(dev):
    """Phase 9 (d), phase 7's session extended: the 512^3 session over 8
    ranks with ``composite.rebalance=occupancy`` and then ``bricks``
    with ``lod.enabled``, a replan every DECOMP_SESSION_PERIOD frames,
    DECOMP_SESSION_FRAMES frames each, driven a frame at a time. Every
    replan is logged (frame, plan or owners and levels, modeled
    factors); the steps are rebuilt on a replan only (``build_steps`` =
    1 + ``rebalance_replans``); the frame after each replan equals a
    hand-driven `distributed_vdi_step_mxu_temporal` and its seed with
    the same plan or map, from the same state and camera, bit for bit;
    K3, K2, K1 and K4 must launch. Returns {mode: (launches, ms)}."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    out = {}
    for mode, extra in (
            ("rebalance", ("composite.rebalance=occupancy",)),
            ("bricks_lod", ("composite.rebalance=bricks",
                            "lod.enabled=true"))):
        cfg = session_config(GRID, ranks=RANKS).with_overrides(
            *extra, f"composite.rebalance_period={DECOMP_SESSION_PERIOD}",
            "obs.enabled=true")
        prefix = f"session_{mode}"
        frames = {}
        sess = session(dev, cfg, [capture_into(frames)])
        kernels.reset_launches()
        replans, wall = 0, []
        for i in range(DECOMP_SESSION_FRAMES):
            st = sess.sim.state
            u0, v0, cam = st.u.clone(), st.v.clone(), sess.camera
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.run(1)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            n_replans = sess.obs.counters.get("rebalance_replans", 0)
            if n_replans == replans:
                continue
            replans = n_replans
            ev = [e["attrs"] for e in sess.obs.events
                  if e.get("name") == "rebalance_plan"][-1]
            log(f"{prefix}.replan", json.dumps(ev))
            # the same frame driven by hand with the adopted plan or map
            spec = slicer.make_spec(cam, (GRID,) * 3, cfg.slicer,
                                    axis_sign=slicer.choose_axis(cam),
                                    multiple_of=RANKS)
            dec = dict(plan=sess._plan, bricks=sess._bricks)
            seed = dp.distributed_initial_threshold_mxu(
                sess.mesh, sess.tf, spec, cfg.vdi, **dec)
            step = dp.distributed_vdi_step_mxu_temporal(
                sess.mesh, sess.tf, spec, cfg.vdi, cfg.composite, **dec)
            g = gs.multi_step_fast(gs.GrayScott(u0, v0, st.params),
                                   SIM_STEPS)
            field = shard_volume(g.field, sess.mesh)
            thr = seed(field, sess._origin, sess._spacing, cam)
            (vdi, _), _ = step(field, sess._origin, sess._spacing, cam, thr)
            check_frames_equal(f"{prefix}.frame{i}_vs_hand", {i: frames[i]},
                               {i: {"vdi_color": vdi.color.cpu().numpy(),
                                    "vdi_depth": vdi.depth.cpu().numpy()}})
            del g, field, thr, vdi, step, seed
        launches = kernels.launches()
        log(f"{prefix}.launches", json.dumps(launches))
        require_launched(launches, DIST_KERNELS, prefix)
        counters = sess.obs.counters
        log(f"{prefix}.counters", json.dumps({k: counters.get(k, 0) for k in (
            "rebalance_replans", "build_steps", "rebalance_steps_built",
            "bricks_steps_built", "compile_step")}))
        if counters.get("build_steps", 0) != 1 + replans:
            raise AssertionError(f"{prefix}: {counters.get('build_steps')} "
                                 f"step builds for {replans} replans")
        evs = [e["attrs"] for e in sess.obs.events
               if e.get("name") == "rebalance_plan"]
        keys = [(tuple(e.get("plan", ())), tuple(e.get("owner", ())),
                 tuple(e.get("level", ()))) for e in evs]
        if any(a == b for a, b in zip(keys, keys[1:])):
            raise AssertionError(f"{prefix}: a replan rebuilt without a "
                                 f"change: {keys}")
        wall.sort()
        ms = wall[len(wall) // 2]
        log(f"{prefix}.ms_per_frame", f"{ms:.3f} (host clock, median of "
            f"{DECOMP_SESSION_FRAMES} frames each fetched, replans "
            f"included; phase 7's one-rank session: "
            f"{SESSION_MS['session_nosinks']:.3f} without sinks, "
            f"{SESSION_MS['session']:.3f} with its sinks every "
            f"{SESSION_EVERY})")
        last = max(frames)
        nj, ni = frames[last]["vdi_color"].shape[-2:]
        check_vdi(prefix, VDI(torch.from_numpy(frames[last]["vdi_color"]),
                              torch.from_numpy(frames[last]["vdi_depth"])),
                  (K, 4, nj, ni), (K, 2, nj, ni))
        out[mode] = (launches, ms, replans)
        del sess, frames
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 10


# phase 10's two-level configurations on phase 4's (name, hosts,
# exchange, dcn_wire, schedule, plan): the plan one is phase 9's p1
HIER_CONFIGS = (
    ("h1", 2, "all_to_all", "f32", "frame", False),
    ("h2", 4, "all_to_all", "f32", "frame", False),
    ("h3", 2, "ring", "f32", "frame", False),
    ("h4", 2, "all_to_all", "bf16", "frame", False),
    ("h5", 2, "all_to_all", "qpack8", "frame", False),
    ("h6", 2, "ring", "f32", "waves", False),
    ("h7", 2, "all_to_all", "f32", "frame", True),
)
HIER_LOSSLESS = ("h1", "h2", "h3", "h6", "h7")
HIER_GATE = 1e-6
HIER_DCN_PSNR_DB = 30.0
SMALL_HIER = ("h1", "h3", "h5", "h6")
HIER_SESSION_FRAMES = 8
HIER_SESSION_RESUME = 4


def hier_topology(hosts, dcn):
    from scenery_insitu_tpu_torch.config import TopologyConfig

    return TopologyConfig(num_hosts=hosts, dcn_wire=dcn)


def hier_comp(ex, sched, plan):
    comp = dict(exchange=ex, schedule=sched)
    if plan is not None:
        comp["rebalance"] = "occupancy"
    return comp


def hier_parts(prefix, colors, depths, topo, ccfg):
    """The two-level composite of one frame's fragments ``[N, K, ...]``
    (every wave's, for a list of them), its parts timed apart (median
    ms): the level-1 exchange (the all_to_all's block transpose, or the
    ring's sort, encode and split), the level-1 sort or ring merges, the
    level-2 DCN merges (encode, decode, merge) and K4. Returns (parts,
    the streams K4 resegments)."""
    from scenery_insitu_tpu_torch.ops.composite import (resegment_stream,
                                                        sort_stream)
    from scenery_insitu_tpu_torch.parallel import hier
    from scenery_insitu_tpu_torch.parallel import pipeline as dp

    frags = colors if isinstance(colors, list) else [(colors, depths)]
    d, wire = topo.domain_size, ccfg.wire
    ring = ccfg.exchange == "ring" and d > 1
    domains = [slice(h * d, (h + 1) * d) for h in range(topo.num_hosts)]

    def exchange(_):
        return [[dp._ring_blocks(c[sl], dd[sl], d, wire) if ring else
                 dp._exchange_vdi_columns(c[sl], dd[sl], d, wire)
                 for sl in domains] for c, dd in frags]

    parts = {"l1_exchange_ms": median_ms(exchange, 3)}
    sent = exchange(None)
    k = frags[0][0].shape[1]

    def level1(_):
        if ring:
            cap = dp._ring_cap(ccfg, k)
            return [[[dp._ring_accumulate(b, j, wire, cap) for j in range(d)]
                     for b in wave] for wave in sent]
        out = []
        for wave in sent:
            accs = []
            for rc, rd in wave:
                _, _, _, _, hh, w = rc.shape
                accs.append([sort_stream(rc[j].reshape(d * k, 4, hh, w),
                                         rd[j].reshape(d * k, 2, hh, w))
                             for j in range(d)])
            out.append(accs)
        return out

    parts["l1_ring_merge_ms" if ring else "l1_sort_ms"] = median_ms(level1, 3)
    accs = level1(None)
    del sent
    parts["l2_dcn_ms"] = median_ms(lambda _: [
        hier.dcn_accumulate(a, topo) for a in accs], 3)
    streams = [s for a in accs for s in hier.dcn_accumulate(a, topo)]
    del accs
    parts["k4_ms"] = median_ms(lambda _: [
        resegment_stream(sc, sd, ccfg) for sc, sd in streams], 3)
    log(f"{prefix}.parts_ms", " ".join(f"{n}={v:.3f}"
                                       for n, v in parts.items()) +
        f" ({len(frags)} composite(s) a frame, every rank)")
    return parts, streams


def run_hier_frames(dev, ref0, p1, profile=False):
    """Phase 10 (a): each two-level configuration driven as phase 4
    drives its frame, from the same seeded state, eye and seed
    threshold, with K1's, K2's and K4's launches counted and its build
    counters and modelled DCN traffic read; its parts timed apart on the
    final state; the gates against phase 4's frame ``ref0`` (h7 against
    phase 9's p1 frame ``p1``)."""
    import torch

    from scenery_insitu_tpu_torch import obs as tobs
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.parallel.topology import (
        resolve_mesh_topology)
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    frames = WARMUP_FRAMES + TIMED_FRAMES
    img0 = render_vdi_same_view(ref0["vdi"])
    res = {}
    for name, hosts, ex, dcn, sched, planned in HIER_CONFIGS:
        plan = p1["plan"] if planned else None
        want = p1 if planned else ref0
        prefix = f"hier_{name}"
        rec = tobs.Recorder(enabled=True)
        prev = tobs.set_recorder(rec)
        try:
            mesh, spec, tf, (vcfg, ccfg), seed, step, camera = dist_steps(
                dev, RANKS, GRID, BASE_EYE, plan=plan,
                topology=hier_topology(hosts, dcn),
                **hier_comp(ex, sched, plan))
        finally:
            tobs.set_recorder(prev)
        _, _, topo = resolve_mesh_topology(mesh, hier_topology(hosts, dcn))
        t = ccfg.wave_tiles if sched == "waves" else 1
        built = {key: rec.counters.get(key, 0) for key in (
            "hier_composite_builds", "dcn_hops_built", "ring_steps_built",
            "wave_steps_built", "wire_encode_builds",
            "rebalance_steps_built")}
        ev = [e["attrs"] for e in rec.events
              if e.get("name") == "hier_composite_build"]
        if built["hier_composite_builds"] != 1 or \
                built["dcn_hops_built"] != hosts - 1:
            raise AssertionError(f"{prefix}: build counters {built}")
        log(f"{prefix}.config", f"hosts={hosts} domain_size="
            f"{RANKS // hosts} exchange={ex} dcn_wire={dcn} schedule="
            f"{sched} wave_tiles={t} plan={list(plan) if plan else None} "
            f"ni={spec.ni} nj={spec.nj} builds={json.dumps(built)}")
        dcn_host = ev[0]["dcn"]["dcn_bytes_sent_per_host"]
        log(f"{prefix}.modelled_traffic", json.dumps(
            {"ici": ev[0]["ici"], "dcn": ev[0]["dcn"]}) + " (modelled: the "
            "in-process ranks move no byte across a link; "
            f"dcn_bytes_sent_per_host={dcn_host} a composite, x{t} a "
            f"frame)")
        st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
        box = Volume.centered(st.v, extent=2.0)
        run = drive_dist_frames(prefix, step, seed, mesh, camera, st,
                                box.origin, box.spacing)
        launches = run["launches"]
        require_launched(launches, DIST_KERNELS, prefix)
        k4 = launches["resegment_sorted"]
        if k4 != RANKS * t * frames:
            raise AssertionError(f"{prefix}: K4 launched {k4} times in "
                                 f"{frames} frames; expected "
                                 f"{RANKS * t * frames}")
        check_vdi(prefix, run["vdi"], (K_OUT, 4, spec.nj, spec.ni),
                  (K_OUT, 2, spec.nj, spec.ni))
        if profile:
            state = [run["u"], run["v"], run["thr"]]

            def one(i, frame=run["frame"], state=state):
                _, _, state[0], state[1], state[2] = frame(*state, i)

            profile_frames(f"{prefix}.profile", one)
        # the gates at the same state, eye and frame
        dc, dd, same, share, exact = vdi_gap(run["vdi"], want["vdi"])
        img = render_vdi_same_view(run["vdi"])
        psnr = image_psnr(img, img0 if not planned
                          else render_vdi_same_view(want["vdi"]))
        tdiff = thr_gap(run["thr"], want["thr"])
        base = "phase 9's p1" if planned else "phase 4"
        log(f"{prefix}.vs_{'p1' if planned else 'phase4'}",
            f"colour_max_diff={dc:.3e} depth_max_diff={dd:.3e} "
            f"same_live_slots={same} pixels_live_count_differs={share:.6f} "
            f"bit_exact={exact} threshold_max_diff={tdiff:.3e} "
            f"psnr_db={psnr:.2f} (against {base}'s frame)")
        if name in HIER_LOSSLESS:
            if not (same and dc <= HIER_GATE and dd <= HIER_GATE):
                raise AssertionError(f"{prefix}: the frame differs from "
                                     f"{base}'s beyond {HIER_GATE}")
        elif not psnr >= HIER_DCN_PSNR_DB or torch.equal(img, img0):
            raise AssertionError(f"{prefix}: the lossy DCN wire is "
                                 f"{psnr:.2f} dB from phase 4's frame or "
                                 f"equals it")
        check(f"{prefix}.threshold_vs_{'p1' if planned else 'phase4'}",
              tdiff, HIER_GATE)
        # the parts, timed apart on the final state and eye
        slabs = shard_volume(run["v"], mesh)
        cam = camera(frames)
        rplan = dp._resolve_plan("occupancy", RANKS, plan)
        rows = dp._frame_rows(slabs, spec, rplan)
        if sched == "waves":
            fr = [dp._RankFrame(slabs, rows, r, box.origin, box.spacing, cam,
                                spec, tf, rplan) for r in range(RANKS)]
            thr_full = [dp._rank_thr(run["thr"], r, spec.nj)
                        for r in range(RANKS)]
            frags = [dp._march_wave(fr, w, RANKS, t, cam, spec, tf, vcfg,
                                    list(thr_full)) for w in range(t)]
            del fr
            parts, streams = hier_parts(prefix, frags, None, topo, ccfg)
        else:
            fs = [dp._mxu_rank_generate(
                slabs, rows, r, box.origin, box.spacing, cam, spec, tf,
                vcfg, dp._rank_thr(run["thr"], r, spec.nj), rplan)[0]
                for r in range(RANKS)]
            colors = torch.stack([f.color for f in fs])
            depths = torch.stack([f.depth for f in fs])
            del fs
            parts, streams = hier_parts(prefix, colors, depths, topo, ccfg)
            del colors, depths
        del rows
        if any(sc.shape[0] != RANKS * K for sc, _ in streams):
            raise AssertionError(f"{prefix}: K4's streams are "
                                 f"{streams[0][0].shape[0]} slots, not "
                                 f"{RANKS * K}")
        ms, b, by = k4_streams_ms(prefix, streams)
        err = check_k4_on(f"{prefix}.resegment", streams) \
            if name in ("h1", "h6") else None
        res[name] = dict(ms=run["ms"], wall_ms=run["wall_ms"], k4=k4,
                         k1=launches["seg_fold_compact"],
                         k2=launches["count_multi"], wave_tiles=t,
                         parts=parts, k4_frame_ms=ms, k4_frame_bound_ms=b,
                         k4_frame_bound_by=by, k4_err=err, psnr_db=psnr,
                         bit_exact=exact, colour_max_diff=dc,
                         depth_max_diff=dd, builds=built,
                         dcn_bytes_per_host=dcn_host * t)
        del streams, run, step, seed
        torch.cuda.empty_cache()
    for name, *_ in HIER_CONFIGS:
        r = res[name]
        base = p1["ms"] if name == "h7" else ref0["ms"]
        log(f"hier_{name}.summary", f"ms_per_frame={r['ms']:.3f} "
            f"({'phase 9 p1' if name == 'h7' else 'phase 4'}: {base:.3f}) "
            f"launches a frame K1={r['k1'] / frames:.1f} "
            f"K4={r['k4'] / frames:.1f} K2 a seed={r['k2']} "
            f"k4_frame_ms={r['k4_frame_ms']:.4f} k4_frame_bound_ms="
            f"{r['k4_frame_bound_ms']:.4f} modelled_dcn_bytes_per_host="
            f"{r['dcn_bytes_per_host']} bit_exact={r['bit_exact']}")
    return res


def check_small_hier(dev):
    """Phase 10 (b): h1, h3, h5 and h6 at 32^3 over 4 ranks (2 x 2) on
    the card against the CPU's plain versions in both march regimes,
    seed + 3 temporal frames from the same inputs: phase 4's bar (1e-4),
    the lossy wire's images at 60 dB, threshold maps within 1e-6."""
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    n = 32
    v0 = gs.multi_step(gs.GrayScott.init((n,) * 3, seed=SEED, device="cpu"),
                       2 * SIM_STEPS).v
    box = Volume.centered(v0, extent=2.0)
    configs = {c[0]: c for c in HIER_CONFIGS}
    for regime, eye in (("z", BASE_EYE), ("x", (3.0, 0.6, 0.4))):
        for name in SMALL_HIER:
            _, _, ex, dcn, sched, _ = configs[name]
            outs = {}
            for dname, d in (("cuda", dev), ("cpu", "cpu")):
                mesh, _, _, _, seed, step, camera = dist_steps(
                    d, SMALL_RANKS, n, eye, fold="pallas_seg", mm="f32",
                    topology=hier_topology(2, dcn),
                    **hier_comp(ex, sched, None))
                data = shard_volume(v0.to(d), mesh)
                origin, spacing = box.origin.to(d), box.spacing.to(d)
                thr = seed(data, origin, spacing, camera(-1))
                imgs = []
                for i in range(3):
                    (vdi, _), thr = step(data, origin, spacing, camera(i),
                                         thr)
                    imgs.append(render_vdi_same_view(vdi).cpu())
                outs[dname] = (imgs, [x.cpu() for x in thr])
            prefix = f"small_hier_{regime}_{name}"
            pairs = list(zip(*(outs[k][0] for k in ("cuda", "cpu"))))
            diff = max(float((a - b).abs().max()) for a, b in pairs)
            mean = max(float((a - b).abs().mean()) for a, b in pairs)
            psnr = min(image_psnr(a, b) for a, b in pairs)
            tdiff = thr_gap(outs["cuda"][1], outs["cpu"][1])
            log(prefix, f"hosts=2 domain_size=2 image_max_abs_diff="
                f"{diff:.3e} image_mean_abs_diff={mean:.3e} psnr_db="
                f"{psnr:.2f} threshold_max_abs_diff={tdiff:.3e}")
            ok = (diff <= 1e-4 and mean <= 1e-4) if dcn == "f32" else \
                psnr >= SMALL_WIRE_PSNR_DB
            if not (ok and tdiff <= 1e-6):
                raise AssertionError(f"{prefix}: the card's frame differs "
                                     f"from the CPU's plain versions")


def run_hier_session(dev):
    """Phase 10 (c), phase 7's session on a 2 x 4 topology at 512^3: a
    warm frame and HIER_SESSION_FRAMES timed frames (the launch counts
    read from them; K3, K2, K1 and K4 must launch, K4 8 a frame), its
    first two frames equal to the hand-driven hierarchical step and
    seed bit for bit, a checkpoint after HIER_SESSION_RESUME frames
    resumed bit for bit, ms a frame beside phase 7's. Returns (launches,
    ms)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.camera import orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.runtime.checkpoint import (load_session,
                                                             save_session)
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    cfg = session_config(GRID, ranks=RANKS).with_overrides(
        "topology.num_hosts=2", "obs.enabled=true")
    out = tempfile.mkdtemp(prefix="chip_smoke_hier_")
    try:
        frames = {}
        sess = session(dev, cfg, [capture_into(frames)])
        st0 = sess.sim.state
        u0, v0, cam0 = st0.u.clone(), st0.v.clone(), sess.camera
        origin, spacing = sess._origin, sess._spacing
        if sess.mesh.axis_names != ("hosts", "ranks") or \
                sess._n_ranks != RANKS:
            raise AssertionError(f"session_hier: mesh {sess.mesh}")
        kernels.reset_launches()
        sess.run(SESSION_WARM)
        before = phase_stats(sess.timers)
        ms, _ = timed_run(sess, HIER_SESSION_FRAMES)
        launches = kernels.launches()
        log("session_hier.launches", json.dumps(launches))
        require_launched(launches, DIST_KERNELS, "the hierarchical session")
        n_frames = SESSION_WARM + HIER_SESSION_FRAMES
        if launches["resegment_sorted"] != RANKS * n_frames:
            raise AssertionError(
                f"session_hier: K4 launched {launches['resegment_sorted']} "
                f"times in {n_frames} frames of {RANKS} ranks")
        counters = sess.obs.counters
        log("session_hier.counters", json.dumps({k: counters.get(k, 0) for k
                                                 in ("hier_composite_builds",
                                                     "dcn_hops_built",
                                                     "compile_step")}))
        if counters.get("hier_composite_builds", 0) < 1:
            raise AssertionError("session_hier: no two-level build")
        log("session_hier.ms_per_frame", f"{ms:.3f} (host clock, mean of "
            f"{HIER_SESSION_FRAMES} frames after a warm one, every frame "
            f"fetched; phase 7's one-rank session: "
            f"{SESSION_MS['session_nosinks']:.3f} without sinks, "
            f"{SESSION_MS['session']:.3f} with its sinks every "
            f"{SESSION_EVERY})")
        log_phase_stats("session_hier", sess.timers, before)
        mesh = sess.mesh
        del sess

        # the first two frames driven by hand on the same two-level mesh
        spec = slicer.make_spec(cam0, (GRID,) * 3, cfg.slicer,
                                axis_sign=slicer.choose_axis(cam0),
                                multiple_of=RANKS)
        tf = for_dataset("gray_scott", device=dev)
        seed = dp.distributed_initial_threshold_mxu(mesh, tf, spec, cfg.vdi)
        step = dp.distributed_vdi_step_mxu_temporal(
            mesh, tf, spec, cfg.vdi, cfg.composite, topology=cfg.topology)
        st = gs.GrayScott(u0, v0, st0.params)
        cam, thr, hand = cam0, None, {}
        for i in range(2):
            st = gs.multi_step_fast(st, SIM_STEPS)
            field = shard_volume(st.field, mesh)
            if thr is None:
                thr = seed(field, origin, spacing, cam)
            (vdi, _), thr = step(field, origin, spacing, cam, thr)
            hand[i] = {"vdi_color": vdi.color.cpu().numpy(),
                       "vdi_depth": vdi.depth.cpu().numpy()}
            cam = orbit(cam, np.float32(SESSION_ORBIT))
        del st, thr, vdi, field, step, seed
        check_frames_equal("session_hier_vs_hand",
                           {i: frames[i] for i in hand}, hand)

        # a checkpoint after HIER_SESSION_RESUME frames, resumed
        sess = session(dev, cfg)
        sess.run(HIER_SESSION_RESUME)
        path = os.path.join(out, "hier.npz")
        save_session(sess, path)
        del sess
        with np.load(path) as z:
            header = json.loads(bytes(z["__header__"]).decode())
        if header["mesh_devices"] != RANKS:
            raise AssertionError(f"session_hier: checkpoint header "
                                 f"mesh_devices={header['mesh_devices']}")
        resumed = {}
        sess = session(dev, cfg, [capture_into(resumed)])
        load_session(sess, path)
        sess.run(HIER_SESSION_RESUME)
        del sess
        check_frames_equal("session_hier_resume", resumed, {
            i: frames[i] for i in range(HIER_SESSION_RESUME,
                                        2 * HIER_SESSION_RESUME)})
        torch.cuda.empty_cache()
        return launches, ms
    finally:
        shutil.rmtree(out, ignore_errors=True)


# ------------------------------------------------------------ phase 11


# phase 11: each run's frames (the first marches every rank), the
# advancing field's seed cubes (z centre, y, x as shares of the grid:
# at 512^3 z = 104, inside rank 1's slab; half side GRID / 64) and the
# P-frame codec's I period (its tiles: one a rank's column block)
REUSE_FRAMES = 8
REUSE_PSNR_DB = 60.0
LOW_SEEDS = ((13 / 64, 1 / 2, 1 / 2), (13 / 64, 5 / 16, 11 / 16),
             (13 / 64, 11 / 16, 5 / 16))
DELTA_IFRAME = 8
# phase 11 (b)'s frozen-field configurations: (name, schedule, hosts)
FROZEN_CONFIGS = (("r1_frame", "frame", 1), ("r2_waves", "waves", 1),
                  ("r3_hier", "frame", 2))


def kbudget_targets(dp, mesh, spec, tf, vcfg, ccfg, v, origin, spacing,
                    cam):
    """Every rank's K budget target as the step computes it (its frame
    state's pyramids, the live fractions summed on the device) and the
    same recomputed on the host from the ranks' live fractions in f32;
    returns (device targets, host targets, live fractions), numpy."""
    import numpy as np

    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume

    slabs = shard_volume(v, mesh)
    rows = dp._frame_rows(slabs, spec)
    frames = [dp._RankFrame(slabs, rows, r, origin, spacing, cam, spec, tf,
                            pyramid=True) for r in range(RANKS)]
    got = np.array([float(x) for x in dp._k_targets(frames, RANKS, vcfg,
                                                    ccfg)], np.float32)
    live = np.array([float(fr.pyrs[0].live_fraction()) for fr in frames],
                    np.float32)
    total = np.float32(0.0)
    for x in live:
        total = np.float32(total + x)
    k = np.float32(vcfg.max_supersegments)
    if total > 1e-9:
        host = np.float32(RANKS * vcfg.max_supersegments) * live / \
            np.maximum(total, np.float32(1e-12))
    else:
        host = np.full(RANKS, k, np.float32)
    host = np.clip(host, np.float32(min(ccfg.k_budget_min, K)), k)
    return got, host.astype(np.float32), live


def rank_slots(dp, mesh, spec, tf, vcfg, v, origin, spacing, cam, thr,
               kts=None):
    """Every rank's mean live slots a pixel of its fragment, marched on
    ``v`` at ``cam`` with its carried maps of ``thr`` (and its K budget
    target)."""
    import torch

    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume

    slabs = shard_volume(v, mesh)
    rows = dp._frame_rows(slabs, spec)
    out = []
    for r in range(RANKS):
        kt = None if kts is None else torch.tensor(float(kts[r]),
                                                   device=v.device)
        vdi = dp._mxu_rank_generate(slabs, rows, r, origin, spacing, cam,
                                    spec, tf, vcfg,
                                    dp._rank_thr(thr, r, spec.nj),
                                    k_target=kt)[0]
        out.append(float(torch.isfinite(vdi.depth[:, 0]).sum(0)
                         .float().mean()))
    return out


def run_kbudget_frames(dev, ref0):
    """Phase 11 (a): the K budget on phase 4's frame. First with
    ``k_budget_min = K`` (every target K): the frame equals phase 4's
    bit for bit. Then the default budget over phase 4's 8 temporal
    frames: each rank's target at the last frame against the host's
    recompute, each rank's mean used slots against the static frame's,
    the image against phase 4's. Returns {name: run}."""
    import numpy as np
    import torch

    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    frames = WARMUP_FRAMES + TIMED_FRAMES
    res = {}
    for name, kmin in (("kbudget_kmin16", K), ("kbudget", None)):
        comp = dict(k_budget="occupancy")
        if kmin is not None:
            comp["k_budget_min"] = kmin
        mesh, spec, tf, (vcfg, ccfg), seed, step, camera = dist_steps(
            dev, RANKS, GRID, BASE_EYE, **comp)
        st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
        box = Volume.centered(st.v, extent=2.0)
        run = drive_dist_frames(name, step, seed, mesh, camera, st,
                                box.origin, box.spacing)
        require_launched(run["launches"], DIST_KERNELS, name)
        check_vdi(name, run["vdi"], (K_OUT, 4, spec.nj, spec.ni),
                  (K_OUT, 2, spec.nj, spec.ni))
        cam = camera(frames - 1)
        got, host, live = kbudget_targets(dp, mesh, spec, tf, vcfg, ccfg,
                                          run["v"], box.origin, box.spacing,
                                          cam)
        err = float(np.abs(got - host).max())
        log(f"{name}.targets", f"{[round(float(x), 4) for x in got]} "
            f"(host recompute max diff {err:.3e}; live fractions "
            f"{[round(float(x), 4) for x in live]}; k_min "
            f"{ccfg.k_budget_min}, K {K})")
        if not err <= 1e-5:
            raise AssertionError(f"{name}: the step's targets differ from "
                                 f"the host's recompute by {err}")
        dc, dd, same, share, exact = vdi_gap(run["vdi"], ref0["vdi"])
        tdiff = thr_gap(run["thr"], ref0["thr"])
        psnr = image_psnr(render_vdi_same_view(run["vdi"]),
                          render_vdi_same_view(ref0["vdi"]))
        log(f"{name}.vs_phase4", f"bit_exact={exact} colour_max_diff="
            f"{dc:.3e} depth_max_diff={dd:.3e} same_live_slots={same} "
            f"pixels_live_count_differs={share:.6f} threshold_max_diff="
            f"{tdiff:.3e} psnr_db={psnr:.2f} (phase 4's {frames} frames, "
            f"static K)")
        if kmin is not None:
            if not ((got == K).all() and exact and tdiff == 0.0):
                raise AssertionError(f"{name}: with every target K the "
                                     f"frame is not phase 4's bit for bit")
        else:
            ours = rank_slots(dp, mesh, spec, tf, vcfg, run["v"],
                              box.origin, box.spacing, cam, run["thr"],
                              got)
            static = rank_slots(dp, mesh, spec, tf, vcfg, run["v"],
                                box.origin, box.spacing, cam, ref0["thr"])
            log(f"{name}.used_slots", f"budget {[round(x, 3) for x in ours]}"
                f" static {[round(x, 3) for x in static]} (mean live slots "
                f"a pixel of each rank's fragment at the last frame)")
        res[name] = run
        del run["frame"]
        torch.cuda.empty_cache()
    return res


def low_slab_state(dev):
    """Gray-Scott at the exact fixed point u = 1, v = 0 but for
    LOW_SEEDS' cubes, all inside rank 1's slab at 512^3: the non-zero
    front moves one cell a step, so after phase 11's 90 steps the slabs
    of ranks 4-7 are still exactly at the fixed point (the periodic z
    boundary wraps nothing that far)."""
    import torch

    from scenery_insitu_tpu_torch.sim import grayscott as gs

    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    u = torch.ones_like(st.u)
    v = torch.zeros_like(st.v)
    r = max(GRID // 64, 1)
    for share in LOW_SEEDS:
        z, y, x = (int(s * GRID) for s in share)
        u[z - r:z + r, y - r:y + r, x - r:x + r] = 0.5
        v[z - r:z + r, y - r:y + r, x - r:x + r] = 0.25
    return gs.GrayScott(u, v, st.params)


def reuse_steps(dev, mode, reuse, fold="auto", **comp):
    """Phase 4's distributed step in ``mode`` (``"temporal"`` or
    ``"histogram"``) with fragment reuse on or off: (mesh, spec, tf,
    (vcfg, ccfg), thr seed or None, reuse seed or None, step)."""
    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 MeshConfig,
                                                 SliceMarchConfig, VDIConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.topology import make_topology_mesh

    topology = comp.pop("topology", None)
    mesh, _ = make_topology_mesh(topology, MeshConfig(num_devices=RANKS),
                                 device=dev)
    base = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    vcfg = VDIConfig(max_supersegments=K, adaptive_mode=mode,
                     histogram_bins=BINS)
    spec = slicer.make_spec(base, (GRID,) * 3,
                            SliceMarchConfig(fold=fold, chunk=CHUNK),
                            axis_sign=slicer.choose_axis(base),
                            multiple_of=RANKS)
    if comp.get("schedule") == "waves":
        comp.setdefault("wave_tiles", wave_tiles_for(spec.ni, RANKS))
    if reuse:
        comp["temporal_reuse"] = "ranges"
    ccfg = CompositeConfig(max_output_supersegments=K_OUT,
                           adaptive_iters=COMP_ITERS, **comp)
    tf = for_dataset("gray_scott", device=dev)
    build = (dp.distributed_vdi_step_mxu_temporal if mode == "temporal"
             else dp.distributed_vdi_step_mxu)
    step = build(mesh, tf, spec, vcfg, ccfg, topology=topology)
    seed = (dp.distributed_initial_threshold_mxu(mesh, tf, spec, vcfg)
            if mode == "temporal" else None)
    rseed = (dp.distributed_initial_reuse_mxu(mesh, tf, spec, vcfg, ccfg)
             if reuse else None)
    return mesh, spec, tf, (vcfg, ccfg), seed, rseed, step, base


def reuse_frames(built, st, origin, spacing, advance, keep=False):
    """REUSE_FRAMES frames of a phase 11 step from the state ``st`` at a
    still camera (the sim advanced SIM_STEPS a frame when ``advance``),
    each timed with CUDA events and the host clock, its launches read
    after it. Returns the frames' VDIs (on the card when ``keep``),
    dirty bits, launches, ms and the final thresholds."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    mesh, spec, _, _, seed, rseed, step, cam = built
    out = dict(vdi=[], dirty=[], launches=[], ms=[], wall=[])
    kernels.reset_launches()
    field = shard_volume(st.field, mesh)
    thr = None if seed is None else seed(field, origin, spacing, cam)
    ru = None if rseed is None else rseed(field, origin, spacing, cam)
    out["seed_launches"] = kernels.launches()
    torch.cuda.synchronize()
    for i in range(REUSE_FRAMES):
        kernels.reset_launches()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        a.record()
        if advance:
            st = gs.multi_step_fast(st, SIM_STEPS)
        args = (shard_volume(st.field, mesh), origin, spacing, cam)
        if thr is not None:
            args += (thr,)
        if ru is not None:
            args += (ru,)
        res = step(*args)
        if thr is not None and ru is not None:
            (vdi, meta), thr, ru = res
        elif thr is not None:
            (vdi, meta), thr = res
        elif ru is not None:
            (vdi, meta), ru = res
        else:
            vdi, meta = res
        b.record()
        b.synchronize()
        out["wall"].append((time.perf_counter() - h0) * 1e3)
        out["ms"].append(a.elapsed_time(b))
        out["launches"].append(kernels.launches())
        out["dirty"].append(None if ru is None else
                            [int(x) for x in ru.dirty.tolist()])
        out["vdi"].append(vdi if keep else type(vdi)(
            vdi.color.cpu(), vdi.depth.cpu()))
    out.update(thr=thr, ru=ru, st=st, spec=spec, meta=meta)
    return out


def frames_ms(ms):
    s = sorted(ms)
    return s[len(s) // 2]


def run_reuse_frozen(dev, ref0, profile=False):
    """Phase 11 (b): fragment reuse on a frozen 512^3 field (phase 4's
    initial state, no sim advance, a still camera), temporal thresholds,
    on the frame schedule, in tile waves and on the 2 x 4 two-level
    mesh: frame 1 marches every rank; frames 2-8 launch no K1 and 8 K4
    a frame (8·T in waves) and equal frame 1 bit for bit. Returns
    {name: summary}."""
    import torch

    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    res = {}
    for name, sched, hosts in FROZEN_CONFIGS:
        prefix = f"reuse_{name}"
        comp = dict(schedule=sched)
        if hosts > 1:
            comp["topology"] = hier_topology(hosts, "f32")
        built = reuse_steps(dev, "temporal", True, **comp)
        ccfg = built[3][1]
        t = ccfg.wave_tiles if sched == "waves" else 1
        st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
        box = Volume.centered(st.v, extent=2.0)
        run = reuse_frames(built, st, box.origin, box.spacing,
                           advance=False, keep=True)
        first = run["vdi"][0]
        if run["dirty"][0] != [1] * RANKS:
            raise AssertionError(f"{prefix}: frame 1 dirty bits "
                                 f"{run['dirty'][0]}")
        k1 = [x["seg_fold_compact"] for x in run["launches"]]
        k4 = [x["resegment_sorted"] for x in run["launches"]]
        for i in range(1, REUSE_FRAMES):
            vdi = run["vdi"][i]
            if run["dirty"][i] != [0] * RANKS or k1[i] != 0 or \
                    k4[i] != RANKS * t:
                raise AssertionError(
                    f"{prefix}: frame {i + 1} dirty {run['dirty'][i]}, K1 "
                    f"{k1[i]}, K4 {k4[i]} (expected none, 0, {RANKS * t})")
            if not (torch.equal(vdi.color, first.color)
                    and torch.equal(vdi.depth, first.depth)):
                raise AssertionError(f"{prefix}: frame {i + 1} differs "
                                     f"from frame 1")
        if k1[0] <= 0:
            raise AssertionError(f"{prefix}: frame 1 launched no K1")
        check_vdi(prefix, first, (K_OUT, 4, run["spec"].nj,
                                  run["spec"].ni),
                  (K_OUT, 2, run["spec"].nj, run["spec"].ni))
        ms = frames_ms(run["ms"][1:])
        wall = frames_ms(run["wall"][1:])
        log(f"{prefix}.frames", f"K1 {k1} K4 {k4} a frame; frames 2-"
            f"{REUSE_FRAMES} bit for bit frame 1's (schedule={sched} "
            f"wave_tiles={t} hosts={hosts})")
        log(f"{prefix}.ms_per_frame", f"{ms:.3f} (median of frames 2-"
            f"{REUSE_FRAMES}, CUDA events; host clock {wall:.3f}); frame 1 "
            f"{run['ms'][0]:.3f}; phase 4's {ref0['ms']:.3f}")
        if profile:
            mesh, _, _, _, _, _, step, cam = built
            from scenery_insitu_tpu_torch.parallel.mesh import shard_volume

            state = [run["thr"], run["ru"]]
            field = shard_volume(st.field, mesh)

            def one(_, state=state, step=step, field=field, cam=cam,
                    box=box):
                (_, _), state[0], state[1] = step(
                    field, box.origin, box.spacing, cam, *state)

            profile_frames(f"{prefix}.profile", one)
        res[name] = dict(ms=ms, wall=wall, first_ms=run["ms"][0],
                         launches=sum_launches(run["launches"]
                                               + [run["seed_launches"]]),
                         k1=k1, k4=k4)
        del run, first, built
        torch.cuda.empty_cache()
    return res


def sum_launches(per_frame):
    out = collections.Counter()
    for x in per_frame:
        out.update(x)
    return dict(out)


def run_reuse_advancing(dev, profile=False):
    """Phase 11 (c): fragment reuse on the advancing low-slab field
    (`low_slab_state`), histogram then temporal thresholds, each against
    the same run with reuse off: the clean ranks and K1's launches a
    frame, ms a frame; histogram frames bit for bit, temporal ones at
    REUSE_PSNR_DB. Returns the summaries and the histogram reuse run's
    frames (host) for (e)."""
    import torch

    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume

    res, keep = {}, None
    for mode in ("histogram", "temporal"):
        runs = {}
        for reuse in (False, True):
            prefix = f"reuse_low_{mode}_{'on' if reuse else 'off'}"
            built = reuse_steps(dev, mode, reuse)
            st = low_slab_state(dev)
            box = Volume.centered(st.v, extent=2.0)
            run = reuse_frames(built, st, box.origin, box.spacing,
                               advance=True)
            k1 = [x["seg_fold_compact"] for x in run["launches"]]
            require_launched(sum_launches(run["launches"]
                                          + [run["seed_launches"]]),
                             DIST_KERNELS, prefix)
            clean = [None if d is None else RANKS - sum(d)
                     for d in run["dirty"]]
            log(f"{prefix}.frames", f"clean ranks {clean} K1 {k1} a frame")
            log(f"{prefix}.ms_per_frame", f"{frames_ms(run['ms'][1:]):.3f} "
                f"(median of frames 2-{REUSE_FRAMES}, CUDA events; host "
                f"clock {frames_ms(run['wall'][1:]):.3f}; every frame "
                f"{[round(x, 3) for x in run['ms']]})")
            runs[reuse] = run
            if profile and reuse and mode == "histogram":
                from scenery_insitu_tpu_torch.parallel.mesh import (
                    shard_volume)
                from scenery_insitu_tpu_torch.sim import grayscott as gs

                mesh, _, _, _, _, _, step, cam = built
                state = [run["st"], run["ru"]]

                def one(_, state=state, step=step, mesh=mesh, cam=cam,
                        box=box):
                    state[0] = gs.multi_step_fast(state[0], SIM_STEPS)
                    (_, _), state[1] = step(shard_volume(state[0].field,
                                                         mesh),
                                            box.origin, box.spacing, cam,
                                            state[1])

                profile_frames(f"{prefix}.profile", one)
            del built
        off, on = runs[False], runs[True]
        worst, gaps = math.inf, []
        for i, (a, b) in enumerate(zip(on["vdi"], off["vdi"])):
            dc, dd, same, share, exact = vdi_gap(a, b)
            gaps.append((exact, dc, dd))
            if mode == "histogram" and not exact:
                raise AssertionError(f"reuse_low_histogram: frame {i + 1} "
                                     f"differs from reuse off ({dc}, {dd})")
            psnr = image_psnr(render_vdi_same_view(a),
                              render_vdi_same_view(b))
            worst = min(worst, psnr)
        log(f"reuse_low_{mode}.vs_off", f"min_psnr_db={worst:.2f} "
            f"(bit_exact, colour, depth max diff) a frame "
            f"{[(e, float(f'{c:.3e}'), float(f'{d:.3e}')) for e, c, d in gaps]}")
        if mode == "temporal" and not worst >= REUSE_PSNR_DB:
            raise AssertionError(f"reuse_low_temporal: {worst:.2f} dB from "
                                 f"reuse off")
        res[mode] = dict(on_ms=frames_ms(on["ms"][1:]),
                         off_ms=frames_ms(off["ms"][1:]),
                         on_launches=sum_launches(on["launches"]
                                                  + [on["seed_launches"]]),
                         off_launches=sum_launches(off["launches"]
                                                   + [off["seed_launches"]]),
                         clean=[RANKS - sum(d) for d in on["dirty"]],
                         k1=[x["seg_fold_compact"] for x in on["launches"]],
                         psnr=worst)
        if mode == "histogram":
            keep = on["vdi"]
        del runs, off, on
        torch.cuda.empty_cache()
    return res, keep


class LowSlabSim:
    """A sim adapter over `low_slab_state`, advanced by K3."""

    kind = "gray_scott"

    def __init__(self, dev):
        self.state = low_slab_state(dev)

    def advance(self, n):
        from scenery_insitu_tpu_torch.sim import grayscott as gs

        self.state = gs.multi_step_fast(self.state, n)

    @property
    def field(self):
        return self.state.field


def run_reuse_session(dev):
    """Phase 11 (d): phase 7's session over 8 ranks with fragment reuse
    and ``obs.enabled`` on the advancing low-slab field, the camera
    still: a warm and 8 timed frames (host clock), the reuse counters
    and the last ``delta_dirty_tiles`` event, and its first 3 frames
    equal to the hand-driven reuse step bit for bit. Returns (launches,
    ms, counters)."""
    import numpy as np

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.runtime.session import InSituSession
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    cfg = session_config(GRID, ranks=RANKS).with_overrides(
        "composite.temporal_reuse=ranges", "obs.enabled=true")
    frames = {}
    cam0 = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    sim = LowSlabSim(dev)
    st0 = sim.state
    sess = InSituSession(cfg, camera=cam0, sim=sim,
                         sinks=[capture_into(frames)], device=dev)
    origin, spacing = sess._origin, sess._spacing
    kernels.reset_launches()
    sess.run(SESSION_WARM)
    before = phase_stats(sess.timers)
    ms, _ = timed_run(sess, SESSION_TIMED)
    launches = kernels.launches()
    log("session_reuse.launches", json.dumps(launches))
    require_launched(launches, DIST_KERNELS, "the reuse session")
    c = sess.obs.counters
    counters = {k: c.get(k, 0) for k in ("delta_march_skipped",
                                         "reuse_steps_built",
                                         "compile_step", "build_steps")}
    evs = [e for e in sess.obs.events if e.get("name") == "delta_dirty_tiles"]
    log("session_reuse.counters", json.dumps(counters) + " last "
        "delta_dirty_tiles " + json.dumps(evs[-1]["attrs"] if evs else None))
    if counters["reuse_steps_built"] < 1 or not evs:
        raise AssertionError("session_reuse: no reuse step or dirty event")
    log("session_reuse.ms_per_frame", f"{ms:.3f} (host clock, mean of "
        f"{SESSION_TIMED} frames after a warm one, every frame fetched; "
        f"phase 7's one-rank session "
        f"{SESSION_MS.get('session_nosinks', math.nan):.3f} without "
        f"sinks)")
    log_phase_stats("session_reuse", sess.timers, before)
    mesh = sess.mesh
    del sess

    spec = slicer.make_spec(cam0, (GRID,) * 3, cfg.slicer,
                            axis_sign=slicer.choose_axis(cam0),
                            multiple_of=RANKS)
    tf = for_dataset("gray_scott", device=dev)
    seed = dp.distributed_initial_threshold_mxu(mesh, tf, spec, cfg.vdi)
    rseed = dp.distributed_initial_reuse_mxu(mesh, tf, spec, cfg.vdi,
                                             cfg.composite)
    step = dp.distributed_vdi_step_mxu_temporal(mesh, tf, spec, cfg.vdi,
                                                cfg.composite)
    st, thr, ru, hand = st0, None, None, {}
    for i in range(3):
        st = gs.multi_step_fast(st, SIM_STEPS)
        field = shard_volume(st.field, mesh)
        if thr is None:
            thr = seed(field, origin, spacing, cam0)
            ru = rseed(field, origin, spacing, cam0)
        (vdi, _), thr, ru = step(field, origin, spacing, cam0, thr, ru)
        hand[i] = {"vdi_color": vdi.color.cpu().numpy(),
                   "vdi_depth": vdi.depth.cpu().numpy()}
    log("session_reuse.hand_dirty", f"{ru.dirty.tolist()} (frame 3)")
    check_frames_equal("session_reuse_vs_hand",
                       {i: frames[i] for i in hand}, hand)
    return launches, ms, counters


def run_delta_codec(vdis):
    """Phase 11 (e): the P-frame codec on (c)'s histogram reuse frames:
    each frame's RANKS column-block tiles quantized to qpack8 and
    encoded against the previous frame's (`ops/delta.DeltaEncoder`,
    I period DELTA_IFRAME), packed (`io/vdi_io.pack_delta_blobs`, zlib),
    unpacked and decoded bit for bit; the code bytes a frame against
    `ops/delta.modeled_delta_traffic` at the run's measured SKIP and P
    shares. Returns the summary."""
    import numpy as np

    from scenery_insitu_tpu_torch.io.vdi_io import (decompress,
                                                    delta_expected_bytes,
                                                    pack_delta_blobs,
                                                    unpack_delta_payload)
    from scenery_insitu_tpu_torch.ops import delta as dl
    from scenery_insitu_tpu_torch.ops.wire import qpack8_quantize_np

    enc, dec = dl.DeltaEncoder(DELTA_IFRAME), dl.DeltaDecoder()
    per_frame, modes = [], collections.Counter()
    full_total = wire_total = packed_total = 0
    changed = slots = 0
    t0 = time.perf_counter()
    for vdi in vdis:
        color, depth = vdi.color.numpy(), vdi.depth.numpy()
        w = color.shape[-1] // RANKS
        fb = wb = pb = 0
        for t in range(RANKS):
            cc, dd, near, far = qpack8_quantize_np(
                color[..., t * w:(t + 1) * w], depth[..., t * w:(t + 1) * w])
            rec = enc.encode(t, cc, dd, near, far)
            modes[rec.mode] += 1
            if rec.mode == "P":
                changed += rec.c_payload[2].size
                slots += cc.size
            h, cb, db = pack_delta_blobs(rec, codec="zlib")
            craw = decompress(cb, "zlib") if cb else b""
            draw = decompress(db, "zlib") if db else b""
            if (len(craw), len(draw)) != delta_expected_bytes(
                    h, cc.shape, dd.shape):
                raise AssertionError("delta_codec: blob byte counts")
            cp, dp_ = unpack_delta_payload(h, craw, draw, cc.shape,
                                           dd.shape)
            got = dec.apply(t, h["mode"], h["gen"], h["base"], cp, dp_,
                            rec.scale)
            if got is None or not (np.array_equal(got[0], cc)
                                   and np.array_equal(got[1], dd)):
                raise AssertionError(f"delta_codec: tile {t} does not "
                                     f"decode bit for bit")
            fb += rec.full_bytes
            wb += rec.wire_bytes
            pb += len(cb) + len(db)
        per_frame.append((fb, wb, pb))
        full_total += fb
        wire_total += wb
        packed_total += pb
    n = len(vdis) * RANKS
    k, _, h, wd = vdis[0].color.shape
    skip = modes["SKIP"] / n
    p = modes["P"] / n
    model = dl.modeled_delta_traffic(k, h, wd, skip_frac=skip, p_frac=p,
                                     residual_frac=(changed / slots
                                                    if slots else 0.0),
                                     iframe_period=DELTA_IFRAME)
    log("delta_codec.frames", json.dumps(
        [dict(full=f, wire=w, zlib=z) for f, w, z in per_frame]) +
        f" (code bytes a frame: qpack8 full, the records' wire bytes, "
        f"after zlib; modes {dict(modes)}; decoded bit for bit; "
        f"{time.perf_counter() - t0:.1f} s on the host)")
    log("delta_codec.vs_model", f"measured {wire_total / len(vdis):.0f} B "
        f"a frame of {full_total / len(vdis):.0f} (x"
        f"{full_total / max(wire_total, 1):.3f}); modelled "
        f"{model['delta_bytes_per_frame']:.0f} of "
        f"{model['qpack8_bytes_per_frame']} (x"
        f"{model['reduction_vs_qpack8']:.3f}) at skip {skip:.3f}, P "
        f"{p:.3f}, residual {model['residual_frac']:.4f}")
    return dict(modes=dict(modes), wire=wire_total / len(vdis),
                full=full_total / len(vdis), packed=packed_total / len(vdis),
                model=model["delta_bytes_per_frame"])


def run_phase11(dev, ref0, done, profile=False):
    """Phase 11: (a) the K budget, (b) reuse on the frozen field, (c)
    reuse on the advancing low-slab field, (d) the reuse session, (e)
    the P-frame codec; ``done(name)`` logs each part's wall time.
    Returns the summaries and every run's launches by configuration."""
    import torch

    out = {"kbudget": run_kbudget_frames(dev, ref0)}
    launches = {n: r["launches"] for n, r in out["kbudget"].items()}
    done("phase11.a")
    out["frozen"] = run_reuse_frozen(dev, ref0, profile)
    launches.update({n: r["launches"] for n, r in out["frozen"].items()})
    done("phase11.b")
    out["low"], vdis = run_reuse_advancing(dev, profile)
    for mode, r in out["low"].items():
        launches[f"low_{mode}_on"] = r["on_launches"]
        launches[f"low_{mode}_off"] = r["off_launches"]
    done("phase11.c")
    out["session"] = run_reuse_session(dev)
    launches["session_reuse"] = out["session"][0]
    torch.cuda.empty_cache()
    done("phase11.d")
    out["codec"] = run_delta_codec(vdis)
    del vdis
    done("phase11.e")
    out["launches"] = launches
    return out


# ------------------------------------------------------------ phase 12


# the bench's gather configuration (bench.py:180-184): 1280 x 720, 256
# samples a ray; the temporal mode is the slice march's, so histogram
# (bench.py:252-260)
GATHER_W, GATHER_H, GATHER_STEPS = 1280, 720, 256
# timed frames: cut from 3, 2 and 4 (with the sessions' PNGs every 4)
# when phase 18 came, to keep the whole run near its length before
GATHER_TIMED = 2
GATHER_DIST_TIMED = 1
GATHER_SESSION_TIMED = 2
GATHER_SESSION_EVERY = 2
# the reference's bars against the single-chip plain renders
# (tests/test_parallel.py:77-107, :206-236)
GATHER_VDI_DB, PLAIN_DB, PLAIN_MXU_DB = 25.0, 28.0, 32.0
PLAIN_BG = (0.1, 0.2, 0.3, 1.0)
# the golden configs of tests/golden/make_golden.py and
# tests/test_golden.py's bar (max 8-bit difference)
GOLDEN = dict(grid=32, w=96, h=72, seed=11, eye=(0.35, 0.55, 2.7), k=6,
              steps=96)
GOLDEN_BAR = 3.0
GOLDEN_NOVEL_EYE = (0.9, 0.15, 2.4)


def gather_vdi_cfg():
    from scenery_insitu_tpu_torch.config import VDIConfig

    return VDIConfig(max_supersegments=K, adaptive_iters=2,
                     adaptive_mode="histogram", histogram_bins=BINS)


def gather_step(dev, w=None, h=None, steps=None):
    """The bench's gather frame step (``SITPU_BENCH_ENGINE=gather``) at
    ``w`` x ``h`` and ``steps`` (None: the gather configuration's)."""
    from scenery_insitu_tpu_torch.config import CompositeConfig
    from scenery_insitu_tpu_torch.models.pipelines import \
        grayscott_vdi_frame_step

    w, h = w or GATHER_W, h or GATHER_H
    steps = steps or GATHER_STEPS
    return grayscott_vdi_frame_step(
        sim_steps=SIM_STEPS, vdi_cfg=gather_vdi_cfg(),
        comp_cfg=CompositeConfig(max_output_supersegments=K,
                                 adaptive_iters=2),
        engine="gather", width=w, height=h, max_steps=steps, device=dev)


def timed_frames(prefix, frame, state, warm, timed):
    """``warm`` then ``timed`` calls of ``state = frame(state, i)``, each
    timed call by CUDA events and the host clock; logs and returns the
    medians (ms) and the last state."""
    import torch

    for i in range(warm):
        state = frame(state, i)
    torch.cuda.synchronize()
    ev, wall = [], []
    for i in range(warm, warm + timed):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        a.record()
        state = frame(state, i)
        b.record()
        b.synchronize()
        wall.append((time.perf_counter() - h0) * 1e3)
        ev.append(a.elapsed_time(b))
    ev.sort()
    wall.sort()
    ms, wall_ms = ev[len(ev) // 2], wall[len(wall) // 2]
    FRAME_MS[prefix] = (ms, wall_ms)
    log(f"{prefix}.ms_per_frame", f"{ms:.3f} (median of {timed}, CUDA "
        f"events; host clock {wall_ms:.3f}; {warm} warm-up)")
    return ms, state


def require_only(launches, names, path):
    """Every kernel of ``names`` launched on ``path``, no other."""
    require_launched(launches, names, path)
    other = {k: n for k, n in launches.items() if n and k not in names}
    if other:
        raise AssertionError(f"{path} launched kernels it does not run: "
                             f"{other}")


def run_gather_frame(dev, profile=False):
    """Phase 12 (a): the single-chip gather frame at the bench's gather
    configuration (512^3 Gray-Scott, 10 sim steps, 1280 x 720, 256
    steps, K = 16, histogram with 16 bins), phase 3's oscillating eye: 1
    warm-up and 2 timed frames with the launch counts read from that run
    (K3 only: the march and its composite launch no kernel), the sim and
    the march timed apart, then the frame against the CPU's plain
    versions on a 32^3 grid. Returns the launch counts and the final
    state."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops.vdi_gen import generate_vdi
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    step = gather_step(dev)
    log("gather.config", f"grid={GRID}^3 image={GATHER_W}x{GATHER_H} "
        f"steps={GATHER_STEPS} k={K} histogram bins={BINS} "
        f"sim_steps={SIM_STEPS}")
    base = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    eye = lambda i: orbit(base, yaw_of(i)).eye
    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)

    def frame(s, i):
        color, depth, u, v = step(s[0], s[1], eye(i))
        return u, v, color, depth

    kernels.reset_launches()
    _, (u, v, color, depth) = timed_frames(
        "gather", frame, (st.u, st.v, None, None), 1, GATHER_TIMED)
    launches = kernels.launches()
    log("gather.launches", json.dumps(launches))
    require_only(launches, ("grayscott_fused",), "the gather frame")
    check_vdi("gather", VDI(color, depth), (K, 4, GATHER_H, GATHER_W),
              (K, 2, GATHER_H, GATHER_W))
    del color, depth
    sim_ms = median_ms(lambda _: gs.multi_step_fast(
        gs.GrayScott(u, v, st.params), SIM_STEPS), GATHER_TIMED)
    log("gather.sim_ms", f"{sim_ms:.3f}")
    tf = for_dataset("gray_scott", device=dev)
    vol = Volume.centered(v, extent=2.0)
    cam = Camera.create(eye(0), fov_y_deg=50.0, near=0.5, far=20.0,
                        device=dev)
    march_ms = median_ms(lambda _: generate_vdi(
        vol, tf, cam, GATHER_W, GATHER_H, gather_vdi_cfg(),
        max_steps=GATHER_STEPS), GATHER_TIMED)
    log("gather.march_ms", f"{march_ms:.3f} (median of {GATHER_TIMED} "
        f"marches alone: the histogram's counting march and the write "
        f"march, {2 * GATHER_STEPS} steps)")
    if profile:
        state = [u, v]

        def one(i):
            _, _, state[0], state[1] = step(*state, eye(i))

        profile_frames("gather.profile", one)
    check_small_gather_frame(dev)
    return launches, (u, v)


def check_small_gather_frame(dev):
    """The gather frame on the card against the CPU's plain versions: 3
    frames of a 32^3 grid at 96 x 72, 64 steps."""
    import torch

    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    n = 32
    st = gs.GrayScott.init((n,) * 3, seed=SEED, device="cpu")
    base = Camera.create(BASE_EYE, device="cpu")
    outs = {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        step = gather_step(d, 96, 72, 64)
        u, v = st.u.to(d), st.v.to(d)
        imgs = []
        for i in range(3):
            color, depth, u, v = step(u, v, orbit(base, yaw_of(i)).eye.to(d))
            imgs.append(render_vdi_same_view(VDI(color, depth)).cpu())
        outs[name] = torch.stack(imgs)
    small_gate("small_gather", outs["cuda"], outs["cpu"])


def small_gate(prefix, got, want, tol=1e-4):
    """A small run on the card against the CPU's: images within ``tol``
    (largest and mean absolute difference)."""
    diff = (got - want).abs()
    log(f"{prefix}.image_max_abs_diff", f"{float(diff.max()):.3e}")
    log(f"{prefix}.image_mean_abs_diff", f"{float(diff.mean()):.3e}")
    if not (float(diff.max()) <= tol and float(diff.mean()) <= tol):
        raise AssertionError(f"{prefix}: the card's run differs from the "
                             f"CPU's plain versions")


def plain_reference(vol, tf, cam, dev, bg=(0.0, 0.0, 0.0, 0.0)):
    """The single-chip plain raycast at the gather configuration, early
    exit off, as the reference's parity tests render it."""
    from scenery_insitu_tpu_torch.config import RenderConfig
    from scenery_insitu_tpu_torch.ops.raycast import raycast

    return raycast(vol, tf, cam, GATHER_W, GATHER_H, RenderConfig(
        max_steps=GATHER_STEPS, early_exit_alpha=1.1, background=bg)).image


def run_gather_dist(dev, state, profile=False):
    """Phase 12 (b) and (c) on phase 4's 8-rank mesh at the gather
    configuration, from phase 12 (a)'s final state: (b) the gather
    `distributed_vdi_step` (phase 4's composite: K_out 16, a 6-step
    search), 1 warm-up and 1 timed frame, K4 once per rank and frame,
    its same-view image >= 25 dB from the single-chip plain raycast at
    that state and eye; (c) `distributed_plain_step` (>= 28 dB from the
    raycast) and `distributed_plain_step_mxu` warped to the display
    camera (>= 32 dB from `slicer.raycast_mxu`), 1 warm-up and 1 timed
    frame each, launching no kernel. K4 is then held against its plain
    version on (b)'s own streams (`gather_k4`). Returns the launch
    counts of (b) and `gather_k4`'s numbers."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 RenderConfig,
                                                 SliceMarchConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import make_mesh, shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    u, v = state
    mesh = make_mesh(RANKS, device=dev)
    tf = for_dataset("gray_scott", device=dev)
    box = Volume.centered(v, extent=2.0)
    origin, spacing = box.origin, box.spacing
    base = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    camera = lambda i: Camera.create(orbit(base, yaw_of(i)).eye,
                                     fov_y_deg=50.0, near=0.5, far=20.0,
                                     device=dev)
    params = gs.GrayScottParams.create(device=dev)
    ccfg = CompositeConfig(max_output_supersegments=K_OUT,
                           adaptive_iters=COMP_ITERS)
    step = dp.distributed_vdi_step(mesh, tf, GATHER_W, GATHER_H,
                                   gather_vdi_cfg(), ccfg,
                                   max_steps=GATHER_STEPS)
    log("gather_dist.config", f"ranks={RANKS} image={GATHER_W}x{GATHER_H} "
        f"steps={GATHER_STEPS} k={K} k_out={K_OUT} "
        f"composite_iters={COMP_ITERS}")

    def frame(s, i):
        st = gs.multi_step_fast(gs.GrayScott(s[0], s[1], params), SIM_STEPS)
        vdi = step(shard_volume(st.field, mesh), origin, spacing, camera(i))
        return st.u, st.v, vdi

    kernels.reset_launches()
    _, (u, v, vdi) = timed_frames("gather_dist", frame, (u, v, None), 1,
                                  GATHER_DIST_TIMED)
    launches = kernels.launches()
    log("gather_dist.launches", json.dumps(launches))
    frames = 1 + GATHER_DIST_TIMED
    require_only(launches, ("grayscott_fused", "resegment_sorted"),
                 "the gather distributed frame")
    if launches["resegment_sorted"] != RANKS * frames:
        raise AssertionError(f"K4 launched {launches['resegment_sorted']} "
                             f"times in {frames} frames of {RANKS} ranks")
    check_vdi("gather_dist", vdi, (K_OUT, 4, GATHER_H, GATHER_W),
              (K_OUT, 2, GATHER_H, GATHER_W))
    cam = camera(frames - 1)
    vol = Volume.centered(v, extent=2.0)
    slabs = shard_volume(v, mesh)
    ref = plain_reference(vol, tf, cam, dev)
    psnr_gate("gather_dist", image_psnr(render_vdi_same_view(vdi), ref),
              GATHER_VDI_DB, "the single-chip plain raycast")
    k4 = gather_k4(dp, mesh, tf, v, origin, spacing, cam, ccfg, vdi)
    del vdi
    if profile:
        state = [u, v]

        def one(i):
            state[0], state[1], _ = frame(state, i)

        profile_frames("gather_dist.profile", one, frames=1)

    # (c) the plain steps: no kernel of the port runs in them
    rcfg = RenderConfig(max_steps=GATHER_STEPS, early_exit_alpha=1.1)
    plain = dp.distributed_plain_step(mesh, tf, GATHER_W, GATHER_H, rcfg)
    spec = slicer.make_spec(base, (GRID,) * 3,
                            SliceMarchConfig(chunk=CHUNK), multiple_of=RANKS)
    plain_mxu = dp.distributed_plain_step_mxu(mesh, tf, spec)
    args = (slabs, origin, spacing, cam)
    kernels.reset_launches()
    _, img = timed_frames("plain_dist", lambda s, i: plain(*args), None, 1,
                          1)
    psnr_gate("plain_dist", image_psnr(img, ref), PLAIN_DB,
              "the single-chip plain raycast")
    del img, ref

    def mxu_frame(s, i):
        img, axcam = plain_mxu(*args)
        return slicer.warp_to_camera(img, axcam, spec, cam, GATHER_W,
                                     GATHER_H, PLAIN_BG)

    log("plain_mxu_dist.spec", spec)
    _, img = timed_frames("plain_mxu_dist", mxu_frame, None, 1, 1)
    ref = slicer.raycast_mxu(vol, tf, cam, GATHER_W, GATHER_H, spec,
                             background=PLAIN_BG).image
    psnr_gate("plain_mxu_dist", image_psnr(img, ref), PLAIN_MXU_DB,
              "the single-chip slice-march plain render")
    plain_launches = kernels.launches()
    log("plain_dist.launches", json.dumps(plain_launches))
    if any(plain_launches.values()):
        raise AssertionError(f"the plain steps launched kernels: "
                             f"{plain_launches}")
    del img, ref, slabs, args
    torch.cuda.empty_cache()
    check_small_gather_dist(dev)
    return launches, k4


def gather_k4(dp, mesh, tf, v, origin, spacing, cam, ccfg, vdi):
    """K4 on the 8-rank gather step's own streams (128 slots a pixel on
    720 x 160 column blocks): the last frame's rank fragments, marched
    as the step marches them, exchanged and sorted as its composite
    sorts them. Their resegment must give the step's VDI bit for bit
    (so these are the main path's streams); then K4 against its plain
    version on the fullest (thresholds and live slots exact, colour and
    depth within 1e-6) and a frame's 8 launches timed beside their
    bound. Returns (max_abs_err, ms, bound_ms, bound_by)."""
    import torch

    from scenery_insitu_tpu_torch.ops.composite import (resegment_stream,
                                                        sort_stream)
    from scenery_insitu_tpu_torch.ops.vdi_gen import generate_vdi
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume

    slabs = shard_volume(v, mesh)
    rows = dp.halo_exchange_z(slabs)
    colors, depths = [], []
    for r in range(RANKS):
        vol, cmin, cmax, _, gmax = dp._local_volume_and_clip(
            slabs, rows, r, origin, spacing)
        frag, _ = generate_vdi(vol, tf, cam, GATHER_W, GATHER_H,
                               gather_vdi_cfg(), max_steps=GATHER_STEPS,
                               clip_min=cmin, clip_max=cmax,
                               sample_min=origin, sample_max=gmax)
        colors.append(frag.color)
        depths.append(frag.depth)
    del slabs, rows, frag
    rc, rd = dp._exchange_vdi_columns(torch.stack(colors),
                                      torch.stack(depths), RANKS)
    del colors, depths
    _, _, k, _, h, w = rc.shape
    streams = [sort_stream(rc[j].reshape(RANKS * k, 4, h, w),
                           rd[j].reshape(RANKS * k, 2, h, w))
               for j in range(RANKS)]
    del rc, rd
    blocks = [resegment_stream(sc, sd, ccfg) for sc, sd in streams]
    same = (torch.equal(torch.cat([b.color for b in blocks], -1), vdi.color)
            and torch.equal(torch.cat([b.depth for b in blocks], -1),
                            vdi.depth))
    del blocks
    log("gather_dist.k4_streams", f"{len(streams)} streams of "
        f"{RANKS * k}x{h}x{w}; their resegment is the step's VDI bit for "
        f"bit: {same}")
    if not same:
        raise AssertionError("gather_dist: the rebuilt streams do not "
                             "resegment to the step's VDI")
    err = check_k4_on("gather_dist.resegment", streams)
    ms, b, by = k4_streams_ms("gather_dist", streams)
    del streams
    torch.cuda.empty_cache()
    return err, ms, b, by


def psnr_gate(prefix, db, bar, what):
    log(f"{prefix}.psnr_db", f"{db:.2f} (against {what}; bar {bar})")
    if not db >= bar:
        raise AssertionError(f"{prefix}: {db:.2f} dB from {what}, below "
                             f"the reference's {bar} dB")


def check_small_gather_dist(dev):
    """The gather distributed step on the card against the CPU's plain
    versions at 32^3 over 4 ranks, 96 x 72 and 64 steps: the ring in
    tile waves, and the 2 x 2 topology."""
    import torch

    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 MeshConfig, TopologyConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.parallel.topology import make_topology_mesh
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    n = 32
    v0 = gs.multi_step(gs.GrayScott.init((n,) * 3, seed=SEED, device="cpu"),
                       2 * SIM_STEPS).v
    box = Volume.centered(v0, extent=2.0)
    configs = {"ring_waves": (None, dict(exchange="ring", schedule="waves",
                                         wave_tiles=2)),
               "hier_2x2": (TopologyConfig(num_hosts=2), {})}
    for name, (topo, comp) in configs.items():
        outs = {}
        for where, d in (("cuda", dev), ("cpu", "cpu")):
            mesh, _ = make_topology_mesh(topo, MeshConfig(
                num_devices=SMALL_RANKS), device=d)
            step = dp.distributed_vdi_step(
                mesh, for_dataset("gray_scott", device=d), 96, 72,
                gather_vdi_cfg(), CompositeConfig(
                    max_output_supersegments=K_OUT,
                    adaptive_iters=COMP_ITERS, **comp), max_steps=64,
                topology=topo)
            cam = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5,
                                far=20.0, device=d)
            vdi = step(shard_volume(v0.to(d), mesh), box.origin.to(d),
                       box.spacing.to(d), cam)
            outs[where] = render_vdi_same_view(vdi).cpu()
        small_gate(f"small_gather_{name}", outs["cuda"], outs["cpu"])


def run_gather_sessions(dev):
    """Phase 12 (d): phase 7's session over 8 ranks in the plain
    slice-march mode and the gather VDI mode (1280 x 720; 256 steps), a
    warm frame and 2 timed frames each with a PNG sink every 2 frames,
    the first 2 frames bit for bit against the hand-driven step and the
    PNG equal to the plain payload's display pixels. Returns each
    mode's launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.camera import orbit
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import make_mesh, shard_volume
    from scenery_insitu_tpu_torch.runtime.session import png_sink
    from scenery_insitu_tpu_torch.sim import grayscott as gs
    from scenery_insitu_tpu_torch.utils.image import load_png, to_display

    modes = {
        "plain_mxu": ("runtime.generate_vdis=false",),
        "gather_vdi": ("slicer.engine=gather", "vdi.adaptive_mode=histogram"),
    }
    out_launches = {}
    for name, extra in modes.items():
        prefix = f"session_{name}"
        cfg = session_config(GRID, ranks=RANKS).with_overrides(
            f"render.width={GATHER_W}", f"render.height={GATHER_H}",
            f"render.max_steps={GATHER_STEPS}", *extra)
        out = tempfile.mkdtemp(prefix="chip_smoke_gather_")
        try:
            frames = {}
            sess = session(dev, cfg, [png_sink(out,
                                               every=GATHER_SESSION_EVERY),
                                      capture_into(frames)])
            st0 = sess.sim.state
            u0, v0, cam0 = st0.u.clone(), st0.v.clone(), sess.camera
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.run(1)
            torch.cuda.synchronize()
            log(f"{prefix}.warm_s", f"{time.perf_counter() - t0:.3f}")
            before = phase_stats(sess.timers)
            ms, _ = timed_run(sess, GATHER_SESSION_TIMED)
            launches = kernels.launches()
            log(f"{prefix}.launches", json.dumps(launches))
            log(f"{prefix}.mode", f"{sess.mode} engine={sess.engine}")
            SESSION_MS[prefix] = ms
            log(f"{prefix}.ms_per_frame", f"{ms:.3f} (host clock, mean of "
                f"{GATHER_SESSION_TIMED} frames after a warm one, a PNG "
                f"every {GATHER_SESSION_EVERY})")
            log_phase_stats(prefix, sess.timers, before)
            if name == "gather_vdi":
                require_only(launches, ("grayscott_fused",
                                        "resegment_sorted"), prefix)
                if launches["resegment_sorted"] != RANKS * (
                        1 + GATHER_SESSION_TIMED):
                    raise AssertionError(f"{prefix}: K4 launched "
                                         f"{launches['resegment_sorted']}"
                                         f" times")
            else:
                require_only(launches, ("grayscott_fused",), prefix)
            out_launches[name] = launches
            del sess

            # the first 2 frames driven by hand
            mesh = make_mesh(RANKS, device=dev)
            tf = for_dataset("gray_scott", device=dev)
            vox = 2.0 / GRID
            origin = torch.full((3,), -GRID * vox / 2, dtype=torch.float32,
                                device=dev)
            spacing = torch.full((3,), vox, dtype=torch.float32,
                                 device=dev)
            r = cfg.render
            if name == "gather_vdi":
                step = dp.distributed_vdi_step(
                    mesh, tf, r.width, r.height, cfg.vdi, cfg.composite,
                    max_steps=r.max_steps)

                def hand_frame(field, cam):
                    vdi = step(field, origin, spacing, cam)
                    return {"vdi_color": vdi.color.cpu().numpy(),
                            "vdi_depth": vdi.depth.cpu().numpy()}
            else:
                spec = slicer.make_spec(cam0, (GRID,) * 3, cfg.slicer,
                                        axis_sign=slicer.choose_axis(cam0),
                                        multiple_of=RANKS)
                step = dp.distributed_plain_step_mxu(mesh, tf, spec, r)

                def hand_frame(field, cam):
                    img, axcam = step(field, origin, spacing, cam)
                    return {"image": slicer.warp_to_camera(
                        img, axcam, spec, cam, r.width, r.height,
                        r.background).cpu().numpy()}
            st = gs.GrayScott(u0, v0, st0.params)
            cam, hand = cam0, {}
            for i in range(2):
                st = gs.multi_step_fast(st, SIM_STEPS)
                hand[i] = hand_frame(shard_volume(st.field, mesh), cam)
                cam = orbit(cam, np.float32(SESSION_ORBIT))
            del st
            for i in hand:
                for key, want in hand[i].items():
                    if not np.array_equal(frames[i][key], want):
                        raise AssertionError(f"{prefix}: frame {i} {key} "
                                             f"differs from the hand-driven "
                                             f"step")
            log(f"{prefix}_vs_hand.bit_exact", f"frames {sorted(hand)}")
            pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
            log(f"{prefix}.pngs", pngs)
            if len(pngs) != 2:
                raise AssertionError(f"{prefix}: expected 2 PNGs, got {pngs}")
            if name == "plain_mxu":
                got = load_png(os.path.join(out, "frame00000.png"))
                if not np.array_equal(got, to_display(frames[0]["image"])):
                    raise AssertionError(f"{prefix}: the PNG sink's pixels "
                                         f"differ from the plain image's")
                log(f"{prefix}.png", f"frame00000.png {got.shape} equals "
                    f"the plain payload's display pixels")
            del frames, hand
        finally:
            shutil.rmtree(out, ignore_errors=True)
        torch.cuda.empty_cache()
    return out_launches


def check_goldens(dev):
    """Phase 12 (e): the committed golden images of the gather raycast,
    the slice-march plain render and the gather VDI's same-view decode,
    rendered on the card from their configs, within the golden test's
    bar (max 8-bit difference)."""
    from scenery_insitu_tpu_torch.config import (RenderConfig,
                                                 SliceMarchConfig, VDIConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import procedural_volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops.raycast import raycast
    from scenery_insitu_tpu_torch.ops.vdi_gen import generate_vdi
    from scenery_insitu_tpu_torch.utils.image import load_png, to_display

    g = GOLDEN
    vol = procedural_volume(g["grid"], kind="blobs", seed=g["seed"],
                            device=dev)
    tf = for_dataset("procedural", device=dev)
    cam = Camera.create(g["eye"], fov_y_deg=50.0, near=0.3, far=20.0,
                        device=dev)
    white = (1.0, 1.0, 1.0, 1.0)
    spec = slicer.make_spec(cam, tuple(vol.data.shape),
                            SliceMarchConfig(matmul_dtype="f32", fold="xla"))
    vdi, _ = generate_vdi(vol, tf, cam, g["w"], g["h"],
                          VDIConfig(max_supersegments=g["k"],
                                    adaptive_iters=4), max_steps=g["steps"])
    images = {
        "raycast_gather": raycast(vol, tf, cam, g["w"], g["h"], RenderConfig(
            max_steps=g["steps"], background=white)).image,
        "raycast_mxu": slicer.raycast_mxu(vol, tf, cam, g["w"], g["h"], spec,
                                          background=white).image,
        "vdi_gather_decode": render_vdi_same_view(vdi, background=white)}
    root = os.path.dirname(os.path.abspath(__file__))
    for name, img in images.items():
        want = load_png(os.path.join(root, "tests", "golden",
                                     f"golden_{name}.png")).astype("float32")
        got = to_display(img.cpu().numpy()).astype("float32")
        gap = float(abs(got - want).max())
        log(f"golden_{name}.max_8bit_diff", f"{gap:.1f} (bar {GOLDEN_BAR})")
        if not gap <= GOLDEN_BAR:
            raise AssertionError(f"golden {name}: max 8-bit difference "
                                 f"{gap} > {GOLDEN_BAR}")


def run_phase12(dev, done, profile=False):
    """Phase 12 (a)-(e); returns the launch counts of each path."""
    t12 = time.perf_counter()
    frame_launches, state = run_gather_frame(dev, profile)
    done("phase12.a")
    dist_launches, gather_k4_nums = run_gather_dist(dev, state, profile)
    del state
    done("phase12.bc")
    session_launches = run_gather_sessions(dev)
    done("phase12.d")
    check_goldens(dev)
    log("phase12.wall_s", f"{time.perf_counter() - t12:.1f} (the gather "
        f"engine and the plain images)")
    return dict(frame=frame_launches, dist=dist_launches,
                sessions=session_launches, gather_k4=gather_k4_nums)


# ------------------------------------------------------------ phase 13

# the novel views of the default frame's VDI at the display camera
NOVEL_W, NOVEL_H = GATHER_W, GATHER_H
NOVEL_FRAMES = 2            # default frames run before the VDI is kept
NOVEL_YAWS = (0.0, 0.12, -0.2)      # same-regime eyes about the frame's
NOVEL_CROSS_EYE = (3.0, 0.6, 0.4)   # an x march: the proxy's regime
NOVEL_BATCH = 8
NOVEL_TIMED = 3
NOVEL_GATHER_STEPS = 512    # the gather renderer, the quality reference
# the reference tests' bars (tests/test_vdi_novel.py, tests/test_ao.py)
NOVEL_DB, NOVEL_REC_DB, NOVEL_CROSS_DB = 25.0, 40.0, 24.0
AO_RADIUS, AO_STRENGTH, AO_DB = 4, 0.8, 24.0
AO_GATHER_STEPS = 512
AO_DIST_RTOL, AO_DIST_ATOL = 1e-4, 2e-5
BATCH_GATE = 1e-5


def timed_view(prefix, view, reps=NOVEL_TIMED, warm=True):
    """`timed_frames` of a stateless ``view()``: (ms, its last output)."""
    return timed_frames(prefix, lambda _, i: view(), None, int(warm), reps)


def img_psnr(a, b) -> float:
    """The reference tests' PSNR of two premultiplied images (peak 1)."""
    from scenery_insitu_tpu_torch.utils.image import psnr

    return psnr(a.detach().cpu().numpy(), b.detach().cpu().numpy())


def novel_state(dev):
    """Phase 13's input through the main path: phase 3's frame step
    (512^3 Gray-Scott, temporal thresholds) from the seeded init for
    NOVEL_FRAMES frames, its launch counts read from that run (K3
    advances the sim, K2 seeds the thresholds, K1 folds). Returns the
    last frame's VDI with the virtual camera and metadata of its march
    (rebuilt from the same volume, camera and spec), the field and the
    launch counts."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.models.pipelines import \
        grayscott_vdi_frame_step
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    base = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    step = grayscott_vdi_frame_step(grid_shape=(GRID,) * 3,
                                    axis_sign=slicer.choose_axis(base),
                                    **frame_config(dev))
    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    u, v = st.u, st.v
    eye = lambda i: orbit(base, yaw_of(i)).eye
    kernels.reset_launches()
    thr = step.init_threshold(u, v, eye(-1))
    for i in range(NOVEL_FRAMES):
        color, depth, u, v, thr = step(u, v, eye(i), thr)
    torch.cuda.synchronize()
    launches = kernels.launches()
    log("novel.state_launches", json.dumps(launches))
    require_only(launches, FRAME_KERNELS, "phase 13's default frames")
    spec = step.spec
    vol = Volume.centered(v, extent=2.0)
    cam = Camera.create(eye(NOVEL_FRAMES - 1), fov_y_deg=50.0, near=0.5,
                        far=20.0, device=dev)
    axcam = slicer.make_axis_camera(vol, cam, spec)
    meta = slicer._vdi_meta(vol, axcam, spec.ni, spec.nj)
    vdi = VDI(color, depth)
    check_vdi("novel.vdi", vdi, (K, 4, spec.nj, spec.ni),
              (K, 2, spec.nj, spec.ni))
    return dict(vdi=vdi, meta=meta, axcam=axcam, spec=spec, cam=cam, v=v,
                launches=launches)


def run_novel_views(dev, s, profile=False):
    """Phase 13 (a): novel views of the frame's VDI at 1280 x 720. The
    plane sweep (`render_vdi_mxu`, every one of the volume's 512 slice
    planes) at the three same-regime eyes of NOVEL_YAWS, each >= 25 dB
    from the gather renderer (`vdi_render.render_vdi`, 512 steps), the
    frame's own view also >= 25 dB from the VDI's same-view decode
    warped to the display (`core/vdi.render_vdi_same_view`), and the
    camera rebuilt from the metadata alone >= 40 dB from the stored
    one; across regimes (an x march) the pre-shaded proxy, built once
    (its bytes logged), marched by `render_vdi_any` >= 24 dB from the
    gather renderer and its same view >= 24 dB from the decode; the
    exact renderer, the proxy >= 24 dB from it; `render_vdi_batch` over
    8 cameras (sweep tier) against the 8 single renders. No kernel."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.config import SliceMarchConfig
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops import vdi_novel as nv
    from scenery_insitu_tpu_torch.ops.vdi_render import render_vdi

    vdi, axcam, spec, meta = s["vdi"], s["axcam"], s["spec"], s["meta"]
    w, h = NOVEL_W, NOVEL_H
    kernels.reset_launches()
    cams = [orbit(s["cam"], y) for y in NOVEL_YAWS]
    regime = slicer.choose_axis(cams[0])
    if any(slicer.choose_axis(c) != regime for c in cams) or \
            regime[0] != spec.axis:
        raise AssertionError("phase 13's same-regime eyes left the regime")
    log("novel.config", f"vdi {spec.ni}x{spec.nj} k={K} planes={GRID} "
        f"display {w}x{h} yaws={NOVEL_YAWS} gather_steps="
        f"{NOVEL_GATHER_STEPS}")
    decode = slicer.warp_to_camera(render_vdi_same_view(vdi), axcam, spec,
                                   s["cam"], w, h)
    sweep = lambda c, ax=axcam, sp=spec: nv.render_vdi_mxu(
        vdi, ax, sp, c, w, h, num_slices=GRID, axis_sign=regime)
    for i, cam in enumerate(cams):
        _, img = timed_view(f"novel.mxu_{i}", lambda: sweep(cam))
        if not bool(torch.isfinite(img).all()):
            raise AssertionError("novel view is not finite")
        _, ref = timed_view(f"novel.gather_{i}", lambda: render_vdi(
            vdi, meta, cam, w, h, steps=NOVEL_GATHER_STEPS), reps=1,
            warm=False)
        psnr_gate(f"novel.mxu_{i}", img_psnr(img, ref), NOVEL_DB,
                  "the gather renderer")
        if i == 0:
            psnr_gate("novel.mxu_same_view", img_psnr(img, decode),
                      NOVEL_DB, "the same-view decode")
    spec_m = nv.axis_spec_from_meta(meta, chunk=spec.chunk)
    rec = nv.axis_camera_from_meta(meta, spec_m)
    psnr_gate("novel.rebuilt_camera", img_psnr(
        nv.render_vdi_mxu(vdi, rec, spec_m, cams[1], w, h, num_slices=GRID,
                          axis_sign=regime), sweep(cams[1])), NOVEL_REC_DB,
        "the stored camera's view")
    if profile:
        profile_frames("novel.mxu.profile", lambda i: sweep(cams[1]))

    # across regimes: the proxy, built once
    cam_x = Camera.create(NOVEL_CROSS_EYE, fov_y_deg=50.0, near=0.5,
                          far=20.0, device=dev)
    if slicer.choose_axis(cam_x)[0] == spec.axis:
        raise AssertionError("phase 13's cross-regime eye marches the "
                             "VDI's own axis")
    nbytes = 16 * GRID * spec.nj * spec.ni
    log("novel.proxy_bytes", f"{nbytes} ({nbytes / 2**30:.3f} GiB: 4 "
        f"channels x f32 x {GRID} planes x {spec.nj} x {spec.ni})")
    _, proxy = timed_view("novel.proxy_build", lambda: nv.vdi_to_rgba_volume(
        vdi, axcam, spec, num_slices=GRID), reps=1, warm=False)
    _, img_x = timed_view("novel.any", lambda: nv.render_vdi_any(
        vdi, axcam, spec, cam_x, w, h, num_slices=GRID, proxy=proxy))
    _, ref_x = timed_view("novel.gather_x", lambda: render_vdi(
        vdi, meta, cam_x, w, h, steps=NOVEL_GATHER_STEPS), reps=1,
        warm=False)
    psnr_gate("novel.any", img_psnr(img_x, ref_x), NOVEL_CROSS_DB,
              "the gather renderer")
    spec_p = slicer.make_spec(s["cam"], tuple(proxy.data.shape[-3:]),
                              SliceMarchConfig(chunk=CHUNK))
    same = nv.render_vdi_proxy(proxy, s["cam"], w, h, spec_p)
    psnr_gate("novel.proxy_same_view", img_psnr(same, decode),
              NOVEL_CROSS_DB, "the same-view decode")
    del same, decode
    if profile:
        profile_frames("novel.any.profile", lambda i: nv.render_vdi_any(
            vdi, axcam, spec, cam_x, w, h, num_slices=GRID, proxy=proxy))
    _, exact = timed_view("novel.exact", lambda: nv.render_vdi_exact(
        vdi, axcam, spec, cam_x, w, h), reps=1, warm=False)
    if not bool(torch.isfinite(exact).all()):
        raise AssertionError("the exact view is not finite")
    psnr_gate("novel.proxy_vs_exact", img_psnr(img_x, exact),
              NOVEL_CROSS_DB, "the exact renderer")
    del proxy, exact
    torch.cuda.empty_cache()

    # the batch: 8 cameras of one regime, one call
    yaws = [-0.2 + 0.4 * i / (NOVEL_BATCH - 1) for i in range(NOVEL_BATCH)]
    bcams = [orbit(s["cam"], y) for y in yaws]
    batch = nv.stack_cameras(bcams)
    ms_b, out = timed_view("novel.batch", lambda: nv.render_vdi_batch(
        vdi, axcam, spec, batch, w, h, tier="sweep", num_slices=GRID,
        axis_sign=regime), reps=1)
    gap = max(float((out[i] - sweep(c)).abs().max())
              for i, c in enumerate(bcams))
    log("novel.batch_vs_single_max_abs", f"{gap:.3e} (bound {BATCH_GATE}; "
        f"{ms_b / NOVEL_BATCH:.3f} ms a view)")
    if not gap <= BATCH_GATE:
        raise AssertionError(f"render_vdi_batch differs from the single "
                             f"renders by {gap}")
    launches = kernels.launches()
    log("novel.views_launches", json.dumps(launches))
    require_only(launches, (), "the novel views")
    return launches


def run_preshaded(dev, s, profile=False):
    """Phase 13 (b): the pre-shaded march on the frame's 512^3 field.
    `shade_volume_ao` (2 GiB out), `raycast_mxu` of it at 1280 x 720
    >= 24 dB from the gather AO render (512 steps); `generate_vdi_mxu`
    of it under ``fold="auto"`` (K2 seeds, K1 folds: both launched),
    then K1 and K2 held against their plain versions on this march's
    own chunks (start counts and K2's counts exact, colour and depth
    within 1e-6); the pre-shaded pyramid on the card skips the chunks
    it skips on the CPU. Returns (launch counts, the shaded volume)."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.config import (RenderConfig,
                                                 SliceMarchConfig, VDIConfig)
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import ao
    from scenery_insitu_tpu_torch.ops import cuda_march as cm
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs
    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops import supersegments as ss
    from scenery_insitu_tpu_torch.ops.raycast import raycast

    w, h = NOVEL_W, NOVEL_H
    tf = for_dataset("gray_scott", device=dev)
    vol = Volume.centered(s["v"], extent=2.0)
    cam = s["cam"]
    white = (1.0, 1.0, 1.0, 1.0)
    _, shaded = timed_view("preshaded.shade", lambda: ao.shade_volume_ao(
        vol, tf, AO_RADIUS, AO_STRENGTH), reps=1, warm=False)
    log("preshaded.bytes", f"{shaded.data.numel() * 4} (radius "
        f"{AO_RADIUS}, strength {AO_STRENGTH})")
    spec = slicer.make_spec(cam, (GRID,) * 3, SliceMarchConfig(chunk=CHUNK))
    log("preshaded.spec", spec)
    kernels.reset_launches()
    _, img = timed_view("preshaded.raycast_mxu", lambda: slicer.raycast_mxu(
        shaded, None, cam, w, h, spec, background=white).image)
    _, ref = timed_view("preshaded.gather_ao", lambda: raycast(
        vol, tf, cam, w, h, RenderConfig(max_steps=AO_GATHER_STEPS,
                                         background=white),
        ao_field=ao.ao_field_volume(vol, tf, AO_RADIUS, AO_STRENGTH)).image,
        reps=1, warm=False)
    psnr_gate("preshaded.raycast_mxu", img_psnr(img, ref), AO_DB,
              "the gather AO render")
    del img, ref
    if profile:
        profile_frames("preshaded.profile", lambda i: slicer.raycast_mxu(
            shaded, None, cam, w, h, spec))

    vcfg = VDIConfig(max_supersegments=K, adaptive_mode="histogram",
                     histogram_bins=BINS)
    _, (vdi, _, axcam) = timed_view(
        "preshaded.generate", lambda: slicer.generate_vdi_mxu(
            shaded, None, cam, spec, vcfg), reps=1)
    launches = kernels.launches()
    log("preshaded.launches", json.dumps(launches))
    require_only(launches, ("seg_fold_compact", "count_multi"),
                 "the pre-shaded VDI march")
    check_vdi("preshaded.vdi", vdi, (K, 4, spec.nj, spec.ni),
              (K, 2, spec.nj, spec.ni))

    # K2 and K1 on this march's own chunks, against their plain versions
    volp = slicer.permute_volume(shaded, spec)
    pyr = occ.pyramid_from_volume(shaded, None, spec, volp=volp)
    gate = pyr.gate(spec)
    chunks = []

    def keep(carry, rgba, sk0, sk1):
        chunks.append((rgba.clone(), sk0.clone(), sk1.clone()))
        return carry

    slicer.slice_march(shaded, None, axcam, spec, keep, None, occupancy=gate,
                       volp=volp, shaded_compact=True)
    del volp
    nj, ni = spec.nj, spec.ni
    tvec = ss.threshold_candidates(BINS, device=dev)
    init_c = lambda: cm.init_count_multi_packed(BINS, nj, ni, device=dev)
    got_c = count_chunks(cm.count_multi_chunk, init_c(), chunks, tvec)
    want_c = count_chunks(cm.count_multi_chunk_plain, init_c(), chunks, tvec)
    count_err = check_counts("preshaded.count_chunks", got_c, want_c)
    thr = ss.pick_threshold(got_c[0], tvec, K)
    if not torch.equal(thr, ss.pick_threshold(want_c[0], tvec, K)):
        raise AssertionError("preshaded: the thresholds differ")
    length = axcam.ray_lengths().contiguous()
    init = lambda: cs.init_seg_packed(K, nj, ni, device=dev)
    kern = fold_chunks(cs.fold_chunk_packed, init(), chunks, thr, length)
    plain = fold_chunks(cs.fold_chunk_packed_plain, init(), chunks, thr,
                        length)
    torch.cuda.synchronize()
    fold_err = packed_err(kern, plain)
    check("preshaded.seg_fold_chunks", fold_err, 1e-6)
    if not torch.equal(kern[2][0], plain[2][0]):
        raise AssertionError("preshaded: K1's start counts differ")
    log("preshaded.chunks", f"{len(chunks)} folded, {int(pyr.chunks.sum())}"
        f" of {pyr.chunks.numel()} live")
    del chunks, kern, plain

    # the pyramid on the card skips what it skips on the CPU
    cpu_pyr = occ.pyramid_from_volume(
        Volume(shaded.data.cpu(), shaded.origin.cpu(), shaded.spacing.cpu()),
        None, spec)
    if not torch.equal(pyr.chunks.cpu(), cpu_pyr.chunks) or \
            not torch.equal(pyr.tiles.cpu(), cpu_pyr.tiles):
        raise AssertionError("preshaded: the pyramid gates differ between "
                             "the card and the CPU")
    log("preshaded.pyramid", f"{int((~cpu_pyr.chunks).sum())} of "
        f"{cpu_pyr.chunks.numel()} chunks skipped on both")
    return launches, dict(count_err=count_err, fold_err=fold_err)


def run_ao_dist(dev, s):
    """Phase 13 (c): AO on phase 4's 8 ranks, the frame schedule:
    `distributed_plain_step_mxu` with ``ao_strength`` on (every rank
    pre-shaded on its radius-deep halo) against the single-device
    pre-shaded render at rtol 1e-4, atol 2e-5, early exit off in both
    (as the reference's parity tests render). No kernel."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.config import RenderConfig, SliceMarchConfig
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import ao, slicer
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import make_mesh, shard_volume

    tf = for_dataset("gray_scott", device=dev)
    vol = Volume.centered(s["v"], extent=2.0)
    cam = s["cam"]
    spec = slicer.make_spec(cam, (GRID,) * 3, SliceMarchConfig(chunk=CHUNK),
                            multiple_of=RANKS)
    mesh = make_mesh(RANKS, device=dev)
    # early exit off in both: each rank saturates on its own, so the
    # composite of early-exited fragments is not the single march's
    rc = RenderConfig(ao_strength=AO_STRENGTH, ao_radius=AO_RADIUS,
                      early_exit_alpha=1.1)
    step = dp.distributed_plain_step_mxu(mesh, tf, spec, rc)
    slabs = shard_volume(vol.data, mesh)
    kernels.reset_launches()
    _, (img, _) = timed_view("ao_dist", lambda: step(
        slabs, vol.origin, vol.spacing, cam))
    launches = kernels.launches()
    require_only(launches, (), "the 8-rank AO step")
    del slabs
    shaded = ao.shade_volume_ao(vol, tf, AO_RADIUS, AO_STRENGTH)
    ref = slicer.render_slices(shaded, None, slicer.make_axis_camera(
        shaded, cam, spec), spec, early_exit_alpha=1.1).image
    del shaded
    diff = (img - ref).abs()
    over = diff - (AO_DIST_ATOL + AO_DIST_RTOL * ref.abs())
    log("ao_dist.max_abs_diff", f"{float(diff.max()):.3e} (rtol "
        f"{AO_DIST_RTOL}, atol {AO_DIST_ATOL}; worst margin "
        f"{float(over.max()):.3e})")
    if float(over.max()) > 0.0:
        raise AssertionError("ao_dist: the 8-rank AO step differs from the "
                             "single-device pre-shaded render")
    torch.cuda.empty_cache()
    return launches


def check_convert(dev, s):
    """Phase 13 (d): `vdi_convert` on the card's VDI: the NDC round trip
    (finite depths within 1e-3, the +inf pattern exact), the reference
    layouts' round trips exact, `validate_vdi` clean (world and NDC);
    and the three goldens of the novel-view slice through the port on
    the card within the golden test's 3.0: ``novel_view`` (the gather
    renderer), ``vdi_decode`` (the same-view decode of the golden VDI),
    ``reference_frame`` (the slice march in the Vulkan frame)."""
    import numpy as np
    import torch

    from scenery_insitu_tpu_torch.config import (CompositeConfig,
                                                 SliceMarchConfig, VDIConfig)
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import procedural_volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops import vdi_convert as vc
    from scenery_insitu_tpu_torch.ops.composite import composite_vdis
    from scenery_insitu_tpu_torch.ops.vdi_render import render_vdi
    from scenery_insitu_tpu_torch.utils.image import load_png, to_display

    vdi, meta = s["vdi"], s["meta"]
    ndc = vc.depths_to_ndc(vdi, meta)
    back = vc.depths_from_ndc(ndc, meta)
    fin = torch.isfinite(vdi.depth)
    if not torch.equal(fin, torch.isfinite(back.depth)):
        raise AssertionError("convert: the NDC round trip moved +inf")
    err = float((back.depth[fin] - vdi.depth[fin]).abs().max())
    log("convert.ndc_roundtrip_max_abs", f"{err:.3e} (bound 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("convert: the NDC round trip drifted")
    color, depth = vc.pack_reference_layout(vdi)
    rt = vc.unpack_reference_layout(color, depth, device=dev)
    live = fin[:, 0]
    if not (torch.equal(rt.color[:, :, :][live[:, None].expand_as(
            rt.color)], vdi.color[live[:, None].expand_as(vdi.color)])
            and torch.equal(rt.depth[live[:, None].expand_as(rt.depth)],
                            vdi.depth[live[:, None].expand_as(vdi.depth)])
            and bool(torch.isinf(rt.depth[:, 0][~live]).all())):
        raise AssertionError("convert: the reference layout's round trip")
    packed = vc.pack_3layer(vdi)
    if not np.array_equal(vc.pack_3layer(vc.unpack_3layer(packed,
                                                          device=dev)),
                          packed):
        raise AssertionError("convert: the 3-layer round trip")
    for name, v, nd in (("world", vdi, False), ("ndc", ndc, True)):
        rep = vc.validate_vdi(v, ndc=nd)
        log(f"convert.validate_{name}", json.dumps(rep))
        bad = {k: n for k, n in rep.items() if k != "live_slots" and n}
        if bad or not rep["live_slots"]:
            raise AssertionError(f"convert: validate_vdi ({name}) {bad}")

    g = GOLDEN
    vol = procedural_volume(g["grid"], kind="blobs", seed=g["seed"],
                            device=dev)
    tf = for_dataset("procedural", device=dev)
    cam = Camera.create(g["eye"], fov_y_deg=50.0, near=0.3, far=20.0,
                        device=dev)
    cam2 = Camera.create(GOLDEN_NOVEL_EYE, fov_y_deg=50.0, near=0.3,
                         far=20.0, device=dev)
    white = (1.0, 1.0, 1.0, 1.0)
    spec = slicer.make_spec(cam, tuple(vol.data.shape),
                            SliceMarchConfig(matmul_dtype="f32", fold="xla"))
    gv, gmeta, _ = slicer.generate_vdi_mxu(vol, tf, cam, spec, VDIConfig(
        max_supersegments=g["k"], adaptive_mode="histogram",
        histogram_bins=8))
    comp = composite_vdis(gv.color[None], gv.depth[None],
                          CompositeConfig(max_output_supersegments=g["k"]))
    gvdi = VDI(comp.color, comp.depth)
    images = {
        "novel_view": (render_vdi(gvdi, gmeta, cam2, g["w"], g["h"],
                                  steps=g["steps"], background=white), 2.2),
        "vdi_decode": (render_vdi_same_view(gvdi, background=white), 2.2),
        "reference_frame": (vc.to_reference_frame(slicer.raycast_mxu(
            vol, tf, cam, g["w"], g["h"], spec, background=white).image),
            1.0)}
    root = os.path.dirname(os.path.abspath(__file__))
    for name, (img, gamma) in images.items():
        want = load_png(os.path.join(root, "tests", "golden",
                                     f"golden_{name}.png")).astype("float32")
        got = to_display(img.cpu().numpy(), gamma).astype("float32")
        gap = float(abs(got - want).max())
        log(f"golden_{name}.max_8bit_diff", f"{gap:.1f} (bar {GOLDEN_BAR})")
        if not gap <= GOLDEN_BAR:
            raise AssertionError(f"golden {name}: max 8-bit difference "
                                 f"{gap} > {GOLDEN_BAR}")


def run_phase13(dev, done, profile=False):
    """Phase 13 (a)-(d); returns the launch counts of each path."""
    import torch

    t13 = time.perf_counter()
    s = novel_state(dev)
    done("phase13.state")
    views = run_novel_views(dev, s, profile)
    torch.cuda.empty_cache()
    done("phase13.a")
    shaded_launches, shaded_errs = run_preshaded(dev, s, profile)
    torch.cuda.empty_cache()
    done("phase13.b")
    dist = run_ao_dist(dev, s)
    done("phase13.c")
    check_convert(dev, s)
    log("phase13.wall_s", f"{time.perf_counter() - t13:.1f} (the novel "
        f"views and the pre-shaded march)")
    return dict(state=s["launches"], views=views, preshaded=shaded_launches,
                ao_dist=dist, errs=shaded_errs)



# ------------------------------------------------------------- phase 14


# the reference's BASELINE Configs 3-5 at full width
# (benchmarks/configs_bench.py:36-42,73-91): 5 sim steps a frame, K = 16
# into 16 output slots, the 1280 x 720 display
P14_STEPS = 5
P14_W, P14_H = 1280, 720
VORTEX_GRID, VORTEX_RANKS = 256, 4
LJ_PARTICLES, LJ_RANKS = 1_000_000, 8
HYBRID_GRID, HYBRID_TRACERS, HYBRID_RANKS = 256, 500_000, 8
P14_WARM, P14_TIMED = 1, 3
# the bars: the reference tests' (tests/test_sims_extra.py,
# tests/test_hybrid.py, tests/test_splat.py) and phases 8-10's
DIV_BAR = 1e-4              # spectral divergence / max |rfft(u_x)|
ENERGY_DRIFT = 0.02         # test_lj_energy_conservation
SPLAT_DEPTH, SPLAT_IMAGE, SPLAT_AGREE = 1e-6, 1e-5, 0.999
HYBRID_DB = 35.0            # the distributed hybrid against one device
SMALL_DB = 60.0             # a small grid, the card against the CPU
HYBRID_KERNELS = ("seg_fold_compact", "count_multi", "resegment_sorted")


def p14_config(kind, grid=0, ranks=1, particles=0, mode="temporal",
               **extra):
    """One of the reference's Configs 3-5 as a session configuration
    (``benchmarks/configs_bench.py``'s overrides)."""
    from scenery_insitu_tpu_torch.config import FrameworkConfig

    over = [f"sim.kind={kind}", f"mesh.num_devices={ranks}",
            f"sim.steps_per_frame={P14_STEPS}", f"vdi.max_supersegments={K}",
            f"vdi.adaptive_mode={mode}",
            f"composite.max_output_supersegments={K}",
            f"render.width={P14_W}", f"render.height={P14_H}"]
    if kind == "vortex":
        over.append("slicer.engine=mxu")
    if grid:
        over.append(f"sim.grid=[{grid},{grid},{grid}]")
    if particles:
        over.append(f"sim.num_particles={particles}")
    over += [f"{k}={v}" for k, v in extra.items()]
    return FrameworkConfig().with_overrides(*over)


def p14_session(prefix, dev, cfg, kernel_names, before=None):
    """A session of ``cfg`` on the card (``before(session)`` called once
    it is built): the launch counts set to 0, a warm frame (its seed
    included) and the timed frames (host clock, synchronised), the
    counts read after and each kernel of ``kernel_names`` required, no
    other. Returns (session, ms a frame, launches, last payload)."""
    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.runtime.session import InSituSession

    t0 = time.perf_counter()
    sess = InSituSession(cfg, device=dev)
    log(f"{prefix}.build_s", f"{time.perf_counter() - t0:.2f} (the sim's "
        f"init and the session)")
    if before is not None:
        before(sess)
    kernels.reset_launches()
    timed_run(sess, P14_WARM)
    before = phase_stats(sess.timers)
    ms, last = timed_run(sess, P14_TIMED)
    launches = kernels.launches()
    log(f"{prefix}.launches", json.dumps(launches))
    require_only(launches, kernel_names, prefix)
    log(f"{prefix}.ms_per_frame", f"{ms:.3f} (host clock, mean of "
        f"{P14_TIMED} after {P14_WARM} warm frame, "
        f"{P14_STEPS} sim steps a frame)")
    log_phase_stats(prefix, sess.timers, before)
    return sess, ms, launches, last


def small_sessions(prefix, dev, cfg, frames=1):
    """The same session on the card and the CPU: (cuda session, its
    payloads, cpu session, its payloads)."""
    from scenery_insitu_tpu_torch.runtime.session import InSituSession

    out = []
    for d in (dev, "cpu"):
        got = {}
        sess = InSituSession(cfg, sinks=[capture_into(got)], device=d)
        sess.run(frames)
        out += [sess, got]
    return out


def card_cpu_gate(prefix, a, b, bar=SMALL_DB):
    """Two host images of the same small frame, the card's and the
    CPU's: at least ``bar`` dB apart."""
    import numpy as np

    from scenery_insitu_tpu_torch.utils.image import psnr

    db = psnr(a, b)
    diff = np.abs(a - b)
    log(f"{prefix}", f"psnr_db={db:.2f} (bar {bar}) max_abs_diff="
        f"{float(diff.max()):.3e} mean_abs_diff={float(diff.mean()):.3e}")
    if not db >= bar:
        raise AssertionError(f"{prefix}: the card differs from the CPU "
                             f"({db:.2f} dB < {bar})")


def run_vortex_session(dev):
    """Phase 14 (a): Config 3, the vortex session at 256^3 over 4 ranks
    (mxu, temporal; K2 seeds, K1 folds, K4 composites every rank), its
    ms a frame and launches; the flow's spectral divergence after its
    last step against the reference test's bar (f64 FFT of the f32
    flow); a 32^3 vortex session on the card against the CPU (fold
    ``pallas_seg`` on both, 3 frames, >= 60 dB)."""
    import torch

    from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
    from scenery_insitu_tpu_torch.sim import vortex as vx

    sess, ms, launches, last = p14_session(
        "vortex", dev, p14_config("vortex", VORTEX_GRID, VORTEX_RANKS),
        HYBRID_KERNELS)
    check_vdi("vortex.vdi", VDI(torch.from_numpy(last["vdi_color"]),
                                torch.from_numpy(last["vdi_depth"])),
              tuple(last["vdi_color"].shape), tuple(last["vdi_depth"].shape))
    u = sess.sim.state.u.double()
    kz, ky, kx = (k.double() for k in vx._grad_axes(u.shape[1:],
                                                    device=u.device))
    uh = [torch.fft.rfftn(u[i]) for i in range(3)]
    div = float((kx * uh[0] + ky * uh[1] + kz * uh[2]).abs().max())
    scale = float(uh[0].abs().max()) + 1e-9
    log("vortex.divergence", f"{div / scale:.3e} of max|rfft(u_x)| (bar "
        f"{DIV_BAR:.0e}) after {(P14_WARM + P14_TIMED) * P14_STEPS} steps")
    if not div / scale < DIV_BAR:
        raise AssertionError("vortex: the flow is not divergence-free")
    del sess, u, uh
    torch.cuda.empty_cache()
    cs, cg, ps, pg = small_sessions("small_vortex", dev, p14_config(
        "vortex", 32, VORTEX_RANKS, **{"slicer.fold": "pallas_seg",
                                       "slicer.matmul_dtype": "f32"}), 3)
    for i in range(3):
        imgs = [render_vdi_same_view(VDI(torch.from_numpy(g[i]["vdi_color"]),
                                         torch.from_numpy(g[i]["vdi_depth"])))
                .numpy() for g in (cg, pg)]
        card_cpu_gate(f"small_vortex.frame{i}", *imgs)
    return dict(ms=ms, launches=launches)


def run_lj_session(dev):
    """Phase 14 (b): Config 4, the Lennard-Jones session of 1,000,000
    particles over 8 ranks (histogram mode; no kernel on this path), its
    ms a frame, the sim (5 steps) and the splat timed apart, the force
    pass's peak memory, the energy drift over the frames against the
    reference test's 2 %; the 8-rank sort-first splat against the
    single-device splat of the same particles (depth within 1e-6, >=
    99.9 % of the pixels within 1e-5); a 2,048-particle session on the
    card against the CPU (the states after a frame within 1e-4, and the
    CPU's splat of the card's state at the bar above, depth relative)."""
    import torch

    from scenery_insitu_tpu_torch.ops.splat import (speed_colors,
                                                    splat_particles)
    from scenery_insitu_tpu_torch.parallel.particles import shard_particles
    from scenery_insitu_tpu_torch.sim import particles as pt

    cfg = p14_config("lennard_jones", ranks=LJ_RANKS,
                     particles=LJ_PARTICLES, mode="histogram")

    def energy(sim):
        _, pot = pt.lj_forces(sim.state.pos, sim.state.box, sim.params,
                              sim.spec)
        return float(pt.kinetic_energy(sim.state)) + float(pot)

    e = []
    sess, ms, launches, last = p14_session(
        "lj", dev, cfg, (), before=lambda s: e.append(energy(s.sim)))
    e0 = e[0]
    sim = sess.sim
    log("lj.cells", f"ncell={sim.spec.ncell} capacity={sim.spec.capacity} "
        f"box={float(sim.state.box):.4f} candidates_a_particle="
        f"{27 * sim.spec.capacity}")
    e1 = energy(sim)
    drift = abs(e1 - e0) / abs(e0)
    frames = P14_WARM + P14_TIMED
    log("lj.energy_drift", f"{drift:.4e} (bar {ENERGY_DRIFT}) over "
        f"{frames * P14_STEPS} steps: {e0:.6e} -> {e1:.6e}")
    if not drift < ENERGY_DRIFT:
        raise AssertionError("lj: the energy drifts")
    # the sim and the splat apart, on the session's own state and step
    st0 = sim.state
    sim_ms = median_ms(lambda _: sim.advance(P14_STEPS), 3)
    sim.state = st0
    centered = sim.pos - sim.state.box / 2.0
    pos8 = shard_particles(centered, sess.mesh)
    vel8 = shard_particles(sim.vel, sess.mesh)
    splat_ms = median_ms(lambda _: sess._step(pos8, vel8, sess.camera), 3)
    log("lj.parts_ms", f"sim={sim_ms:.3f} ({P14_STEPS} steps, "
        f"{P14_STEPS + 1} force passes) splat={splat_ms:.3f} (8 ranks, "
        f"{P14_W}x{P14_H}, depth-min composite included); CUDA events")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pt.lj_forces(sim.state.pos, sim.state.box, sim.params, sim.spec)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log("lj.force_pass_peak_bytes", f"{peak} ({peak / 2**30:.3f} GiB "
        f"above the {base / 2**30:.3f} GiB held; blocks of "
        f"{pt.FORCE_BLOCK_ENTRIES // (27 * sim.spec.capacity)} particles)")
    out8 = sess._step(pos8, vel8, sess.camera)
    one = splat_particles(centered, speed_colors(sim.vel),
                          cfg.sim.particle_radius, sess.camera, P14_W, P14_H)
    splat_agree("lj.sort_first", out8, one)
    del pos8, vel8, out8, one, sess, sim, st0, centered
    torch.cuda.empty_cache()

    small = p14_config("lennard_jones", ranks=LJ_RANKS, particles=2048,
                       mode="histogram")
    cs, cg, ps, pg = small_sessions("small_lj", dev, small)
    err = float((cs.sim.pos.cpu() - ps.sim.pos).abs().max())
    log("small_lj.state_max_abs_diff", f"{err:.3e} (bar 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("small_lj: the card's state differs")
    cpu_step = ps._step
    mesh = ps.mesh
    centered = cs.sim.pos.cpu() - cs.sim.state.box.cpu() / 2.0
    cpu_cam = type(cs.camera)(*(x.cpu() for x in cs.camera))
    want = cpu_step(shard_particles(centered, mesh),
                    shard_particles(cs.sim.vel.cpu(), mesh), cpu_cam)
    got = cs._step(shard_particles(centered.to(dev), cs.mesh),
                   shard_particles(cs.sim.vel, cs.mesh), cs.camera)
    splat_agree("small_lj.splat", got, want, relative=True)
    return dict(ms=ms, launches=launches, sim_ms=sim_ms, splat_ms=splat_ms,
                peak_bytes=peak, drift=drift)


def splat_agree(prefix, got, want, relative=False):
    """The reference test's bar: the same pixels covered, depth within
    1e-6 (``relative``: of the depth, as the CPU tests hold the port to
    the reference, where two devices' arithmetic differs by ulps), >=
    99.9 % of the pixels within 1e-5."""
    import torch

    gd, wd = got.depth.cpu(), want.depth.cpu()
    live = torch.isfinite(wd)
    if not torch.equal(torch.isfinite(gd), live):
        raise AssertionError(f"{prefix}: the covered pixels differ")
    diff = (gd[live] - wd[live]).abs()
    if relative:
        diff = diff / wd[live].abs()
    derr = float(diff.max()) if live.any() else 0.0
    agree = float(torch.isclose(got.image.cpu(), want.image.cpu(),
                                atol=SPLAT_IMAGE, rtol=0).all(0)
                  .float().mean())
    log(f"{prefix}", f"covered={int(live.sum())} depth_max_"
        f"{'rel' if relative else 'abs'}_diff={derr:.3e} (bar "
        f"{SPLAT_DEPTH}) pixels_within_{SPLAT_IMAGE}="
        f"{agree:.6f} (bar {SPLAT_AGREE})")
    if not (derr <= SPLAT_DEPTH and agree >= SPLAT_AGREE):
        raise AssertionError(f"{prefix}: the splats differ")
    if not bool(live.any()):
        raise AssertionError(f"{prefix}: no particle is in view")


def run_hybrid_session(dev):
    """Phase 14 (c): Config 5, the hybrid session at 256^3 with 500,000
    tracers over 8 ranks (temporal: K2 seeds, K1 folds, K4 composites),
    its ms a frame and launches; K1 against its plain version on one
    rank's chunks of the frame's march at its carried thresholds, and K4
    on the frame's composite streams; the distributed hybrid image
    against ``hybrid_vortex_frame_step``'s at the same state (histogram
    thresholds in both, >= 35 dB); one frame each of the ring, bf16,
    qpack8, tile waves, plan p1 and a 2 x 4 topology against the frame
    schedule (lossless ones within 1e-6, the waves 1e-5, the lossy
    wires >= 40 dB and not equal, the plan >= 35 dB); a 32^3 hybrid
    session (2,048 tracers, 4 ranks) on the card against the CPU."""
    import dataclasses

    import torch

    from scenery_insitu_tpu_torch.config import TopologyConfig, VDIConfig
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.models.pipelines import (
        hybrid_vortex_frame_step)
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs
    from scenery_insitu_tpu_torch.ops import occupancy as occ
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.parallel.particles import shard_particles
    from scenery_insitu_tpu_torch.parallel.topology import make_topology_mesh
    from scenery_insitu_tpu_torch.sim import vortex as vx

    cfg = p14_config("hybrid", HYBRID_GRID, HYBRID_RANKS, HYBRID_TRACERS)
    sess, ms, launches, last = p14_session("hybrid", dev, cfg,
                                           HYBRID_KERNELS)
    if not (last["image"].shape == (4, P14_H, P14_W)
            and bool(torch.isfinite(torch.from_numpy(last["image"])).all())):
        raise AssertionError("hybrid: the image is not finite or of the "
                             "wrong shape")
    (key,) = [k for k in sess._mxu_steps]
    _, _, spec = sess._mxu_steps[key]
    thr = sess._mxu_thr[key]
    log("hybrid.spec", spec)
    tf, cam, mesh = sess.tf, sess.camera, sess.mesh
    origin, spacing = sess._origin, sess._spacing
    field = sess.sim.field
    slabs = shard_volume(field, mesh)
    n = HYBRID_RANKS
    rows = dp._frame_rows(slabs, spec)
    frames = [dp._RankFrame(slabs, rows, r, origin, spacing, cam, spec, tf)
              for r in range(n)]
    # K1 on rank n/2's chunks at its carried maps
    r = n // 2
    fr, unit = frames[r], frames[r].dec.units[0]
    chunks = []

    def keep(carry, rgba, sk0, sk1):
        chunks.append((rgba.clone(), sk0.clone(), sk1.clone()))
        return carry

    _, march = slicer._frame_march(unit.vol, tf, cam, spec,
                                   v_bounds=unit.v_bounds,
                                   occupancy=fr.pyrs[0], axcam=fr.axcam,
                                   volp=fr.volps[0], w_bounds=unit.w_bounds)
    march(keep, None, shaded_compact=True)
    rthr = dp._rank_thr(thr, r, spec.nj).thr.contiguous()
    length = fr.axcam.ray_lengths().contiguous()
    init = lambda: cs.init_seg_packed(K, spec.nj, spec.ni, device=dev)
    kern = fold_chunks(cs.fold_chunk_packed, init(), chunks, rthr, length)
    plain = fold_chunks(cs.fold_chunk_packed_plain, init(), chunks, rthr,
                        length)
    torch.cuda.synchronize()
    k1_err = packed_err(kern, plain)
    check("hybrid.seg_fold_chunks", k1_err, 1e-6)
    if not torch.equal(kern[2][0], plain[2][0]):
        raise AssertionError("hybrid: K1's start counts differ")
    log("hybrid.k1_chunks", f"{len(chunks)} chunks of rank {r}")
    del chunks, kern, plain
    # K4 on the frame's composite streams
    colors, depths, _ = dp._frame_schedule(frames, cam, spec, tf, cfg.vdi,
                                           thr, spec.nj, None, None)
    _, streams = exchange_parts("hybrid", dp, colors, depths, cfg.composite)
    k4_err = check_k4_on("hybrid.resegment", streams)
    del colors, depths, streams, frames, rows
    torch.cuda.empty_cache()

    # the distributed hybrid against the single-chip hybrid frame step
    vh = dataclasses.replace(cfg.vdi, adaptive_mode="histogram")
    radius = cfg.sim.particle_radius * sess._vox
    world = vx.tracers_to_world(sess.sim.tracers, origin, spacing)
    vel = vx.tracer_velocities(sess.sim.flow.u, sess.sim.tracers)

    def dist_image(ccfg, mesh=mesh, plan=None, topology=None):
        step = dp.distributed_hybrid_step_mxu(
            mesh, tf, spec, vh, ccfg, radius=radius, stamp=5, plan=plan,
            topology=topology)
        img, _ = step(shard_volume(field, mesh), origin, spacing,
                      shard_particles(world, mesh),
                      shard_particles(vel, mesh), cam)
        return img

    frame_img = dist_image(cfg.composite)
    axcam = slicer.make_axis_camera(Volume(field, origin, spacing), cam,
                                    spec)
    shown = slicer.warp_to_camera(frame_img, axcam, spec, cam, P14_W, P14_H)
    single = hybrid_vortex_frame_step(
        P14_W, P14_H, tuple(field.shape), key[1:], sim_steps=0, vdi_cfg=vh,
        tf=tf, radius=radius, stamp=5, slicer_cfg=cfg.slicer, device=dev)
    one, _, _ = single(sess.sim.flow.u, sess.sim.tracers, cam.eye)
    db = img_psnr(shown, one)
    log("hybrid.vs_single", f"{db:.2f} dB (bar {HYBRID_DB}) against "
        f"hybrid_vortex_frame_step at the same state")
    if not db >= HYBRID_DB:
        raise AssertionError("hybrid: the distributed image differs from "
                             "the single-chip frame step")
    del shown, one
    # the other schedules, one frame each, against the frame schedule
    profile = torch.cat([occ.z_live_profile(x, tf, nzb=occ._cap_divisor(
        slabs.shape[1], 32)) for x in slabs]).cpu().numpy()
    p1 = occ.slice_plan(profile, HYBRID_GRID, n, min_depth=4, quantum=4)
    log("hybrid.p1_plan", list(p1))
    topo = TopologyConfig(num_hosts=2)
    from scenery_insitu_tpu_torch.config import MeshConfig
    mesh2, _ = make_topology_mesh(topo, MeshConfig(num_devices=n),
                                  device=dev)
    cc = cfg.composite
    runs = {
        "ring": (dict(exchange="ring"), {}, ("max", 1e-6)),
        "bf16": (dict(wire="bf16"), {}, ("db", 40.0)),
        "qpack8": (dict(exchange="ring", wire="qpack8"), {}, ("db", 40.0)),
        "waves": (dict(schedule="waves",
                       wave_tiles=wave_tiles_for(spec.ni, n)), {},
                  ("max", 1e-5)),
        # a plan cuts supersegments where the even split does not (phase
        # 9), and a particle inside a slab sees its traversed fraction,
        # so the image is held at the hybrid bar of two composites of
        # one frame
        "plan_p1": (dict(rebalance="occupancy"), dict(plan=p1),
                    ("db", HYBRID_DB)),
        "hier_2x4": ({}, dict(mesh=mesh2, topology=topo), ("max", 1e-6)),
    }
    for name, (knobs, kw, (kind, bar)) in runs.items():
        img = dist_image(dataclasses.replace(cc, **knobs), **kw)
        if kind == "max":
            err = float((img - frame_img).abs().max())
            log(f"hybrid.{name}", f"max_abs_diff={err:.3e} (bar {bar})")
            ok = err <= bar
        else:
            db = img_psnr(img, frame_img)
            same = bool(torch.equal(img, frame_img))
            log(f"hybrid.{name}", f"{db:.2f} dB (bar {bar}) equal={same}")
            ok = db >= bar and (name == "plan_p1" or not same)
        if not ok:
            raise AssertionError(f"hybrid: the {name} frame misses its bar")
    del sess, slabs, frame_img, world, vel
    torch.cuda.empty_cache()
    cs_, cg, ps, pg = small_sessions("small_hybrid", dev, p14_config(
        "hybrid", 32, 4, 2048, **{"slicer.fold": "pallas_seg",
                                  "slicer.matmul_dtype": "f32"}), 2)
    for i in range(2):
        card_cpu_gate(f"small_hybrid.frame{i}", cg[i]["image"],
                      pg[i]["image"])
    return dict(ms=ms, launches=launches, k1_err=k1_err, k4_err=k4_err)


def run_phase14(dev, done):
    """Phase 14 (a)-(c); returns each session's launch counts and the
    K1 and K4 checks on the hybrid frame."""
    import torch

    t14 = time.perf_counter()
    vortex = run_vortex_session(dev)
    torch.cuda.empty_cache()
    done("phase14.a")
    lj = run_lj_session(dev)
    torch.cuda.empty_cache()
    done("phase14.b")
    hybrid = run_hybrid_session(dev)
    torch.cuda.empty_cache()
    done("phase14.c")
    log("phase14.wall_s", f"{time.perf_counter() - t14:.1f} (the particle "
        f"and hybrid workloads)")
    return dict(vortex=vortex, lj=lj, hybrid=hybrid)


# ------------------------------------------------------------- phase 15


# the scene: phase 4's 512^3 field cut OpenFPM-style into three uneven z
# slabs, the middle one cut unevenly in x (6 grids, non-power-of-two
# extents), 1-voxel ghosts on every inner face; 4 frames, every grid
# pushed from the host each frame
P15_Z_CUTS = (150, 340)
P15_X_CUTS = (97, 230, 371)
P15_FRAMES = 4
P15_K1_GRID = 2             # the middle slab's x piece [97, 230)
SCENE_DB = 30.0             # tests/test_scene.py's bar against one volume
# steering: the gray_scott scenario's 13 frames. Its TF updates at frames
# 4, 8 and 12 send the second, the first and the second message; the
# first has the knots of for_dataset("gray_scott"), the session's own
# start TF, so frames 8 and 12 restore steps: the reference's session
# counts the same
STEER_FRAMES = 13
STEER_COUNTS = {"tf_updates": 3, "tf_steps_reused": 2, "build_steps": 2}
STEER_GATE = 1e-6
P15_FOLD = "auto"           # pallas_seg (K1) on the card


def phase4_field(dev):
    """Phase 4's Gray-Scott field after its sim steps (the seeded init,
    then WARMUP_FRAMES + TIMED_FRAMES advances of SIM_STEPS), on the
    host."""
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    for _ in range(WARMUP_FRAMES + TIMED_FRAMES):
        st = gs.multi_step_fast(st, SIM_STEPS)
    return st.v.cpu().numpy()


def scene_grids(field):
    """The host field cut into the scene's grids: (grids, origins,
    ghost_lo, ghost_hi, boxes), each grid a contiguous numpy copy with
    its ghosts, placed as ``Volume.centered(field, 2.0)`` places the
    whole."""
    import numpy as np

    d, h, w = field.shape
    sp = 2.0 / max(d, h, w)
    origin = np.asarray([-w * sp / 2, -h * sp / 2, -d * sp / 2], np.float32)
    zs = (0,) + P15_Z_CUTS + (d,)
    boxes = []
    for j, (z0, z1) in enumerate(zip(zs[:-1], zs[1:])):
        xs = (0,) + P15_X_CUTS + (w,) if j == 1 else (0, w)
        boxes += [(z0, z1, x0, x1) for x0, x1 in zip(xs[:-1], xs[1:])]
    grids, origins, glo, ghi = [], [], [], []
    for z0, z1, x0, x1 in boxes:
        gz0, gz1 = int(z0 > 0), int(z1 < d)
        gx0, gx1 = int(x0 > 0), int(x1 < w)
        grids.append(np.ascontiguousarray(
            field[z0 - gz0:z1 + gz1, :, x0 - gx0:x1 + gx1]))
        origins.append(origin + np.asarray(
            [(x0 - gx0) * sp, 0.0, (z0 - gz0) * sp], np.float32))
        glo.append((gx0, 0, gz0))
        ghi.append((gx1, 0, gz1))
    return grids, origins, glo, ghi, boxes, np.full(3, sp, np.float32)


def p15_config(**extra):
    """The flagship frame (K, bins, chunk, temporal thresholds, phase 4's
    composite) as a session configuration at 1280 x 720."""
    from scenery_insitu_tpu_torch.config import FrameworkConfig

    over = {"slicer.engine": "mxu", "slicer.chunk": str(CHUNK),
            "slicer.fold": P15_FOLD,
            "vdi.max_supersegments": str(K), "vdi.adaptive_iters": "2",
            "vdi.adaptive_mode": "temporal",
            "vdi.histogram_bins": str(BINS),
            "composite.max_output_supersegments": str(K_OUT),
            "composite.adaptive_iters": str(COMP_ITERS),
            "render.width": str(P14_W), "render.height": str(P14_H),
            "runtime.dataset": "gray_scott"}
    over.update(extra)
    return FrameworkConfig().with_overrides(
        *(f"{k}={v}" for k, v in over.items()))


def run_scene(dev, field, dist_ms=None):
    """Phase 15 (a): the 6-grid scene through ``SceneSession`` on a
    z-marching camera: ``update_data`` from the host, then 4 frames each
    after an ``update_grid`` of every grid (host clock; K1, K2 and K4
    launched, no other kernel); frame 0's image against the single-volume
    ``generate_vdi_mxu`` of the assembled field (>= 30 dB); K1 against its
    plain version on grid 2's chunks (the x cut's u ownership) at its
    carried maps, and K4 on the frame's 6-grid sorted stream.
    ``dist_ms``: phase 4's ms a frame, logged beside (None: not run)."""
    import dataclasses

    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.vdi import VDI, render_vdi_same_view
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops import supersegments as ss
    from scenery_insitu_tpu_torch.ops.composite import sort_stream
    from scenery_insitu_tpu_torch.runtime.scene_session import SceneSession

    grids, origins, glo, ghi, boxes, sp = scene_grids(field)
    log("scene.grids", json.dumps([
        dict(z=[z0, z1], x=[x0, x1], shape=list(g.shape), ghost_lo=lo,
             ghost_hi=hi) for (z0, z1, x0, x1), g, lo, hi
        in zip(boxes, grids, glo, ghi)]))
    cam = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                        device=dev)
    cfg = p15_config()
    sess = SceneSession(cfg, camera=cam, device=dev)
    t0 = time.perf_counter()
    sess.update_data(0, grids, origins, sp, glo, ghi)
    torch.cuda.synchronize()
    log("scene.update_data_s", f"{time.perf_counter() - t0:.3f} (6 host "
        f"grids, {sum(g.nbytes for g in grids) / 1e6:.1f} MB, to the card)")
    kernels.reset_launches()
    wall, payloads = [], []
    for _ in range(P15_FRAMES):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for gid, g in enumerate(grids):
            sess.update_grid(0, gid, g)
        payloads.append(sess.render_frame())
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - h0) * 1e3)
    launches = kernels.launches()
    log("scene.launches", json.dumps(launches))
    require_only(launches, HYBRID_KERNELS, "the scene frames")
    ms = sum(wall[1:]) / (len(wall) - 1)
    log("scene.ms_per_frame", f"{ms:.3f} (host clock, mean of frames 1-"
        f"{P15_FRAMES - 1}, each with 6 update_grid pushes from the host; "
        f"frame 0 with the seed {wall[0]:.3f}; phase 4's 8-rank frame "
        f"{'not run' if dist_ms is None else f'{dist_ms:.3f}'} ms)")
    (key,) = list(sess._steps)
    regime = key[0]
    spec = slicer.make_spec(cam, (GRID,) * 3, cfg.slicer, axis_sign=regime)
    log("scene.spec", f"{spec} regime={regime}")
    if (spec.axis, spec.u_axis) != (2, 0):
        raise AssertionError("scene: the camera does not march z with x "
                             "as its u axis")
    p0 = payloads[0]
    got = VDI(torch.from_numpy(p0["vdi_color"]),
              torch.from_numpy(p0["vdi_depth"]))
    check_vdi("scene.frame0", got, (K_OUT, 4, spec.nj, spec.ni),
              (K_OUT, 2, spec.nj, spec.ni))
    tf = sess.tf
    vol = Volume.centered(torch.from_numpy(field).to(dev), extent=2.0)
    hcfg = dataclasses.replace(cfg.vdi, adaptive_mode="histogram")
    one, _, _ = slicer.generate_vdi_mxu(vol, tf, cam, spec, hcfg)
    db = image_psnr(render_vdi_same_view(got),
                    render_vdi_same_view(VDI(one.color.cpu(),
                                             one.depth.cpu())))
    log("scene.vs_single_volume_db", f"{db:.2f} (bar {SCENE_DB}; frame 0 "
        f"against generate_vdi_mxu of the assembled field, histogram "
        f"thresholds, the same eye)")
    if not db >= SCENE_DB:
        raise AssertionError("scene: frame 0 differs from the single "
                             "volume")
    del vol, one

    # K1 on grid 2's chunks at its carried maps
    thr = sess._thr[key]
    lo, hi = sess.scene.global_bounds()
    marches = sess.scene._march_grids(spec, lo, hi)
    vol_g, ub, vb = marches[P15_K1_GRID]
    chunks = []

    def keep(carry, rgba, sk0, sk1):
        chunks.append((rgba.clone(), sk0.clone(), sk1.clone()))
        return carry

    axcam, march = slicer._frame_march(vol_g, tf, cam, spec, lo, hi, ub, vb)
    march(keep, None, shaded_compact=True)
    rthr = thr.thr[P15_K1_GRID].contiguous()
    length = axcam.ray_lengths().contiguous()
    init = lambda: cs.init_seg_packed(K, spec.nj, spec.ni, device=dev)
    kern = fold_chunks(cs.fold_chunk_packed, init(), chunks, rthr, length)
    plain = fold_chunks(cs.fold_chunk_packed_plain, init(), chunks, rthr,
                        length)
    torch.cuda.synchronize()
    k1_err = packed_err(kern, plain)
    check("scene.seg_fold_chunks", k1_err, 1e-6)
    if not torch.equal(kern[2][0], plain[2][0]):
        raise AssertionError("scene: K1's start counts differ")
    log("scene.k1_chunks", f"{len(chunks)} chunks of grid {P15_K1_GRID} "
        f"(u bounds {float(ub[0]):.5f}..{float(ub[1]):.5f})")
    del chunks, kern, plain
    # K4 on the frame's 6-grid stream, sorted as the composite sorts it
    colors, depths = [], []
    for i, (vg, ugb, vgb) in enumerate(marches):
        state = ss.ThresholdState(*(f[i] for f in thr))
        vdi, _, _, _ = slicer.generate_vdi_mxu_temporal(
            vg, tf, cam, spec, state, cfg.vdi, box_min=lo, box_max=hi,
            u_bounds=ugb, v_bounds=vgb)
        colors.append(vdi.color)
        depths.append(vdi.depth)
    g = len(colors)
    sc, sd = sort_stream(torch.stack(colors).reshape(g * K, 4, spec.nj,
                                                     spec.ni),
                         torch.stack(depths).reshape(g * K, 2, spec.nj,
                                                     spec.ni))
    del colors, depths, marches
    k4_err = check_k4_on("scene.resegment", [(sc, sd)])
    del sc, sd, sess
    torch.cuda.empty_cache()
    return dict(ms=ms, launches=launches, k1_err=k1_err, k4_err=k4_err,
                db=db)


def run_steering(dev):
    """Phase 15 (b): the ``gray_scott`` scenario at 512^3 and 1280 x 720
    through ``scenarios.run_steered`` for 13 frames (its TF schedule: a
    new TF at frame 4, the session's own start TF at 8, frame 4's again
    at 12): the counters 3 updates, 2 reuses, 2 step builds
    (``STEER_COUNTS``); the session checkpointed
    right after frame 12's steering message, and a session built with
    that TF from the checkpoint's state renders frame 12 within 1e-6 of
    the frame on the restored steps."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from scenery_insitu_tpu_torch import kernels, scenarios
    from scenery_insitu_tpu_torch.runtime.checkpoint import (load_session,
                                                             save_session)
    from scenery_insitu_tpu_torch.runtime.streaming import tf_from_message

    scn = scenarios.get("gray_scott")
    over = (f"sim.grid=[{GRID},{GRID},{GRID}]",
            f"sim.steps_per_frame={SIM_STEPS}", "sim.fused_stencil=true",
            f"vdi.max_supersegments={K}", "vdi.adaptive_mode=temporal",
            f"vdi.histogram_bins={BINS}",
            f"composite.max_output_supersegments={K}", "slicer.engine=mxu",
            f"slicer.chunk={CHUNK}", f"slicer.fold={P15_FOLD}",
            f"render.width={P14_W}",
            f"render.height={P14_H}", "obs.enabled=true")
    last = STEER_FRAMES - 1
    msg = scn.steering(None, last)
    frames = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_steer_") as tmp:
        path = os.path.join(tmp, "steered.npz")
        sess = scenarios.make_session("gray_scott", extra_overrides=over,
                                      device=dev,
                                      sinks=[capture_into(frames)])

        def checkpoint(m):
            # behind the TF handler: the new TF is in, the frame not yet
            if sess.frame_index == last:
                save_session(sess, path)

        sess.on_steer.append(checkpoint)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scenarios.run_steered(sess, scn, STEER_FRAMES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launches()
        log("steer.launches", json.dumps(launches))
        require_only(launches, FRAME_KERNELS, "the steered scenario")
        c = sess.obs.counters
        counts = {k: int(c.get(k, 0)) for k in ("tf_updates",
                                                "tf_steps_reused",
                                                "build_steps")}
        log("steer.counters", f"{json.dumps(counts)} over {STEER_FRAMES} "
            f"frames ({wall / STEER_FRAMES * 1e3:.3f} ms a frame, host "
            f"clock, sinks included)")
        if counts != STEER_COUNTS:
            raise AssertionError(f"steering: counters {counts}")
        fresh_frames = {}
        fresh = scenarios.make_session(
            "gray_scott", extra_overrides=over, device=dev,
            tf=tf_from_message(msg, device=dev),
            sinks=[capture_into(fresh_frames)])
        load_session(fresh, path)
        if fresh.frame_index != last or fresh.obs.counters.get(
                "build_steps", 0) != 1:
            raise AssertionError("steering: the checkpoint did not resume "
                                 "frame 12 under the steered TF")
        scenarios.run_steered(fresh, dataclasses.replace(scn, steering=None),
                              1)
    got, want = frames[last], fresh_frames[last]
    err = max(max_abs(torch.from_numpy(got[k]), torch.from_numpy(want[k]))
              for k in ("vdi_color", "vdi_depth"))
    same = all(np.array_equal(got[k], want[k]) for k in ("vdi_color",
                                                          "vdi_depth"))
    log("steer.restored_vs_fresh", f"max_abs_diff={err:.3e} (bar "
        f"{STEER_GATE:.0e}) bit_exact={same}; frame {last} on the restored "
        f"steps against a session built with that TF from the checkpoint")
    if not err <= STEER_GATE:
        raise AssertionError("steering: the restored steps' frame differs "
                             "from a fresh session's")
    del sess, fresh
    torch.cuda.empty_cache()
    return dict(launches=launches, counts=counts, err=err)


def run_twins(dev):
    """Phase 15 (c): the example twins at their default sizes on the
    card: ``volume_from_file`` (96^3, 5 views at 512 x 512, with
    ``--store-vdis``) and ``ao_render`` (96^3, 480 x 360, 192 steps);
    every PNG non-blank, every VDI finite with a live slot."""
    import glob
    import tempfile

    import numpy as np
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.examples import ao_render, volume_from_file
    from scenery_insitu_tpu_torch.io.vdi_io import load_vdi
    from scenery_insitu_tpu_torch.utils.image import load_png

    def non_blank(path):
        img = load_png(path)
        rgb = img[..., :3].reshape(-1, 3)
        if not (rgb != rgb[0]).any():
            raise AssertionError(f"twins: {os.path.basename(path)} is blank")

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_twins_") as tmp:
        for name, main_fn, args, pngs in (
                ("volume_from_file", volume_from_file.main,
                 ["--out", os.path.join(tmp, "vff"), "--store-vdis"], 5),
                ("ao_render", ao_render.main,
                 ["--out", os.path.join(tmp, "ao")], 4)):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if main_fn(args) != 0:
                raise AssertionError(f"twins: {name} failed")
            torch.cuda.synchronize()
            files = sorted(glob.glob(os.path.join(args[1], "*.png")))
            if len(files) != pngs:
                raise AssertionError(f"twins: {name} wrote {len(files)} "
                                     f"PNGs, expected {pngs}")
            for f in files:
                non_blank(f)
            for f in sorted(glob.glob(os.path.join(args[1], "*.npz"))):
                vdi, _ = load_vdi(f)
                if not (np.isfinite(vdi.color).all()
                        and np.isfinite(vdi.depth[:, 0]).any()):
                    raise AssertionError(f"twins: {f} is not finite or "
                                         f"has no live slot")
            out[name] = kernels.launches()
            log(f"twins.{name}", f"{time.perf_counter() - t0:.2f} s, "
                f"{len(files)} PNGs non-blank, launches "
                f"{json.dumps(out[name])}")
    return out


def run_phase15(dev, done, field=None, dist_ms=None):
    """Phase 15 (a)-(c); ``field`` is phase 4's host field (made here
    when None), ``dist_ms`` phase 4's ms a frame. Returns each part's
    launch counts and the K1 and K4 checks on the scene frame."""
    import torch

    t15 = time.perf_counter()
    if field is None:
        field = phase4_field(dev)
        torch.cuda.empty_cache()
        done("phase15.field")
    scene = run_scene(dev, field, dist_ms)
    del field
    done("phase15.a")
    steer = run_steering(dev)
    done("phase15.b")
    twins = run_twins(dev)
    torch.cuda.empty_cache()
    done("phase15.c")
    log("phase15.wall_s", f"{time.perf_counter() - t15:.1f} (the multi-"
        f"grid scene, steering and the example twins)")
    return dict(scene=scene, steer=steer, twins=twins)


# ------------------------------------------------------------ phase 16

# phase 16's bars, stated before its first run: bf16 against f32 (the
# frame and the viewer's proxy) at the reference's lossy-wire bar; the
# bf16 product against the CPU's plain form, relative to its largest
# value; a served answer against its single-camera render
P16_DB = 40.0
P16_PRODUCT_RTOL = 1e-5
P16_SERVE_ATOL = 1e-5
P16_VIEWERS = 16            # one full bucket (ServeConfig.batch_size)
P16_YAWS = tuple(-0.3 + 0.6 * i / (P16_VIEWERS - 1)
                 for i in range(P16_VIEWERS))
P16_FRAMES = 3              # frames of each phase 16 session
P16_SERVED = 2              # VDI frames served at ServeConfig's size
P16_FULL_CHECKED = 2        # answers a tier checked at the VDI's width
P16_IFRAME = 4              # the stream's P-frame codec I period
P16_PRODUCT_CALL = 8        # the march's product call whose operands
#                             phase 16 (a) holds against the CPU


def p16_frames(dev, mm):
    """Phase 3's frame run in ``mm`` (the init, its seed, the warm-up
    and timed frames with phase 3's eyes): (ms, launches, VDI, u, v,
    step, eye)."""
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.models.pipelines import \
        grayscott_vdi_frame_step
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    base = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    step = grayscott_vdi_frame_step(grid_shape=(GRID,) * 3,
                                    axis_sign=slicer.choose_axis(base),
                                    **frame_config(dev, mm=mm))
    if step.spec.matmul_dtype != mm:
        raise AssertionError(f"the card's spec resolved {mm} to "
                             f"{step.spec.matmul_dtype}")
    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    u, v = st.u, st.v
    eye = lambda i: orbit(base, yaw_of(i)).eye
    kernels.reset_launches()
    thr = step.init_threshold(u, v, eye(-1))
    ms, (color, depth, u, v, thr) = timed_frames(
        f"bf16.frame_{mm}", lambda s, i: step(s[2], s[3], eye(i), s[4]),
        (None, None, u, v, thr), WARMUP_FRAMES, TIMED_FRAMES)
    launches = kernels.launches()
    log(f"bf16.frame_{mm}.launches", json.dumps(launches))
    require_only(launches, FRAME_KERNELS, f"the {mm} frame")
    return ms, launches, VDI(color, depth), u, v, step, eye


def p16_product(dev, u, v, eye):
    """One chunk's resampling operands of the bf16 march (the
    `slicer.resample_product` call P16_PRODUCT_CALL of a march on the
    frame's field, or its last): the card's bf16 product against the
    CPU's plain
    form (relative to the largest value), both products' ms on the card
    and the f32 pair's."""
    import torch

    from scenery_insitu_tpu_torch.config import SliceMarchConfig
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer

    vol = Volume.centered(v, extent=2.0)
    cam = Camera.create(eye, fov_y_deg=50.0, near=0.5, far=20.0, device=dev)
    spec = slicer.make_spec(cam, tuple(v.shape),
                            SliceMarchConfig(chunk=CHUNK))
    product, calls = slicer.resample_product, []

    def spy(wv, slices, wu, mm="f32"):
        if len(calls) <= P16_PRODUCT_CALL:
            calls.append((wv, slices, wu, mm))
        return product(wv, slices, wu, mm)

    slicer.resample_product = spy
    try:
        slicer.raycast_mxu(vol, for_dataset("gray_scott", device=dev), cam,
                           64, 64, spec)
    finally:
        slicer.resample_product = product
    wv, slices, wu, mm = calls[-1]
    if mm != "bf16":
        raise AssertionError(f"the card's march resampled in {mm}")
    got = product(wv, slices, wu, "bf16")
    want = product(wv.cpu(), slices.cpu(), wu.cpu(), "bf16")
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    log("bf16.product_shapes", f"wv {tuple(wv.shape)} slices "
        f"{tuple(slices.shape)} wu {tuple(wu.shape)}")
    check("bf16.product_vs_cpu_rel", err, P16_PRODUCT_RTOL)
    ms = {m: median_ms(lambda _: product(wv, slices, wu, m), 10)
          for m in ("bf16", "f32", "bf16", "f32")}
    c, b, y = wv.shape
    x, i = slices.shape[-1], wu.shape[1]
    log("bf16.product_ms", f"bf16 {ms['bf16']:.4f} (bf16 x bf16 -> f32, "
        f"then f32 x bf16-rounded), f32 {ms['f32']:.4f}; {c} planes of "
        f"[{b} x {y}] @ [{y} x {x}] @ [{x} x {i}]")
    return dict(err=err, ms=ms["bf16"], f32_ms=ms["f32"])


def p16_proxy(dev, vdi, u, v, spec, eye):
    """The viewer's proxy (`vdi_novel.vdi_to_rgba_volume`, marched by
    `render_vdi_proxy` across regimes) of the bf16 frame's VDI, built
    and marched in bf16 and in f32: the bf16 view >= P16_DB from the
    f32's."""
    import dataclasses

    import torch

    from scenery_insitu_tpu_torch.config import SliceMarchConfig
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops import vdi_novel as nv

    vol = Volume.centered(v, extent=2.0)
    cam = Camera.create(eye, fov_y_deg=50.0, near=0.5, far=20.0, device=dev)
    axcam = slicer.make_axis_camera(vol, cam, spec)
    cam_x = Camera.create(NOVEL_CROSS_EYE, fov_y_deg=50.0, near=0.5,
                          far=20.0, device=dev)
    views = {}
    for mm in ("bf16", "f32"):
        sp = dataclasses.replace(spec, matmul_dtype=mm)
        proxy = nv.vdi_to_rgba_volume(vdi, axcam, sp, num_slices=GRID)
        spec_x = slicer.make_spec(cam_x, tuple(proxy.data.shape[-3:]),
                                  SliceMarchConfig(chunk=CHUNK,
                                                   matmul_dtype=mm))
        ms, views[mm] = timed_view(f"bf16.proxy_{mm}", lambda: (
            nv.render_vdi_proxy(proxy, cam_x, NOVEL_W, NOVEL_H, spec_x)),
            reps=2)
        del proxy
        torch.cuda.empty_cache()
    db = img_psnr(views["bf16"], views["f32"])
    psnr_gate("bf16.proxy", db, P16_DB, "the f32 proxy's view")
    return db


def run_bf16(dev, phase3_launches=None):
    """Phase 16 (a): phase 3's default frame (bf16 on the card) and the
    same frames in f32, each timed; the bf16 image >= P16_DB from the
    f32's; the bf16 frames' launches equal the f32 frames' and phase
    3's; K1 against its plain version on the bf16 frame's chunks; the
    bf16 product against the CPU's plain form on one chunk's operands;
    the viewer's proxy in bf16 >= P16_DB from f32."""
    import torch

    from scenery_insitu_tpu_torch.core.vdi import render_vdi_same_view
    from scenery_insitu_tpu_torch.ops import cuda_seg as cs

    runs = {mm: p16_frames(dev, mm) for mm in ("bf16", "f32")}
    (ms, launches, vdi, u, v, step, eye) = runs["bf16"]
    f32_ms, f32_launches = runs["f32"][:2]
    db = img_psnr(render_vdi_same_view(vdi),
                  render_vdi_same_view(runs["f32"][2]))
    log("bf16.frame_ms", f"bf16 {ms:.3f}, f32 {f32_ms:.3f} (x"
        f"{f32_ms / ms:.3f}; CUDA events, median of {TIMED_FRAMES})")
    psnr_gate("bf16.frame", db, P16_DB, "the f32 frame")
    want = dict(f32=f32_launches)
    if phase3_launches is not None:
        want["phase 3"] = phase3_launches
    for name, other in want.items():
        if {k: launches.get(k, 0) for k in FRAME_KERNELS} != \
                {k: other.get(k, 0) for k in FRAME_KERNELS}:
            raise AssertionError(f"the bf16 frames launched {launches}, "
                                 f"the {name} frames {other}")
    del runs
    torch.cuda.empty_cache()
    last = eye(WARMUP_FRAMES + TIMED_FRAMES - 1)
    cap = capture_chunks(dev, u, v, last)
    init = lambda: cs.init_seg_packed(K, *cap["thr"].shape, device=dev)
    kern = fold_chunks(cs.fold_chunk_packed, init(), cap["chunks"],
                       cap["thr"], cap["length"])
    plain = fold_chunks(cs.fold_chunk_packed_plain, init(), cap["chunks"],
                        cap["thr"], cap["length"])
    torch.cuda.synchronize()
    k1_err = packed_err(kern, plain)
    check("bf16.seg_fold_frame_chunks", k1_err, 1e-5)
    if not torch.equal(kern[2][0], plain[2][0]):
        raise AssertionError("bf16: K1's start counts differ from the "
                             "plain version's")
    del cap, kern, plain
    torch.cuda.empty_cache()
    product = p16_product(dev, u, v, last)
    proxy_db = p16_proxy(dev, vdi, u, v, step.spec, last)
    return dict(ms=ms, f32_ms=f32_ms, db=db, launches=launches,
                f32_launches=f32_launches, k1_err=k1_err, product=product,
                proxy_db=proxy_db)


def run_p16_sessions(dev, h264_path):
    """Phase 16's main path: phase 7's session (512^3, temporal, one
    rank) and the same on phase 4's 8-rank mesh, P16_FRAMES frames each,
    the launch counts set to 0 before both and read after. The 1-rank
    session's frames go to a capture sink, the I_PCM H.264 movie sink
    (`video_sink(codec="h264_ipcm")`) and a publisher without a socket
    (qpack8 with the P-frame codec); the 8-rank session's to another.
    Returns (launches, payloads, publishers, ms a frame with the
    sinks)."""
    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.config import DeltaConfig
    from scenery_insitu_tpu_torch.runtime import streaming as stm

    pubs = {"qpack8_delta": stm.VDIPublisher(
                None, codec="zlib", precision="qpack8",
                delta=DeltaConfig(enabled=True, iframe_period=P16_IFRAME)),
            "qpack8_delta_8rank": stm.VDIPublisher(
                None, codec="zlib", precision="qpack8",
                delta=DeltaConfig(enabled=True, iframe_period=P16_IFRAME))}
    payloads = {}
    movie = stm.video_sink(h264_path, codec="h264_ipcm")
    enc = collections.defaultdict(float)
    sinks = [capture_into(payloads), timed_sink(enc, "h264", movie)] + [
        timed_sink(enc, "qpack8_delta", stm.stream_sink(pubs["qpack8_delta"]))]
    kernels.reset_launches()
    ms = {}
    for name, cfg, sk in (
            ("session", session_config(GRID), sinks),
            ("session_8rank", session_config(GRID, ranks=RANKS),
             [timed_sink(enc, "qpack8_delta_8rank",
                        stm.stream_sink(pubs["qpack8_delta_8rank"]))])):
        sess = session(dev, cfg, sk)
        ms[name], _ = timed_run(sess, P16_FRAMES)
        log(f"p16.{name}.ms_per_frame", f"{ms[name]:.3f} (host clock, "
            f"mean of {P16_FRAMES} frames with their sinks, the first "
            f"seeding)")
        del sess
    movie.release()
    log("p16.encode_ms", json.dumps({n: round(t * 1e3 / P16_FRAMES, 3)
                                     for n, t in enc.items()}) +
        " (host clock, mean a frame: each sink's encode and, for the "
        "movie, the same-view decode of the VDI)")
    launches = kernels.launches()
    log("p16.launches", json.dumps(launches))
    require_only(launches, DIST_KERNELS, "phase 16's sessions")
    return launches, payloads, pubs, ms


def p16_request(srv, viewers, tier, seq):
    """Each viewer ``(ident, camera)`` sends its camera of ``tier``
    through the server's `handle`, as `pump_clients` hands it a parsed
    message."""
    from scenery_insitu_tpu_torch.runtime.streaming import \
        make_camera_message

    for ident, cam in viewers:
        srv.handle(ident, dict(make_camera_message(cam), seq=seq,
                               tier=tier))


def p16_single(srv, tier, cam):
    """The independent single-camera `render_vdi_batch` render of one
    answer, on the server's adopted frame (its proxy and spec)."""
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops import vdi_novel as nv

    f, w, h = srv.frame, srv.cfg.width, srv.cfg.height
    one = nv.stack_cameras([cam])
    if tier == "exact":
        return nv.render_vdi_batch(f["vdi"], f["axcam0"], f["spec0"], one,
                                   w, h, tier="exact")[0]
    proxy = srv._ensure_proxy()
    spec_new = srv._spec_new_for(slicer.choose_axis(cam),
                                 tuple(proxy.data.shape[-3:]))
    return nv.render_vdi_batch(None, None, f["spec0"], one, w, h,
                               tier="proxy", proxy=proxy,
                               spec_new=spec_new)[0]


def p16_device_ops(fn):
    """Device operations (kernels, copies, fills) of one ``fn()``, from
    torch.profiler; None where the trace holds no device rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA)
    return n or None


def p16_serve_frame(srv, vdi, meta, cam0, tag, checked):
    """One adopted VDI frame served to a full bucket on each tier: the
    batch's ms (host clock, the answers on the host) and a viewer's,
    ``checked`` answers a tier against their single renders (exact and
    proxy within P16_SERVE_ATOL, wire within one u8 step), then the same
    cameras answered again from the cache with no render."""
    import numpy as np
    import torch

    from scenery_insitu_tpu_torch.core.camera import orbit

    srv.adopt(vdi, meta)
    out = {}
    for tier in ("exact", "proxy", "wire"):
        srv.outbox.clear()
        viewers = [(b"%s%s%02d" % (tag.encode(), tier.encode(), i),
                    orbit(cam0, y)) for i, y in enumerate(P16_YAWS)]
        p16_request(srv, viewers, tier, 1)
        batches = srv.stats["batches"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answered = srv.answer_pending()
        ms = (time.perf_counter() - t0) * 1e3
        if answered != P16_VIEWERS or \
                srv.stats["batches"] != batches + 1:
            raise AssertionError(f"serve {tier}: {answered} answers in "
                                 f"{srv.stats['batches'] - batches} "
                                 f"batches")
        gap = 0.0
        for k in range(checked):
            fields, blob = srv.outbox[k][1:]
            one = p16_single(srv, tier, viewers[k][1]).cpu().numpy()
            if tier == "wire":
                want = np.clip(np.round(one * 255.0), 0,
                               255).astype(np.uint8)
                got = np.frombuffer(blob, np.uint8).reshape(want.shape)
                g = float(np.abs(got.astype(np.int16)
                                 - want.astype(np.int16)).max())
                if g > 1.0:
                    raise AssertionError(f"serve wire answer {k} is {g} "
                                         f"u8 steps from its render")
            else:
                got = np.frombuffer(blob, np.float32).reshape(one.shape)
                g = float(np.abs(got - one).max())
                if not g <= P16_SERVE_ATOL:
                    raise AssertionError(f"serve {tier} answer {k} is "
                                         f"{g} from its render")
            gap = max(gap, g)
        srv.outbox.clear()
        p16_request(srv, viewers, tier, 2)
        t0 = time.perf_counter()
        cached = srv.answer_pending()
        cache_ms = (time.perf_counter() - t0) * 1e3
        if cached != P16_VIEWERS or srv.stats["batches"] != batches + 1 \
                or not all(f["cached"] for _, f, _ in srv.outbox):
            raise AssertionError(f"serve {tier}: the unchanged cameras "
                                 f"were not all served from the cache")
        out[tier] = dict(ms=ms, view_ms=ms / P16_VIEWERS, gap=gap,
                         cache_ms=cache_ms)
    return out


def run_serve(dev, payloads):
    """Phase 16 (b): the serving tier on the session's VDIs (512^3,
    temporal), through `ViewerServer.without_sockets`: P16_SERVED frames
    at ServeConfig's 128 x 96 (every answer checked) and one at the
    VDI's own width (P16_FULL_CHECKED answers a tier checked), each tier
    a full bucket of P16_VIEWERS cameras, the cache re-serving them; the
    device operations of a view on the exact and proxy tiers (phase 13
    prints a view's with --profile)."""
    from scenery_insitu_tpu_torch.config import FrameworkConfig
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.serve import ViewerServer

    frames = sorted(payloads)
    cam0 = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    ni = int(payloads[frames[0]]["vdi_color"].shape[-1])
    sizes = {"serve": (128, 96), "serve_full": (ni, ni * 3 // 4)}
    out = {}
    for prefix, (w, h) in sizes.items():
        cfg = FrameworkConfig().with_overrides(f"serve.width={w}",
                                               f"serve.height={h}")
        srv = ViewerServer.without_sockets(cfg, device=dev)
        served = frames[-P16_SERVED:] if prefix == "serve" else frames[-1:]
        for f in served:
            p = payloads[f]
            res = p16_serve_frame(
                srv, VDI(p["vdi_color"], p["vdi_depth"]), p["meta"], cam0,
                prefix,
                P16_VIEWERS if prefix == "serve" else P16_FULL_CHECKED)
            for tier, r in res.items():
                log(f"{prefix}_{tier}.frame{f}", f"{r['ms']:.3f} ms a batch "
                    f"of {P16_VIEWERS}, {r['view_ms']:.3f} a viewer, "
                    f"{w} x {h} (host clock, answers on the host); largest "
                    f"gap to single renders {r['gap']:.3e}; cache "
                    f"{r['cache_ms']:.3f} ms for all {P16_VIEWERS}")
            out[prefix] = res
        log(f"{prefix}.num_slices", srv.frame["num_slices"])
        if prefix == "serve":
            from scenery_insitu_tpu_torch.core.camera import orbit

            for tier in ("exact", "proxy"):
                view = p16_device_ops(lambda: p16_single(
                    srv, tier, orbit(cam0, P16_YAWS[0])))
                log(f"serve_{tier}.device_ops", f"{view} a view "
                    f"(torch.profiler; a batch renders its views one "
                    f"by one, {P16_VIEWERS} x that)")
        log(f"{prefix}.stats", json.dumps(srv.stats))
        srv.close()
    return out


def run_head(dev, field):
    """Phase 16 (c): the head node's depth-min composite of 8 rank
    images: phase 4's field cut into RANKS z slabs, each rendered by
    `slicer.raycast_mxu` at 1280 x 720 (image and first-hit depth), the
    head's numpy composite (`runtime/head.depth_min_composite_np`) equal
    to `ops/composite.composite_depth_min` on the card bit for bit."""
    import numpy as np
    import torch

    from scenery_insitu_tpu_torch.config import SliceMarchConfig
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.core.transfer import for_dataset
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.ops.composite import composite_depth_min
    from scenery_insitu_tpu_torch.runtime.head import depth_min_composite_np

    v = torch.as_tensor(field).to(dev)
    box = Volume.centered(v, extent=2.0)
    tf = for_dataset("gray_scott", device=dev)
    cam = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                        device=dev)
    d = v.shape[0] // RANKS
    imgs, deps = [], []
    for r in range(RANKS):
        slab = v[r * d:(r + 1) * d].contiguous()
        origin = box.origin.clone()
        origin[2] = origin[2] + r * d * box.spacing[2]
        vol = Volume(slab, origin, box.spacing)
        spec = slicer.make_spec(cam, tuple(slab.shape),
                                SliceMarchConfig(chunk=CHUNK))
        out = slicer.raycast_mxu(vol, tf, cam, GATHER_W, GATHER_H, spec)
        imgs.append(out.image)
        deps.append(out.depth)
    himgs = [x.cpu().numpy() for x in imgs]
    hdeps = [x.cpu().numpy() for x in deps]
    t0 = time.perf_counter()
    img, dep = depth_min_composite_np(himgs, hdeps)
    head_ms = (time.perf_counter() - t0) * 1e3
    stack_i, stack_d = torch.stack(imgs), torch.stack(deps)
    dev_ms = median_ms(lambda _: composite_depth_min(stack_i, stack_d), 5)
    want_i, want_d = (x.cpu().numpy()
                      for x in composite_depth_min(stack_i, stack_d))
    if not (np.array_equal(img, want_i) and np.array_equal(dep, want_d)):
        raise AssertionError("the head's composite differs from "
                             "composite_depth_min")
    live = float(np.isfinite(dep).mean())
    if not live > 0.0 or not float(img[3].max()) > 0.0:
        raise AssertionError("the head's composite is empty")
    log("head.composite", f"bit for bit composite_depth_min over {RANKS} "
        f"rank images {GATHER_W} x {GATHER_H}; head (numpy) "
        f"{head_ms:.3f} ms, card {dev_ms:.3f} ms; pixels with a hit "
        f"{live:.3f}")
    return dict(head_ms=head_ms, dev_ms=dev_ms)


def run_stream(pubs, payloads):
    """Phase 16 (d): the stream's encoding of the sessions' VDIs through
    `VDIPublisher(None)` (the encode path, its header fields and blobs),
    decoded back: the last frame in f32 with zlib bit for bit (its
    encode timed), the qpack8 P-frame streams' records (`ops/delta`) to
    the frames' codes bit for bit; bytes a frame against `ops/delta.
    modeled_delta_traffic` at the run's SKIP and P shares; the encode ms
    of the P-frame publishers from the sessions' sinks."""
    import numpy as np

    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.io.vdi_io import (decompress,
                                                    unpack_delta_payload)
    from scenery_insitu_tpu_torch.ops import delta as dl
    from scenery_insitu_tpu_torch.ops.wire import qpack8_quantize_np
    from scenery_insitu_tpu_torch.runtime.streaming import VDIPublisher

    frames = sorted(payloads)
    last = payloads[frames[-1]]
    pub = VDIPublisher(None, codec="zlib")
    t0 = time.perf_counter()
    pub.publish(VDI(last["vdi_color"], last["vdi_depth"]), last["meta"])
    f32_ms = (time.perf_counter() - t0) * 1e3
    fields, cb, db = pub.outbox[0]
    color = np.frombuffer(decompress(cb, fields["codec"]), np.float32)
    depth = np.frombuffer(decompress(db, fields["codec"]), np.float32)
    if not (np.array_equal(color, np.asarray(last["vdi_color"]).ravel())
            and np.array_equal(depth,
                               np.asarray(last["vdi_depth"]).ravel())):
        raise AssertionError("stream f32: the frame does not decode bit "
                             "for bit")
    out = {"f32": len(cb) + len(db), "f32_ms": f32_ms}
    for name in ("qpack8_delta", "qpack8_delta_8rank"):
        pub = pubs[name]
        dec = dl.DeltaDecoder()
        modes = collections.Counter()
        changed = slots = 0
        for i, (fields, cb, db) in enumerate(pub.outbox):
            dh = fields["delta"]
            cshape, dshape = fields["color_shape"], fields["depth_shape"]
            craw = decompress(cb, fields["codec"]) if cb else b""
            draw = decompress(db, fields["codec"]) if db else b""
            cp, dp_ = unpack_delta_payload(dh, craw, draw, tuple(cshape),
                                           tuple(dshape))
            got = dec.apply(-1, dh["mode"], dh["gen"], dh["base"], cp, dp_,
                            tuple(fields["qscale"]))
            if got is None:
                raise AssertionError(f"stream {name}: a record without "
                                     f"its base")
            if name == "qpack8_delta":
                p = payloads[frames[i]]
                cc, dd, _, _ = qpack8_quantize_np(
                    np.asarray(p["vdi_color"]), np.asarray(p["vdi_depth"]))
                if not (np.array_equal(got[0], cc)
                        and np.array_equal(got[1], dd)):
                    raise AssertionError(f"stream {name}: frame "
                                         f"{frames[i]}'s codes differ")
            modes[dh["mode"]] += 1
            if dh["mode"] == "P":
                changed += dh["c_n"]
                slots += int(np.prod(cshape))
        n = len(pub.outbox)
        k, h, w = pub.outbox[0][0]["color_shape"]      # packed RGBA
        model = dl.modeled_delta_traffic(
            k, h, w, skip_frac=modes["SKIP"] / n, p_frac=modes["P"] / n,
            residual_frac=changed / slots if slots else 0.0,
            iframe_period=P16_IFRAME)
        st = pub.delta_stats
        log(f"stream.{name}", f"modes {dict(modes)}; wire "
            f"{st['bytes_wire'] / n:.0f} B a frame (records' code "
            f"bytes) against the model's "
            f"{model['delta_bytes_per_frame']:.0f} of "
            f"{model['qpack8_bytes_per_frame']}; after zlib "
            f"{sum(len(cb) + len(db) for _, cb, db in pub.outbox) / n:.0f}"
            f" B a frame; stats {json.dumps(st)}")
        out[name] = dict(modes=dict(modes), model=model)
    log("stream.f32", f"{out['f32']} B a frame after zlib (K={K}, bit "
        f"for bit), its encode {f32_ms:.3f} ms on the host")
    return out


def run_h264(path, payloads):
    """Phase 16 (e): the session's I_PCM H.264 stream: its size equal to
    `io/h264.ipcm_stream_bytes` for the frames' decoded images."""
    from scenery_insitu_tpu_torch.io.h264 import ipcm_stream_bytes

    p = payloads[min(payloads)]
    h, w = p["vdi_color"].shape[-2:]
    want = ipcm_stream_bytes(int(w) & ~1, int(h) & ~1, len(payloads))
    got = os.path.getsize(path)
    log("h264.stream_bytes", f"{got} (the I_PCM layout's {want}; "
        f"{len(payloads)} frames of {w} x {h})")
    if got != want:
        raise AssertionError(f"the H.264 stream holds {got} bytes, the "
                             f"I_PCM layout {want}")
    return got


def run_sockets(dev, payloads):
    """Phase 16 (f), where pyzmq and msgpack are installed: the sockets
    in one process, session frames -> `VDIPublisher` -> `VDISubscriber`
    (bit for bit, f32 with zlib) -> `ViewerServer` -> `ViewerClient`
    (one answer a tier)."""
    import importlib.util

    missing = [m for m in ("zmq", "msgpack")
               if importlib.util.find_spec(m) is None]
    if missing:
        log("sockets", f"not run: {', '.join(missing)} not installed on "
            f"this machine (the loopback needs them; every other part of "
            f"phase 16 ran)")
        return None
    import numpy as np

    from scenery_insitu_tpu_torch.config import FrameworkConfig
    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.runtime import streaming as stm
    from scenery_insitu_tpu_torch.serve import (ViewerClient, ViewerFrame,
                                                ViewerServer)

    f = max(payloads)
    p = payloads[f]
    pub = stm.VDIPublisher("tcp://127.0.0.1:0", codec="zlib")
    sub = stm.VDISubscriber(pub.endpoint)
    srv = ViewerServer(FrameworkConfig(), connect=pub.endpoint,
                       bind="tcp://127.0.0.1:0", device=dev)
    clients = [ViewerClient(srv.endpoint, tier=t)
               for t in ("exact", "proxy", "wire")]
    try:
        deadline = time.monotonic() + 30
        got = None
        while time.monotonic() < deadline and (got is None
                                               or srv.frame is None):
            pub.publish(VDI(p["vdi_color"], p["vdi_depth"]), p["meta"])
            got = sub.receive(timeout_ms=100) if got is None else got
            srv.pump_stream(timeout_ms=100)
        if got is None or srv.frame is None:
            raise AssertionError("sockets: no frame crossed the loopback")
        if not (np.array_equal(got[0].color, np.asarray(p["vdi_color"]))
                and np.array_equal(got[0].depth,
                                   np.asarray(p["vdi_depth"]))):
            raise AssertionError("sockets: the subscriber's VDI differs")
        cam = orbit(Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5,
                                  far=20.0, device=dev), 0.1)
        for c in clients:
            c.request(cam)
        while time.monotonic() < deadline and \
                any(c.last is None for c in clients):
            srv.run_once(timeout_ms=10)
            for c in clients:
                c.poll(timeout_ms=0)
        if not all(isinstance(c.last, ViewerFrame) for c in clients):
            raise AssertionError("sockets: a viewer got no answer")
        log("sockets", f"loopback frame {f}: subscriber bit for bit, "
            f"answers {[(c.last.tier, c.last.wire_bytes) for c in clients]}")
        return True
    finally:
        for c in clients:
            c.close()
        srv.close()
        sub.close()
        pub.close()


def run_phase16(dev, done, phase3_launches=None, field=None):
    """Phase 16 (a)-(f); ``phase3_launches`` are phase 3's counts (None:
    the bf16 frames are held to the f32 frames' alone), ``field``
    phase 4's host field (made here when None). Returns each part's
    summary and the main path's launch counts."""
    import shutil
    import tempfile

    import torch

    t16 = time.perf_counter()
    bf16 = run_bf16(dev, phase3_launches)
    torch.cuda.empty_cache()
    done("phase16.a")
    tmp = tempfile.mkdtemp(prefix="p16_")
    try:
        launches, payloads, pubs, ms = run_p16_sessions(
            dev, os.path.join(tmp, "session.h264"))
        torch.cuda.empty_cache()
        done("phase16.sessions")
        serve = run_serve(dev, payloads)
        torch.cuda.empty_cache()
        done("phase16.b")
        if field is None:
            field = phase4_field(dev)
        head = run_head(dev, field)
        del field
        torch.cuda.empty_cache()
        done("phase16.c")
        stream = run_stream(pubs, payloads)
        done("phase16.d")
        h264 = run_h264(os.path.join(tmp, "session.h264"), payloads)
        done("phase16.e")
        sockets = run_sockets(dev, payloads)
        done("phase16.f")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("phase16.wall_s", f"{time.perf_counter() - t16:.1f} (bf16 "
        f"resampling, the serving tier, the head node, the stream, H.264 "
        f"and the sockets)")
    return dict(bf16=bf16, launches=launches, session_ms=ms, serve=serve,
                head=head, stream=stream, h264=h264, sockets=sockets)


# ------------------------------------------------------------ phase 17

P17_PROCS = 2               # the fleet: 2 processes x RANKS / 2 ranks
P17_FRAMES = 3              # (a): temporal frames after the seed
P17_SMALL = 32              # (c): the lost-host drill's grid (64^2 image)
P17_DROP_MS = 3000          # (c): the head's wait for the silent host
P17_SCALING_FRAMES = 5      # (d): timed frames a fleet
P17_KERNELS = ("seg_fold_compact", "count_multi", "resegment_sorted")


def p17_worker(ctx):
    """Phase 17's fleet worker (an entry of ``testing/multiproc.py``):
    one of P17_PROCS processes on gloo, holding RANKS / P17_PROCS ranks,
    all on one card. (a) the process mesh: the threshold seed and
    P17_FRAMES temporal frames of phase 4's step on this process's slabs
    of the field in the workdir (each frame's column block to a file,
    the last frame put together on process 0 by the host gather); (b)
    one host-path frame of phase 12's gather step, f32 tiles over
    loopback, merged at the head; (c) the gathers, the obs merge and the
    lost-host drill. The launches, times and bytes of each go to
    ``p17_<pid>.json``."""
    import numpy as np
    import torch

    from scenery_insitu_tpu_torch import kernels, obs
    from scenery_insitu_tpu_torch.config import CompositeConfig, VDIConfig
    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.parallel import hier
    from scenery_insitu_tpu_torch.parallel import multihost as mh

    wd, pid, nproc = ctx.workdir, ctx.process_id, ctx.num_processes
    dev = torch.device(ctx.device)
    with open(os.path.join(wd, "p17.json")) as f:
        cfg = json.load(f)
    rec = obs.Recorder(enabled=True, rank=pid)
    obs.set_recorder(rec)
    field = np.load(os.path.join(wd, "field.npy"), mmap_mode="r")
    grid = field.shape[0]
    origin = torch.tensor(cfg["origin"], device=dev)
    spacing = torch.tensor(cfg["spacing"], device=dev)
    mesh = mh.global_mesh(ctx.ranks_per_proc, dev)
    _, _, tf, _, seed, step, camera = dist_steps(dev, mesh.n, grid,
                                                 BASE_EYE, mesh=mesh)
    dn = grid // mesh.n
    lo = mesh.first_rank * dn
    slabs = mh.shard_global(np.ascontiguousarray(
        field[lo:lo + mesh.n_local * dn]), mesh)
    cuda = dev.type == "cuda"
    out = {}

    # (a) the process mesh
    kernels.reset_launches()
    mh.reset_wire_bytes()
    thr = seed(slabs, origin, spacing, camera(-1))
    ms, wall = [], []
    for i in range(cfg["frames"]):
        mh.barrier("p17a")
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        h0 = time.perf_counter()
        (vdi, _), thr = step(slabs, origin, spacing, camera(i), thr)
        if cuda:
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        wall.append((time.perf_counter() - h0) * 1e3)
        for part in ("color", "depth"):
            np.save(os.path.join(wd, f"a_{pid}_{i}_{part}.npy"),
                    getattr(vdi, part).cpu().numpy())
    out["a"] = dict(launches=kernels.launches(), ms=ms, wall_ms=wall,
                    wire=mh.wire_bytes())
    t0 = time.perf_counter()
    whole = mh.gather_vdi_compressed(vdi, codec="none")
    out["a"]["gather_ms"] = (time.perf_counter() - t0) * 1e3
    if pid == 0:
        np.save(os.path.join(wd, "a_whole_color.npy"), whole[0])
        np.save(os.path.join(wd, "a_whole_depth.npy"), whole[1])
    del whole, vdi, thr, slabs
    if cuda:
        torch.cuda.empty_cache()

    # (b) the host path of phase 12's gather step
    kernels.reset_launches()
    hp = hier.run_host_path(
        pid, nproc, field, tf, camera(0), origin, spacing, cfg["gw"],
        cfg["gh"], gather_vdi_cfg(), CompositeConfig(
            max_output_supersegments=K_OUT, adaptive_iters=COMP_ITERS),
        mesh.n_local, dev, max_steps=cfg["gsteps"], codec="none")
    out["b"] = dict(launches=kernels.launches(), sent=hp["sent"],
                    step_ms=hp["step_ms"])
    if pid == 0:
        c, d, degraded = hp["frames"][0]
        np.save(os.path.join(wd, "b_color.npy"), c)
        np.save(os.path.join(wd, "b_depth.npy"), d)
        out["b"].update(ms=hp["ms"], merge_ms=hp["merge_ms"],
                        received=hp["received"], degraded=degraded)
    del hp
    if cuda:
        torch.cuda.empty_cache()

    # (c) the gathers and the obs merge across the processes, then the
    # lost host: process 1 publishes nothing
    with rec.span("p17_rank_work", frame=pid):
        pass
    wp = 8
    color = torch.full((2, 4, 4, wp), float(pid + 1), device=dev)
    depth = torch.stack([torch.full((2, 4, wp), 0.1 * (pid + 1)),
                         torch.full((2, 4, wp), 0.2 * (pid + 1))],
                        dim=1).to(dev)
    tiles = mh.gather_vdi_tiles(VDI(color, depth), codec="zlib")
    tiles = None if tiles is None else list(tiles)
    whole = mh.gather_vdi_compressed(VDI(color, depth), codec="zlib")
    merged = mh.gather_obs_events(rec)
    f = grid // P17_SMALL
    small = np.ascontiguousarray(field[::f, ::f, ::f])
    box = Volume.centered(torch.from_numpy(small), extent=2.0)
    hp = hier.run_host_path(
        pid, nproc, small, tf, camera(0), box.origin.to(dev),
        box.spacing.to(dev), 2 * P17_SMALL, 2 * P17_SMALL,
        VDIConfig(max_supersegments=4, adaptive_iters=2),
        CompositeConfig(max_output_supersegments=6, adaptive_iters=2),
        mesh.n_local, dev, max_steps=64, silent=(1,),
        timeout_ms=P17_DROP_MS)
    if pid == 0:
        out["c"] = dict(
            tiles_ok=([t[0] for t in tiles] == [wp * p for p in
                                                range(nproc)]
                      and all(np.all(t[1] == p + 1)
                              for p, t in enumerate(tiles))),
            whole_ok=bool(whole[0].shape == (2, 4, 4, wp * nproc)),
            span_ranks=sorted({e.get("rank") for e in merged
                               if e.get("name") == "p17_rank_work"}),
            dcn_spans=sorted({e.get("name") for e in merged
                              if str(e.get("name", "")).startswith("dcn")}),
            drill_degraded=bool(hp["frames"][0][2]),
            drill_blocks=hp["frames"][0][0] is not None,
            host_down="multihost.host_down" in [
                e["component"] for e in obs.ledger()],
            transport_ledgered="multihost.transport" in [
                e["component"] for e in obs.ledger()])
    with open(os.path.join(wd, f"p17_{pid}.json"), "w") as fp:
        json.dump(out, fp)


def p17_same(prefix, got_c, got_d, want_c, want_d):
    """Bit for bit: colours, live slots and live depths; raises."""
    import numpy as np

    same = (got_c.shape == want_c.shape
            and np.array_equal(got_c, want_c)
            and np.array_equal(np.isinf(got_d), np.isinf(want_d))
            and np.array_equal(got_d[np.isfinite(want_d)],
                               want_d[np.isfinite(want_d)]))
    if not same:
        gap = (float(np.abs(got_c - want_c).max())
               if got_c.shape == want_c.shape else math.inf)
        raise AssertionError(f"{prefix}: the fleet's frame differs from "
                             f"the in-process one (colour gap {gap})")
    log(f"{prefix}.bitwise", f"equal ({got_c.shape[0]} slots, "
        f"{got_c.shape[2]} x {got_c.shape[3]})")


def p17_launch_gates(ref_launches, res, ranks):
    """(a): each process launched K1, K2 and K4, half as often as the
    in-process run of all the ranks; (b): K4 only at the head, once a
    tile it merged."""
    for p, r in enumerate(res):
        la = r["a"]["launches"]
        for name in P17_KERNELS:
            if la[name] <= 0 or 2 * la[name] != ref_launches[name]:
                raise AssertionError(
                    f"p17a: process {p} launched {name} {la[name]} "
                    f"times, the in-process run {ref_launches[name]}")
    k4 = [r["b"]["launches"]["resegment_sorted"] for r in res]
    if k4 != [ranks] + [0] * (len(res) - 1):
        raise AssertionError(f"p17b: K4 launches by process {k4}; the "
                             f"head merges {ranks} tiles")


def run_phase17(dev, done, field=None, gw=None, gh=None, gsteps=None):
    """Phase 17 (a)-(d): the multi-process fleet, two processes on the
    card over gloo. ``field`` is phase 4's host field (made here when
    None); ``gw``, ``gh``, ``gsteps`` phase 12's gather configuration
    (None: its full size). Returns the launch counts of the in-process
    references and of each worker's (a) and (b)."""
    import tempfile

    import numpy as np
    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.benchmarks import scaling_bench
    from scenery_insitu_tpu_torch.config import CompositeConfig
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.parallel import pipeline as dp
    from scenery_insitu_tpu_torch.parallel.hier import modeled_dcn_traffic
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.testing import multiproc

    t17 = time.perf_counter()
    gw, gh, gsteps = gw or GATHER_W, gh or GATHER_H, gsteps or GATHER_STEPS
    cuda = dev.type == "cuda"
    if field is None:
        field = phase4_field(dev)
        done("phase17.field")
    grid = field.shape[0]
    ranks = RANKS // P17_PROCS
    box = Volume.centered(torch.from_numpy(field), extent=2.0)
    origin, spacing = box.origin.to(dev), box.spacing.to(dev)
    log("p17.config", f"{P17_PROCS} processes x {ranks} ranks on {dev} "
        f"over gloo (NCCL refuses two ranks on one card); (a) phase 4's "
        f"step at {grid}^3, the seed and {P17_FRAMES} frames; (b) phase "
        f"12's gather step {gw}x{gh}, {gsteps} steps, f32 tiles, codec "
        f"none")

    # the in-process references: phase 4's 8-rank mesh on the same field
    mesh, _, tf, _, seed, step, camera = dist_steps(dev, RANKS, grid,
                                                    BASE_EYE)
    slabs = shard_volume(torch.from_numpy(field).to(dev), mesh)
    kernels.reset_launches()
    thr = seed(slabs, origin, spacing, camera(-1))
    ref_a, ms = [], []
    for i in range(P17_FRAMES):
        h0 = time.perf_counter()
        (vdi, _), thr = step(slabs, origin, spacing, camera(i), thr)
        ref_a.append((vdi.color.cpu().numpy(), vdi.depth.cpu().numpy()))
        ms.append((time.perf_counter() - h0) * 1e3)
    ref_launches = kernels.launches()
    log("p17a.in_process.launches", json.dumps(ref_launches))
    log("p17a.in_process.ms_per_frame", f"{sorted(ms)[len(ms) // 2]:.3f} "
        f"(one process, {RANKS} ranks in turn; host clock with the copy "
        f"to the host)")
    ccfg = CompositeConfig(max_output_supersegments=K_OUT,
                           adaptive_iters=COMP_ITERS)
    gstep = dp.distributed_vdi_step(mesh, tf, gw, gh, gather_vdi_cfg(), ccfg,
                                    max_steps=gsteps)
    h0 = time.perf_counter()
    g = gstep(slabs, origin, spacing, camera(0))
    ref_b = (g.color.cpu().numpy(), g.depth.cpu().numpy())
    log("p17b.in_process.ms", f"{(time.perf_counter() - h0) * 1e3:.3f} "
        f"(one frame, {RANKS} ranks in turn, host clock)")
    del slabs, thr, vdi, g
    if cuda:
        torch.cuda.empty_cache()
    done("phase17.references")

    with tempfile.TemporaryDirectory(prefix="p17_") as wd:
        np.save(os.path.join(wd, "field.npy"), field)
        with open(os.path.join(wd, "p17.json"), "w") as f:
            json.dump(dict(origin=origin.tolist(), spacing=spacing.tolist(),
                           frames=P17_FRAMES, gw=gw, gh=gh, gsteps=gsteps),
                      f)
        h0 = time.perf_counter()
        results = multiproc.run_multiproc(
            "chip_smoke:p17_worker", P17_PROCS, ranks, workdir=wd,
            timeout_s=600.0, device=dev)
        log("p17.fleet_wall_s", f"{time.perf_counter() - h0:.1f} (two "
            f"processes: start, (a), (b), (c))")
        for r in results:
            if not r.ok:
                raise AssertionError(f"phase 17 worker {r.process_id} "
                                     f"failed (rc {r.returncode}):\n"
                                     f"{r.output[-6000:]}")
        res = []
        for p in range(P17_PROCS):
            with open(os.path.join(wd, f"p17_{p}.json")) as f:
                res.append(json.load(f))
        load = lambda name: np.load(os.path.join(wd, name))

        # (a): every frame's blocks side by side, and the head's gather
        for i, (rc, rd) in enumerate(ref_a):
            got = [np.concatenate([load(f"a_{p}_{i}_{part}.npy")
                                   for p in range(P17_PROCS)], axis=-1)
                   for part in ("color", "depth")]
            p17_same(f"p17a.frame{i}", *got, rc, rd)
        p17_same("p17a.gathered", load("a_whole_color.npy"),
                 load("a_whole_depth.npy"), *ref_a[-1])
        p17_launch_gates(ref_launches, res, ranks)
        for p, r in enumerate(res):
            log(f"p17a.p{p}.launches", json.dumps(r["a"]["launches"]))
            t = sorted(r["a"]["ms"] or r["a"]["wall_ms"])
            log(f"p17a.p{p}.ms_per_frame", f"{t[len(t) // 2]:.3f} "
                f"(median of {P17_FRAMES}, "
                f"{'CUDA events' if r['a']['ms'] else 'host clock'}; two "
                f"processes time-slicing one card, not phase 4's ms)")
            log(f"p17a.p{p}.wire_bytes", json.dumps(r["a"]["wire"]))
        w = sorted(res[0]["a"]["wall_ms"])
        log("p17a.head_wall_ms_per_frame", f"{w[len(w) // 2]:.3f} (host "
            f"clock, the exchange's host copies included)")
        log("p17a.gather_ms", f"{res[0]['a']['gather_ms']:.1f} (the last "
            f"frame put together on process 0, codec none, the store)")

        # (b): the host path against the flat step, K4 at the head
        p17_same("p17b.frame", load("b_color.npy"), load("b_depth.npy"),
                 *ref_b)
        hb = res[0]["b"]
        if hb["degraded"]:
            raise AssertionError("p17b: the host-path frame is degraded")
        model = modeled_dcn_traffic(P17_PROCS, ranks, K, gh, gw)
        log("p17b.launches", json.dumps([r["b"]["launches"] for r in res]))
        log("p17b.dcn_bytes", f"sent a host {[r['b']['sent'][0] for r in res]}"
            f", received at the head {hb['received'][0]} (measured, every "
            f"host's whole partial to the head); modelled "
            f"{model['dcn_bytes_sent_per_host']} a host (the device "
            f"path's ring, one column sub-block a rank)")
        log("p17b.head_ms", f"{hb['ms'][0]:.1f} (barrier to assembled "
            f"frame, host clock); merge {hb['merge_ms'][0]:.1f} ({ranks} "
            f"tiles: upload, sort, K4, each waited for); steps "
            f"{[round(r['b']['step_ms'][0], 1) for r in res]} (march, "
            f"level 1 and publish, a host)")

        # (c): the gathers, the obs merge, the lost host
        c = res[0]["c"]
        if not (c["tiles_ok"] and c["whole_ok"] and c["span_ranks"] ==
                list(range(P17_PROCS)) and "dcn_allgather" in c["dcn_spans"]
                and c["transport_ledgered"]):
            raise AssertionError(f"p17c: the gathers or the obs merge: {c}")
        if not (c["drill_degraded"] and c["drill_blocks"] and
                c["host_down"]):
            raise AssertionError(f"p17c: the lost-host drill: {c}")
        log("p17c", f"gather_vdi_tiles in column order, both ranks' spans "
            f"{c['span_ranks']} with {c['dcn_spans']}; host 1 silent: the "
            f"frame degraded, multihost.host_down on the ledger")
    done("phase17.abc")

    # (d) the scaling twin at 1 and 2 hosts
    sweep = scaling_bench.hosts_mode(max_hosts=2, ranks_per_host=2,
                                     frames=P17_SCALING_FRAMES, device=dev)
    for row in sweep["sweep"]:
        if "error" in row:
            raise AssertionError(f"p17d: {row}")
        log(f"p17d.hosts{row['hosts']}", json.dumps(row))
    done("phase17.d")
    log("phase17.wall_s", f"{time.perf_counter() - t17:.1f} (the multi-"
        f"process fleet)")
    return dict(in_process=ref_launches,
                fleet=[r["a"]["launches"] for r in res],
                host_path=[r["b"]["launches"] for r in res])


# ------------------------------------------------------------- phase 18

P18_GRID = 512              # the demo producer's field: 512 MiB a slot
P18_SLOTS = 3               # the ring's slots (the demo producer's)
P18_PRODUCED = 4            # frames each demo producer publishes
P18_LIVE = 6                # session frames while the producer publishes
P18_GATE = 3                # frames of each session on the static frame
P18_WAIT_MS = 3000          # the live source's frame_timeout_ms
P18_KERNELS = ("seg_fold_compact", "count_multi", "resegment_sorted")
B10_SHAPES = ((8, 128), (8192, 8192))
B10_BAD_H = 8196            # not a multiple of 8: the wrapper raises


def load_b10():
    """The B10 fixture module (``tests/torch_lint_fixtures/good_cuda.py``,
    loaded by path): importing it registers its library with
    ``kernels``, so the start's build compiles it with the others."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "torch_lint_fixtures", "good_cuda.py")
    spec = importlib.util.spec_from_file_location("b10_good_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def p18_grid():
    """Prints /dev/shm's size; returns the largest power-of-two cube, at
    most P18_GRID, whose two rings (b: the 8 slab rings and the field's)
    fit in what is free, with a tenth to spare."""
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    log("p18.dev_shm", f"{st.f_blocks * st.f_frsize} B, {free} B free")
    g = P18_GRID
    while g > 16 and 2 * P18_SLOTS * g ** 3 * 4 * 1.1 > free:
        g //= 2
    if g != P18_GRID:
        log("p18.cut", f"grid {g}^3 in place of {P18_GRID}^3: /dev/shm "
            f"holds {free} B, two rings of {P18_GRID}^3 need "
            f"{2 * P18_SLOTS * P18_GRID ** 3 * 4} B")
    return g


class PlainFrame:
    """A sim adapter holding one field tensor: the ingest gate's
    reference."""

    kind = "external"

    def __init__(self, field):
        self.field = field

    def advance(self, n):
        pass


def p18_session(dev, g, sim, sinks=()):
    """Phase 4's 8-rank session (phase 7's settings) on an external
    sim's ``g``^3 field."""
    from scenery_insitu_tpu_torch.core.camera import Camera
    from scenery_insitu_tpu_torch.runtime.session import InSituSession

    cam = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                        device=dev)
    sess = InSituSession(session_config(g, ranks=RANKS), camera=cam,
                         sim=sim, sinks=list(sinks), device=dev)
    sess.orbit_rate = SESSION_ORBIT
    return sess


def p18_upload(prefix, src, nbytes):
    """The source's host-to-card copies: ms each (host clock, with the
    wait for the copy's event) and GB/s."""
    ms = sorted(src.upload_ms)
    med = ms[len(ms) // 2]
    log(f"{prefix}.h2d_ms", f"{med:.3f} (median of {len(ms)}: "
        f"{[round(x, 3) for x in src.upload_ms]}, host clock, {nbytes} B "
        f"a frame)")
    log(f"{prefix}.h2d_gbps", f"{nbytes / med / 1e6:.3f}")
    return med


def p18_vdi_ok(prefix, payload):
    import numpy as np

    c, d = payload["vdi_color"], payload["vdi_depth"]
    live = np.isfinite(d[:, 0])
    log(f"{prefix}.vdi", f"{c.shape} {d.shape}, live slots "
        f"{int(live.sum())}")
    if not (np.isfinite(c).all() and live.any()
            and np.all(np.isfinite(d) | (d == np.inf))):
        raise AssertionError(f"{prefix}: the VDI is not finite or has no "
                             f"live slot")


def run_ingest(dev, g, demo):
    """Phase 18 (a): the demo producer publishes P18_PRODUCED frames of
    its travelling Gaussian (``g``^3) while phase 4's 8-rank session
    renders P18_LIVE frames from ``ShmVolumeSource`` (the counts set to
    0 before, read after); then, the producer gone, a fresh source on
    the static final frame against a plain adapter holding that frame
    as a tensor, P18_GATE frames each, bit for bit. Returns (launches,
    the gate's frames, the live h2d ms)."""
    import subprocess as sp

    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.ingest import shm

    ch = f"/sitpu_p18_field_{os.getpid()}"
    nbytes = g ** 3 * 4
    prod = sp.Popen([demo, ch, "field", str(g), str(P18_PRODUCED), "0"],
                    stdout=sp.PIPE, stderr=sp.STDOUT, text=True)
    try:
        src = shm.ShmVolumeSource(ch, (g,) * 3, timeout_ms=120_000,
                                  frame_timeout_ms=P18_WAIT_MS, device=dev)
        live = {}
        sess = p18_session(dev, g, src, [capture_into(live)])
        kernels.reset_launches()
        ms, _ = timed_run(sess, P18_LIVE)
        launches = kernels.launches()
        out, _ = prod.communicate(timeout=300)
        if prod.returncode != 0:
            raise AssertionError(f"demo producer exited {prod.returncode}: "
                                 f"{out}")
        log("p18a.launches", json.dumps(launches))
        require_only(launches, P18_KERNELS, "phase 18 (a), the ingest "
                     "session")
        log("p18a.ms_per_frame", f"{ms:.3f} (host clock, mean of "
            f"{P18_LIVE} frames with the waits for the producer's, the "
            f"first seeding)")
        h2d = p18_upload("p18a", src, nbytes)
        stats = shm.channel_stats(ch)
        log("p18a.frames", f"consumed {src.frames} of {stats['last_seq']} "
            f"published (skipped {src.last_seq - src.frames}), producer "
            f"frames dropped {stats['frames_dropped']}, stall episodes "
            f"{src.stall_count}")
        p18_vdi_ok("p18a.live", live[P18_LIVE - 1])
        del sess, live
        src.close()
        # the gate: the static final frame, through a fresh source and as
        # a tensor through a plain adapter
        tensor = torch.from_numpy(shm.ShmConsumer(ch, (g,) * 3).latest(
            timeout_ms=1000)[0]).to(dev)
        gate = {}
        for name, sim in (
                ("ingest", shm.ShmVolumeSource(ch, (g,) * 3,
                                               timeout_ms=10_000,
                                               frame_timeout_ms=0,
                                               device=dev)),
                ("tensor", PlainFrame(tensor))):
            gate[name] = {}
            p18_session(dev, g, sim, [capture_into(gate[name])]).run(
                P18_GATE)
            if name == "ingest":
                if not torch.equal(sim.field, tensor):
                    raise AssertionError("p18a: the ingested frame differs "
                                         "from the final frame")
                sim.close()
        check_frames_equal("p18a.ingest_vs_tensor", gate["ingest"],
                           gate["tensor"])
        p18_vdi_ok("p18a.gate", gate["ingest"][P18_GATE - 1])
        return launches, gate["ingest"], h2d
    finally:
        if prod.poll() is None:
            prod.kill()
            prod.wait()
        shm.unlink(ch)
        torch.cuda.empty_cache()


def run_sharded(dev, g, demo, want):
    """Phase 18 (b): RANKS slab producers and one field producer of the
    same Gaussian, run to their end; ``ShmShardedVolumeSource`` on the
    8-rank mesh equals the field bit for bit, and its session's
    P18_GATE frames equal (a)'s gate frames ``want``. Returns the
    session's launches."""
    import subprocess as sp

    import torch

    from scenery_insitu_tpu_torch import kernels
    from scenery_insitu_tpu_torch.ingest import shm
    from scenery_insitu_tpu_torch.parallel.mesh import make_mesh

    pid = os.getpid()
    chans = [f"/sitpu_p18_slab{r}_{pid}" for r in range(RANKS)]
    whole = f"/sitpu_p18_whole_{pid}"
    procs = [sp.Popen([demo, c, "slab", str(g), str(P18_PRODUCED), "0",
                       str(r), str(RANKS)], stdout=sp.DEVNULL)
             for r, c in enumerate(chans)]
    procs.append(sp.Popen([demo, whole, "field", str(g), str(P18_PRODUCED),
                           "0"], stdout=sp.DEVNULL))
    try:
        t0 = time.perf_counter()
        rcs = [p.wait(timeout=300) for p in procs]
        log("p18b.producers_s", f"{time.perf_counter() - t0:.3f} "
            f"({RANKS} slab producers and the field's, in parallel)")
        if any(rcs):
            raise AssertionError(f"p18b: producers exited {rcs}")
        src = shm.ShmShardedVolumeSource(
            chans, (g // RANKS, g, g), make_mesh(RANKS, device=dev),
            timeout_ms=10_000, frame_timeout_ms=0)
        field = torch.from_numpy(shm.ShmConsumer(whole, (g,) * 3).latest(
            timeout_ms=1000)[0]).to(dev)
        if tuple(src.slabs.shape) != (RANKS, g // RANKS, g, g) or \
                not torch.equal(src.field, field):
            raise AssertionError("p18b: the assembled slabs differ from "
                                 "the field producer's frame")
        log("p18b.assembled", f"{tuple(src.slabs.shape)} bit for bit the "
            f"field's, seqs {src.last_seqs}")
        p18_upload("p18b", src, g ** 3 * 4)
        frames = {}
        sess = p18_session(dev, g, src, [capture_into(frames)])
        kernels.reset_launches()
        sess.run(P18_GATE)
        launches = kernels.launches()
        log("p18b.launches", json.dumps(launches))
        require_only(launches, P18_KERNELS, "phase 18 (b), the sharded "
                     "session")
        check_frames_equal("p18b.sharded_vs_ingest", frames, want)
        src.close()
        return launches
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for c in chans + [whole]:
            shm.unlink(c)
        torch.cuda.empty_cache()


def run_lz4(color, depth):
    """Phase 18 (c): a VDI (host arrays) through
    ``pack_vdi_segments(codec="lz4")`` in RANKS column segments and an
    lz4 ``.npz`` artifact, bit for bit; the ratio and MB/s each way
    (host clock)."""
    import shutil
    import tempfile

    import numpy as np

    from scenery_insitu_tpu_torch.core.vdi import VDI
    from scenery_insitu_tpu_torch.io import vdi_io

    k, _, h, w = color.shape
    raw = color.nbytes + depth.nbytes
    t0 = time.perf_counter()
    blobs, _, _ = vdi_io.pack_vdi_segments(VDI(color, depth), RANKS,
                                           codec="lz4")
    t1 = time.perf_counter()
    back = vdi_io.unpack_vdi_segments(blobs, k, h, w, codec="lz4")
    t2 = time.perf_counter()
    if not (np.array_equal(back.color, color)
            and np.array_equal(back.depth, depth)):
        raise AssertionError("p18c: lz4 segments do not round-trip")
    packed = sum(len(b) for b in blobs)
    log("p18c.segments", f"{raw} B -> {packed} B, ratio "
        f"{raw / packed:.3f}; compress {raw / (t1 - t0) / 1e6:.1f} MB/s, "
        f"decompress {raw / (t2 - t1) / 1e6:.1f} MB/s (host clock, "
        f"{RANKS} segments, bit for bit)")
    out = tempfile.mkdtemp(prefix="chip_smoke_lz4_")
    try:
        path = os.path.join(out, "vdi.npz")
        t0 = time.perf_counter()
        vdi_io.save_vdi(path, VDI(color, depth), codec="lz4")
        t1 = time.perf_counter()
        (c2, d2), _ = vdi_io.load_vdi(path)
        t2 = time.perf_counter()
        if not (np.array_equal(c2, color) and np.array_equal(d2, depth)):
            raise AssertionError("p18c: the lz4 .npz does not round-trip")
        log("p18c.npz", f"{os.path.getsize(path)} B, ratio "
            f"{raw / os.path.getsize(path):.3f}; save "
            f"{raw / (t1 - t0) / 1e6:.1f} MB/s, load "
            f"{raw / (t2 - t1) / 1e6:.1f} MB/s (host clock, bit for bit)")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return raw / packed


def b10_input(h, w, dev):
    """Seeded normals with +-0 rows; from 32 rows on, tile 1 holds a
    NaN, tile 2 is <= 0 with a -0 row (its max -0) and tile 3 <= 0 with
    a +0 row (its max +0)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((h, w), generator=gen, device=dev)
    x[h // 2] = -0.0
    x[h // 2 + 1] = 0.0
    if h >= 32:
        x[9, w // 3] = float("nan")
        x[16:32] = -x[16:32].abs()
        x[16] = -0.0
        x[27] = 0.0
    return x


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN positions equal (NaN payloads not
    compared)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32)))


def run_lint_b10(dev, b10):
    """Phase 18 (d): the port's lint exits 0 with --fail-on-stale; B10 at
    B10_SHAPES (the counts set to 0 before those two calls, read after)
    equals its plain version bit for bit, NaN and +-0 tiles included;
    a height of B10_BAD_H raises; B10 with the stream kept full beside
    its bound, its plain version and the two torch calls."""
    import subprocess as sp

    import torch

    from scenery_insitu_tpu_torch import kernels

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    lint = sp.run([sys.executable, "-m", "scenery_insitu_tpu_torch.tools.lint",
                   "--fail-on-stale"], cwd=root, capture_output=True,
                  text=True, timeout=300)
    last = (lint.stdout.strip().splitlines() or [""])[-1]
    log("p18d.lint", f"exit {lint.returncode} in "
        f"{time.perf_counter() - t0:.1f} s: {last}")
    if lint.returncode != 0:
        raise AssertionError(f"p18d: the lint failed:\n{lint.stdout}"
                             f"{lint.stderr}")
    xs = [b10_input(h, w, dev) for h, w in B10_SHAPES]
    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = [b10.double_chunk(x) for x in xs]
    torch.cuda.synchronize()
    launches = kernels.launches()
    log("p18d.launches", json.dumps(launches))
    require_only(launches, ("double_chunk",), "phase 18 (d), B10")
    err = 0.0
    for (h, w), x, got in zip(B10_SHAPES, xs, outs):
        want = b10.double_chunk_plain(x)
        for g_, w_ in zip(got, want):
            if not same_bits(g_, w_):
                raise AssertionError(f"p18d: B10 at {h}x{w} differs from "
                                     f"its plain version")
            fin = ~torch.isnan(w_)
            err = max(err, float((g_[fin] - w_[fin]).abs().max()))
        log(f"b10_{h}x{w}.bit_exact", f"y and the {h // 8} tile maxima "
            f"(NaN tiles {int(torch.isnan(got[1]).sum())})")
    m = outs[1][1][:4, 0].tolist()
    if not (math.isnan(m[1]) and m[2] == 0 and math.copysign(1, m[2]) < 0
            and m[3] == 0 and math.copysign(1, m[3]) > 0):
        raise AssertionError(f"p18d: tiles 1-3's maxima {m}: expected NaN, "
                             f"-0, +0")
    try:
        b10.double_chunk(torch.zeros((B10_BAD_H, 128), device=dev))
    except ValueError as e:
        log("b10_bad_height", f"raises before the launch: {e}")
    else:
        raise AssertionError(f"p18d: B10 took a height of {B10_BAD_H}")
    x = xs[1]
    h, w = x.shape
    ms = stream_ms(lambda: b10.double_chunk(x))
    plain = stream_ms(lambda: b10.double_chunk_plain(x))
    pair = stream_ms(lambda: (x * 2, x.view(h // 8, -1).amax(1)))
    bnd, by = bound_ms(2 * h * w * 4 + h // 8 * 4, 2 * h * w)
    log("b10.ms", f"{ms:.4f} (stream kept full, {h}x{w}; bound {bnd:.4f} "
        f"by {by}; plain {plain:.4f}; x * 2 and amax {pair:.4f})")
    return dict(launches=launches["double_chunk"], err=err, ms=ms,
                plain_ms=plain, pair_ms=pair, bound_ms=bnd, bound_by=by)


def run_phase18(dev, done, b10, vdi=None):
    """Phase 18 (a)-(d): the external simulation's ingest on the card,
    its sharded feed, LZ4 on ``vdi`` (phase 3's, host arrays; (a)'s last
    VDI when None) and the lint with B10."""
    from scenery_insitu_tpu_torch.ingest import shm

    t18 = time.perf_counter()
    g = p18_grid()
    t0 = time.perf_counter()
    demo = shm.ensure_built()["demo_producer"]
    log("p18.native_build_s", f"{time.perf_counter() - t0:.2f}")
    launches, gate, h2d = run_ingest(dev, g, demo)
    done("phase18.a")
    sharded = run_sharded(dev, g, demo, gate)
    done("phase18.b")
    if vdi is None:
        vdi = (gate[P18_GATE - 1]["vdi_color"],
               gate[P18_GATE - 1]["vdi_depth"])
    ratio = run_lz4(*vdi)
    done("phase18.c")
    lint = run_lint_b10(dev, b10)
    done("phase18.d")
    log("phase18.wall_s", f"{time.perf_counter() - t18:.1f} (the ingest, "
        f"LZ4 and the lint)")
    return dict(ingest=launches, sharded=sharded, grid=g, h2d_ms=h2d,
                lz4_ratio=ratio, b10=lint)



# ------------------------------------------------------------- phase 19

# the unprofiled frame ms of earlier runs on the card, before the phase
# scopes (CUDA events, median of TIMED_FRAMES): phase 3's single-chip
# frame and phase 4's 8-rank frame
P3_RANGE_MS = (110.634, 120.193)
P4_RANGE_MS = (143.756, 191.856)
P19_FRAMES = 2                  # profiled frames a capture
P19_WARMUP = 1                  # its warm-up frames, traced and dropped
P19_SUM_TOL = 0.15              # phases' sum against the wall
# the attributed kernels: C entry -> (kernel function, the phase it runs in)
P19_KERNELS = {"grayscott_fused": ("grayscott_stream_kernel", "sim_step"),
               "seg_fold_compact": ("seg_fold_kernel", "march"),
               "count_multi": ("count_multi_kernel", "march"),
               "resegment_sorted": ("resegment_kernel", "resegment")}


def p19_window(prefix, run, entries, frames):
    """`ProfileCapture` over ``frames`` calls of ``run`` after its
    warm-up call, with the launch counts set to 0 between the two and
    read after: the capture succeeds, every phase is in the catalog,
    the phases sum to the wall within P19_SUM_TOL, and every launch of
    each C entry of
    ``entries`` (each launched at least once) shows in the trace joined
    to its phase. Returns (attribution, launches, {entry: device ms a
    frame})."""
    import torch

    from scenery_insitu_tpu_torch import kernels, obs
    from scenery_insitu_tpu_torch.obs.profiler import (EXTRA_PHASES, PHASES,
                                                       ProfileCapture)

    obs.clear_ledger()
    calls = [0]

    def counted():
        # the counts start with the measured frames, after the capture's
        # warm-up frame (its events are dropped with the warm-up step)
        calls[0] += 1
        if calls[0] == P19_WARMUP + 1:
            torch.cuda.synchronize()
            kernels.reset_launches()
        run()

    cap = ProfileCapture(frames=frames, warmup=P19_WARMUP)
    attr = cap.capture(None, step=counted)
    launches = kernels.launches()
    if attr is None or any(e["component"] == "obs.profiler"
                           for e in obs.ledger()):
        raise AssertionError(f"{prefix}: the capture failed: "
                             f"{obs.ledger()}")
    log(f"{prefix}.attribution", json.dumps(attr))
    bad = set(attr["phases"]) - set(PHASES) - set(EXTRA_PHASES)
    if bad:
        raise AssertionError(f"{prefix}: phases outside the catalog: {bad}")
    total = sum(p["ms"] for p in attr["phases"].values())
    wall = attr["wall_ms_per_frame"]
    log(f"{prefix}.sum_vs_wall_ms", f"{total:.3f} of {wall:.3f} (gate "
        f"within {P19_SUM_TOL:.0%}; devices {attr['devices']}, coverage "
        f"{attr['coverage']})")
    if abs(total - wall) > P19_SUM_TOL * wall:
        raise AssertionError(f"{prefix}: phases sum to {total} ms, the "
                             f"wall is {wall} ms")
    ms = {}
    for entry in entries:
        fn, want = P19_KERNELS[entry]
        rows = [(ph, dur) for name, ph, dur in cap.rows if fn in name]
        phases = collections.Counter(ph for ph, _ in rows)
        log(f"{prefix}.{entry}.joined", f"{dict(phases)} of "
            f"{launches[entry]} launches (want all in {want})")
        if launches[entry] < 1 or len(rows) != launches[entry] \
                or phases[want] != len(rows):
            raise AssertionError(
                f"{prefix}: {entry} launched {launches[entry]} times, "
                f"trace rows by phase {dict(phases)} (want every one in "
                f"{want})")
        ms[entry] = sum(d for _, d in rows) / 1e3 / frames
    return attr, launches, ms


def p19_frame_ms(prefix, run, want_range):
    """The frame's unprofiled ms with the scopes in place (CUDA events,
    median of TIMED_FRAMES after a warm-up call), logged beside the
    range of earlier runs; no gate."""
    import torch

    run()
    torch.cuda.synchronize()
    ev = []
    for _ in range(TIMED_FRAMES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        ev.append(a.elapsed_time(b))
    ev.sort()
    ms = ev[len(ev) // 2]
    log(f"{prefix}.unprofiled_ms", f"{ms:.3f} (median of {TIMED_FRAMES}, "
        f"CUDA events; before the scopes: {want_range[0]}-"
        f"{want_range[1]})")
    return ms


def p19_paths(dev):
    """(a) and (b) on phase 3's single-chip frame and phase 4's 8-rank
    frame: each seeded, its unprofiled ms, its seed and P19_FRAMES frames
    under the capture, and the same frames through `profile_frames`;
    the kernels' device ms from both, side by side."""
    import torch

    from scenery_insitu_tpu_torch.core.camera import Camera, orbit
    from scenery_insitu_tpu_torch.core.volume import Volume
    from scenery_insitu_tpu_torch.models.pipelines import \
        grayscott_vdi_frame_step
    from scenery_insitu_tpu_torch.obs.profiler import phase
    from scenery_insitu_tpu_torch.ops import slicer
    from scenery_insitu_tpu_torch.parallel.mesh import shard_volume
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    out = {}
    # phase 3's frame
    base = Camera.create(BASE_EYE, fov_y_deg=50.0, near=0.5, far=20.0,
                         device=dev)
    step = grayscott_vdi_frame_step(grid_shape=(GRID,) * 3,
                                    axis_sign=slicer.choose_axis(base),
                                    **frame_config(dev))
    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    state = [st.u, st.v, None]
    count = [0]

    def eye():
        count[0] += 1
        return orbit(base, yaw_of(count[0])).eye

    def seed3():
        state[2] = step.init_threshold(state[0], state[1], eye())

    def frame3():
        _, _, state[0], state[1], state[2] = step(state[0], state[1], eye(),
                                                  state[2])

    seed3()
    frame3()
    out["p3_ms"] = p19_frame_ms("phase19.p3", frame3, P3_RANGE_MS)
    out["p3_seed"] = p19_window("phase19.p3_seed", seed3, ("count_multi",),
                                1)
    out["p3"] = p19_window("phase19.p3", frame3,
                           ("grayscott_fused", "seg_fold_compact"),
                           P19_FRAMES)
    own, trace = profile_frames("phase19.p3.profile", lambda i: frame3(),
                                P19_FRAMES)
    os.remove(trace)
    p19_beside("phase19.p3", out["p3"][2], own, P19_FRAMES)
    del step, state[:]
    torch.cuda.empty_cache()

    # phase 4's frame: the sim advance under its sim_step scope, as the
    # reference's frame body scopes it
    mesh, spec, tf, _, seed, step, camera = dist_steps(dev, RANKS, GRID,
                                                       BASE_EYE)
    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    box = Volume.centered(st.v, extent=2.0)
    origin, spacing = box.origin, box.spacing
    dstate = [st.u, st.v, None]
    count[0] = 0

    def seed4():
        dstate[2] = seed(shard_volume(dstate[1], mesh), origin, spacing,
                         camera(-1))

    def frame4():
        with phase("sim_step"):
            s = gs.multi_step_fast(gs.GrayScott(dstate[0], dstate[1],
                                                st.params), SIM_STEPS)
        count[0] += 1
        (_, _), dstate[2] = step(shard_volume(s.field, mesh), origin,
                                 spacing, camera(count[0]), dstate[2])
        dstate[0], dstate[1] = s.u, s.v

    seed4()
    frame4()
    out["p4_ms"] = p19_frame_ms("phase19.p4", frame4, P4_RANGE_MS)
    out["p4_seed"] = p19_window("phase19.p4_seed", seed4, ("count_multi",),
                                1)
    out["p4"] = p19_window("phase19.p4", frame4,
                           ("grayscott_fused", "seg_fold_compact",
                            "resegment_sorted"), P19_FRAMES)
    own, trace = profile_frames("phase19.p4.profile", lambda i: frame4(),
                                P19_FRAMES)
    os.remove(trace)
    p19_beside("phase19.p4", out["p4"][2], own, P19_FRAMES)
    del step, dstate[:]
    torch.cuda.empty_cache()
    return out


def p19_beside(prefix, ms, own, frames):
    """Each attributed kernel's device ms a frame from the capture beside
    `profile_frames`' figure over the same frames' calls."""
    for entry, got in ms.items():
        fn = P19_KERNELS[entry][0]
        theirs = sum(v[0] for k, v in own.items() if k.startswith(fn))
        log(f"{prefix}.{entry}.ms_per_frame", f"capture {got:.3f}, "
            f"profile_frames {theirs / frames:.3f}")


P19_BENCH_FIELDS = ("vs_baseline", "vs_baseline_unscaled",
                    "vs_baseline_note", "mfu_matmul", "hbm_gbps",
                    "hbm_frac_peak", "hbm_bytes_per_frame",
                    "hbm_bytes_source", "cost_analysis",
                    "phase_attribution", "roofline_verdicts")


def p19_bench(dev):
    """(c) the bench twin at 512 with the phase attribution: every
    roofline field non-null, both shares of peak in (0, 1]."""
    from scenery_insitu_tpu_torch import bench

    res = bench.run(dev, env={"SITPU_BENCH_GRID": str(GRID),
                              "SITPU_BENCH_FRAMES": str(BENCH_FRAMES),
                              "SITPU_BENCH_PROFILE": "1",
                              "SITPU_BENCH_PROFILE_FRAMES": "2"})
    log("phase19.bench_twin", json.dumps(res))
    missing = [k for k in P19_BENCH_FIELDS if res.get(k) is None]
    if missing:
        raise AssertionError(f"bench twin: null fields {missing}")
    for key in ("hbm_frac_peak", "mfu_matmul"):
        if not 0.0 < res[key] <= 1.0:
            raise AssertionError(f"bench twin: {key} = {res[key]} is not a "
                                 f"share of peak in (0, 1]")
    log("phase19.bench_roofline", f"ms_per_frame {res['ms_per_frame']} "
        f"mfu_matmul {res['mfu_matmul']} hbm_gbps {res['hbm_gbps']} "
        f"hbm_frac_peak {res['hbm_frac_peak']} (source "
        f"{res['hbm_bytes_source']}, {res['hbm_bytes_per_frame']} bytes a "
        f"frame; {res['config']['device']} at {res['config']['power_limit']})")
    return res


def p19_session(dev):
    """(d) phase 4's 8 ranks as a session (histogram thresholds, async
    delivery) publishing to a `Collector` in this process: linked, 3
    frames under ``run(profile_dir=...)``, the merged fleet trace holds
    the session's spans and its frames' lineage, the profile trace names
    the port's kernels, and ``device_snapshot`` counts the regime step's
    bytes, its kernels' among them."""
    import shutil
    import tempfile
    import threading

    from scenery_insitu_tpu_torch.obs.collector import Collector

    col = Collector()
    tmp = tempfile.mkdtemp(prefix="p19_", dir=os.path.abspath("."))
    try:
        cfg = session_config(GRID, ranks=RANKS).with_overrides(
            "vdi.adaptive_mode=histogram", "obs.enabled=true",
            f"obs.collector={col.endpoint}",
            f"obs.collector_hb={col.hb_endpoint}",
            "obs.collector_interval_s=0.001", "delivery.enabled=true")
        sess = session(dev, cfg, sinks=(lambda i, p: None,))
        deadline = time.monotonic() + 20.0
        while not sess._obs_pub.linked and time.monotonic() < deadline:
            sess._obs_pub.probe()
            col.poll(10)
        if not sess._obs_pub.linked:
            raise AssertionError("session: the publisher never linked")
        # the collector answers heartbeats while the session runs (its
        # sockets are this thread's alone until the join)
        stop = threading.Event()
        poller = threading.Thread(target=lambda: [
            col.poll(10) for _ in iter(stop.is_set, True)])
        poller.start()
        try:
            sess.run(1)
            sess.run(3, profile_dir=tmp)
        finally:
            stop.set()
            poller.join(timeout=30)
        for _ in range(100):
            col.poll(20)
        merged = col.merged_events()
        names = collections.Counter(e["name"] for e in merged)
        frames = col.frames_seen()
        log("phase19.session.fleet", f"batches {col.batches}, events "
            f"{dict(names)}, lineage frames {frames}")
        if not ({"sim", "dispatch", "fetch"} <= set(names)
                and set(range(4)) <= set(frames)):
            raise AssertionError(f"session: the fleet trace lacks spans or "
                                 f"lineage: {dict(names)}, {frames}")
        with open(os.path.join(tmp, "trace.json")) as f:
            text = f.read()
        found = [fn for fn, _ in P19_KERNELS.values() if fn in text]
        log("phase19.session.profile_trace", f"{len(text)} bytes, kernels "
            f"{found}")
        if len(found) != len(P19_KERNELS):
            raise AssertionError(f"session: the profile trace names "
                                 f"{found} of the port's kernels")
        snaps = sess.device_snapshot()
        log("phase19.session.device_snapshot", json.dumps(snaps))
        key = str(sess._slicer.choose_axis(sess.camera))
        snap = snaps.get(key) or {}
        if not (snap.get("source") == "torch_dispatch_count"
                and snap.get("kernel_bytes", 0) > 0
                and snap["bytes_accessed"] > snap["kernel_bytes"]):
            raise AssertionError(f"session: device_snapshot {snaps}")
        return snaps
    finally:
        col.close()
        shutil.rmtree(tmp, ignore_errors=True)


def p19_chaos(dev):
    """(e) the chaos matrix at seed 7 with the serving scenarios on the
    card: every scenario ok."""
    from scenery_insitu_tpu_torch.testing.faults import run_matrix

    rep = run_matrix(seed=7, device=dev)
    bad = [s for s in rep["scenarios"] if not s["ok"]]
    log("phase19.chaos", f"{sum(s['ok'] for s in rep['scenarios'])}/"
        f"{len(rep['scenarios'])} scenarios ok")
    if bad or len(rep["scenarios"]) != 15:
        raise AssertionError(f"chaos matrix: {bad}")
    return rep


def run_phase19(dev, done):
    """Phase 19 (a)-(e); returns the attributed kernels' rows."""
    out = p19_paths(dev)
    done("phase19.ab")
    out["bench"] = p19_bench(dev)
    done("phase19.c")
    out["snaps"] = p19_session(dev)
    done("phase19.d")
    p19_chaos(dev)
    done("phase19.e")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile two frames of each path: device "
                         "time by kernel "
                         "and the device's busy share")
    ap.add_argument("--k1-compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another design of csrc/seg_fold.cu (the same C "
                         "entries) to check and time in turns with K1 and "
                         "B1b in phase 2; repeatable")
    ap.add_argument("--fused-compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another design of csrc/fused_fold.cu (the same C "
                         "entries) to check and time in turns with B5 and "
                         "B6 in phase 2; repeatable")
    ap.add_argument("--k4-compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another design of csrc/resegment.cu (the same C "
                         "entries) to check and time in turns with K4 in "
                         "phase 4; repeatable")
    ap.add_argument("--k2-compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another design of csrc/count_multi.cu (the same "
                         "C entries) to check and time in turns with K2 in "
                         "phase 2; repeatable")
    ap.add_argument("--phase11-only", action="store_true",
                    help="run the build, phase 4's distributed frame (the "
                         "reference of phase 11 (a)) and phase 11 only, "
                         "then exit without the kernel table")
    ap.add_argument("--phase12-only", action="store_true",
                    help="run the build and phase 12 only (the gather "
                         "engine and the plain images), then exit without "
                         "the kernel table")
    ap.add_argument("--phase13-only", action="store_true",
                    help="run the build and phase 13 only (the VDI's novel "
                         "views, the pre-shaded march and its AO), then "
                         "exit without the kernel table")
    ap.add_argument("--phase14-only", action="store_true",
                    help="run the build and phase 14 only (the vortex, "
                         "Lennard-Jones and hybrid sessions of the "
                         "reference's Configs 3-5), then exit without the "
                         "kernel table")
    ap.add_argument("--phase15-only", action="store_true",
                    help="run the build and phase 15 only (the multi-grid "
                         "scene session, steering with the scenario zoo "
                         "and the example twins), then exit without the "
                         "kernel table")
    ap.add_argument("--phase16-only", action="store_true",
                    help="run the build and phase 16 only (bf16 "
                         "resampling, the serving tier, the head node, the "
                         "stream, H.264 and the sockets), then exit "
                         "without the kernel table")
    ap.add_argument("--phase17-only", action="store_true",
                    help="run the build and phase 17 only (the "
                         "multi-process fleet: the process mesh, the "
                         "host path, the gathers and the scaling twin), "
                         "then exit without the kernel table")
    ap.add_argument("--phase18-only", action="store_true",
                    help="run the build and phase 18 only (the external "
                         "simulation's ingest, its sharded feed, LZ4 and "
                         "the lint with B10), then exit without the "
                         "kernel table")
    ap.add_argument("--phase19-only", action="store_true",
                    help="run the build and phase 19 only (phase "
                         "attribution, the bench twin's roofline fields, "
                         "the collector with a session, the chaos "
                         "matrix), then exit without the kernel table")
    ap.add_argument("--events-compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another design of csrc/fold_chunk.cu (the same C "
                         "entries) whose B8 and B9 to check and time in "
                         "turns with this tree's in phase 6; repeatable")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from scenery_insitu_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("torch", f"{torch.__version__} cuda={torch.version.cuda} "
        f"python={sys.version.split()[0]}")
    dev = torch.device("cuda")
    log("device", torch.cuda.get_device_name(0))
    b10 = load_b10()
    build_s = kernels.build(kernels.LIBRARIES + ("good_double",))
    log("build_s", f"{build_s:.2f}")

    t0 = time.perf_counter()

    def phase_done(name):
        log(f"{name}.wall_s", f"{time.perf_counter() - t0:.1f} (since the "
            f"build)")

    if args.phase12_only:
        run_phase12(dev, phase_done, args.profile)
        phase_done("phase12")
        log("phase12_only", "done (no kernel table: run without flags for "
            "it)")
        return 0
    if args.phase13_only:
        run_phase13(dev, phase_done, args.profile)
        phase_done("phase13")
        log("phase13_only", "done (no kernel table: run without flags for "
            "it)")
        return 0
    if args.phase14_only:
        run_phase14(dev, phase_done)
        phase_done("phase14")
        log("phase14_only", "done (no kernel table: run without flags for "
            "it)")
        return 0
    if args.phase15_only:
        run_phase15(dev, phase_done)
        phase_done("phase15")
        log("phase15_only", "done (no kernel table: run without flags for "
            "it)")
        return 0
    if args.phase16_only:
        run_phase16(dev, phase_done)
        phase_done("phase16")
        log("phase16_only", "done (no kernel table: run without flags for "
            "it)")
        return 0
    if args.phase18_only:
        run_phase18(dev, phase_done, b10)
        phase_done("phase18")
        log("phase18_only", "done (no kernel table: run without flags for "
            "it)")
        return 0
    if args.phase19_only:
        run_phase19(dev, phase_done)
        phase_done("phase19")
        log("phase19_only", "done (no kernel table: run without flags for "
            "it)")
        return 0
    if args.phase17_only:
        run_phase17(dev, phase_done)
        phase_done("phase17")
        log("phase17_only", "done (no kernel table: run without flags for "
            "it)")
        return 0
    if args.phase11_only:
        dist_ref = run_dist_frame(dev, args.profile)[3]
        phase_done("phase4")
        run_phase11(dev, dist_ref, phase_done, args.profile)
        phase_done("phase11")
        log("phase11_only", "done (no kernel table: run without flags for "
            "it)")
        return 0
    compare = compare_folds(args.k1_compare)
    fused_compare = compare_fused(args.fused_compare)
    k4_compare = compare_resegments(args.k4_compare)
    k2_compare = compare_counts(args.k2_compare)
    designs = event_designs(args.events_compare)
    g = gs_init(dev)
    cap = capture_chunks(dev, g.u, g.v, (0.0, 0.6, 3.0))
    stencil = check_stencil(dev)
    fold = check_fold_and_count(dev, cap["chunks"], cap["thr"],
                                cap["length"], compare, k2_compare)
    new = check_new_folds(dev, cap, compare, fused_compare)
    del cap
    ranges = check_stencil_ranges(dev, g)
    del g
    torch.cuda.empty_cache()
    phase_done("phase2")
    launches, ref = run_frame(dev, args.profile)
    check_small_frame(dev)
    phase_done("phase3")
    folds = run_fold_frames(dev, ref, args.profile)
    phase_done("phase3b.frames")
    for f in FOLD_KERNELS:
        check_small_frame(dev, f)
    torch.cuda.empty_cache()
    phase_done("phase3b")
    dist_launches, rc, rd, dist_ref = run_dist_frame(dev, args.profile)
    reseg = check_resegment(dev, rc, rd, k4_compare)
    del rc, rd
    # phase 15's scene: phase 4's field after its frames, on the host
    scene_field = dist_ref["v"].cpu().numpy()
    torch.cuda.empty_cache()
    check_small_dist(dev)
    phase_done("phase4")
    occ_launches = run_occupancy_frames(dev, ref, args.profile)
    del ref
    torch.cuda.empty_cache()
    phase_done("phase5.frames")
    for f in ("pallas_seg",) + tuple(FOLD_KERNELS) + ("seg", "xla"):
        check_small_frame(dev, f, occupancy="sim")
    torch.cuda.empty_cache()
    run_bench_twin(dev)
    phase_done("phase5")
    events = check_event_folds(dev, designs)
    torch.cuda.empty_cache()
    phase_done("phase6.gates")
    t6 = time.perf_counter()
    micro_launches, _ = run_microbench(dev)
    log("phase6.wall_s", f"{time.perf_counter() - t6:.1f} (the sweep)")
    torch.cuda.empty_cache()
    phase_done("phase6")
    t7 = time.perf_counter()
    session_launches = run_session(dev)
    torch.cuda.empty_cache()
    small_session_launches = check_small_session(dev)
    log("phase7.wall_s", f"{time.perf_counter() - t7:.1f} (the session)")
    phase_done("phase7")
    t8 = time.perf_counter()
    exch = run_exchange_frames(dev, dist_ref, args.profile)
    torch.cuda.empty_cache()
    phase_done("phase8.frames")
    check_small_exchange(dev)
    phase_done("phase8.small")
    waves_session_launches = run_session_waves(
        dev, exch["c7_ring_waves"]["ms"])
    torch.cuda.empty_cache()
    log("phase8.wall_s", f"{time.perf_counter() - t8:.1f} (the exchange "
        f"schedules)")
    phase_done("phase8")
    t9 = time.perf_counter()
    decomp = run_decomp_frames(dev, dist_ref, args.profile)
    torch.cuda.empty_cache()
    phase_done("phase9.frames")
    check_small_decomp(dev)
    phase_done("phase9.small")
    decomp_sessions = run_decomp_sessions(dev)
    log("phase9.wall_s", f"{time.perf_counter() - t9:.1f} (the render "
        f"decomposition)")
    phase_done("phase9")
    t10 = time.perf_counter()
    hier = run_hier_frames(dev, dist_ref, decomp.pop("p1_frame"),
                           args.profile)
    torch.cuda.empty_cache()
    phase_done("phase10.frames")
    check_small_hier(dev)
    phase_done("phase10.small")
    hier_session_launches, _ = run_hier_session(dev)
    log("phase10.wall_s", f"{time.perf_counter() - t10:.1f} (the two-level "
        f"composite)")
    phase_done("phase10")
    t11 = time.perf_counter()
    p11 = run_phase11(dev, dist_ref, phase_done, args.profile)
    dist_ms = dist_ref["ms"]
    del dist_ref
    torch.cuda.empty_cache()
    log("phase11.wall_s", f"{time.perf_counter() - t11:.1f} (K budgets and "
        f"fragment reuse)")
    phase_done("phase11")
    p12 = run_phase12(dev, phase_done, args.profile)
    torch.cuda.empty_cache()
    phase_done("phase12")
    p13 = run_phase13(dev, phase_done, args.profile)
    torch.cuda.empty_cache()
    phase_done("phase13")
    p14 = run_phase14(dev, phase_done)
    phase_done("phase14")
    p15 = run_phase15(dev, phase_done, scene_field, dist_ms)
    phase_done("phase15")
    p16 = run_phase16(dev, phase_done, launches, scene_field)
    torch.cuda.empty_cache()
    phase_done("phase16")
    p17 = run_phase17(dev, phase_done, scene_field)
    del scene_field
    torch.cuda.empty_cache()
    phase_done("phase17")
    p18 = run_phase18(dev, phase_done, b10, (PHASE3_VDI.pop("color"),
                                             PHASE3_VDI.pop("depth")))
    phase_done("phase18")
    torch.cuda.empty_cache()
    p19 = run_phase19(dev, phase_done)
    phase_done("phase19")
    n_frames = WARMUP_FRAMES + TIMED_FRAMES

    table = [
        dict(name="grayscott_fused", route="cuda",
             source="scenery_insitu_tpu_torch/csrc/stencil.cu",
             replaces="scenery_insitu_tpu/sim/pallas_stencil.py:509",
             launches=launches["grayscott_fused"],
             max_abs_err=stencil[4]["err"], ms=stencil[4]["ms"],
             plain_ms=stencil[4]["plain_ms"],
             bound_ms=stencil[4]["bound_ms"],
             bound_by=stencil[4]["bound_by"], library_ms=None),
        dict(name="seg_fold_compact", route="cuda",
             source="scenery_insitu_tpu_torch/csrc/seg_fold.cu",
             replaces="scenery_insitu_tpu/ops/pallas_seg.py:237",
             launches=launches["seg_fold_compact"],
             max_abs_err=max(fold[16]["seg"]["err"], fold[1]["seg"]["err"],
                             fold["frame"]["err"], p14["hybrid"]["k1_err"],
                             p15["scene"]["k1_err"],
                             p16["bf16"]["k1_err"]),
             ms=fold[16]["seg"]["ms"],
             plain_ms=fold[16]["seg"]["plain_ms"],
             bound_ms=fold[16]["seg"]["bound_ms"],
             bound_by=fold[16]["seg"]["bound_by"], library_ms=None,
             frame_ms=fold["frame"]["ms"],
             frame_bound_ms=fold["frame"]["bound_ms"],
             # phase 9: K1's launches a frame under each decomposition
             decomp_launches_per_frame={
                 c: decomp[c]["k1"] / (WARMUP_FRAMES + TIMED_FRAMES)
                 for c in DECOMP_NAMES},
             # phase 10: K1's launches a frame on each two-level mesh
             hier_launches_per_frame={c: hier[c]["k1"] / n_frames
                                      for c in hier}),
        dict(name="count_multi", route="cuda",
             source="scenery_insitu_tpu_torch/csrc/count_multi.cu",
             replaces="scenery_insitu_tpu/ops/pallas_march.py:426",
             launches=launches["count_multi"],
             max_abs_err=fold[16]["count"]["err"],
             ms=fold[16]["count"]["ms"],
             plain_ms=fold[16]["count"]["plain_ms"],
             bound_ms=fold[16]["count"]["bound_ms"],
             bound_by=fold[16]["count"]["bound_by"], library_ms=None,
             one_launch_ms=fold[16]["count"]["one_launch_ms"],
             frame_ms=fold["count_frame"]["ms"],
             frame_bound_ms=fold["count_frame"]["bound_ms"],
             compare_ms={**fold[16]["count"]["compare_ms"], **{
                 f"{n}_frame": v for n, v in
                 fold["count_frame"]["compare_ms"].items()}},
             # phase 9: K2's launches a seed under each decomposition
             decomp_launches_per_seed={c: decomp[c]["k2"]
                                       for c in DECOMP_NAMES},
             hier_launches_per_seed={c: hier[c]["k2"] for c in hier}),
        dict(name="resegment_sorted", route="cuda",
             source="scenery_insitu_tpu_torch/csrc/resegment.cu",
             replaces="scenery_insitu_tpu/ops/pallas_composite.py:172",
             launches=dist_launches["resegment_sorted"],
             max_abs_err=max([reseg[b]["err"] for b in ("seeded",
                                                        "frame_block")]
                             + [exch[c]["k4_err"] for c in
                                ("c2_ring_cap", "c7_ring_waves")]
                             + [decomp["brick_stream"]["err"]]
                             + [hier[c]["k4_err"] for c in ("h1", "h6")]
                             + [p14["hybrid"]["k4_err"],
                                p15["scene"]["k4_err"]]),
             ms=reseg["frame_block"]["ms"],
             plain_ms=reseg["frame_block"]["plain_ms"],
             bound_ms=reseg["frame_block"]["bound_ms"],
             bound_by=reseg["frame_block"]["bound_by"], library_ms=None,
             one_launch_ms=reseg["frame_block"]["one_launch_ms"],
             frame_ms=reseg["frame"]["ms"],
             frame_bound_ms=reseg["frame"]["bound_ms"],
             compare_ms=reseg["frame_block"]["compare_ms"],
             # phase 8: K4's launches in each exchange configuration's run
             # (8 frames) and one frame's K4 launches timed on that
             # configuration's own streams, beside their bound
             exchange_launches={c: exch[c]["k4"] for c in exch
                                if "k4" in exch[c]},
             exchange_frame_ms={c: exch[c]["k4_frame_ms"] for c in exch},
             exchange_frame_bound_ms={c: exch[c]["k4_frame_bound_ms"]
                                      for c in exch},
             ring_cap_frame_ms=exch["c2_ring_cap"]["k4_frame_ms"],
             wave_frame_ms=exch["c6_a2a_waves"]["k4_frame_ms"],
             session_waves_launches=waves_session_launches[
                 "resegment_sorted"],
             # phase 9: K4's launches in each decomposition's run (8
             # frames), a frame's K4 launches on its own streams, K4 on
             # b3's 640-slot brick stream (the stream kept full, the one
             # launch beside), and the decomposition sessions' launches
             decomp_launches={c: decomp[c]["k4"] for c in DECOMP_NAMES},
             decomp_frame_ms={c: decomp[c]["parts"]["k4_ms"]
                              for c in DECOMP_NAMES},
             decomp_frame_bound_ms={c: decomp[c]["parts"]["k4_bound_ms"]
                                    for c in DECOMP_NAMES},
             brick_stream_ms=decomp["brick_stream"]["ms"],
             brick_stream_one_launch_ms=decomp["brick_stream"][
                 "one_launch_ms"],
             brick_stream_plain_ms=decomp["brick_stream"]["plain_ms"],
             brick_stream_bound_ms=decomp["brick_stream"]["bound_ms"],
             brick_stream_slots=decomp["brick_stream"]["nk"],
             decomp_session_launches={
                 m: v[0]["resegment_sorted"]
                 for m, v in decomp_sessions.items()},
             # phase 10: K4's launches in each two-level run (8 frames),
             # a frame's K4 launches at the top on their own N·K-slot
             # streams beside their bound, and the two-level session's
             hier_launches={c: hier[c]["k4"] for c in hier},
             hier_frame_ms={c: hier[c]["k4_frame_ms"] for c in hier},
             hier_frame_bound_ms={c: hier[c]["k4_frame_bound_ms"]
                                  for c in hier},
             hier_session_launches=hier_session_launches[
                 "resegment_sorted"]),
    ]
    # the kernels of this slice: B1b has no caller on a frame path; the
    # microbenchmark's pallas_seg and tf_pallas_seg variants run it, so
    # its count is that sweep's; each fold kernel's count is its fold
    # frame's run
    sources = {"seg_fold_planes": ("seg_fold.cu", "ops/pallas_seg.py:252"),
               "fold_chunk": ("fold_chunk.cu", "ops/pallas_march.py:367"),
               "fused_fold_chunk": ("fused_fold.cu", "ops/pallas_seg.py:426"),
               "fused_stream_fold": ("fused_fold.cu",
                                     "ops/pallas_seg.py:514")}
    runs = {name: folds[f][0][name] for f, name in FOLD_KERNELS.items()}
    runs["seg_fold_planes"] = micro_launches["seg_fold_planes"]
    for name, (src, site) in sources.items():
        r = new[name]
        table.append(dict(
            name=name, route="cuda",
            source=f"scenery_insitu_tpu_torch/csrc/{src}",
            replaces=f"scenery_insitu_tpu/{site}", launches=runs[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None))
        if name == "fold_chunk":
            # B7: stream kept full on the seeded chunk (the one launch
            # beside it), and its S / C launches over phase 6's march
            table[-1].update(one_launch_ms=r["one_launch_ms"],
                             march_ms=events["fold_chunk"]["march_ms"],
                             march_bound_ms=events["fold_chunk"][
                                 "march_bound_ms"])
        if name in ("fused_fold_chunk", "fused_stream_fold"):
            # B5: its 32 launches over a frame's feed; B6: its one launch
            # a march. compare_ms: each --fused-compare design's times in
            # turns
            table[-1].update(frame_ms=r["frame_ms"],
                             frame_bound_ms=r["frame_bound_ms"],
                             compare_ms=r["compare_ms"])
    # K3's one body replaces both stencil sites (3-D and 2-D grids), and
    # B4b both sites' ranges epilogue
    table[0]["also_replaces"] = ["scenery_insitu_tpu/sim/pallas_stencil.py"
                                 ":240"]
    table.append(dict(
        name="grayscott_fused_ranges", route="cuda",
        source="scenery_insitu_tpu_torch/csrc/stencil.cu",
        replaces="scenery_insitu_tpu/sim/pallas_stencil.py:125",
        also_replaces=["scenery_insitu_tpu/sim/pallas_stencil.py:404"],
        launches=occ_launches["sim"]["grayscott_fused_ranges"],
        max_abs_err=ranges[4]["err"], ms=ranges[4]["ms"],
        plain_ms=ranges[4]["plain_ms"], bound_ms=ranges[4]["bound_ms"],
        bound_by=ranges[4]["bound_by"], library_ms=None))
    # the microbenchmark's deferred-event folds: launches from its sweep;
    # ms at (C, K) = (16, 16) with the stream kept full, march_ms over
    # phase 6's march; compare_ms: each --events-compare design in turns
    for name, site in (("events_fold_chunk", "benchmarks/fold_microbench.py"
                        ":253"),
                       ("scratch_fold_chunk", "benchmarks/fold_microbench.py"
                        ":362")):
        r = events[name]
        table.append(dict(
            name=name, route="cuda",
            source="scenery_insitu_tpu_torch/csrc/fold_chunk.cu",
            replaces=site, launches=micro_launches[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, one_launch_ms=r["one_launch_ms"],
            march_ms=r["march_ms"], march_bound_ms=r["march_bound_ms"],
            compare_ms=r["compare_ms"]))
    # the session's runs (phase 7): K3, K2 and K1 in the flagship loop,
    # K4 in the 4-rank session; phase 11: each K budget and reuse run's
    # launches (8 frames and their seeds), and K1's and K4's a frame on
    # the frozen field (the first frame marches every rank)
    for row in table:
        name = row["name"]
        if name in DIST_KERNELS:
            row["phase11_launches"] = {c: v.get(name, 0) for c, v in
                                       p11["launches"].items()}
        if name in ("seg_fold_compact", "resegment_sorted"):
            key = "k1" if name == "seg_fold_compact" else "k4"
            row["phase11_frozen_launches_per_frame"] = {
                c: v[key] for c, v in p11["frozen"].items()}
        if name in FRAME_KERNELS:
            row["session_launches"] = session_launches[name]
            row["hier_session_launches"] = hier_session_launches[name]
        elif name == "resegment_sorted":
            row["session_launches"] = small_session_launches[name]
        # phase 12: each gather and plain path's run (the single-chip
        # gather frame, the 8-rank gather step, the two 8-rank sessions)
        row["phase12_launches"] = {
            "gather_frame": p12["frame"][name],
            "gather_dist": p12["dist"][name],
            **{f"session_{m}": v[name]
               for m, v in p12["sessions"].items()}}
        # phase 13: the default frames that made the VDI, its novel
        # views, the pre-shaded VDI march and the 8-rank AO step
        row["phase13_launches"] = {
            "default_frames": p13["state"][name],
            "novel_views": p13["views"][name],
            "preshaded_vdi": p13["preshaded"][name],
            "ao_dist": p13["ao_dist"][name]}
        # phase 14: the vortex, Lennard-Jones and hybrid sessions (each
        # its warm frame, seed included, and its timed frames)
        row["phase14_launches"] = {
            f"{c}_session": p14[c]["launches"].get(name, 0)
            for c in ("vortex", "lj", "hybrid")}
        # phase 15: the 6-grid scene's 4 frames, the steered scenario's
        # 13 and the two example twins' runs
        row["phase15_launches"] = {
            "scene": p15["scene"]["launches"].get(name, 0),
            "steered": p15["steer"]["launches"].get(name, 0),
            **{f"twin_{t}": v.get(name, 0)
               for t, v in p15["twins"].items()}}
        # phase 16: the bf16 and f32 frames (a), and the main path's two
        # sessions (phase 7's, and over phase 4's 8 ranks)
        row["phase16_launches"] = {
            "bf16_frames": p16["bf16"]["launches"].get(name, 0),
            "f32_frames": p16["bf16"]["f32_launches"].get(name, 0),
            "sessions": p16["launches"].get(name, 0)}
        # phase 17: the in-process seed and 3 frames on phase 4's field,
        # each fleet process's share of them (half the ranks), and each
        # process's host-path frame of the gather step (K4 at the head)
        row["phase17_launches"] = {
            "in_process": p17["in_process"].get(name, 0),
            **{f"fleet_p{p}": v.get(name, 0)
               for p, v in enumerate(p17["fleet"])},
            **{f"host_path_p{p}": v.get(name, 0)
               for p, v in enumerate(p17["host_path"])}}
        # phase 18: the ingest session's live frames (a) and the sharded
        # feed's session (b)
        row["phase18_launches"] = {
            "ingest_session": p18["ingest"].get(name, 0),
            "sharded_session": p18["sharded"].get(name, 0)}
        # phase 19: the profiled windows' launches (each path's frames,
        # then its seed) and the phase each one was joined to, with the
        # kernel's device ms a frame in that window
        if name in P19_KERNELS:
            row["phase19_attribution"] = {
                "phase": P19_KERNELS[name][1],
                **{w: {"launches": p19[w][1][name],
                       "ms_per_frame": p19[w][2].get(name)}
                   for w in ("p3", "p3_seed", "p4", "p4_seed")
                   if p19[w][1][name]}}
        if name == "seg_fold_compact":
            row["bf16_max_abs_err"] = p16["bf16"]["k1_err"]
        if name == "seg_fold_compact":
            row["scene_max_abs_err"] = p15["scene"]["k1_err"]
        if name == "resegment_sorted":
            row["scene_max_abs_err"] = p15["scene"]["k4_err"]
        if name == "seg_fold_compact":
            row["hybrid_max_abs_err"] = p14["hybrid"]["k1_err"]
        if name == "resegment_sorted":
            row["hybrid_max_abs_err"] = p14["hybrid"]["k4_err"]
        if name == "seg_fold_compact":
            row["preshaded_max_abs_err"] = p13["errs"]["fold_err"]
        if name == "count_multi":
            row["preshaded_max_abs_err"] = p13["errs"]["count_err"]
        if name == "resegment_sorted":
            # on the 8-rank gather step's 128-slot, 720 x 160 streams
            err, ms, b, by = p12["gather_k4"]
            row.update(gather_dist_max_abs_err=err, gather_dist_frame_ms=ms,
                       gather_dist_frame_bound_ms=b,
                       gather_dist_frame_bound_by=by)
    # B10, the lint fixture's kernel: its launches in phase 18 (d)'s two
    # calls; no single torch call computes it: the pair x * 2 and amax
    # is timed beside it
    b = p18["b10"]
    table.append(dict(
        name="double_chunk", route="cuda",
        source="tests/torch_lint_fixtures/good_double.cu",
        replaces="tests/lint_fixtures/good_pallas.py:24",
        also_replaces=["tests/lint_fixtures/bad_pallas.py:24"],
        launches=b["launches"], max_abs_err=b["err"], ms=b["ms"],
        plain_ms=b["plain_ms"], bound_ms=b["bound_ms"],
        bound_by=b["bound_by"], library_ms=None,
        library_pair_ms=b["pair_ms"]))
    log("library_ms", "null for every kernel: no single PyTorch call "
        "computes the fused Gray-Scott steps, the segmented write fold, "
        "the multi-threshold count, the sort-and-resegment of a "
        "supersegment stream, the supersegment machine (with its close "
        "events deferred or not), the shading "
        "and fold of a value stream, the stencil with per-brick "
        "ranges or the doubling with its tile maxima (B10: x * 2 and "
        "amax timed as library_pair_ms)")
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def gs_init(dev):
    from scenery_insitu_tpu_torch.sim import grayscott as gs

    st = gs.GrayScott.init((GRID,) * 3, seed=SEED, device=dev)
    return gs.multi_step_fast(st, 2 * SIM_STEPS)


if __name__ == "__main__":
    sys.exit(main())
